"""A tiny cell run end to end on the CPU, through the port's step engine:
the run is correct, its metrics are those BENCHMARK.json lists, and each
fault the timed path can have, planted underneath it in the port, makes it
incorrect. So does the control: the reference in bfloat16 in the
program's place."""

import numpy as np
import pytest
import torch
from tiny import tiny_cell

from portbench import check, control, jobs, traffic
from portbench import run as bench
from repro_torch.core import torchsim

SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def one_warm_job(monkeypatch):
    monkeypatch.setattr(bench, "WARM_JOBS", 1)


@pytest.mark.parametrize("name,n_lbas,segment", [("corpus512m.sepbit", 256, 16),
                                                 ("corpus128m.sepbit_gp4", 256, 16)])
def test_tiny_cell_is_correct(name, n_lbas, segment):
    cell = tiny_cell(name, n_lbas=n_lbas, volumes=2, segment_size=segment, sample=14)
    res = bench.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert all(value == 0 == limit for value, limit in res["checks"].values())


def _unchanged(orig):
    def replay(cfg, st, trace, *a, **k):      # returns its state as it came
        return st
    return replay


def _half(orig):
    def replay(cfg, st, trace, *a, **k):      # the second half of the volumes left out
        V = trace.shape[0]
        half = torchsim.own_state({key: x[: V // 2] for key, x in st.items()})
        orig(cfg, half, trace[: V // 2].contiguous(), *a, **k)
        for key, x in st.items():
            x[: V // 2] = half[key]
        return st
    return replay


def _altered(orig):
    def replay(cfg, st, trace, *a, **k):      # one answer altered where it is produced
        orig(cfg, st, trace, *a, **k)
        st["reclaimed"] += 1
        return st
    return replay


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_fault_underneath_is_caught(monkeypatch, fault):
    monkeypatch.setattr(torchsim, "_replay", fault(torchsim._replay))
    res = bench.run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert not res["correct"]


def test_control_is_caught(monkeypatch):
    """The control: every volume's answer from the bfloat16 reference."""
    cell = tiny_cell()
    c = cell["config"]

    def control(self):
        return [check.reference_volume(c, *self.volume(k), self.n_segments, "bfloat16")
                for k in range(self.n_volumes)]

    monkeypatch.setattr(jobs.Job, "run", control)
    res = bench.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["reference_mismatches"][0] > 0


def _gc_uncounted(orig):
    def replay(cfg, st, trace, *a, **k):      # one volume's GC writes left uncounted
        orig(cfg, st, trace, *a, **k)
        st["gc_writes"][-1] = 0
        st["class_gc"][-1] = 0
        return st
    return replay


def test_accounting_catches_a_volume_outside_the_sample(monkeypatch):
    """A fault in one volume that the sample may miss breaks the log's
    accounting, which every volume is held to."""
    monkeypatch.setattr(torchsim, "_replay", _gc_uncounted(torchsim._replay))
    res = bench.run_cell(tiny_cell(sample=1), SEED, 0.0, False, device="cpu")
    assert res["checks"]["accounting_broken"][0] > 0
    assert res["checks"]["writes_miscounted"][0] == 0
    assert not res["correct"]


def test_control_fails_the_runs_own_judge():
    out = control.control_readings(tiny_cell(), SEED, device="cpu")
    assert not out["correct"]
    assert out["checks"]["reference_mismatches"][0] > 0
    assert set(out["checks"]) == set(check.LIMITS)


def test_sample_spreads_over_tiles_and_holds_the_longest():
    cell = tiny_cell("corpus128m.sepbit_gp4", sample=8)
    cell["traffic"]["jitter"] = 0.25        # traces of different lengths
    c = cell["config"]
    corpus = traffic.make_corpus(cell["traffic"], c["volumes"], c["n_lbas"], SEED, "cpu")
    job = jobs.Job(c, cell["traffic"], corpus.numpy(), "cpu")
    picks = check.sample(job, SEED, 8)
    assert len(set(picks)) == 8
    assert sorted({k // c["volumes"] for k in picks}) == [0, 1, 2, 3]
    assert sorted({k % check.LANES for k in picks}) == list(range(check.LANES))
    assert int(np.argmax(job.writes[: c["volumes"]])) in {k % c["volumes"] for k in picks}
    assert picks == check.sample(job, SEED, 8) != check.sample(job, SEED + 1, 8)


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res = bench.run_cell(tiny_cell(), SEED, 0.0, False, device="cuda")
    assert res["correct"], res["checks"]
