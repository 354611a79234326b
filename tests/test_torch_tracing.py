"""The port's host spans and host counters, on the CPU.

A tiny cell of the benchmark (``portbench/tests/tiny.py``, its traffic cut
to a few updates a block so that the profiled window stays small) runs
traced through ``portbench.run.run_cell``: the five metrics that read the
spans and counters are reported, the spans on the cell's path are host rows
of the trace with no ``aten::`` row inside any of them (on the CPU every
torch op is such a row, so a span that held one would hold device work on
the card), the counters equal the final states' bytes and 84 B a volume,
and no trace row is copied on the host. A grouped sweep with fk opens every span the port has; the readers
give None on a trace or a port without them."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spans, tracing  # noqa: E402
from portbench import run as bench  # noqa: E402
from portbench.metrics import reader  # noqa: E402
from portbench.tests.tiny import tiny_cell  # noqa: E402
from repro_torch.core import fleetshard, torchsim  # noqa: E402
from repro_torch.core.config import TorchSimConfig, init_state  # noqa: E402
from repro_torch.core.tracegen import make_fleet  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SEED = 2 ** 31 + 29
CELLS = ("corpus512m.sepbit", "corpus128m.sepbit_gp4")
NEW = ("trace_prep_ms", "summary_ms", "host_unnamed_ms", "readback_mb", "readback_used_pct")
ON_PATH = {"corpus512m.sepbit": {"check_lbas", "summaries"},
           "corpus128m.sepbit_gp4": {"gather", "check_lbas", "summaries", "sweep_summary"}}
EVERY_SPAN = {"gather", "check_lbas", "next_writes", "summaries", "regroup", "sweep_summary"}
SUMMARY_BYTES = 84      # 9 int32 / float32 scalars and two int32 counts of 6 class slots


def _cell(name):
    cell = tiny_cell(name, n_lbas=32, volumes=2, segment_size=8)
    cell["traffic"]["updates_per_lba"] = 3
    return cell


@pytest.fixture(scope="module")
def traced():
    """Each cell run once, traced, with no warm-up job: its result, its
    trace, the final states its jobs summarized and the host counts."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "WARM_JOBS", 0)
        caught, states = [], []
        trace_of, summarize = tracing.from_profiler, torchsim.summarize_fleet

        def from_profiler(prof):
            caught.append(trace_of(prof))
            return caught[-1]
        mp.setattr(tracing, "from_profiler", from_profiler)

        def summarize_fleet(cfg, st, n_volumes):
            states.append({k: (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                               else x.nbytes) for k, x in st.items()})
            return summarize(cfg, st, n_volumes)
        mp.setattr(torchsim, "summarize_fleet", summarize_fleet)
        for name in CELLS:
            ops.reset_launch_counts()
            del caught[:], states[:]
            cell = _cell(name)
            res = bench.run_cell(cell, SEED, 0.0, True, device="cpu")
            out[name] = {"res": res, "trace": caught[-1], "states": list(states),
                         "counts": ops.host_counts(), "cell": cell}
    return out


def _port_rows(trace):
    return [(n, s, e) for n, s, e in trace.host if n.startswith(spans.PREFIX)]


@pytest.mark.parametrize("name", CELLS)
def test_traced_tiny_cell_reports_the_five_new_metrics(traced, name):
    res = traced[name]["res"]
    assert res["correct"], res["checks"]
    assert set(NEW) <= set(res["metrics"])
    assert {m["name"] for m in traced[name]["cell"]["per_layer"]} >= set(NEW)
    assert all(res["metrics"][m]["value"] >= 0 for m in NEW)


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_spans_are_host_rows(traced, name):
    tr = traced[name]["trace"]
    found = {n.removeprefix("repro_torch.fleet.") for n, _, _ in _port_rows(tr)}
    assert found == ON_PATH[name]
    assert not [n for n, _, _ in tr.device if n.startswith(spans.PREFIX)]
    (lo, hi), = tr.jobs
    assert all(lo <= s <= e <= hi for _, s, e in _port_rows(tr))


@pytest.mark.parametrize("name", CELLS)
def test_no_torch_op_inside_a_port_span(traced, name):
    tr = traced[name]["trace"]
    ports = _port_rows(tr)
    aten = [(n, s, e) for n, s, e in tr.host if n.startswith("aten::")]
    assert ports and aten
    inside = [(p, a) for p, ps, pe in ports for a, s, e in aten if s < pe and e > ps]
    assert not inside, inside[:5]


@pytest.mark.parametrize("name", CELLS)
def test_state_readback_bytes_are_the_final_states_bytes(traced, name):
    run = traced[name]
    counts, states = run["counts"], run["states"]
    assert counts["fleet_summaries"] == len(states) == 1
    assert counts["state_readback_bytes"] == sum(sum(s.values()) for s in states)
    assert run["res"]["metrics"]["readback_mb"]["value"] == (
        counts["state_readback_bytes"] / counts["fleet_summaries"] / 1e6)


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_copy_no_trace_rows_on_the_host(traced, name):
    """One scheme group on one device, or a fleet matrix as it is: every
    row selection is a view, and no trace row is copied on the host."""
    assert traced[name]["counts"]["trace_copy_bytes"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_summary_bytes_are_84_a_volume(traced, name):
    run = traced[name]
    c = run["cell"]
    volumes = c["config"]["volumes"] * (4 if name.endswith("gp4") else 1)
    counts = run["counts"]
    assert counts["summary_bytes"] == SUMMARY_BYTES * volumes * counts["fleet_summaries"]
    assert run["res"]["metrics"]["readback_used_pct"]["value"] == (
        100.0 * counts["summary_bytes"] / counts["state_readback_bytes"])


def test_span_metrics_add_up_to_the_job():
    """On a made-up trace: a job of 10 ms with 2 ms of prep spans (one
    nested in another), 1 ms of summaries, 3 ms of device rows overlapping
    one prep span by 1 ms."""
    tr = tracing.Trace(jobs=[(0.0, 10_000.0)],
                       device=[("Memcpy HtoD", 2_500.0, 5_500.0)],
                       host=[("repro_torch.fleet.gather", 1_000.0, 2_000.0),
                             ("repro_torch.fleet.check_lbas", 1_500.0, 3_000.0),
                             ("aten::copy_", 2_600.0, 2_700.0),
                             ("repro_torch.fleet.summaries", 8_000.0, 9_000.0)])
    run = bench.Run({}, None, [], [], 0.0, tr)
    assert reader("trace_prep_ms")(run) == 2.0
    assert reader("summary_ms")(run) == 1.0
    assert reader("host_unnamed_ms")(run) == 10.0 - 2.0 - 1.0 - 2.5


def test_readers_give_none_without_spans_or_counters(monkeypatch):
    """An older port: no ``repro_torch.`` span in the trace and no host
    counters in ``kernels.ops``."""
    tr = tracing.Trace(jobs=[(0.0, 10.0)], device=[("k", 1.0, 2.0)], host=[("aten::x", 3, 4)])
    run = bench.Run({}, None, [], [], 0.0, tr)
    for name in ("trace_prep_ms", "summary_ms", "host_unnamed_ms"):
        assert reader(name)(run) is None
        assert reader(name)(bench.Run({}, None, [], [], 0.0, None)) is None
    monkeypatch.delattr(ops, "host_counts")
    for name in ("readback_mb", "readback_used_pct"):
        assert reader(name)(run) is None


def test_a_grouped_sweep_with_fk_opens_every_span():
    """Two scheme groups (regroup) and fk (its next-write stream) on the
    step engine, and one single-volume run: every span the port has, each
    holding no torch op, and the counters of the sweep's one summary."""
    traces = make_fleet("mixed", 4, 16, 3 * 16, jitter=0.25, seed=31)
    cfg = TorchSimConfig(n_lbas=16, segment_size=4)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fleetshard.simulate_fleet_sweep(traces, cfg, schemes=["sepbit", "fk"],
                                              selectors=["greedy"], gp_thresholds=[0.15],
                                              device="cpu")
        torchsim.run(cfg, traces[0][:8], device="cpu")
    rows = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    ports = [r for r in rows if r[0].startswith(spans.PREFIX)]
    assert {n.removeprefix("repro_torch.fleet.") for n, _, _ in ports} == EVERY_SPAN
    aten = [r for r in rows if r[0].startswith("aten::")]
    assert not [(p, a) for p, ps, pe in ports for a, s, e in aten if s < pe and e > ps]
    assert len(res["volumes"]) == 4
    counts = ops.host_counts()
    assert counts["fleet_summaries"] == 1
    assert counts["summary_bytes"] == 4 * SUMMARY_BYTES
    # each group's state read back once; the single-volume run returns tensors
    per_volume = sum(x[:1].numel() * x.element_size()
                     for x in init_state(fleetshard.hetero_config(cfg, res["policy"]),
                                         res["policy"].as_state_arrays(), "cpu").values())
    assert counts["state_readback_bytes"] == 4 * per_volume


@pytest.mark.parametrize("timing,fifo", [(False, False), (True, False), (False, True)])
def test_summary_keys_are_the_keys_the_summary_reads(timing, fifo):
    """`torchsim.summary_keys`, which `summary_bytes` counts, against the
    keys `_summary` reads of a volume's state."""
    cfg = TorchSimConfig(n_lbas=64, segment_size=8, timing=timing, fifo_occupancy=fifo)
    st = {k: x[0].numpy() for k, x in init_state(cfg, None, "cpu").items()}
    read = set()

    class Recording(dict):
        def __getitem__(self, key):
            read.add(key)
            return dict.__getitem__(self, key)

    torchsim._summary(cfg, Recording(st))
    assert read == set(torchsim.summary_keys(cfg))
    assert len(torchsim.summary_keys(cfg)) == len(set(torchsim.summary_keys(cfg)))
    if not (timing or fifo):
        assert sum(np.asarray(st[k]).nbytes for k in read) == SUMMARY_BYTES
