"""The port's heterogeneous fleet sweeps (``core/fleetshard.py``) held
against the JAX package's on the CPU: the policy encoders and configs equal,
grouped and ungrouped hetero replays and sweeps bit-equal to JAX on every
state key (``lat_*`` and ``sch_*`` included, stateful schemes on the step
engine), the split across two devices equal to one, and the committed
latency bench (``BENCH_gc_latency.json``) reproduced cell for cell; the
traces' rows handed to each replay as views of the caller's fleet where they
are contiguous, and the LBA check made on the uploaded trace before any
state."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fleetshard as jfs
from repro.core.jaxsim import JaxSimConfig
from repro.core.tracegen import make_fleet, tiled_fleet
from repro_torch import convert
from repro_torch.core import fleetshard as tfs
from repro_torch.core import torchsim
from repro_torch.core.config import TorchSimConfig, init_state
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
N, SEG = 128, 8


def _port_cfg(jcfg: JaxSimConfig) -> TorchSimConfig:
    return convert.config_from_jax(dataclasses.asdict(jcfg))


def _assert_states_equal(got: dict, want: dict):
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(got[key], ref, err_msg=f"state[{key}]")


def _assert_policies_equal(got: tfs.FleetPolicy, want: jfs.FleetPolicy):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert np.array_equal(got.n_classes, want.n_classes)
    for key, arr in want.as_state_arrays().items():
        np.testing.assert_array_equal(got.as_state_arrays()[key], np.asarray(arr), err_msg=key)


ENCODINGS = [
    dict(),
    dict(schemes=["nosep", "fk", "warcip"], selectors=["greedy", 1, "cost_benefit"],
         gp_thresholds=[0.1, 0.15, 0.2], nc_windows=[8, 16, 24],
         gcscheds=["greedy", "rate_limited", "idle_window"]),
    dict(schemes="dac", gcscheds=2, gp_thresholds=0.12),
]


@pytest.mark.parametrize("kw", range(len(ENCODINGS)))
def test_encoders_and_configs_match_jax(kw):
    kw = ENCODINGS[kw]
    got, want = tfs.encode_policies(3, **kw), jfs.encode_policies(3, **kw)
    _assert_policies_equal(got, want)
    for i in range(3):
        assert got.describe(i) == want.describe(i) and got.gcsched(i) == want.gcsched(i)
        assert {k: np.asarray(v) for k, v in got.volume(i).items()} == \
            {k: np.asarray(v) for k, v in want.volume(i).items()}
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, timing=True)
    assert tfs.hetero_config(_port_cfg(jcfg), got) == _port_cfg(jfs.hetero_config(jcfg, want))
    for i in range(3):
        assert tfs.matching_single_config(_port_cfg(jcfg), got, i) == \
            _port_cfg(jfs.matching_single_config(jcfg, want, i))
    g, w = tfs.scheme_groups(got), jfs.scheme_groups(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g, w))


def test_policy_grid_matches_jax():
    args = (["nosep", "sepbit"], ["greedy", "cost_benefit"], [0.1, 0.15, 0.2])
    got, cells = tfs.policy_grid(*args, volumes_per_cell=2, gcsched="rate_limited")
    want, jcells = jfs.policy_grid(*args, volumes_per_cell=2, gcsched="rate_limited")
    _assert_policies_equal(got, want)
    assert cells == jcells and got.n_volumes == 24
    with pytest.raises(ValueError, match="fleet length"):
        tfs.FleetPolicy(got.scheme_id, got.selector_id[:3], got.gp_threshold, got.nc_window)
    with pytest.raises(ValueError, match="per-volume"):
        tfs.encode_policies(3, schemes=["nosep"])


def test_pool_is_sized_from_the_float32_max_threshold():
    """0.15 as float32 is 0.1500000059604645: the pool is sized from that,
    as in JAX, not from the Python float."""
    pol = tfs.encode_policies(2, gp_thresholds=[0.1, 0.15])
    cfg = tfs.hetero_config(TorchSimConfig(n_lbas=1000, segment_size=16), pol)
    jcfg = jfs.hetero_config(JaxSimConfig(n_lbas=1000, segment_size=16),
                             jfs.encode_policies(2, gp_thresholds=[0.1, 0.15]))
    assert cfg.n_segments == jcfg.n_segments and cfg.class_slots == jcfg.class_slots == 6


@pytest.fixture(scope="module")
def mixed_fleet():
    """Nine volumes of unequal length (pad steps): elementwise and stateful
    schemes (fk, dac), both selectors, three GC thresholds and the three GC
    schedules, timing on; JAX's grouped replay as the reference."""
    traces = make_fleet("mixed", 9, N, 3 * N, jitter=0.3, seed=41)
    kw = dict(schemes=["sepbit", "fk", "nosep", "dac", "sepbit", "gw", "fk", "sepgc", "uw"],
              selectors=["cost_benefit", "greedy"] * 4 + ["greedy"],
              gp_thresholds=[0.1, 0.15, 0.2] * 3,
              gcscheds=["greedy", "rate_limited", "idle_window"] * 3)
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, timing=True, gc_block_cost=1.3,
                        write_cost=0.7)
    jres, jst = jfs.simulate_fleet_hetero(traces, jcfg, jfs.encode_policies(9, **kw),
                                          shard=False, return_state=True)
    return traces, kw, jcfg, jres, jst


@pytest.mark.parametrize("group", [True, False])
def test_simulate_fleet_hetero_matches_jax(mixed_fleet, group):
    traces, kw, jcfg, jres, jst = mixed_fleet
    idle = np.asarray(kw["gcscheds"]) == "idle_window"
    assert (np.asarray(jst["reclaimed"])[~idle] > 0).all()
    res, st = tfs.simulate_fleet_hetero(traces, _port_cfg(jcfg), tfs.encode_policies(9, **kw),
                                        group=group, return_state=True, engine="step",
                                        device="cpu")
    _assert_states_equal(st, jst)
    assert res["volumes"] == jres["volumes"]
    want = dict(jres["fleet"], n_scheme_groups=jres["fleet"]["n_scheme_groups"] if group else 1)
    assert res["fleet"] == want


def test_split_across_two_devices_equals_one(mixed_fleet):
    traces, kw, jcfg, _, jst = mixed_fleet
    pol = tfs.encode_policies(9, **kw)
    res, st = tfs.simulate_fleet_hetero(traces, _port_cfg(jcfg), pol, group=False,
                                        devices=["cpu", "cpu"], return_state=True, engine="step")
    assert res["fleet"]["n_devices"] == 2
    _assert_states_equal(st, jst)
    one, _ = tfs.simulate_fleet_hetero(traces, _port_cfg(jcfg), pol, devices=["cpu", "cpu"],
                                       shard=False, return_state=True, engine="step")
    assert one["fleet"]["n_devices"] == 1


def test_simulate_fleet_sweep_matches_jax():
    """A timing sweep (rate_limited, 2 x 2 x 2 cells, two volumes each)
    equals JAX's on every state key and in every sweep row."""
    args = dict(schemes=["sepbit", "fk"], selectors=["greedy", "cost_benefit"],
                gp_thresholds=[0.1, 0.2], gcsched="rate_limited")
    traces = tiled_fleet("mixed", 8, 2, N, 3 * N, jitter=0.25, seed=43)
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, timing=True)
    want = jfs.simulate_fleet_sweep(traces, jcfg, shard=False, **args)
    got = tfs.simulate_fleet_sweep(traces, _port_cfg(jcfg), device="cpu", **args)
    assert got["sweep"] == want["sweep"]
    assert got["volumes"] == want["volumes"] and got["fleet"] == want["fleet"]
    assert [r["n_volumes"] for r in got["sweep"]] == [2] * 8
    assert all("lat_p99" in r for r in got["sweep"])
    with pytest.raises(ValueError, match="tile"):
        tfs.simulate_fleet_sweep(traces[:5], _port_cfg(jcfg), device="cpu", **args)


def test_sweep_summary_matches_jax_without_timing():
    traces = tiled_fleet("mixed", 4, 3, N, 3 * N, jitter=0.25, seed=44)
    args = dict(schemes=["nosep", "sepbit"], selectors=["cost_benefit"],
                gp_thresholds=[0.15, 0.1])
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG)
    want = jfs.simulate_fleet_sweep(traces, jcfg, shard=False, group=False, **args)
    got = tfs.simulate_fleet_sweep(traces, _port_cfg(jcfg), device="cpu", group=False, **args)
    assert got["sweep"] == want["sweep"]
    assert [r["gp_threshold"] for r in got["sweep"]] == [float(np.float32(g))
                                                          for g in (0.15, 0.1)] * 2
    assert tfs._t95(0) == jfs._t95(0) and all(tfs._t95(d) == jfs._t95(d) for d in range(1, 40))


def test_latency_bench_reproduced():
    """The 12 cells of ``BENCH_gc_latency.json`` (greedy / rate_limited /
    idle_window × nosep / sepgc / sepbit / fk, two volumes each; mixed,
    n_lbas 256, segment 32, seed 47, cost-benefit, GP 0.15, timing on) and
    its slo row, every field, from the port's hetero replay on the CPU."""
    bench = json.loads((ROOT / "BENCH_gc_latency.json").read_text())
    cells = [(g, s) for g in bench["gcscheds"] for s in bench["schemes"]]
    per = bench["volumes_per_cell"]
    n = bench["n_lbas"]
    traces = tiled_fleet(bench["workload"], len(cells), per, n, bench["n_updates"],
                         jitter=0.25, seed=47)
    policy = tfs.encode_policies(
        len(cells) * per, schemes=[s for _, s in cells for _ in range(per)],
        selectors=bench["selector"], gp_thresholds=bench["gp_threshold"],
        gcscheds=[g for g, _ in cells for _ in range(per)])
    cfg = TorchSimConfig(n_lbas=n, segment_size=bench["segment_size"], timing=True)
    res = tfs.simulate_fleet_hetero(traces, cfg, policy, device="cpu")
    rows, slo = tfs.latency_cells(res["volumes"], cells, per, cfg.write_cost)
    assert rows == bench["cells"]
    assert slo == bench["slo"]
    by = {(r["gcsched"], r["scheme"]): r for r in rows}
    assert [round(by[("greedy", s)]["wa"], 6) for s in bench["schemes"]] == \
        [3.559956, 2.831606, 2.84493, 2.102887]
    assert by[("rate_limited", "nosep")]["p99"] == pytest.approx(4.757, abs=1e-3)
    assert by[("idle_window", "fk")]["p99"] == 1.0


# -- trace preparation: row views and the LBA check ---------------------------

def _grid(schemes):
    return lambda: tfs.policy_grid(schemes, ["greedy"], [0.1, 0.2], volumes_per_cell=2)[0]


def _interleaved():
    return tfs.encode_policies(4, schemes=["sepbit", "nosep", "sepbit", "nosep"],
                               gp_thresholds=[0.1, 0.1, 0.2, 0.2])


# (policy, devices, rows copied on the host: 0 for views, else the whole fleet once)
LAYOUTS = {
    "one_scheme_sweep": (_grid(["sepbit"]), ["cpu"], False),
    "cell_major_schemes": (_grid(["sepbit", "nosep", "dac"]), ["cpu"], False),
    "two_way_split": (_grid(["sepbit"]), ["cpu", "cpu"], False),
    "interleaved": (_interleaved, ["cpu"], True),
    "interleaved_two_way_split": (_interleaved, ["cpu", "cpu"], True),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_group_and_chunk_rows_are_views_of_the_callers_fleet(monkeypatch, layout):
    """Every trace matrix `run_fleet` gets shares memory with the caller's
    fleet where the rows of its group and chunk are contiguous (the cell-major
    grid, `np.array_split`'s chunks), and the host copies nothing; rows
    interleaved across groups are copied once, the chunks of such a group
    being slices of its copy; either way the result equals the ungrouped
    replay's."""
    make_policy, devices, copies = LAYOUTS[layout]
    policy = make_policy()
    fleet = torchsim.pad_fleet(make_fleet("mixed", policy.n_volumes, 32, 64, jitter=0.25,
                                          seed=45))
    cfg = TorchSimConfig(n_lbas=32, segment_size=4)
    seen, run_fleet = [], torchsim.run_fleet

    def recording(cfg, traces, *a, **kw):
        seen.append((np.shares_memory(traces, fleet), traces.flags.c_contiguous))
        return run_fleet(cfg, traces, *a, **kw)
    monkeypatch.setattr(torchsim, "run_fleet", recording)
    ops.reset_launch_counts()
    res, st = tfs.simulate_fleet_hetero(fleet, cfg, policy, devices=devices, engine="step",
                                        return_state=True)
    copied = ops.host_counts()["trace_copy_bytes"]
    assert len(seen) == len(tfs.scheme_groups(policy)) * len(devices)
    assert seen == [(not copies, True)] * len(seen)
    assert copied == (fleet.size * 4 if copies else 0)
    monkeypatch.setattr(torchsim, "run_fleet", run_fleet)
    want, want_st = tfs.simulate_fleet_hetero(fleet, cfg, policy, devices=devices, group=False,
                                              engine="step", return_state=True)
    assert res["volumes"] == want["volumes"]
    _assert_states_equal(st, want_st)


def _check_fleet():
    """Four volumes with pad steps under sepbit, fk (its next-write stream
    made from the trace) and sfs (its refresh steps read from it)."""
    traces = torchsim.pad_fleet(make_fleet("mixed", 4, 32, 64, jitter=0.3, seed=46))
    policy = tfs.encode_policies(4, schemes=["sepbit", "fk", "sfs", "sepbit"])
    cfg = tfs.hetero_config(TorchSimConfig(n_lbas=32, segment_size=4, sfs_resample=16), policy)
    return cfg, traces, policy.as_state_arrays()


@pytest.mark.parametrize("engine", ["replay", "step"])
@pytest.mark.parametrize("start", ["policies", "state"])
def test_run_fleet_refuses_an_lba_of_n_lbas_before_any_state(monkeypatch, engine, start):
    """An LBA of ``n_lbas`` in the last step of the last volume: the same
    ValueError and message on either engine, raised before a state is made
    or copied, a passed state left as it was."""
    cfg, traces, pol = _check_fleet()
    traces[-1, -1] = cfg.n_lbas
    state = init_state(cfg, pol, "cpu")
    before = {k: v.clone() for k, v in state.items()}
    made = []
    for name in ("init_state", "own_state"):
        monkeypatch.setattr(torchsim, name, lambda *a, _n=name, **kw: made.append(_n))
    kw = {"policies": pol} if start == "policies" else {"state": state}
    with pytest.raises(ValueError, match=r"^trace LBAs must lie in \[0, 32\)$"):
        torchsim.run_fleet(cfg, traces, device="cpu", engine=engine, **kw)
    assert made == []
    assert all(torch.equal(state[k], before[k]) for k in before)


def test_a_cpu_replay_reads_the_callers_trace_and_leaves_it_as_it_was(monkeypatch):
    """On the CPU the replay's trace tensor is the caller's array itself (no
    host copy), and after the step engine has replayed it (fk's stream and
    sfs's refresh steps made from it) the array is bit-equal to a copy taken
    before."""
    cfg, traces, pol = _check_fleet()
    kept = traces.copy()
    shared, replay = [], torchsim._replay

    def recording(cfg, st, trace, *a, **kw):
        shared.append(np.shares_memory(trace.numpy(), traces))
        return replay(cfg, st, trace, *a, **kw)
    monkeypatch.setattr(torchsim, "_replay", recording)
    ops.reset_launch_counts()
    st = torchsim.run_fleet(cfg, traces, pol, device="cpu")
    assert shared == [True] and ops.host_counts()["trace_copy_bytes"] == 0
    assert int(st["reclaimed"].sum()) > 0
    np.testing.assert_array_equal(traces, kept)
