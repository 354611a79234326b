"""The port's legacy GC engine (``gc_engine="legacy"``: the victim selected
at loop entry on every user write, an unrolled rewrite per class slot) held
bit for bit against the JAX package's legacy engine on the CPU, on every
state key: single volumes under both selectors, a 14-scheme fleet with pad
steps, the heterogeneous fleet of the reference's own legacy-against-tick
test, the timing model at a non-unit GC cost and the free-pool exhaustion
corner; outside exhaustion it equals the port's tick engine. The JAX
package's gcbench fleet reproduces ``BENCH_fleet_gc.json`` through both
engines."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jaxsim
from repro.core import fleetshard as jfleetshard
from repro.core.jaxsim import JaxSimConfig
from repro.core.tracegen import make_fleet as jmake_fleet
from repro_torch import convert
from repro_torch.core import fleetshard, torchsim
from repro_torch.core.config import TorchSimConfig, init_state
from repro_torch.core.tracegen import make_fleet
from repro_torch.kernels import ops
from repro_torch.kernels import replay as kreplay

ROOT = Path(__file__).resolve().parents[1]
N, SEG = 128, 8
TRACE = np.asarray(np.random.default_rng(11).integers(0, N, 5 * N), np.int32)


def _port_cfg(jcfg: JaxSimConfig) -> TorchSimConfig:
    return convert.config_from_jax(dataclasses.asdict(jcfg))


def _assert_states_equal(got: dict, want: dict, volume=None):
    """Every key, ``sch_*`` and ``lat_*`` included, equal in shape, dtype and
    value; ``got``'s row ``volume`` (all rows when None) is compared."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key, ref in want.items():
        mine = got[key] if volume is None else got[key][volume]
        assert mine.dtype == ref.dtype, key
        np.testing.assert_array_equal(mine, ref, err_msg=f"state[{key}]")


def _jax_single(jcfg: JaxSimConfig, trace) -> dict:
    nxt = jaxsim._single_annotations(trace, jcfg, None)
    return jax.device_get(jaxsim._run(jcfg, jnp.asarray(trace), None,
                                      None if nxt is None else jnp.asarray(nxt)))


@pytest.mark.parametrize("scheme,selector", [("sepbit", "greedy"), ("sepbit", "cost_benefit"),
                                             ("gw", "greedy"), ("fk", "cost_benefit")])
def test_single_volume_legacy_matches_jax(scheme, selector):
    """The single-volume path: victims from `segment_select` (K2's plain
    version on the CPU), fk's next-write stream made from the trace."""
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, scheme=scheme, selector=selector,
                        gc_engine="legacy")
    ref = _jax_single(jcfg, TRACE)
    assert int(ref["reclaimed"]) > 0 and int(ref["overflow"]) == 0
    got = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), TRACE, device="cpu"))
    _assert_states_equal(got, ref, volume=0)
    assert (torchsim.simulate(TRACE, _port_cfg(jcfg), device="cpu")
            == jaxsim.simulate_jax(TRACE, jcfg))


def test_fleet_of_all_schemes_legacy_matches_jax():
    """All 14 schemes in one fleet under the legacy engine: unequal trace
    lengths (pad steps, exact no-ops), mixed selectors, GC thresholds and nc
    windows, class_slots 6 (padded slots on most volumes)."""
    V = len(jaxsim.SCHEME_NAMES)
    traces = jmake_fleet("mixed", V, N, 3 * N, jitter=0.3, seed=19)
    schemes = np.arange(V, dtype=np.int32)
    gps = np.asarray([0.08, 0.12, 0.16, 0.22, 0.1, 0.15, 0.2] * 2, np.float32)
    pol = {"p_scheme": schemes, "p_selector": (np.arange(V) % 2).astype(np.int32),
           "p_gp": gps, "p_ncw": np.asarray([16, 8, 24, 16] * 3 + [16, 8], np.int32),
           "p_classes": np.asarray(jaxsim.SCHEME_CLASSES, np.int32)[schemes],
           "p_gcsched": np.zeros(V, np.int32)}
    base = JaxSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, sfs_resample=64,
                        gc_engine="legacy")
    jcfg = dataclasses.replace(
        base, n_segments=dataclasses.replace(base, gp_threshold=float(gps.max())).s_max)
    padded = jaxsim.pad_fleet(traces)
    nxts = jaxsim.fleet_annotations(padded, schemes)
    ref = jax.device_get(jaxsim._run_fleet(jcfg, jnp.asarray(padded), jnp.asarray(nxts), True,
                                           {k: jnp.asarray(v) for k, v in pol.items()}))
    assert (np.asarray(ref["reclaimed"]) > 0).all() and np.asarray(ref["overflow"]).sum() == 0
    assert len({len(t) for t in traces}) > 1
    cfg = _port_cfg(jcfg)
    stats = torchsim.ReplayStats()
    st = torchsim.run_fleet(cfg, traces, pol, device="cpu", stats=stats, engine="step")
    _assert_states_equal(convert.state_to_numpy(st), ref)
    assert (torchsim.summarize_fleet(cfg, st, V) == jaxsim.summarize_fleet(jcfg, ref, V))
    assert stats.steps == padded.shape[1] and 0 < stats.gc_ticks <= stats.tick_iterations
    # one host sync per iteration, and one per step that ends its loop
    assert stats.host_syncs == stats.steps + stats.tick_iterations
    tick = torchsim.run_fleet(dataclasses.replace(cfg, gc_engine="tick"), traces, pol,
                              device="cpu", engine="step")
    _assert_states_equal(convert.state_to_numpy(tick), ref)


def test_hetero_fleet_legacy_matches_jax_and_tick():
    """The fleet of the reference's ``test_legacy_gc_engine_matches_tick_bitwise``
    (sepbit, dac, nosep, fk; legacy ungrouped): the port's legacy equals
    JAX's legacy and the port's tick engine, on every key and every row of
    the summaries."""
    n = 96
    jtraces = jmake_fleet("mixed", 4, n, 2 * n, jitter=0.2, seed=41)
    kw = dict(schemes=["sepbit", "dac", "nosep", "fk"],
              selectors=["cost_benefit", "greedy", "cost_benefit", "greedy"],
              gp_thresholds=[0.12, 0.15, 0.20, 0.15])
    jbase = JaxSimConfig(n_lbas=n, segment_size=SEG, gc_engine="legacy")
    r_j, st_j = jfleetshard.simulate_fleet_hetero(
        jtraces, jbase, jfleetshard.encode_policies(4, **kw), group=False, return_state=True)
    traces = make_fleet("mixed", 4, n, 2 * n, jitter=0.2, seed=41)
    policy = fleetshard.encode_policies(4, **kw)
    base = _port_cfg(jbase)
    r_l, st_l = fleetshard.simulate_fleet_hetero(traces, base, policy, group=False,
                                                 return_state=True, device="cpu")
    r_t, st_t = fleetshard.simulate_fleet_hetero(
        traces, dataclasses.replace(base, gc_engine="tick"), policy, return_state=True,
        device="cpu")
    _assert_states_equal(st_l, st_j)
    _assert_states_equal(st_t, st_j)
    assert r_l["volumes"] == r_j["volumes"] == r_t["volumes"]
    assert all(v["reclaimed"] > 0 for v in r_l["volumes"])


def test_legacy_timing_matches_jax():
    """The timing model under the legacy engine at non-unit costs (write 0.7,
    GC block 1.3): each rewrite's debt booked in the rewrite and charged
    after the step, ``lat_*`` equal to JAX's."""
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, gc_engine="legacy", timing=True,
                        write_cost=0.7, gc_block_cost=1.3)
    ref = _jax_single(jcfg, TRACE)
    assert int(ref["gc_writes"]) > 0 and float(ref["lat_charged"]) > 0
    got = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), TRACE, device="cpu"))
    _assert_states_equal(got, ref, volume=0)


@pytest.mark.parametrize("n_segments,seed", [(16, 67), (12, 65)])
def test_exhaustion_corner_legacy_matches_jax(n_segments, seed):
    """Undersized pools where several classes' fresh row is the pad row:
    the reference's exhaustion test (16 segments, seed 67), where the two
    engines end equal, and 12 segments at seed 65, where they differ in
    ``overflow``. The port's legacy equals JAX's legacy, its tick engine
    JAX's tick engine, and the two engines differ in the keys JAX's do."""
    tr = np.asarray(np.random.default_rng(seed).integers(0, 96, size=6 * 96), np.int32)
    got, ref = {}, {}
    for engine in ("legacy", "tick"):
        jcfg = JaxSimConfig(n_lbas=96, segment_size=8, n_segments=n_segments,
                            gp_threshold=0.10, gc_engine=engine)
        ref[engine] = _jax_single(jcfg, tr)
        got[engine] = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), tr, device="cpu"))
        _assert_states_equal(got[engine], ref[engine], volume=0)
        assert int(ref[engine]["overflow"]) > 0
    differ_jax = {k for k in ref["tick"]
                  if not np.array_equal(np.asarray(ref["tick"][k]), np.asarray(ref["legacy"][k]))}
    differ = {k for k in got["tick"] if not np.array_equal(got["tick"][k], got["legacy"][k])}
    assert differ == differ_jax and bool(differ) == (n_segments == 12)


def test_victim_selected_at_entry_on_every_write(monkeypatch):
    """Legacy selects a victim at loop entry on every user write, GC or not,
    and again after each rewrite: selections = steps + iterations. The tick
    engine selects only inside its iterations."""
    calls = []
    select = torchsim._select_victims_fleet
    monkeypatch.setattr(torchsim, "_select_victims_fleet",
                        lambda st: calls.append(1) or select(st))
    traces = make_fleet("mixed", 3, N, 3 * N, jitter=0.0, seed=5)
    for engine in ("legacy", "tick"):
        calls.clear()
        stats = torchsim.ReplayStats()
        cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_engine=engine)
        torchsim.run_fleet(cfg, traces, device="cpu", stats=stats, engine="step")
        assert stats.tick_iterations > 0
        want = stats.steps + stats.tick_iterations if engine == "legacy" else \
            stats.tick_iterations
        assert len(calls) == want, engine


def test_legacy_config_builds_and_keeps_the_greedy_schedule():
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_engine="legacy")
    assert cfg.gc_engine == "legacy"
    for sched in ("rate_limited", "idle_window"):
        with pytest.raises(ValueError, match="tick engine"):
            dataclasses.replace(cfg, gc_sched=sched)
    policy = fleetshard.encode_policies(2, gcscheds=["greedy", "rate_limited"])
    with pytest.raises(ValueError, match="tick engine"):
        fleetshard.simulate_fleet_hetero([TRACE, TRACE], cfg, policy, device="cpu")


def test_replay_kernel_refuses_legacy_before_any_launch():
    """The replay kernel's wrapper refuses the legacy engine before any other
    check (the state here is on the CPU, which it would refuse next) and any
    launch, naming ``engine="step"``; on the CPU ``engine="replay"`` is the
    step engine, which runs legacy."""
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_engine="legacy")
    st = torchsim.own_state(init_state(cfg, device="cpu"))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match='engine="step"'):
        kreplay.replay(cfg, st, torch.from_numpy(TRACE[None]))
    assert sum(ops.launch_counts().values()) == 0
    a = torchsim.run(cfg, TRACE, device="cpu", engine="replay")
    b = torchsim.run(cfg, TRACE, device="cpu", engine="step")
    _assert_states_equal(convert.state_to_numpy(a), convert.state_to_numpy(b))


def test_gcbench_fleet_reproduces_the_committed_bench():
    """The JAX package's gcbench (``benchmarks/run.py`` ``gcbench``: 16
    volumes of 256 blocks, segment 32, sepbit, cost-benefit, GC thresholds
    cycling 0.08 / 0.12 / 0.16 / 0.22, the mixed fleet at 4 * n updates,
    jitter 0.25, seed 23) through the port: legacy ungrouped and tick
    grouped, each reproducing ``BENCH_fleet_gc.json``'s per-volume reclaimed
    counts, WA and GC writes, and equal to each other on every key."""
    bench = json.loads((ROOT / "BENCH_fleet_gc.json").read_text())
    V, n = bench["n_volumes"], bench["n_lbas"]
    traces = make_fleet(bench["workload"], V, n, 4 * n, jitter=0.25, seed=23)
    policy = fleetshard.encode_policies(V, schemes=bench["scheme"],
                                        selectors=bench["selector"],
                                        gp_thresholds=bench["gp_thresholds"])
    base = TorchSimConfig(n_lbas=n, segment_size=bench["segment_size"])
    states = {}
    for engine, group in (("legacy", False), ("tick", True)):
        res, states[engine] = fleetshard.simulate_fleet_hetero(
            traces, dataclasses.replace(base, gc_engine=engine), policy, group=group,
            return_state=True, device="cpu")
        vols = res["volumes"]
        assert [v["reclaimed"] for v in vols] == bench["gc"]["per_volume_reclaimed"]
        assert sum(v["reclaimed"] for v in vols) == bench["gc"]["total_reclaimed"] == 2313
        for v, want in zip(vols, bench["per_volume"]):
            assert (v["wa"], v["gc_writes"], v["reclaimed"], v["gp_threshold"]) == (
                want["wa"], want["gc_writes"], want["reclaimed"],
                float(np.float32(want["gp"]))), engine
    _assert_states_equal(states["legacy"], states["tick"])
