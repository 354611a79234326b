"""The port's replay engine held bit for bit against the JAX package's tick
engine on the CPU: single volumes, heterogeneous fleets, a fleet of one, a
replay carried across from JAX mid-trace, and free-pool exhaustion."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jaxsim
from repro.core.jaxsim import JaxSimConfig
from repro.core.traces import hotcold_trace, zipf_trace
from repro.core.tracegen import make_fleet
from repro_torch import convert
from repro_torch.core import torchsim
from repro_torch.core.config import TorchSimConfig, init_state
from repro_torch.kernels import ops
from repro_torch.kernels import replay as treplay

N, SEG = 128, 8
ELEMENTWISE = ["nosep", "sepgc", "sepbit", "uw", "gw"]
SELECTORS = ["greedy", "cost_benefit"]
TRACES = {   # same length, so each JAX config compiles once for both
    "zipf": np.asarray(zipf_trace(N, 3 * N, alpha=1.1, seed=3), np.int32),
    "hotcold": np.asarray(hotcold_trace(N, 3 * N, seed=4), np.int32),
}


def _port_cfg(jcfg: JaxSimConfig) -> TorchSimConfig:
    return convert.config_from_jax(dataclasses.asdict(jcfg))


def _assert_states_equal(got: dict, want: dict, volume=None):
    """Every key, the stateful schemes' ``sch_*`` included, equal in shape,
    dtype and value; ``got`` keeps the port's leading volume axis, whose row
    ``volume`` (all rows when None) is compared."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key, ref in want.items():
        mine = got[key] if volume is None else got[key][volume]
        assert mine.dtype == ref.dtype, key
        np.testing.assert_array_equal(mine, ref, err_msg=f"state[{key}]")


@pytest.mark.parametrize("trace", list(TRACES))
@pytest.mark.parametrize("selector", SELECTORS)
@pytest.mark.parametrize("scheme", ELEMENTWISE)
def test_single_volume_matches_jax(scheme, selector, trace):
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, scheme=scheme, selector=selector)
    tr = TRACES[trace]
    ref = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr)))
    got = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), tr, device="cpu"))
    assert int(ref["reclaimed"]) > 0 and int(ref["overflow"]) == 0
    _assert_states_equal(got, ref, volume=0)
    assert (torchsim._summary(_port_cfg(jcfg), {k: v[0] for k, v in got.items()})
            == jaxsim._summary(jcfg, ref))


@pytest.fixture(scope="module")
def hetero_fleet():
    """Unequal-length traces (masked pad steps), per-volume GC thresholds and
    selectors, SepBIT with cost-benefit among them and every other
    elementwise scheme beside it; the pool is sized from the largest
    threshold, as fleetshard.hetero_config does."""
    V = 8
    traces = make_fleet("mixed", V, N, 3 * N, jitter=0.3, seed=17)
    gps = np.asarray([0.08, 0.12, 0.16, 0.22, 0.12, 0.15, 0.2, 0.1], np.float32)
    schemes = np.asarray([2, 2, 2, 2, 0, 1, 7, 8], np.int32)
    pol = {"p_scheme": schemes, "p_selector": np.asarray([1, 0, 1, 1, 0, 1, 0, 1], np.int32),
           "p_gp": gps, "p_ncw": np.asarray([16, 8, 16, 24, 16, 16, 8, 16], np.int32),
           "p_classes": np.asarray([jaxsim.SCHEME_CLASSES[s] for s in schemes], np.int32),
           "p_gcsched": np.zeros(V, np.int32)}
    base = JaxSimConfig(n_lbas=N, segment_size=SEG, class_slots=6)
    jcfg = dataclasses.replace(
        base, n_segments=dataclasses.replace(base, gp_threshold=float(gps.max())).s_max)
    padded = jaxsim.pad_fleet(traces)
    ref = jax.device_get(jaxsim._run_fleet(
        jcfg, jnp.asarray(padded), jnp.full(padded.shape, jaxsim.NOBIT, jnp.int32), True,
        {k: jnp.asarray(v) for k, v in pol.items()}))
    return jcfg, traces, pol, ref


@pytest.mark.parametrize("engine", ["replay", "step"])
def test_hetero_fleet_matches_jax(hetero_fleet, engine, monkeypatch):
    """Both engines equal JAX. On the CPU ``engine="replay"`` runs the
    replay kernel's plain version, the step engine, so the two cases are the
    same replay: the replay case asserts that it went through `step_replay`
    and launched no kernel."""
    jcfg, traces, pol, ref = hetero_fleet
    assert (np.asarray(ref["reclaimed"]) > 0).all()
    assert len({len(t) for t in traces}) > 1
    ran = []
    step = torchsim.step_replay
    monkeypatch.setattr(torchsim, "step_replay", lambda *a, **kw: ran.append(1) or step(*a, **kw))
    ops.reset_launch_counts()
    stats = torchsim.ReplayStats()
    st = torchsim.run_fleet(_port_cfg(jcfg), traces, pol, device="cpu", stats=stats,
                            engine=engine)
    assert ran == [1] and ops.launch_counts()["replay"] == 0
    _assert_states_equal(convert.state_to_numpy(st), ref)
    assert stats.steps == max(len(t) for t in traces)
    assert 0 < stats.gc_ticks <= stats.tick_iterations
    want = jaxsim.summarize_fleet(jcfg, ref, len(traces))
    assert torchsim.summarize_fleet(_port_cfg(jcfg), st, len(traces)) == want


def test_fleet_of_one_matches_single_volume(hetero_fleet):
    jcfg, traces, pol, _ = hetero_fleet
    cfg = _port_cfg(jcfg)
    one = {k: v[:1] for k, v in pol.items()}
    fleet = convert.state_to_numpy(torchsim.run_fleet(cfg, traces[:1], one, device="cpu"))
    single = convert.state_to_numpy(torchsim.run(cfg, traces[0], one, device="cpu"))
    for key in single:
        np.testing.assert_array_equal(fleet[key], single[key], err_msg=key)
    res = torchsim.simulate_fleet(traces[:1], cfg, one, device="cpu")
    assert res["volumes"][0] == torchsim.simulate(traces[0], cfg, one, device="cpu")


def test_replay_carried_across_from_jax_mid_trace():
    """JAX replays the first half; its state, carried into the port, and the
    JAX state run on through the second half end bit-equal."""
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, selector="greedy")
    tr = TRACES["zipf"]
    half = len(tr) // 2
    mid = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr[:half])))
    assert int(mid["reclaimed"]) > 0

    def step(st, lba):
        return jaxsim._user_step(jcfg, st, lba, jnp.int32(jaxsim.NOBIT)), None

    ref, _ = jax.lax.scan(step, jax.tree_util.tree_map(jnp.asarray, mid),
                          jnp.asarray(tr[half:]))
    got = torchsim.run(_port_cfg(jcfg), tr[half:], device="cpu",
                       state=convert.state_from_numpy(mid, "cpu"))
    _assert_states_equal(convert.state_to_numpy(got), jax.device_get(ref), volume=0)


def test_fleet_carried_across_from_jax_mid_trace(hetero_fleet):
    jcfg, traces, pol, ref = hetero_fleet
    padded = jaxsim.pad_fleet(traces)
    half = padded.shape[1] // 2
    nx = jnp.full(padded.shape, jaxsim.NOBIT, jnp.int32)
    mid = jax.device_get(jaxsim._run_fleet(jcfg, jnp.asarray(padded[:, :half]), nx[:, :half],
                                           True, {k: jnp.asarray(v) for k, v in pol.items()}))
    got = torchsim.run_fleet(_port_cfg(jcfg), padded[:, half:], device="cpu",
                             state=convert.state_from_numpy(mid, "cpu"))
    _assert_states_equal(convert.state_to_numpy(got), ref)


def _exhaustion_trace():
    rng = np.random.default_rng(67)
    return np.asarray(rng.integers(0, 96, size=6 * 96), np.int32)


def test_exhaustion_corner_matches_jax_and_keeps_its_envelope():
    """The undersized pool of the JAX package's exhaustion test: several
    classes alias the pad row, so scatters meet duplicate targets. On the
    CPU the port still equals JAX bit for bit, and the envelope holds."""
    jcfg = JaxSimConfig(n_lbas=96, segment_size=8, n_segments=16, gp_threshold=0.10)
    tr = _exhaustion_trace()
    ref = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr)))
    cfg = _port_cfg(jcfg)
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    _assert_states_equal(got, ref, volume=0)
    st = {k: v[0] for k, v in got.items()}
    assert int(st["overflow"]) > 0
    live = (st["loc_seg"] >= 0) & (st["loc_seg"] < cfg.pad_row)
    lbas = np.nonzero(live)[0]
    assert live.any()
    assert (st["seg_lba"][st["loc_seg"][lbas], st["loc_off"][lbas]] == lbas).all()
    assert st["seg_valid"][st["loc_seg"][lbas], st["loc_off"][lbas]].all()
    assert (st["seg_n"] <= cfg.segment_size).all()
    assert int(st["seg_state"][cfg.pad_row]) != 0
    assert torchsim._summary(cfg, st)["degraded"] is True


@pytest.mark.parametrize("change,item", [
    (dict(timing=True), "item 6"),
    (dict(gc_sched="rate_limited"), "item 6"),
    (dict(gc_engine="legacy"), "item 7"),
    (dict(scheme_group=("sepbit",)), "item 5"),
    (dict(scheme="fk"), "item 4b"),
    (dict(scheme="warcip"), "item 4b"),
])
def test_unported_config_values_raise(change, item):
    """The knobs of items 5 and 6 (timing, GC schedules, scheme groups) make
    a config that replays equal to JAX; the legacy engine (item 7) makes a
    config, and the replay kernel refuses it before any launch, naming
    ``engine="step"``, where it runs; the stateful schemes (item 4b) make a
    config the replay kernel's checks take, scheme and next-write stream
    alike, refusing only the well-formed state on the CPU, last."""
    if item == "item 7":
        cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, **change)
        st = torchsim.own_state(init_state(cfg, device="cpu"))
        with pytest.raises(ValueError, match='engine="step"'):
            treplay.check_inputs(cfg, st, torch.from_numpy(TRACES["zipf"][None]))
        return
    if item in ("item 5", "item 6"):
        jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, **change)
        tr = TRACES["hotcold"]
        ref = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr), jaxsim.default_policy(jcfg)))
        got = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), tr, device="cpu"))
        assert int(ref["reclaimed"]) > 0
        _assert_states_equal(got, ref, volume=0)
        return
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, **change)
    st = torchsim.own_state(init_state(cfg, device="cpu"))
    trace = torch.from_numpy(TRACES["zipf"][None])
    with pytest.raises(ValueError, match="CUDA"):
        treplay.check_inputs(cfg, st, trace, torchsim._next_writes(st, trace))


@pytest.mark.parametrize("engine", ["kernel", "Step", ""])
def test_unknown_engines_raise(engine):
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG)
    with pytest.raises(ValueError, match="engine"):
        torchsim.run(cfg, TRACES["zipf"], device="cpu", engine=engine)
    with pytest.raises(ValueError, match="engine"):
        torchsim.run_fleet(cfg, [TRACES["zipf"]], device="cpu", engine=engine)


def test_unported_policies_raise():
    """A fleet with a stateful scheme beside an elementwise one builds its
    state; per-volume GC schedules (item 6) replay equal to JAX; an unknown
    schedule id and a scheme outside the config's group raise."""
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6)
    pol = {"p_scheme": [2, 4], "p_selector": [0, 0], "p_gp": [0.1, 0.1], "p_ncw": [16, 16],
           "p_classes": [6, 6], "p_gcsched": [0, 0]}
    st = init_state(cfg, pol, device="cpu")       # dac runs: its slice is in the state
    assert st["sch_dac_region"].shape == (2, N) and not st["sch_dac_region"].any()
    sched = dict(pol, p_scheme=[2, 2], p_classes=[6, 6], p_gcsched=[0, 2])
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, class_slots=6)
    traces = np.stack([TRACES["zipf"], TRACES["hotcold"]])
    ref = jax.device_get(jaxsim._run_fleet(
        jcfg, jnp.asarray(traces), jnp.full(traces.shape, jaxsim.NOBIT, jnp.int32), False,
        {k: jnp.asarray(np.asarray(v, np.float32 if k == "p_gp" else np.int32))
         for k, v in sched.items()}))
    got = torchsim.run_fleet(_port_cfg(jcfg), traces, sched, device="cpu")
    _assert_states_equal(convert.state_to_numpy(got), ref)
    with pytest.raises(ValueError, match="GC scheduling"):
        init_state(cfg, dict(sched, p_gcsched=[0, 3]), device="cpu")
    grouped = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, scheme_group=("dac",))
    with pytest.raises(ValueError, match="dispatch group"):
        init_state(grouped, pol, device="cpu")
