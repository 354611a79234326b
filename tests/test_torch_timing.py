"""The port's timing model and GC schedules held against the JAX package on
the CPU: the nine tests of ``tests/test_timing.py`` on the port, each state
bit-equal to JAX's on every key (``lat_*`` included), every schedule under
both selectors, and non-unit costs whose latencies fall between the
histogram's bucket edges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import jaxsim
from repro.core.fleetshard import encode_policies as jax_encode_policies
from repro.core.fleetshard import simulate_fleet_hetero as jax_simulate_fleet_hetero
from repro.core.jaxsim import JaxSimConfig
from repro_torch import convert
from repro_torch.core import torchsim
from repro_torch.core.config import (
    GCSCHED_IDS,
    LAT_BUCKETS_PER_OCTAVE,
    TorchSimConfig,
    default_policy,
    init_state,
    state_spec,
)
from repro_torch.core.fleetshard import (
    encode_policies,
    matching_single_config,
    simulate_fleet_hetero,
)

N, SEG = 96, 8
JBASE = JaxSimConfig(n_lbas=N, segment_size=SEG, timing=True)
BASE = TorchSimConfig(n_lbas=N, segment_size=SEG, timing=True)


def _trace(size, seed=0, n=N):
    return np.asarray(np.random.default_rng(seed).integers(0, n, size=size), np.int32)


def _port_cfg(jcfg: JaxSimConfig) -> TorchSimConfig:
    return convert.config_from_jax(dataclasses.asdict(jcfg))


def _final(jcfg: JaxSimConfig, tr) -> dict:
    """The port's final state of one volume (numpy, no volume axis), held
    bit-equal to JAX's on every key first."""
    ref = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr), jaxsim.default_policy(jcfg)))
    got = convert.state_to_numpy(torchsim.run(_port_cfg(jcfg), tr, device="cpu"))
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = np.asarray(want)
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key][0], want, err_msg=f"state[{key}]")
    return {k: v[0] for k, v in got.items()}


def test_latency_accounting_conserves_charged_time():
    """lat_charged + lat_debt == gc_writes * gc_block_cost, the histogram
    counts every user write, and the clock equals the latency sum."""
    jcfg = dataclasses.replace(JBASE, gc_block_cost=2.0)
    st = _final(jcfg, _trace(6 * N, seed=1))
    assert int(st["gc_writes"]) > 0
    assert float(st["lat_charged"]) + float(st["lat_debt"]) \
        == pytest.approx(int(st["gc_writes"]) * jcfg.gc_block_cost)
    assert int(st["lat_hist"].sum()) == int(st["user_writes"])
    assert float(st["lat_now"]) == float(st["lat_sum"])
    assert float(st["lat_sum"]) >= int(st["user_writes"]) * jcfg.write_cost


def test_zero_gc_trace_p99_equals_service_time():
    jcfg = dataclasses.replace(JBASE, write_cost=3.0)
    st = _final(jcfg, np.arange(N, dtype=np.int32))
    assert int(st["gc_writes"]) == 0
    lat = torchsim._summary(_port_cfg(jcfg), st)["latency"]
    assert lat["p50"] == lat["p99"] == lat["max"] == jcfg.write_cost
    assert lat["mean"] == pytest.approx(jcfg.write_cost)


def test_rate_limited_caps_per_write_wait():
    """rate_limited bounds a write's wait behind GC at the per-step charge
    cap, while greedy's maximum on the same trace exceeds it."""
    tr = _trace(6 * N, seed=2)
    jrl = dataclasses.replace(JBASE, gc_sched="rate_limited", gc_rate=2)
    st_g, st_r = _final(JBASE, tr), _final(jrl, tr)
    cap = jrl.write_cost + jrl.gc_rate * jrl.gc_block_cost
    assert float(st_r["lat_max"]) <= cap < float(st_g["lat_max"])
    g = torchsim._summary(BASE, st_g)["latency"]
    r = torchsim._summary(_port_cfg(jrl), st_r)["latency"]
    assert r["p99"] < g["p99"]
    assert int(st_r["gc_writes"]) == int(st_g["gc_writes"])


def test_idle_window_watermark_prevents_exhaustion():
    """On an all-write trace idle_window defers every GC but the watermark's:
    with the watermark the pool never exhausts; with it off (gc_watermark 0)
    the same config overflows."""
    tr = _trace(8 * N, seed=3)
    jcfg = dataclasses.replace(JBASE, n_segments=24, gp_threshold=0.10, gc_sched="idle_window")
    st = _final(jcfg, tr)
    assert int(st["overflow"]) == 0 and int(st["reclaimed"]) > 0
    st_off = _final(dataclasses.replace(jcfg, gc_watermark=0), tr)
    assert int(st_off["overflow"]) > 0
    greedy = _final(dataclasses.replace(jcfg, gc_sched="greedy"), tr)
    assert int(st["gc_writes"]) < int(greedy["gc_writes"])


def test_fleet_timing_matches_single_bitwise():
    """A fleet of unequal lengths (pad steps, the masked charge) under the
    three schedules equals each volume's single run, lat_* included, and
    JAX's hetero replay on every key."""
    lengths = (5 * N, 4 * N, 3 * N)
    traces = [_trace(sz, seed=10 + i) for i, sz in enumerate(lengths)]
    scheds = ["greedy", "rate_limited", "idle_window"]
    pol = encode_policies(3, schemes="sepbit", gcscheds=scheds)
    _, st = simulate_fleet_hetero(traces, BASE, pol, return_state=True, device="cpu")
    _, ref = jax_simulate_fleet_hetero(traces, JBASE, jax_encode_policies(
        3, schemes="sepbit", gcscheds=scheds), shard=False, return_state=True)
    for key, want in ref.items():
        np.testing.assert_array_equal(st[key], np.asarray(want), err_msg=key)
    per_class = {"open_sid", "class_user", "class_gc"}
    for i in range(3):
        cfg_i = matching_single_config(BASE, pol, i)
        assert cfg_i.gc_sched == pol.gcsched(i)
        si = convert.state_to_numpy(torchsim.run(cfg_i, traces[i], device="cpu"))
        for k, b in si.items():
            if k.startswith("p_"):
                continue
            a = st[k][i]
            if k in per_class:      # the fleet pads the class axis
                a = a[: cfg_i.n_classes]
            np.testing.assert_array_equal(a, b[0], err_msg=f"volume {i} state[{k}]")


def test_summary_latency_fields():
    tr = _trace(4 * N, seed=4)
    r = torchsim.simulate(tr, BASE, device="cpu")
    assert r == jaxsim.simulate_jax(tr, JBASE)
    assert r["gcsched"] == "greedy"
    lat = r["latency"]
    assert set(lat) >= {"p50", "p99", "max", "mean", "total", "gc_time_charged", "gc_debt",
                        "hist"}
    assert lat["p50"] <= lat["p99"] <= lat["max"]
    r_off = torchsim.simulate(tr, TorchSimConfig(n_lbas=N, segment_size=SEG), device="cpu")
    assert "latency" not in r_off
    assert r_off["overflow"] == 0 and r_off["degraded"] is False


def test_hist_quantile_lower_edge_semantics():
    hist = np.zeros(64, np.int64)
    hist[0] = 99
    hist[8] = 1
    assert torchsim.hist_quantile(hist, 0.50, 2.0) == 2.0
    assert torchsim.hist_quantile(hist, 0.99, 2.0) == 2.0
    assert torchsim.hist_quantile(hist, 1.00, 2.0) == 2.0 * 2.0 ** (8 / 4)
    assert torchsim.hist_quantile(np.zeros(4), 0.5) == 0.0
    for q in (0.0, 0.5, 0.99, 1.0):
        assert torchsim.hist_quantile(hist, q, 3.0) == jaxsim.hist_quantile(hist, q, 3.0)
    assert LAT_BUCKETS_PER_OCTAVE == jaxsim.LAT_BUCKETS_PER_OCTAVE


def test_state_spec_covers_lat_keys():
    spec = state_spec(BASE)
    lat = {k: v for k, v in spec.items() if k.startswith("lat_")}
    assert set(lat) == {"lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_dens",
                        "lat_sum", "lat_max", "lat_hist"}
    assert spec["lat_hist"][0] == (BASE.lat_buckets,)
    assert set(spec) == set(state_spec(dataclasses.replace(BASE, timing=False)))
    assert set(spec) == set(jaxsim.state_spec(JBASE))


def test_gcsched_validation():
    with pytest.raises(ValueError, match="gc_sched"):
        dataclasses.replace(BASE, gc_sched="nope")
    with pytest.raises(ValueError, match="tick engine"):
        dataclasses.replace(BASE, gc_engine="legacy", gc_sched="idle_window")
    assert dataclasses.replace(BASE, gc_engine="legacy").gc_engine == "legacy"
    with pytest.raises(ValueError, match="GC scheduling"):
        init_state(BASE, dict(default_policy(BASE), p_gcsched=5), device="cpu")
    assert GCSCHED_IDS == jaxsim.GCSCHED_IDS and GCSCHED_IDS["greedy"] == 0


# -- every schedule against JAX, and costs off the bucket edges -----------------

@pytest.mark.parametrize("selector", ["greedy", "cost_benefit"])
@pytest.mark.parametrize("sched", ["greedy", "rate_limited", "idle_window"])
def test_every_schedule_matches_jax(sched, selector):
    jcfg = dataclasses.replace(JBASE, gc_sched=sched, selector=selector, gc_rate=3)
    st = _final(jcfg, _trace(6 * N, seed=7))
    assert int(st["reclaimed"]) > 0


@pytest.mark.parametrize("sched", ["greedy", "rate_limited", "idle_window"])
def test_non_unit_costs_match_jax(sched):
    """write_cost 0.7 and gc_block_cost 1.3: latencies are no multiples of
    the write cost, so the histogram's log2 and the debt's float32 sums are
    held to JAX's; the histogram fills buckets other than the integer
    ratios'."""
    jcfg = dataclasses.replace(JBASE, gc_sched=sched, write_cost=0.7, gc_block_cost=1.3,
                               idle_density=0.4)
    st = _final(jcfg, _trace(6 * N, seed=8))
    assert int(st["gc_writes"]) > 0
    assert np.count_nonzero(st["lat_hist"]) > 1 or sched == "idle_window"


def test_timing_off_keeps_lat_keys_and_idle_window_still_defers():
    """With timing off the lat_* keys stay at their initial values (all
    but the density EWMA), and idle_window's deferral still applies, as in
    JAX: fewer GC writes than greedy."""
    jcfg = JaxSimConfig(n_lbas=N, segment_size=SEG, n_segments=24, gp_threshold=0.10,
                        gc_sched="idle_window")
    tr = _trace(8 * N, seed=3)
    st = _final(jcfg, tr)
    for key in ("lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_sum", "lat_max"):
        assert float(st[key]) == 0.0, key
    assert not st["lat_hist"].any() and float(st["lat_dens"]) > 0.5
    greedy = _final(dataclasses.replace(jcfg, gc_sched="greedy"), tr)
    assert int(st["gc_writes"]) < int(greedy["gc_writes"])
