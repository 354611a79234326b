"""GC operations of k victims and SepBIT's FIFO-occupancy samples (the
paper's Exp#2 and Exp#5) held against the JAX package's numpy per-block
simulator (`core.simulator.simulate`), the only reference that has them.

The port is not bit-equal to the numpy loop at any k: argmax ties fall in
another order (``np.argsort(-scores)`` against the row order) and ℓ is
float64 there, float32 here, so it is held within `test_differential`'s
bands, as the fleet engine is at k = 1. Exp#2 and Exp#5 run cost-benefit
selection, and so do these fleets. Each fleet runs once per k on the CPU
step engine, all its volumes in one replay.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jaxsim
from repro.core.jaxsim import JaxSimConfig
from repro.core.simulator import simulate
from repro.core.tracegen import make_fleet
from repro_torch import convert
from repro_torch.core import torchsim
from repro_torch.core.config import (
    FIFO_KEYS,
    SCHEME_CLASSES,
    SCHEME_IDS,
    TorchSimConfig,
    default_policy,
    init_state,
    state_spec,
)
from repro_torch.core.inplace import Consts
from repro_torch.kernels import ref
from repro_torch.kernels import replay as treplay

N, WRITES, SEG = 256, 2500, 16
EXP2 = ("nosep", "sepgc", "warcip", "sepbit", "fk")
STATEFUL = ("warcip", "fk")
FIFO = ("sepbit", "uw")
SCHEMES = EXP2 + ("uw", "gw")        # gw keeps ℓ but takes no FIFO sample
TRACES = 2
# the bands: test_differential's for WA (cost-benefit 0.03, a stateful
# scheme 0.10); the FIFO peak within 5 % of numpy's, the last sample within
# 5 % of the working set (the memory reduction 1 - last / wss within 5
# points). ℓ here is one write above numpy's at every refresh (the JAX
# engine's segment creation time), so the peak runs about one LBA above
WA_TOL, WA_TOL_STATEFUL = 0.03, 0.10
PEAK_TOL, LAST_TOL = 0.05, 0.05


def _cells():
    return [(s, i) for s in SCHEMES for i in range(TRACES)]


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def exp2(request):
    """One fleet per k: every scheme on each trace, fifo_occupancy on, and
    numpy's ``simulate(..., gc_batch_segments=k)`` of each volume."""
    k = request.param
    traces = make_fleet("mixed", TRACES, N, WRITES, seed=1)
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, gc_batch_segments=k,
                         fifo_occupancy=True)
    cells = _cells()
    sch = np.asarray([SCHEME_IDS[s] for s, _ in cells], np.int32)
    pol = {key: np.full(len(cells), v) for key, v in default_policy(cfg).items()}
    pol["p_scheme"] = sch
    pol["p_classes"] = np.asarray(SCHEME_CLASSES, np.int32)[sch]
    res = torchsim.simulate_fleet([traces[i] for _, i in cells], cfg, pol, device="cpu")
    want = {cell: simulate(np.asarray(traces[cell[1]]), cell[0], n_lbas=N, segment_size=SEG,
                           gc_batch_segments=k, selector="cost_benefit")
            for cell in cells}
    return {cell: (res["volumes"][j], want[cell]) for j, cell in enumerate(cells)}


@pytest.mark.parametrize("trace", range(TRACES))
@pytest.mark.parametrize("scheme", EXP2)
def test_k_victim_operations_track_numpy(exp2, scheme, trace):
    """Exp#2's five schemes at k = 2 and 4: WA within the band of numpy's,
    the same user writes and working set."""
    got, want = exp2[(scheme, trace)]
    assert got["reclaimed"] > 0
    tol = WA_TOL_STATEFUL if scheme in STATEFUL else WA_TOL
    assert got["wa"] == pytest.approx(want.wa, rel=tol)
    assert got["user_writes"] == want.user_writes
    assert got["wss_unique_lbas"] == want.wss_unique_lbas
    assert got["overflow"] == 0


@pytest.mark.parametrize("trace", range(TRACES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fifo_samples_track_numpy(exp2, scheme, trace):
    """sepbit's and uw's FIFO-occupancy peak and last sample within their
    bands of numpy's; every other scheme, gw included, takes none (None in
    both)."""
    got, want = exp2[(scheme, trace)]
    if scheme not in FIFO:
        assert want.fifo_occupancy_peak is None and want.fifo_occupancy_last is None
        assert got["fifo_occupancy_peak"] is None and got["fifo_occupancy_last"] is None
        return
    wss = want.wss_unique_lbas
    assert got["fifo_occupancy_peak"] == pytest.approx(want.fifo_occupancy_peak, rel=PEAK_TOL)
    assert abs(got["fifo_occupancy_last"] - want.fifo_occupancy_last) <= LAST_TOL * wss
    assert 0 <= got["fifo_occupancy_last"] <= got["fifo_occupancy_peak"] <= wss


def test_no_refresh_gives_no_sample():
    """A trace whose GC reclaims too few Class-1 segments for an ℓ
    refresh: no sample, None in both."""
    tr = np.asarray(make_fleet("mixed", 1, N, 1000, seed=2)[0][:350])
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_batch_segments=2, fifo_occupancy=True)
    got = torchsim.simulate(tr, cfg, device="cpu")
    want = simulate(tr, "sepbit", n_lbas=N, segment_size=SEG, gc_batch_segments=2)
    assert got["ell"] == float("inf") and got["reclaimed"] == want.segments_reclaimed > 0
    assert got["fifo_occupancy_peak"] is got["fifo_occupancy_last"] is None
    assert want.fifo_occupancy_peak is want.fifo_occupancy_last is None
    assert got["wss_unique_lbas"] == want.wss_unique_lbas


@pytest.mark.parametrize("selector", ["cost_benefit", "greedy"])
def test_operation_victims_are_the_top_k_rows_at_its_start(selector):
    """One GC operation of k = 4 on mid-trace states of a mixed fleet: its
    victims, in order, are the eligible rows of highest score at the
    operation's start (ties to the lower row), as numpy's ``GCPolicy.select``
    ranks them, fewer where fewer rows are eligible. Greedy scores a row
    that a rewrite seals with garbage in it above others; it waits for the
    next operation."""
    k = 4
    schemes = ("nosep", "sepgc", "sepbit", "warcip", "uw", "gw")
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, selector=selector,
                         gc_batch_segments=k)
    sch = np.asarray([SCHEME_IDS[s] for s in schemes], np.int32)
    pol = {key: np.full(len(sch), v) for key, v in default_policy(cfg).items()}
    pol["p_scheme"] = sch
    pol["p_classes"] = np.asarray(SCHEME_CLASSES, np.int32)[sch]
    traces = torchsim.coerce_fleet(make_fleet("mixed", len(sch), N, 1200, seed=7))
    st = torchsim.run_fleet(cfg, traces[:, :500], pol, device="cpu", engine="step")
    one_op = dataclasses.replace(cfg, max_gc_per_step=1)
    checked = 0
    for begin, end in ((500, 800), (800, 1000), (1000, 1200)):
        st = torchsim.run_fleet(cfg, traces[:, begin:end], device="cpu", state=st,
                                engine="step")
        scores = ref._scores(st["seg_n"], st["seg_nvalid"], st["seg_stime"], st["seg_state"],
                             st["t"][:, None], st["p_selector"][:, None])
        want = []
        for row in scores:
            order = torch.sort(-row, stable=True).indices[:k]
            want.append([int(i) for i in order if torch.isfinite(row[i])])
        op = torchsim.own_state(st)
        op["p_gp"].zero_()               # every volume with garbage triggers
        taken = []

        def select(s):
            v = torchsim._select_victims_fleet(s)
            taken.append(v.clone())
            return v

        torchsim.fleet_gc_tick(one_op, op, Consts(one_op, len(sch), "cpu", op["p_scheme"],
                                                  op["p_gcsched"]), select=select)
        assert len(taken) == k
        for v in range(len(sch)):
            got = [int(r[v]) for r in taken]
            got = got[:got.index(-1)] if -1 in got else got
            assert got == want[v], (end, schemes[v])
            checked += len(got)
        assert (op["reclaimed"] - st["reclaimed"]).tolist() == [len(w) for w in want]
    assert checked > 3 * len(sch)


@pytest.mark.parametrize("scheme", ["sepbit", "fk"])
def test_fleet_of_one_equals_a_single_volume_at_k4(scheme):
    """At k = 4 a fleet of one (the batched victim argmax) equals the
    single-volume run (the single-volume argmax) on every key, fifo_*
    included."""
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, scheme=scheme, gc_batch_segments=4,
                         fifo_occupancy=True)
    tr = np.asarray(make_fleet("mixed", 1, N, 800, seed=3)[0][:800])
    fleet = convert.state_to_numpy(torchsim.run_fleet(cfg, [tr], device="cpu"))
    single = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert set(fleet) == set(single) and int(single["reclaimed"][0]) > 0
    for key in single:
        np.testing.assert_array_equal(fleet[key], single[key], err_msg=key)


@pytest.mark.parametrize("kw", [
    {"gc_batch_segments": 0},
    {"gc_batch_segments": 2, "gc_engine": "legacy"},
    {"gc_batch_segments": 2, "timing": True},
    {"gc_batch_segments": 2, "gc_sched": "rate_limited"},
    {"gc_batch_segments": 4, "gc_sched": "idle_window"},
    {"fifo_occupancy": True, "gc_engine": "legacy"},
    {"fifo_occupancy": True, "timing": True},
    {"fifo_occupancy": True, "gc_sched": "idle_window"},
], ids=["k0", "legacy", "timing", "rate_limited", "idle_window", "fifo_legacy", "fifo_timing",
        "fifo_idle_window"])
def test_config_refuses_what_no_reference_path_runs(kw):
    with pytest.raises(ValueError, match="gc_batch_segments"):
        TorchSimConfig(n_lbas=N, **kw)


@pytest.mark.parametrize("kw", [{"gc_batch_segments": 2}, {"fifo_occupancy": True}],
                         ids=["k2", "fifo"])
def test_refused_beside_a_per_volume_gc_schedule(kw):
    """A policy's own GC schedule other than greedy is refused at k > 1 and
    with the FIFO samples by `init_state` and by the kernel's `check_inputs`
    (before any device check)."""
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, **kw)
    pol = {key: np.full(3, v) for key, v in default_policy(cfg).items()}
    pol["p_gcsched"] = np.asarray([0, 2, 0], np.int32)
    with pytest.raises(ValueError, match="gc_batch_segments"):
        init_state(cfg, pol, "cpu")
    one = TorchSimConfig(n_lbas=N, segment_size=SEG)
    st = init_state(one, pol, "cpu")
    if cfg.fifo_occupancy:
        st.update({key: torch.full((3,), -1, dtype=torch.int32) for key in FIFO_KEYS})
    with pytest.raises(ValueError, match="gc_batch_segments"):
        treplay.check_inputs(cfg, st, torch.zeros((3, 4), dtype=torch.int32))


def test_legacy_loop_refuses_k_victims():
    """The legacy GC loop takes one victim an operation, whatever config
    reaches it."""
    legacy = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_engine="legacy")
    st = torchsim.own_state(init_state(legacy, None, "cpu"))
    object.__setattr__(legacy, "gc_batch_segments", 2)
    with pytest.raises(ValueError, match="one victim"):
        torchsim.legacy_gc(legacy, st, Consts(legacy, 1, "cpu"))


def test_defaults_keep_the_jax_state():
    """gc_batch_segments=1 and fifo_occupancy=False (the defaults, given
    explicitly): the state's key set is JAX's and every value after a
    replay equals JAX's."""
    jcfg = JaxSimConfig(n_lbas=128, segment_size=8)
    cfg = dataclasses.replace(convert.config_from_jax(dataclasses.asdict(jcfg)),
                              gc_batch_segments=1, fifo_occupancy=False)
    assert cfg == TorchSimConfig(n_lbas=128, segment_size=8)
    tr = np.asarray(make_fleet("mixed", 1, 128, 384, seed=4)[0], np.int32)
    ref_st = jax.device_get(jaxsim._run(jcfg, jnp.asarray(tr)))
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert set(got) == set(ref_st) == set(state_spec(cfg))
    assert int(ref_st["reclaimed"]) > 0
    for key, want in ref_st.items():
        np.testing.assert_array_equal(got[key][0], np.asarray(want), err_msg=key)
    assert torchsim._summary(cfg, {k: v[0] for k, v in got.items()}) == jaxsim._summary(jcfg,
                                                                                       ref_st)


def test_fifo_samples_change_no_other_key():
    """fifo_occupancy adds fifo_peak and fifo_last and changes no other
    key; fifo_last never exceeds fifo_peak."""
    tr = np.asarray(make_fleet("mixed", 1, N, 1000, seed=5)[0][:1000])
    off = TorchSimConfig(n_lbas=N, segment_size=SEG, gc_batch_segments=2)
    on = dataclasses.replace(off, fifo_occupancy=True)
    a = convert.state_to_numpy(torchsim.run(off, tr, device="cpu"))
    b = convert.state_to_numpy(torchsim.run(on, tr, device="cpu"))
    assert set(b) - set(a) == {"fifo_peak", "fifo_last"} and set(a) <= set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert 0 <= int(b["fifo_last"][0]) <= int(b["fifo_peak"][0]) <= N
