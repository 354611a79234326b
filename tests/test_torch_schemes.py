"""The port's nine stateful placement schemes held against the JAX package
on the CPU: the torch twin of ``temperature_shared`` bit-equal to the numpy
module function by function, the decay-boundary cases of the conformance
suite on the twin and the port's branches, the copied BIT annotations, and
the step engine bit-equal to JAX's tick engine on every state key
(``sch_*`` included) for single volumes, a heterogeneous 14-scheme fleet and
a fleet carried across from JAX mid-trace; and the greedy cells of the
committed latency bench reproduced."""

import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jaxsim, simulator
from repro.core.fleetshard import encode_policies, hetero_config
from repro.core.placement import registry
from repro.core.placement import temperature_shared as ref_ts
from repro.core.tracegen import make_fleet, tiled_fleet
from repro_torch import convert
from repro_torch.core import annotate, torchsim
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.inplace import Consts, own_state
from repro_torch.core.placement import stateful
from repro_torch.core.placement import temperature_shared as ts
from repro_torch.kernels import replay as kreplay

ROOT = Path(__file__).resolve().parents[1]
N, SEG = 128, 8
STATEFUL = ["fk", "dac", "ml", "sfs", "eti", "mq", "sfr", "fadac", "warcip"]
SELECTORS = ["greedy", "cost_benefit"]
TRACE = np.asarray(np.random.default_rng(0).integers(0, N, 600), np.int32)


def _port_cfg(jcfg) -> TorchSimConfig:
    return convert.config_from_jax(dataclasses.asdict(jcfg))


def _assert_states_equal(got: dict, want: dict, volume=None):
    """Every key, ``sch_*`` included, equal in shape, dtype and value."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key, ref in want.items():
        mine = got[key] if volume is None else got[key][volume]
        assert mine.dtype == ref.dtype, key
        np.testing.assert_array_equal(mine, ref, err_msg=f"state[{key}]")


# -- the twin of temperature_shared ---------------------------------------------

def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _floats(rng, shape, hi):
    return (rng.random(shape) * hi).astype(np.float32)


def _elementwise_cases(rng, V=6, m=257):
    """(name, numpy inputs) of the elementwise functions, over (V, m)."""
    sh = (V, m)
    big = _ints(rng, sh, 1, 2 ** 31 - 1)
    small = _ints(rng, sh, -5, 200)
    return {
        "ilog2": (np.concatenate([big, small], 1),),
        "log2_interp": (np.concatenate([big, _ints(rng, sh, 1, 5000)], 1),),
        "eti_fold": (_ints(rng, sh, 0, 2 ** 20), _ints(rng, sh, 0, 60), _ints(rng, sh, 0, 70)),
        "mq_ladder": (small,),
        "mq_user": (_ints(rng, sh, 1, 40), _ints(rng, sh, 0, 5), _ints(rng, sh, 0, 3000),
                    _ints(rng, sh, 0, 3000)),
        "sfr_freq_update": (_floats(rng, sh, 30.0),),
        "sfr_score": (_floats(rng, sh, 40.0), _ints(rng, sh, 0, 2 ** 30),
                      rng.integers(0, 2, sh).astype(np.float32)),
        "sfr_class": (_floats(rng, sh, 1.5),),
        "fadac_fold": (_ints(rng, sh, 0, 2 ** 20), _ints(rng, sh, 0, 2 ** 24),
                       _ints(rng, sh, 2 ** 24, 2 ** 26)),
        "fadac_class": (_ints(rng, sh, -3, 80),),
        "warcip_interval": (np.concatenate([_ints(rng, sh, -10, 40), big], 1),),
        "warcip_update": (_floats(rng, sh, 30.0), _floats(rng, sh, 1500.0),
                          _floats(rng, sh, 30.0)),
    }


@pytest.mark.parametrize("name", list(_elementwise_cases(np.random.default_rng(0))))
def test_twin_elementwise_functions_match_numpy(name):
    args = _elementwise_cases(np.random.default_rng(41))[name]
    want = getattr(ref_ts, name)(*args)
    got = getattr(ts, name)(*(torch.from_numpy(a) for a in args))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for w, g in zip(want, got):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_twin_eti_user_class_matches_numpy_per_volume():
    """Each volume's mean over its own extents, at several table widths
    (powers of two and not) and epochs, with forced hot / cold ties."""
    rng = np.random.default_rng(5)
    for n_ext in (1, 2, 3, 16, 64):
        V = 40
        counts = _ints(rng, (V, n_ext), 0, 9)
        counts[::5] = counts[::5, :1]               # every extent at the mean
        lasts = _ints(rng, (V, n_ext), 0, 3)
        epoch = _ints(rng, (V,), 0, 4)
        e = _ints(rng, (V,), 0, n_ext)
        got = ts.eti_user_class(*(torch.from_numpy(a) for a in (counts, lasts, epoch, e)))
        want = [int(ref_ts.eti_user_class(counts[v], lasts[v], epoch[v], e[v]))
                for v in range(V)]
        assert got.dtype == torch.int32
        assert got.tolist() == want, n_ext


def test_twin_warcip_assign_takes_each_volumes_first_minimum():
    rng = np.random.default_rng(6)
    V = 200
    cent = _floats(rng, (V, 5), 20.0)
    cent[::3, 3] = cent[::3, 1]                     # ties: the first one wins
    li = np.where(np.arange(V) % 3 == 0, cent[:, 1], _floats(rng, (V,), 25.0))
    got = ts.warcip_assign(torch.from_numpy(cent), torch.from_numpy(li))
    want = [int(ref_ts.warcip_assign(cent[v], li[v])) for v in range(V)]
    assert got.dtype == torch.int32 and got.tolist() == want


def test_twin_constants_match_numpy():
    for name in ("ETI_EXTENT_BLOCKS", "ETI_DECAY_EVERY", "MQ_USER_CLASSES", "SFR_CHUNK_BLOCKS",
                 "SFR_LAST_INIT", "FADAC_CHUNK_BLOCKS", "FADAC_HALF_LIFE",
                 "WARCIP_CENTROID_INIT", "WARCIP_COUNT_CAP"):
        assert getattr(ts, name) == getattr(ref_ts, name), name
    assert ts.LN2 == float(ref_ts.LN2)


def test_searchsorted_matches_jax_on_unordered_bounds():
    """sfs's bound lookup is JAX's binary search step for step, also where
    the bounds are out of order or tied."""
    rng = np.random.default_rng(8)
    V = 64
    bounds = _floats(rng, (V, 5), 1.0)
    bounds[: V // 2].sort(axis=1)
    bounds[::4, 2] = bounds[::4, 1]
    h = np.concatenate([_floats(rng, (V, 30), 1.2), bounds], 1)
    got = stateful.searchsorted_left(torch.from_numpy(bounds), torch.from_numpy(h))
    want = np.stack([np.asarray(jnp.searchsorted(jnp.asarray(bounds[v]), jnp.asarray(h[v])))
                     for v in range(V)])
    np.testing.assert_array_equal(got.numpy(), want)


# -- decay boundaries: the JAX triple and the port's branch driven alike ---------

def _drive(scheme, events):
    """Feed the JAX triple and the port's branch (one volume) the same
    events, ("user", t, lba) or ("gc", t, lbas); returns (JAX classes, port
    classes, final JAX state, final port state)."""
    impl = dict((sd.name, jp) for sd, jp in registry.jax_schemes())[scheme]
    jcfg = types.SimpleNamespace(n_lbas=N, segment_size=SEG, sfs_resample=4096)
    jst = {"t": jnp.int32(0), **impl.init_state(jcfg)}
    sid = jaxsim.SCHEME_IDS[scheme]
    branch = stateful.STATEFUL[sid]
    pst = {key: torch.full((1,) + shape, 0, dtype=dtype) for key, (shape, dtype, _) in
           branch.spec(jcfg).items()}
    for key, (shape, dtype, fill) in branch.spec(jcfg).items():
        pst[key][:] = torch.tensor(fill, dtype=dtype)
    pst = own_state(pst)
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, scheme=scheme)
    k = Consts(cfg, 1, torch.device("cpu"), torch.tensor([sid], dtype=torch.int32))
    keep = torch.ones(1, dtype=torch.bool)
    out_j, out_p = [], []
    for ev in events:
        t = torch.tensor([ev[1]], dtype=torch.int32)
        jst["t"] = jnp.int32(ev[1])
        if ev[0] == "user":
            cls, jst = impl.user_class(jcfg, jst, jnp.int32(ev[2]), jnp.int32(0),
                                       jnp.int32(2 ** 30))
            out_j.append(int(cls))
            w = stateful.UserWrite(torch.tensor([ev[2]]), t, None, keep, k)
            out_p.append(int(branch.user(cfg, pst, w)[0]))
        else:
            lv = np.asarray(ev[2], np.int32)
            utime = jnp.zeros(lv.shape, jnp.int32)
            cls, jst = impl.gc_classes(jcfg, jst, jnp.int32(0), jnp.asarray(lv), utime,
                                       jnp.ones(lv.shape, bool), jnp.int32(ev[1]) - utime)
            out_j.extend(int(c) for c in cls)
            if isinstance(branch.gc, int):
                out_p.extend([branch.gc] * len(lv))
            else:
                g = stateful.GcVictims(torch.from_numpy(lv).long()[None],
                                       torch.ones((1, len(lv)), dtype=torch.bool), t, keep, k)
                out_p.extend(branch.gc(cfg, pst, g)[0].tolist())
    return out_j, out_p, jax.device_get(jst), {key: x.numpy()[0] for key, x in pst.items()}


def _assert_slices_equal(jst, pst):
    for key, x in pst.items():
        np.testing.assert_array_equal(x, np.asarray(jst[key]), err_msg=key)


@pytest.mark.parametrize("scheme", STATEFUL)
def test_driven_sequence_matches_jax_triple(scheme):
    """User writes at jumping times and GC classifications, as the
    conformance suite drives them: every class and the final slice equal."""
    rng = np.random.default_rng(17)
    events, t = [], 0
    for step in range(300):
        t += int(rng.integers(1, 40))
        if step % 11 == 10:
            events.append(("gc", t, rng.integers(0, N, size=SEG)))
        else:
            events.append(("user", t, int(rng.integers(0, N))))
    out_j, out_p, jst, pst = _drive(scheme, events)
    assert out_p == out_j
    _assert_slices_equal(jst, pst)


def test_eti_halving_tick_boundary():
    """The write that completes a 2^15-write decay period classifies against
    the halved counters; one write earlier it does not."""
    D = ts.ETI_DECAY_EVERY
    for last_t, epoch, count in ((D - 2, 0, 2), (D - 1, 1, 1)):
        out_j, out_p, jst, pst = _drive("eti", [("user", 0, 0), ("user", last_t, 0)])
        assert out_p == out_j
        _assert_slices_equal(jst, pst)
        assert pst["sch_eti_count"][0] == 2 and pst["sch_eti_last"][0] == 0
        folded = ts.eti_fold(torch.tensor([2]), torch.tensor([0]), torch.tensor([epoch]))
        assert int(folded) == count
    counts, lasts = torch.tensor([[2, 0]]), torch.zeros((1, 2), dtype=torch.int32)
    for epoch, cls in ((0, 0), (1, 1)):      # [2, 0] hot before the tick, [1, 0] not
        got = ts.eti_user_class(counts, lasts, torch.tensor([epoch]), torch.tensor([0]))
        assert int(got) == cls


def test_fadac_half_life_boundary():
    """A count of 1 survives until exactly a half-life has passed since its
    update, then halves to 0: class 4, then 5, on the GC read path."""
    H = ts.FADAC_HALF_LIFE
    for t_read, want in ((H - 1, 4), (H, 5)):
        out_j, out_p, _, _ = _drive("fadac", [("user", 0, 0), ("gc", t_read, [0, 0])])
        assert out_p == out_j and out_p[1:] == [want, want], t_read
    folded = ts.fadac_fold(torch.tensor([1]), torch.tensor([0]), torch.tensor([H]))
    assert int(ts.fadac_fold(folded, torch.tensor([H]), torch.tensor([H]))) == int(folded)


def test_mq_expiry_demotion_boundary():
    """Expiry demotes strictly after ``expire``: the level holds at t ==
    expire and drops one at expire + 1; level 0 never goes below 0."""
    def user(freq, lvl, expire, t):
        return ts.mq_user(*(torch.tensor([x], dtype=torch.int32) for x in (freq, lvl, expire, t)))
    assert [int(x) for x in user(2, 3, 10, 10)] == [1, 3]
    assert [int(x) for x in user(2, 3, 10, 11)] == [2, 2]
    assert int(user(1, 0, 10, 99)[1]) == 0
    out_j, out_p, jst, pst = _drive("mq", [("user", t, 0) for t in (0, 1, 2, 3, 2000, 2001)])
    assert out_p == out_j
    _assert_slices_equal(jst, pst)


def test_warcip_first_write_unknown_interval():
    """A first write has no interval: the coldest user class (4), centroids
    untouched; the second write clusters and moves exactly one centroid."""
    out_j, out_p, jst, pst = _drive("warcip", [("user", 7, 3)])
    assert out_p == out_j == [4]
    np.testing.assert_array_equal(pst["sch_warcip_cent"],
                                  np.asarray(ts.WARCIP_CENTROID_INIT, np.float32))
    out_j, out_p, jst, pst = _drive("warcip", [("user", 7, 3), ("user", 19, 3)])
    assert out_p == out_j and 0 <= out_p[1] < 5
    moved = pst["sch_warcip_cent"] != np.asarray(ts.WARCIP_CENTROID_INIT, np.float32)
    assert moved.sum() == 1
    _assert_slices_equal(jst, pst)


def test_sfr_sequentiality_reset():
    """A write to the previous LBA + 1 is sequential: a colder class than
    the same write off the run; a non-adjacent LBA resets the run."""
    seq = _drive("sfr", [("user", 0, 10), ("user", 1, 11)])
    non = _drive("sfr", [("user", 0, 10), ("user", 1, 13)])
    for out_j, out_p, jst, pst in (seq, non):
        assert out_p == out_j
        _assert_slices_equal(jst, pst)
    assert seq[1][1] > non[1][1]
    assert seq[3]["sch_sfr_prev"] == 11
    out_j, out_p, _, _ = _drive("sfr", [("user", 0, 10), ("user", 1, 13), ("user", 2, 11)])
    assert out_p == out_j


# -- BIT annotations --------------------------------------------------------------

def test_annotations_match_jax_package():
    rng = np.random.default_rng(9)
    for m in (0, 1, 7, 500):
        tr = rng.integers(0, 40, m)
        np.testing.assert_array_equal(annotate.annotate_next_write(tr, 40),
                                      simulator.annotate_next_write(tr, 40))
        np.testing.assert_array_equal(annotate.fk_annotations(tr), jaxsim.fk_annotations(tr))
    padded = jaxsim.pad_fleet(make_fleet("mixed", 5, 64, 200, jitter=0.3, seed=2))
    for ids in ([0, 2, 7, 8, 1], [3, 0, 3, 12, 4]):
        want = jaxsim.fleet_annotations(padded, ids)
        got = annotate.fleet_annotations(padded, ids)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            annotate.coerce_fleet_annotations(got, padded.shape, "cpu").numpy(),
            np.asarray(jaxsim.coerce_fleet_annotations(want, padded.shape)))


# -- the engine against JAX ---------------------------------------------------------

@pytest.mark.parametrize("selector", SELECTORS)
@pytest.mark.parametrize("scheme", STATEFUL)
def test_single_volume_matches_jax(scheme, selector):
    """``torchsim.run`` against ``jaxsim._run`` with fk's annotations; sfs
    refreshes its bounds every 64 writes. XLA compiles sfs's quantile
    arithmetic one way in ``_run`` and another in ``_run_fleet``, so ``_run``
    and its own fleet of one can end an ulp apart in ``sch_sfs_bounds``; the
    port follows the fleet engine: for sfs it equals JAX's fleet of one on
    every key, and ``_run`` on every other key."""
    jcfg = jaxsim.JaxSimConfig(n_lbas=N, segment_size=SEG, scheme=scheme, selector=selector,
                               sfs_resample=64)
    nxt = jnp.asarray(jaxsim.fk_annotations(TRACE))
    ref = jax.device_get(jaxsim._run(jcfg, jnp.asarray(TRACE), None, nxt))
    cfg = _port_cfg(jcfg)
    stats = torchsim.ReplayStats()
    got = convert.state_to_numpy(torchsim.run(cfg, TRACE, device="cpu", stats=stats))
    assert int(ref["reclaimed"]) > 0 and int(ref["overflow"]) == 0
    if scheme == "sfs":
        fleet = jax.device_get(jaxsim._run_fleet(jcfg, jnp.asarray(TRACE[None]), nxt[None], False,
                                                 jaxsim.broadcast_policies(jcfg, 1)))
        _assert_states_equal(got, fleet)
        assert bool(np.asarray(ref["sch_sfs_ready"]))
        ref, got = ({k: v for k, v in x.items() if k != "sch_sfs_bounds"} for x in (ref, got))
    _assert_states_equal(got, ref, volume=0)
    assert (torchsim._summary(cfg, {k: v[0] for k, v in got.items()})
            == jaxsim._summary(jcfg, ref))
    assert stats.steps == len(TRACE) and stats.tick_iterations >= int(ref["reclaimed"])


@pytest.fixture(scope="module")
def fleet14():
    """All 14 schemes in one fleet: unequal trace lengths (pad steps), mixed
    selectors, GC thresholds and nc windows, class_slots 6, the pool sized
    from the largest threshold; sfs refreshes every 64 writes."""
    V = len(jaxsim.SCHEME_NAMES)
    traces = make_fleet("mixed", V, N, 4 * N, jitter=0.3, seed=19)
    schemes = np.arange(V, dtype=np.int32)
    gps = np.asarray([0.08, 0.12, 0.16, 0.22, 0.1, 0.15, 0.2] * 2, np.float32)
    pol = {"p_scheme": schemes, "p_selector": (np.arange(V) % 2).astype(np.int32),
           "p_gp": gps, "p_ncw": np.asarray([16, 8, 24, 16] * 3 + [16, 8], np.int32),
           "p_classes": np.asarray(jaxsim.SCHEME_CLASSES, np.int32)[schemes],
           "p_gcsched": np.zeros(V, np.int32)}
    base = jaxsim.JaxSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, sfs_resample=64)
    jcfg = dataclasses.replace(
        base, n_segments=dataclasses.replace(base, gp_threshold=float(gps.max())).s_max)
    padded = jaxsim.pad_fleet(traces)
    nxts = jaxsim.fleet_annotations(padded, schemes)
    ref = jax.device_get(jaxsim._run_fleet(jcfg, jnp.asarray(padded), jnp.asarray(nxts), True,
                                           {k: jnp.asarray(v) for k, v in pol.items()}))
    return jcfg, traces, pol, nxts, ref


def test_fleet_of_all_schemes_matches_jax(fleet14):
    jcfg, traces, pol, _, ref = fleet14
    assert (np.asarray(ref["reclaimed"]) > 0).all() and np.asarray(ref["overflow"]).sum() == 0
    assert len({len(t) for t in traces}) > 1
    cfg = _port_cfg(jcfg)
    stats = torchsim.ReplayStats()
    st = torchsim.run_fleet(cfg, traces, pol, device="cpu", stats=stats, engine="step")
    _assert_states_equal(convert.state_to_numpy(st), ref)
    assert (torchsim.summarize_fleet(cfg, st, len(traces))
            == jaxsim.summarize_fleet(jcfg, ref, len(traces)))
    assert stats.steps == max(len(t) for t in traces)


def test_fleet_carried_across_from_jax_mid_trace(fleet14):
    """JAX replays the first half, the port the second from JAX's state,
    with every scheme's tables live and fk's annotations of the whole
    trace; the end equals JAX's replay of the whole."""
    jcfg, traces, pol, nxts, ref = fleet14
    padded = jaxsim.pad_fleet(traces)
    half = padded.shape[1] // 2
    mid = jax.device_get(jaxsim._run_fleet(jcfg, jnp.asarray(padded[:, :half]),
                                           jnp.asarray(nxts[:, :half]), True,
                                           {k: jnp.asarray(v) for k, v in pol.items()}))
    assert (np.asarray(mid["sch_sfs_since"]) > 0).any() and np.asarray(mid["sch_sfs_ready"]).any()
    st = torchsim.run_fleet(_port_cfg(jcfg), padded[:, half:], device="cpu",
                            state=convert.state_from_numpy(mid, "cpu"), engine="step",
                            nxts=nxts[:, half:])
    _assert_states_equal(convert.state_to_numpy(st), ref)


def test_host_refresh_steps_equal_asking_the_device(fleet14):
    """The step engine's host-side schedule of sfs refreshes gives the same
    state as deciding each step on the device."""
    jcfg, traces, pol, _, ref = fleet14
    cfg = _port_cfg(jcfg)
    padded = torchsim.pad_fleet(traces)
    st = own_state(torchsim.init_state(cfg, pol, "cpu"))
    k = Consts(cfg, len(traces), torch.device("cpu"), st["p_scheme"])
    nxt = torch.from_numpy(annotate.fleet_annotations(padded, pol["p_scheme"]))
    for i in range(padded.shape[1]):
        torchsim.fleet_step(cfg, st, torch.from_numpy(padded[:, i]).long(), True, k,
                            torchsim._select_victims_fleet, None, nxt[:, i], None)
    _assert_states_equal(convert.state_to_numpy(st), ref)


def test_replay_kernel_refuses_the_stateful_schemes_named_4b(fleet14):
    """The replay kernel's checks take the 14-scheme fleet with fk's
    next-write stream (`torchsim._next_writes`, the JAX fleet's
    annotations) and refuse only the well-formed state on the CPU, last;
    without the stream, the fk volume is refused. (The name is kept from
    when the kernel refused these schemes, ROADMAP item 4b; the card tests
    hold the kernel on them to the CPU.)"""
    jcfg, traces, pol, nxt, _ = fleet14
    cfg = _port_cfg(jcfg)
    st = own_state(torchsim.init_state(cfg, pol, "cpu"))
    trace = torch.from_numpy(torchsim.pad_fleet(traces))
    made = torchsim._next_writes(st, trace)
    assert np.array_equal(made.numpy(), np.asarray(nxt))
    with pytest.raises(ValueError, match="CUDA"):
        kreplay.check_inputs(cfg, st, trace, made)
    with pytest.raises(ValueError, match="fk"):
        kreplay.check_inputs(cfg, st, trace)


# -- the committed latency bench's greedy cells ------------------------------------

def test_latency_bench_greedy_cells_reproduced():
    """``BENCH_gc_latency.json``'s greedy cells (nosep, sepgc, sepbit, fk,
    two volumes each, cost-benefit, GP 0.15) from the port's step engine on
    the CPU with the timing model off: the same user and GC writes."""
    bench = json.loads((ROOT / "BENCH_gc_latency.json").read_text())
    cells = [c for c in bench["cells"] if c["gcsched"] == "greedy"]
    schemes = [c["scheme"] for c in cells]
    assert schemes == ["nosep", "sepgc", "sepbit", "fk"]
    traces = tiled_fleet("mixed", 12, 2, 256, 1024, jitter=0.25, seed=47)[:8]
    policy = encode_policies(8, schemes=[s for s in schemes for _ in range(2)],
                             selectors="cost_benefit", gp_thresholds=0.15)
    jcfg = hetero_config(jaxsim.JaxSimConfig(n_lbas=256, segment_size=32), policy)
    pol = {k: np.asarray(v) for k, v in policy.as_state_arrays().items()}
    st = torchsim.run_fleet(_port_cfg(jcfg), traces, pol, device="cpu")
    res = torchsim.summarize_fleet(_port_cfg(jcfg), st, 8)["volumes"]
    for i, cell in enumerate(cells):
        vols = res[2 * i:2 * i + 2]
        assert sum(v["user_writes"] for v in vols) == cell["user_writes"] == 2702
        assert sum(v["gc_writes"] for v in vols) == cell["gc_writes"], cell["scheme"]
        assert sum(v["overflow"] for v in vols) == cell["overflow"] == 0
    assert [c["gc_writes"] for c in cells] == [6917, 4949, 4985, 2980]
