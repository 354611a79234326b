"""The JAX package's static contracts (``docs/static_analysis.md``, proven
there by walking jaxprs) held on the port as runtime properties, under both
GC engines (``gc_engine`` tick and legacy) on the CPU:

- SA101 / SA102 (slice isolation): a scheme writes and reads only its own
  ``sch_<name>_*`` slice. Filled with noise at the start, every volume's
  other slices end as they began, and every other key ends as in a replay
  from the clean initial state;
- SA301 / SA302 (totality): classes are int32 in ``[0, n_classes)``: the
  classify kernel's outputs over random inputs (hypothesis), and after a
  replay no block counted in a padded class slot, no open or sealed row of
  a padded class;
- SA202 (spec stability): after a step and after a replay every key keeps
  ``state_spec``'s dtype and shape;
- SA501 (fleet isolation): change one volume's trace, its length too, and
  every other volume's state stays bit-unchanged; this is what lets one
  warp, or one device, own each volume.

Imports no JAX: ``tests/test_torch_cuda.py`` runs the same checks on the card
(the replay kernel and the step engine)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import convert
from repro_torch.core import torchsim
from repro_torch.core.config import SCHEME_CLASSES, SCHEME_NAMES, TorchSimConfig, init_state, \
    state_spec
from repro_torch.core.inplace import Consts, own_state
from repro_torch.core.placement.schemes import ELEMENTWISE_IDS
from repro_torch.core.tracegen import make_fleet
from repro_torch.kernels.classify import classify

N, SEG = 64, 8
ALL = tuple(SCHEME_NAMES)
ELEMENTWISE = tuple(SCHEME_NAMES[i] for i in ELEMENTWISE_IDS)
GC_ENGINES = ("tick", "legacy")


def fleet(schemes, gc_engine: str, timing: bool = False):
    """One volume per scheme: unequal trace lengths (pad steps), mixed
    selectors and GC thresholds, six class slots, the pool sized from the
    largest threshold; returns the config, the padded traces and the
    policy arrays."""
    V = len(schemes)
    ids = np.asarray([SCHEME_NAMES.index(s) for s in schemes], np.int32)
    gps = np.asarray([0.08, 0.12, 0.16, 0.22, 0.1, 0.15, 0.2][:V] * 2, np.float32)[:V]
    pol = {"p_scheme": ids, "p_selector": (np.arange(V) % 2).astype(np.int32), "p_gp": gps,
           "p_ncw": np.full(V, 8, np.int32),
           "p_classes": np.asarray(SCHEME_CLASSES, np.int32)[ids],
           "p_gcsched": np.zeros(V, np.int32)}
    sized = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6,
                           gp_threshold=float(gps.max()))
    cfg = TorchSimConfig(n_lbas=N, segment_size=SEG, class_slots=6, n_segments=sized.s_max,
                         sfs_resample=32, gc_engine=gc_engine, timing=timing)
    traces = torchsim.pad_fleet(make_fleet("mixed", V, N, 3 * N, jitter=0.3, seed=37))
    return cfg, traces, pol


def replay(cfg, traces, pol=None, device="cpu", engine="step", state=None) -> dict:
    st = torchsim.run_fleet(cfg, traces, pol, device=device, engine=engine, state=state)
    return convert.state_to_numpy(st)


@functools.lru_cache(maxsize=None)
def _clean(schemes, gc_engine, device, engine):
    cfg, traces, pol = fleet(schemes, gc_engine)
    return replay(cfg, traces, pol, device, engine)


def _own(key: str, scheme: str) -> bool:
    return key.startswith(f"sch_{scheme}_")


def check_slices_isolated(schemes, gc_engine, device="cpu", engine="step"):
    """SA101 / SA102."""
    cfg, traces, pol = fleet(schemes, gc_engine)
    clean = _clean(schemes, gc_engine, device, engine)
    gen = torch.Generator().manual_seed(5)
    start = init_state(cfg, pol, "cpu")
    noise = {}
    for key, x in start.items():
        if not key.startswith("sch_"):
            continue
        if x.dtype == torch.bool:
            z = torch.randint(0, 2, x.shape, generator=gen).bool()
        elif x.dtype.is_floating_point:
            z = 50.0 * torch.rand(x.shape, generator=gen)
        else:
            z = torch.randint(0, 4, x.shape, generator=gen, dtype=x.dtype)
        for i, s in enumerate(schemes):
            if not _own(key, s):
                x[i] = z[i]
        noise[key] = x.clone().numpy()
    got = replay(cfg, traces, device=device, engine=engine,
                 state={k: v.to(device) for k, v in start.items()})
    checked = 0
    for key in got:
        for i, s in enumerate(schemes):
            if key.startswith("sch_") and not _own(key, s):
                np.testing.assert_array_equal(got[key][i], noise[key][i],
                                              err_msg=f"{s} wrote {key}")
                checked += 1
            else:
                np.testing.assert_array_equal(got[key][i], clean[key][i],
                                              err_msg=f"{s} read another slice: {key}")
    assert checked > 0 and (clean["reclaimed"] > 0).all()


def check_classes_in_range(schemes, gc_engine, device="cpu", engine="step"):
    """SA301 / SA302 on a replay's final state."""
    cfg, traces, pol = fleet(schemes, gc_engine)
    got = _clean(schemes, gc_engine, device, engine)
    C = cfg.n_class_slots
    padded = np.arange(C)[None, :] >= pol["p_classes"][:, None]
    for key in ("class_user", "class_gc", "seg_cls", "open_sid"):
        assert got[key].dtype == np.int32, key
    assert not got["class_user"][padded].any() and not got["class_gc"][padded].any()
    assert (got["class_user"].sum(1) == (traces >= 0).sum(1)).all()
    assert (got["class_gc"].sum(1) == got["gc_writes"]).all()
    live = (got["seg_state"] == 1) | (got["seg_state"] == 2)
    live[:, cfg.pad_row] = False
    cls = np.where(live, got["seg_cls"], 0)
    assert (cls >= 0).all() and (cls < pol["p_classes"][:, None]).all()
    assert (got["class_gc"] > 0).any(axis=1).all()


def check_state_spec_kept(schemes, gc_engine, device="cpu", engine="step"):
    """SA202, timing on (every lat_* key moves): after one lockstep step
    and after the whole replay."""
    cfg, traces, pol = fleet(schemes, gc_engine, timing=True)
    V = len(schemes)
    spec = state_spec(cfg)

    def same_spec(state):
        assert set(state) == set(spec)
        for key, (shape, dtype) in spec.items():
            assert state[key].dtype == dtype and tuple(state[key].shape) == (V,) + shape, key

    st0 = own_state(init_state(cfg, pol, device))
    k = Consts(cfg, V, st0["t"].device, st0["p_scheme"], st0["p_gcsched"])
    lbas = torch.from_numpy(traces[:, 0].astype(np.int64)).to(device)
    torchsim.fleet_step(cfg, st0, lbas, True, k, nxt=torch.full((V,), 1 << 30, dtype=torch.int32,
                                                              device=device))
    same_spec(st0)
    final = torchsim.run_fleet(cfg, traces, pol, device=device, engine=engine)
    same_spec(final)
    assert (final["lat_charged"] > 0).any()


def check_volumes_isolated(schemes, gc_engine, device="cpu", engine="step"):
    """SA501: volume j's trace replaced (shorter, then longer than every
    other); every other volume ends bit-equal."""
    cfg, traces, pol = fleet(schemes, gc_engine)
    clean = _clean(schemes, gc_engine, device, engine)
    j = len(schemes) // 2
    rng = np.random.default_rng(8)
    for length in (N + 10, traces.shape[1] + 40):
        other = [traces[i][traces[i] >= 0] for i in range(len(schemes))]
        other[j] = rng.integers(0, N, length)
        got = replay(cfg, torchsim.pad_fleet(other), pol, device, engine)
        assert got["t"][j] == length
        for key in got:
            for i in range(len(schemes)):
                if i != j:
                    np.testing.assert_array_equal(got[key][i], clean[key][i],
                                                  err_msg=f"volume {i} moved with {j}: {key}")


@pytest.mark.parametrize("gc_engine", GC_ENGINES)
def test_sa101_sa102_slices_isolated(gc_engine):
    check_slices_isolated(ALL, gc_engine)


@pytest.mark.parametrize("gc_engine", GC_ENGINES)
def test_sa301_sa302_replay_classes_in_range(gc_engine):
    check_classes_in_range(ALL, gc_engine)


@pytest.mark.parametrize("gc_engine", GC_ENGINES)
def test_sa202_state_spec_kept(gc_engine):
    check_state_spec_kept(ALL, gc_engine)


@pytest.mark.parametrize("gc_engine", GC_ENGINES)
def test_sa501_volumes_isolated(gc_engine):
    check_volumes_isolated(ALL, gc_engine)


int32s = st.integers(-(2 ** 31), 2 ** 31 - 1)
ells = st.floats(min_value=0.0, allow_nan=False, allow_infinity=True, width=32)


def check_classify_in_range(rows, device="cpu"):
    """SA301 / SA302 for the classify kernel: ``rows`` of (scheme id, v, g,
    from_c1, is_gc, ell); every output int32 in [0, n_classes(scheme))."""
    ids, v, g, c1, gc, ell = (list(x) for x in zip(*rows))
    col = [[x] for x in v], [[x] for x in g], [[x] for x in c1], [[x] for x in gc]
    args = [torch.tensor(a, dtype=torch.int32, device=device) for a in col]
    out = classify(*args, torch.tensor(ell, dtype=torch.float32, device=device),
                   torch.tensor(ids, dtype=torch.int32, device=device)).cpu()
    assert out.dtype == torch.int32 and out.shape == (len(rows), 1)
    n = torch.tensor([SCHEME_CLASSES[i] for i in ids], dtype=torch.int32)
    assert ((out[:, 0] >= 0) & (out[:, 0] < n)).all(), (rows, out)


classify_rows = st.lists(st.tuples(st.sampled_from(ELEMENTWISE_IDS), int32s,
                                   st.integers(0, 2 ** 31 - 1), st.integers(0, 1),
                                   st.integers(0, 1), ells), min_size=1, max_size=64)


@settings(max_examples=200, deadline=None)
@given(classify_rows)
def test_sa301_sa302_classify_in_range(rows):
    check_classify_in_range(rows)


def test_fleet_helpers_cover_both_engines_and_every_scheme():
    """The properties above run on every registered scheme, elementwise and
    stateful, and the legacy engine differs from the tick engine only in
    ``gc_engine``."""
    tick, _, pol = fleet(ALL, "tick")
    legacy, _, _ = fleet(ALL, "legacy")
    assert dataclasses.replace(legacy, gc_engine="tick") == tick
    assert sorted(pol["p_scheme"].tolist()) == list(range(len(SCHEME_NAMES)))
    assert set(ELEMENTWISE) < set(ALL)
