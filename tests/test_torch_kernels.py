"""The port's kernels: plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) and its jnp oracles, the wrappers' CPU routing and
checks, and the port's import hygiene. The CUDA kernels themselves are held
against their plain versions in test_torch_cuda.py, on a card."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.placement import jax_schemes
from repro.kernels import classify as jclassify
from repro.kernels import ref as jref
from repro.kernels import segsel as jsegsel
from repro_torch.core.placement import schemes as tschemes
from repro_torch.kernels import classify as tclassify
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segsel as tsegsel

ROOT = Path(__file__).resolve().parents[1]


def _segsel_inputs(seed, V, S, seg=128):
    """Reachable segment metadata (nv <= n <= seg, stime < t), forced ties
    (segment 3 copied onto S-2), an all-ineligible volume, mixed selectors."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, seg + 1, (V, S))
    nv = np.minimum(rng.integers(0, seg + 1, (V, S)), n)
    t = rng.integers(1, 30_000, V)
    stime = rng.integers(0, 30_000, (V, S)) % t[:, None]
    state = rng.integers(0, 4, (V, S))
    for a in (n, nv, stime, state):
        a[:, S - 2] = a[:, 3]
    state[V - 1] = np.where(state[V - 1] == 2, 0, state[V - 1])
    sel = np.arange(V) % 2
    return [np.ascontiguousarray(x, np.int32) for x in (n, nv, stime, state, t, sel)]


@pytest.mark.parametrize("V,S", [(5, 640), (3, 1500), (4, 17)])
def test_segment_select_batch_ref_matches_pallas_and_jnp(V, S):
    args = _segsel_inputs(V * S, V, S)
    idx, score = tref.segment_select_batch_ref(*map(torch.from_numpy, args))
    jidx, jscore = jsegsel.segment_select_batch(*map(jnp.asarray, args[:5]),
                                                selector_ids=jnp.asarray(args[5]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))   # bit-equal, -inf too
    assert idx.dtype == torch.int32 and score.dtype == torch.float32
    assert int(idx[V - 1]) == -1
    for v in range(V):
        ridx, rscore = jref.segment_select_ref(*(jnp.asarray(a[v]) for a in args[:5]),
                                               selector_id=int(args[5][v]))
        assert int(idx[v]) == int(ridx)
        assert score[v].item() == float(rscore) or np.isneginf(float(rscore))


def test_segment_select_ties_go_to_the_lowest_index():
    n = torch.full((8,), 10, dtype=torch.int32)
    nv = torch.tensor([9, 4, 9, 4, 4, 9, 9, 9], dtype=torch.int32)
    state = torch.full((8,), 2, dtype=torch.int32)
    stime = torch.zeros(8, dtype=torch.int32)
    idx, score = tref.segment_select_ref(n, nv, stime, state, 5, 0)
    assert int(idx) == 1 and score.item() == np.float32(0.6)


@pytest.mark.parametrize("S", [17, 1500])
@pytest.mark.parametrize("selector", [0, 1])
def test_segment_select_ref_matches_pallas_1d(S, selector):
    n, nv, stime, state, t, _ = (a[0] for a in _segsel_inputs(S + selector, 1, S))
    idx, score = tsegsel.segment_select(*map(torch.from_numpy, (n, nv, stime, state)),
                                        int(t), selector)
    jidx, jscore = jsegsel.segment_select(*map(jnp.asarray, (n, nv, stime, state)),
                                          jnp.int32(t), selector_id=jnp.int32(selector))
    assert idx.shape == () and int(idx) == int(jidx)
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))


def test_segment_select_no_eligible_segment():
    z = torch.zeros(64, dtype=torch.int32)
    idx, score = tsegsel.segment_select(z, z, z, z, 5, 1)
    assert int(idx) == -1 and score.item() == -np.inf


def _classify_inputs(seed, B):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, (14, B)).astype(np.int32)
            for hi in (10_000, 100_000, 2, 2)]


@pytest.mark.parametrize("ell", [np.inf, 1234.5, 1.0, 0.0])
def test_classify_ref_matches_pallas_for_every_scheme_id(ell):
    v, g, c1, gc = _classify_inputs(int(ell) if np.isfinite(ell) else 99, 300)
    sids = np.arange(14, dtype=np.int32)
    ells = np.full(14, ell, np.float32)
    got = tref.classify_ref(*map(torch.from_numpy, (v, g, c1, gc, ells, sids))).numpy()
    for sid in range(14):
        args = tuple(jnp.asarray(a[sid]) for a in (v, g, c1, gc))
        want = jclassify.classify(*args, jnp.float32(ell), scheme_id=jnp.int32(sid))
        np.testing.assert_array_equal(got[sid], np.asarray(want), err_msg=f"scheme {sid}")
        oracle = jref.classify_ref(*args, jnp.float32(ell), scheme_id=sid)
        np.testing.assert_array_equal(got[sid], np.asarray(oracle), err_msg=f"scheme {sid}")
        if sid not in tschemes.ELEMENTWISE_IDS:
            assert not got[sid].any()


def _user_write_lifespans(seed, V):
    """(V, 1) int32 lifespans of user writes, by row in turn: t + 2^30 (a
    fresh LBA), 2^30 + 65..127 (rounds up to 2^30 + 128 in float32) and the
    short lifespan of a rewritten LBA."""
    rng = np.random.default_rng(seed)
    kinds = np.stack([rng.integers(0, 60_000, V) + (1 << 30),
                      rng.integers(65, 128, V) + (1 << 30),
                      rng.integers(1, 60_000, V)])
    return kinds[np.arange(V) % 3, np.arange(V)][:, None].astype(np.int32)


@pytest.mark.parametrize("ell", [np.inf, 2.0 ** 30 + 128, 20_000.5])
def test_classify_ref_matches_pallas_on_user_write_lifespans(ell):
    """The user write's (V, 1) batch, is_gc = 0, where v = t + 2^30 for a
    fresh LBA and float32 rounding decides the class near ℓ."""
    v = _user_write_lifespans(11, 42)
    z = np.zeros_like(v)
    sids = (np.arange(42) // 3).astype(np.int32)
    ells = np.full(42, ell, np.float32)
    got = tref.classify_ref(*map(torch.from_numpy, (v, z, z, z, ells, sids))).numpy()
    for row in range(42):
        args = (jnp.asarray(v[row]),) + (jnp.asarray(z[row]),) * 3
        want = jclassify.classify(*args, jnp.float32(ell), scheme_id=jnp.int32(sids[row]))
        np.testing.assert_array_equal(got[row], np.asarray(want), err_msg=f"row {row}")
    if ell == 2.0 ** 30 + 128:
        assert got[7, 0] == 1       # sepbit: v < ℓ as integers, not once rounded


@pytest.mark.parametrize("sid", range(14))
def test_elementwise_chain_matches_jax(sid):
    v, g, c1, gc = (a[0] for a in _classify_inputs(sid, 257))
    for ell in (np.float32(np.inf), np.float32(777.5)):
        got = tschemes.elementwise_chain(
            torch.tensor(sid, dtype=torch.int32), torch.from_numpy(v).float(),
            torch.from_numpy(g).float(), torch.from_numpy(c1), torch.from_numpy(gc),
            torch.tensor(ell))
        want = jax_schemes.elementwise_chain(
            jnp.int32(sid), jnp.asarray(v, jnp.float32), jnp.asarray(g, jnp.float32),
            jnp.asarray(c1), jnp.asarray(gc), jnp.float32(ell))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    ops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _segsel_inputs(1, 4, 100)]
    idx, score = ops.segment_select_batch(*args)
    ridx, rscore = tref.segment_select_batch_ref(*args)
    assert torch.equal(idx, ridx) and torch.equal(score, rscore)
    v, g, c1, gc = (torch.from_numpy(a) for a in _classify_inputs(2, 64))
    ell = torch.full((14,), 50.0)
    sids = torch.arange(14, dtype=torch.int32)
    assert torch.equal(ops.classify(v, g, c1, gc, ell, sids),
                       tref.classify_ref(v, g, c1, gc, ell, sids))
    assert torch.equal(ops.classify(v, g, c1, gc, ell, sids, site="user"),
                       tref.classify_ref(v, g, c1, gc, ell, sids))
    assert ops.launch_counts() == {"segment_select_batch": 0, "segment_select": 0,
                                   "classify_gc": 0, "classify_user": 0,
                                   "zipf_bit_sums": 0, "flash_decode": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    args = [torch.from_numpy(a) for a in _segsel_inputs(3, 4, 100)]
    with pytest.raises(TypeError, match="int32"):
        tsegsel.segment_select_batch(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        tsegsel.segment_select_batch(args[0][:2], *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tsegsel.segment_select_batch(args[0].t().contiguous().t(), *args[1:])
    v = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        tclassify.classify(v, v, v, v, torch.zeros(2, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="site"):
        tclassify.classify(v, v, v, v, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                           site="fill")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
    assert len(_port_sources()) > 10
    assert not bad, bad
