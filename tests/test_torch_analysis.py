"""The port's §3 analysis slice against the JAX package on the CPU: the Zipf
sums (K4) and flash-decode attention (K5) on their plain routes against the
Pallas kernels (interpret mode) and the jnp oracles, the closed-form Figs 8
and 10, the paper's own numbers at its scale, the trace-empirical Figs 9 and
11, the volume pool, and the wrappers' checks. The CUDA kernels are held
against their plain versions in test_torch_cuda.py, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import traces as jtraces
from repro.core import volumes as jvolumes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import analysis, traces, volumes
from repro_torch.kernels import decode_attn, ops, zipfprob
from repro_torch.kernels import ref as tref

G = analysis.BLOCKS_PER_GIB
EXPONENTS = (100.0, 400.0, 2000.0, 800.0)     # u0, v0, g0, r0 of tests/test_kernels.py


@pytest.mark.parametrize("n", [1000, 1 << 14])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_zipf_bit_sums_matches_pallas_and_jnp(n, alpha):
    """rtol 2e-4, atol 1e-6: float32 sums taken in different orders."""
    p = traces.zipf_probs(n, alpha).astype(np.float32)
    got = ops.zipf_bit_sums(torch.from_numpy(p), *EXPONENTS)
    assert got.dtype == torch.float32 and got.shape == (4,)
    for want in (jops.zipf_bit_sums(jnp.asarray(p), *EXPONENTS),
                 jref.zipf_bit_sums_ref(jnp.asarray(p), *EXPONENTS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_pr_kernels_match_pallas(alpha):
    """The float32 ratio wrappers; rtol 2e-4 as for the sums."""
    p = traces.zipf_probs(1 << 14, alpha).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    for got, want in ((zipfprob.pr_user_bit_kernel(tp, 300.0, 900.0),
                       jops.pr_user_bit_kernel(jp, 300.0, 900.0)),
                      (zipfprob.pr_gc_bit_kernel(tp, 2000.0, 800.0),
                       jops.pr_gc_bit_kernel(jp, 2000.0, 800.0))):
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=2e-4)


@pytest.mark.parametrize("n,alpha", [(1 << 16, 1.0), (1 << 16, 0.6), (analysis.PAPER_N, 1.0)])
def test_pr_user_and_gc_bit_match_float64_closed_form(n, alpha):
    """The port's float32 route within abs 1e-4 of the JAX package's float64
    numpy closed form, over a spread of windows (in blocks)."""
    probs = traces.zipf_probs(n, alpha)
    for u0, v0 in ((n / 40, n / 2.5), (n / 10, n / 40), (n / 10, n / 10)):
        got = analysis.pr_user_bit(u0, v0, probs=probs, device="cpu")
        assert got == pytest.approx(janalysis.pr_user_bit(u0, v0, probs=probs), abs=1e-4)
    for g0, r0 in ((n / 5, 4 * n / 5), (16 * n / 5, 4 * n / 5), (n, n / 10)):
        got = analysis.pr_gc_bit(g0, r0, probs=probs, device="cpu")
        assert got == pytest.approx(janalysis.pr_gc_bit(g0, r0, probs=probs), abs=1e-4)


def test_pr_bits_are_zero_without_a_denominator():
    """den == 0 gives 0.0, as in the reference: v0 = 0 (no lifespan <= 0),
    and a pmf of zeros."""
    assert analysis.pr_user_bit(100, 0, n=1000, device="cpu") == 0.0
    assert janalysis.pr_user_bit(100, 0, n=1000) == 0.0
    assert analysis.pr_gc_bit(10, 10, probs=np.zeros(64), device="cpu") == 0.0


def test_fig8a_min_771_at_paper_scale():
    """Fig 8(a): the lowest probability is 77.1% at (u0 0.25, v0 4) GiB."""
    assert analysis.pr_user_bit(0.25 * G, 4 * G, device="cpu") == pytest.approx(0.771, abs=0.002)
    grid = analysis.fig8a_grid(device="cpu")
    assert len(grid) == 25 and min(grid.values()) == pytest.approx(0.771, abs=0.003)
    assert min(grid, key=grid.get) == (0.25, 4)


def test_fig8b_alpha_extremes_at_paper_scale():
    """Fig 8(b): >= 87.1% at alpha 1 (u0 1 GiB); 9.5% at alpha 0."""
    curve = analysis.fig8b_curve(alphas=(0.0, 1.0), device="cpu")
    assert min(curve[(1.0, v)] for v in (0.25, 0.5, 1, 2, 4)) == pytest.approx(0.871, abs=0.003)
    assert curve[(0.0, 1)] == pytest.approx(0.095, abs=0.002)
    assert analysis.pr_user_bit(1 * G, 1 * G, alpha=0.0, device="cpu") == curve[(0.0, 1)]


def test_fig10a_age_separation_at_paper_scale():
    """Fig 10(a), r0 8 GiB: 41.2% at g0 2 GiB against 14.9% at 32 GiB."""
    grid = analysis.fig10a_grid(r0_gib=(8,), device="cpu")
    assert grid[(2, 8)] == pytest.approx(0.412, abs=0.003)
    assert grid[(32, 8)] == pytest.approx(0.149, abs=0.003)
    assert analysis.pr_gc_bit(2 * G, 8 * G, device="cpu") == grid[(2, 8)]


def test_fig10b_skew_dependence_at_paper_scale():
    """Fig 10(b): age separation 3.5 points at alpha 0.2, 26.4 at alpha 1."""
    curve = analysis.fig10b_curve(g0_gib=(2, 32), alphas=(0.2, 1.0), device="cpu")
    assert curve[(0.2, 2)] - curve[(0.2, 32)] == pytest.approx(0.035, abs=0.004)
    assert curve[(1.0, 2)] - curve[(1.0, 32)] == pytest.approx(0.264, abs=0.004)


def test_grids_match_the_reference_grids():
    """Every key of the four figure grids, and each value within abs 1e-4 of
    the float64 closed form, at n = 2^15 with the windows scaled by
    n / PAPER_N (the paper's windows at that n would push (1-p)^g0 below
    float32's range, where both float32 routes give 0)."""
    n = 1 << 15
    s = n / analysis.PAPER_N
    u0s = tuple(s * x for x in (0.25, 0.5, 1, 2, 4))
    g0s, r0s = tuple(s * x for x in (2, 4, 8, 16, 32)), tuple(s * x for x in (1, 2, 4, 8))
    for port, ref, windows in (
            (analysis.fig8a_grid, janalysis.fig8a_grid, dict(u0_gib=u0s, v0_gib=u0s)),
            (analysis.fig8b_curve, janalysis.fig8b_curve, dict(u0_gib=s, v0_gib=u0s)),
            (analysis.fig10a_grid, janalysis.fig10a_grid, dict(g0_gib=g0s, r0_gib=r0s)),
            (analysis.fig10b_curve, janalysis.fig10b_curve, dict(r0_gib=8 * s, g0_gib=g0s))):
        got, want = port(n=n, device="cpu", **windows), ref(n=n, **windows)
        assert list(got) == list(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, abs=1e-4), (port.__name__, key)


def _trace(kind):
    n = 1 << 12
    if kind == "zipf":
        return jtraces.zipf_trace(n, 6 * n, alpha=1.0, seed=4)
    if kind == "hotcold":
        return jtraces.hotcold_trace(n, 6 * n, seed=5)
    return jtraces.mixed_trace(n, 6 * n, seed=6, burst_echo_prob=0.4)


def _same(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("kind", ["zipf", "hotcold", "mixed"])
def test_trace_conditionals_equal_the_reference(kind):
    """Exactly equal (integer counts), including v0 = 0, which selects
    nothing (nan), and a g0 past every lifespan (nan)."""
    tr = _trace(kind)
    n = int(tr.max()) + 1
    for u0, v0 in ((0.1, 0.1), (0.1, 0.4), (0.4, 0.4), (0.05, 0.0), (0.0, 0.2)):
        got = analysis.trace_conditional_user(tr, int(u0 * n), int(v0 * n), device="cpu")
        want = janalysis.trace_conditional_user(tr, int(u0 * n), int(v0 * n))
        assert _same(got, want), (u0, v0, got, want)
    assert np.isnan(analysis.trace_conditional_user(tr, 10, 0, device="cpu"))
    for g0, r0 in ((0.1, 0.5), (1.0, 0.5), (0.0, 0.0), (100.0, 0.5)):
        got = analysis.trace_conditional_gc(tr, int(g0 * n), int(r0 * n), device="cpu")
        want = janalysis.trace_conditional_gc(tr, int(g0 * n), int(r0 * n))
        assert _same(got, want), (g0, r0, got, want)
    assert np.isnan(analysis.trace_conditional_gc(tr, 100 * n, 1, device="cpu"))


def test_trace_conditionals_on_a_tiny_trace():
    """By hand: writes a b a a b; the lifespans are a:2,1,- b:3,- ."""
    tr = np.asarray([0, 1, 0, 0, 1])
    # updates at 2 (v 2), 3 (v 1), 4 (v 3); their own lifespans: 1, -, -
    assert analysis.trace_conditional_user(tr, 1, 2, device="cpu") == 0.5
    assert janalysis.trace_conditional_user(tr, 1, 2) == 0.5
    # u = 2, 3, 1, 2 (horizon 5 - 3), 1 (horizon 5 - 4)
    assert analysis.trace_conditional_gc(tr, 2, 0, device="cpu") == janalysis.trace_conditional_gc(
        tr, 2, 0) == 2 / 3


def test_default_pool_equals_the_reference():
    got, want = volumes.default_pool(1), jvolumes.default_pool(1)
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sequential_trace_stats_and_overall_wa_equal_the_reference():
    for n, passes in ((5, 1), (300, 4)):
        a, b = traces.sequential_trace(n, passes), jtraces.sequential_trace(n, passes)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for tr in (traces.sequential_trace(300, 4), _trace("mixed"), np.zeros(0, np.int64)):
        assert traces.trace_stats(tr) == jtraces.trace_stats(tr)

    class R:
        def __init__(self, user_writes, gc_writes):
            self.user_writes, self.gc_writes = user_writes, gc_writes
    for rs in ([R(100, 30), R(50, 0)], [R(0, 0)], []):
        assert volumes.overall_wa(rs) == jvolumes.overall_wa(rs)


DECODE_SHAPES = [
    (1, 4, 1, 64, 300),      # MQA, ragged tile
    (2, 8, 2, 64, 700),      # GQA
    (2, 8, 8, 128, 512),     # MHA, aligned
    (1, 16, 2, 128, 1024),   # large G
    (2, 32, 32, 96, 300),    # phi3-mini's D = 96
    (2, 24, 2, 128, 333),    # starcoder2-3b's G = 12
]


@pytest.mark.parametrize("B,Hq,Hkv,D,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_pallas_and_jnp(B, Hq, Hkv, D, S, dtype):
    """atol = rtol = 1e-4 in float32, 2e-2 in bfloat16 (tests/test_kernels.py)."""
    rng = np.random.default_rng(B * Hq * D + S)
    x = [rng.standard_normal(shape).astype(np.float32)
         for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    kl = rng.integers(1, S + 1, B).astype(np.int32)
    kl[0] = S
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in x)
    got = ops.flash_decode(q, k, v, torch.from_numpy(kl))
    assert got.dtype == tdt and got.shape == (B, Hq, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in x)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for want in (jops.flash_decode(jq, jk, jv, jnp.asarray(kl), kv_tile=256),
                 jref.flash_decode_ref(jq, jk, jv, jnp.asarray(kl))):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_flash_decode_masks_past_kv_len():
    """Positions at or past kv_len change nothing; kv_len above S counts as S."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    kl = torch.tensor([17, 40], dtype=torch.int32)
    out = ops.flash_decode(q, k, v, kl)
    k2, v2 = k.clone(), v.clone()
    k2[0, 17:], v2[0, 17:] = 1e4, -1e4
    assert torch.equal(ops.flash_decode(q, k2, v2, kl)[0], out[0])
    assert torch.equal(ops.flash_decode(q, k, v, torch.tensor([17, 99], dtype=torch.int32)), out)


def test_new_wrappers_route_cpu_tensors_to_the_plain_versions():
    ops.reset_launch_counts()
    p = torch.from_numpy(traces.zipf_probs(500, 1.0).astype(np.float32))
    assert torch.equal(ops.zipf_bit_sums(p, *EXPONENTS), tref.zipf_bit_sums_ref(p, *EXPONENTS))
    analysis.pr_user_bit(10, 40, n=500, device="cpu")
    q, k = torch.ones(1, 2, 64), torch.ones(1, 8, 1, 64)
    kl = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(ops.flash_decode(q, k, k, kl), tref.flash_decode_ref(q, k, k, kl))
    assert ops.launch_counts()["zipf_bit_sums"] == 0
    assert ops.launch_counts()["flash_decode"] == 0


def test_zipf_bit_sums_rejects_what_the_kernel_does_not_take():
    p = torch.full((64,), 1 / 64)
    with pytest.raises(TypeError, match="float32"):
        zipfprob.zipf_bit_sums(p.double(), *EXPONENTS)
    with pytest.raises(ValueError, match="1-D"):
        zipfprob.zipf_bit_sums(p.reshape(8, 8), *EXPONENTS)
    with pytest.raises(ValueError, match="contiguous"):
        zipfprob.zipf_bit_sums(torch.full((128,), 1 / 64)[::2], *EXPONENTS)
    with pytest.raises(ValueError, match="1-D"):
        zipfprob.zipf_bit_sums(p.numpy(), *EXPONENTS)


def _decode_args(B=2, Hq=8, Hkv=2, D=64, S=16, dtype=torch.float32):
    return (torch.zeros(B, Hq, D, dtype=dtype), torch.zeros(B, S, Hkv, D, dtype=dtype),
            torch.zeros(B, S, Hkv, D, dtype=dtype), torch.full((B,), S, dtype=torch.int32))


@pytest.mark.parametrize("case,error,match", [
    ("kv_len zero", ValueError, ">= 1"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("mixed dtypes", TypeError, "bfloat16"),
    ("Hq % Hkv", ValueError, "Hq % Hkv"),
    ("D 80", ValueError, "head dim"),
    ("G 128", ValueError, "at most"),
    ("q 2-D", ValueError, r"\(B, Hq, D\)"),
    ("v shape", ValueError, "shape"),
    ("kv_len int64", TypeError, "int32"),
    ("k strided", ValueError, "contiguous"),
])
def test_flash_decode_rejects_what_the_kernel_does_not_take(case, error, match):
    q, k, v, kl = _decode_args()
    if case == "kv_len zero":
        kl = torch.tensor([3, 0], dtype=torch.int32)
    elif case == "float16":
        q, k, v, kl = _decode_args(dtype=torch.float16)
    elif case == "mixed dtypes":
        k = k.to(torch.bfloat16)
    elif case == "Hq % Hkv":
        q, k, v, kl = _decode_args(Hq=6, Hkv=4)
    elif case == "D 80":
        q, k, v, kl = _decode_args(D=80)
    elif case == "G 128":
        q, k, v, kl = _decode_args(Hq=128, Hkv=1)
    elif case == "q 2-D":
        q = q[0]
    elif case == "v shape":
        v = v[:, :8].contiguous()
    elif case == "kv_len int64":
        kl = kl.long()
    elif case == "k strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(error, match=match):
        decode_attn.flash_decode(q, k, v, kl)
