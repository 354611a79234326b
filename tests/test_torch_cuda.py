"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version (bit-equal for the replay engine's kernels, within a stated
tolerance for the float reductions), a fleet replayed through the kernels
bit-equal to the same fleet replayed on the CPU, and the §3 analysis on the
card against the CPU. Imports no JAX (the machine with the card has none);
every test skips where ``torch.cuda.is_available()`` is false."""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import analysis, torchsim
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.tracegen import make_fleet
from repro_torch.core.traces import mixed_trace, zipf_probs
from repro_torch.kernels import classify as tclassify
from repro_torch.kernels import decode_attn, zipfprob
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segsel as tsegsel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ built with nvcc)")
    return torch.device("cuda")


def _segsel_inputs(seed, V, S, seg=128):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, seg + 1, (V, S))
    nv = np.minimum(rng.integers(0, seg + 1, (V, S)), n)
    t = rng.integers(1, 30_000, V)
    stime = rng.integers(0, 30_000, (V, S)) % t[:, None]
    state = rng.integers(0, 4, (V, S))
    for a in (n, nv, stime, state):
        a[:, S - 2] = a[:, 3]                 # a tie at a higher index
    state[V - 1] = np.where(state[V - 1] == 2, 0, state[V - 1])   # no victim
    return [np.ascontiguousarray(x, np.int32) for x in (n, nv, stime, state, t, np.arange(V) % 2)]


def _user_write_lifespans(seed, V):
    """(V, 1) int32 lifespans of user writes, by row in turn: t + 2^30 (a
    fresh LBA), 2^30 + 65..127 (rounds up to 2^30 + 128 in float32) and the
    short lifespan of a rewritten LBA."""
    rng = np.random.default_rng(seed)
    kinds = np.stack([rng.integers(0, 60_000, V) + (1 << 30),
                      rng.integers(65, 128, V) + (1 << 30),
                      rng.integers(1, 60_000, V)])
    return kinds[np.arange(V) % 3, np.arange(V)][:, None].astype(np.int32)


def test_cuda_kernels_match_plain_versions(card):
    ops.reset_launch_counts()
    args = [torch.from_numpy(a).to(card) for a in _segsel_inputs(5, 64, 363)]
    idx, score = tsegsel.segment_select_batch(*args)
    ridx, rscore = tref.segment_select_batch_ref(*args)
    assert torch.equal(idx, ridx) and torch.equal(score, rscore)
    assert int(idx[-1]) == -1
    i1, s1 = tsegsel.segment_select(*(a[0] for a in args[:4]), args[4][0], args[5][0])
    assert int(i1) == int(ridx[0]) and torch.equal(s1, rscore[0])
    rng = np.random.default_rng(6)
    v, g, c1, gc = (torch.from_numpy(rng.integers(0, hi, (14, 128)).astype(np.int32)).to(card)
                    for hi in (10_000, 100_000, 2, 2))
    ell = torch.linspace(1.0, 5000.0, 14, device=card)
    ell[0] = float("inf")
    sids = torch.arange(14, dtype=torch.int32, device=card)
    assert torch.equal(tclassify.classify(v, g, c1, gc, ell, sids),
                       tref.classify_ref(v, g, c1, gc, ell, sids))
    # the user write's (V, 1) batch: fresh LBAs give v = t + 2^30, which
    # rounds on its way to float32; ℓ near 2^30 makes the rounding decide
    uv = torch.from_numpy(_user_write_lifespans(7, 126)).to(card)
    uell = torch.tensor([np.inf, 2.0 ** 30 + 128, 20_000.5], device=card).repeat_interleave(42)
    usids = (torch.arange(126, device=card) // 3 % 14).to(torch.int32)
    z = torch.zeros_like(uv)
    assert torch.equal(tclassify.classify(uv, z, z, z, uell, usids, site="user"),
                       tref.classify_ref(uv, z, z, z, uell, usids))
    assert ops.launch_counts() == {"segment_select_batch": 1, "segment_select": 1,
                                   "classify_gc": 1, "classify_user": 1,
                                   "zipf_bit_sums": 0, "flash_decode": 0}


def test_card_fleet_matches_cpu_fleet(card):
    traces = make_fleet("mixed", 6, 256, 768, jitter=0.3, seed=17)
    schemes = np.asarray([2, 2, 0, 1, 7, 8])
    pol = {"p_scheme": schemes, "p_selector": np.asarray([1, 0, 1, 0, 1, 1]),
           "p_gp": np.asarray([0.08, 0.22, 0.12, 0.15, 0.2, 0.1], np.float32),
           "p_ncw": np.full(6, 16), "p_classes": np.asarray([6, 6, 1, 2, 3, 4]),
           "p_gcsched": np.zeros(6)}
    sized = TorchSimConfig(n_lbas=256, segment_size=16, class_slots=6, gp_threshold=0.22)
    cfg = TorchSimConfig(n_lbas=256, segment_size=16, class_slots=6, n_segments=sized.s_max)
    ops.reset_launch_counts()
    on_card = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    counts = ops.launch_counts()
    on_cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (on_cpu["reclaimed"] > 0).all()
    for key, want in on_cpu.items():
        assert on_card[key].dtype == want.dtype, key
        np.testing.assert_array_equal(on_card[key], want, err_msg=key)
    assert counts["segment_select_batch"] > 0
    assert counts["classify_gc"] > 0 and counts["classify_user"] > 0


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_zipf_kernel_matches_plain_and_repeats_bit_identically(card, alpha):
    """rtol 2e-4, atol 1e-6 (float32 sums in another order); a repeat on the
    same input is bit-identical (fixed order, no atomics)."""
    p = torch.from_numpy(zipf_probs((1 << 20) + 17, alpha)).to(card).float()
    G = analysis.BLOCKS_PER_GIB
    ops.reset_launch_counts()
    for exps in ((0.25 * G, 4 * G, 0.0, 0.0), (0.0, 0.0, 32 * G, 8 * G), (100.0, 400.0, 2e3, 8e2)):
        got = zipfprob.zipf_bit_sums(p, *exps)
        torch.testing.assert_close(got, tref.zipf_bit_sums_ref(p, *exps), rtol=2e-4, atol=1e-6)
        assert torch.equal(zipfprob.zipf_bit_sums(p, *exps), got)
    assert ops.launch_counts()["zipf_bit_sums"] == 6


@pytest.mark.parametrize("B,Hq,Hkv,D,S", [(2, 8, 2, 64, 700), (3, 24, 2, 128, 333),
                                          (2, 32, 32, 96, 300), (2, 64, 8, 128, 1100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(card, B, Hq, Hkv, D, S, dtype):
    """atol = rtol = 1e-4 in float32, 2e-2 in bfloat16, with the plain
    version's float32 products in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card, dtype)
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kl = rng.integers(1, S + 1, B)
    kl[0], kl[-1] = S, 1
    kl = torch.from_numpy(kl.astype(np.int32)).to(card)
    ops.reset_launch_counts()
    got = decode_attn.flash_decode(q, k, v, kl)
    assert ops.launch_counts()["flash_decode"] == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), tref.flash_decode_ref(q, k, v, kl).float(),
                               atol=tol, rtol=tol)
    with pytest.raises(ValueError, match=">= 1"):
        decode_attn.flash_decode(q, k, v, torch.zeros_like(kl))


def test_analysis_on_the_card_matches_the_cpu(card):
    """Closed form within abs 1e-5 (float32 sums in two orders); the trace
    conditionals exactly (integer counts)."""
    G = analysis.BLOCKS_PER_GIB
    ops.reset_launch_counts()
    for u0, v0, alpha in ((0.25, 4, 1.0), (1, 1, 0.0)):
        assert analysis.pr_user_bit(u0 * G, v0 * G, alpha=alpha, device=card) == pytest.approx(
            analysis.pr_user_bit(u0 * G, v0 * G, alpha=alpha, device="cpu"), abs=1e-5)
    assert analysis.pr_gc_bit(2 * G, 8 * G, device=card) == pytest.approx(
        analysis.pr_gc_bit(2 * G, 8 * G, device="cpu"), abs=1e-5)
    assert ops.launch_counts()["zipf_bit_sums"] == 3
    tr = mixed_trace(1 << 12, 6 << 12, seed=8, burst_echo_prob=0.3)
    for u0, v0 in ((400, 1600), (10, 0)):
        a = analysis.trace_conditional_user(tr, u0, v0, device=card)
        b = analysis.trace_conditional_user(tr, u0, v0, device="cpu")
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert (analysis.trace_conditional_gc(tr, 400, 2000, device=card)
            == analysis.trace_conditional_gc(tr, 400, 2000, device="cpu"))
