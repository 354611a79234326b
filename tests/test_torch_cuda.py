"""Card-only tests of the port: each CUDA kernel bit-equal to its plain
PyTorch version, and a fleet replayed through the kernels bit-equal to the
same fleet replayed on the CPU. Imports no JAX (the machine with the card has
none); every test skips where ``torch.cuda.is_available()`` is false."""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import torchsim
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.tracegen import make_fleet
from repro_torch.kernels import classify as tclassify
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
                                   "classify_gc": 1, "classify_user": 1}


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
