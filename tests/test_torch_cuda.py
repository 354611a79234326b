"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version (bit-equal for the replay engine's kernels, within a stated
tolerance for the float reductions), a fleet replayed through the kernels
bit-equal to the same fleet replayed on the CPU (the stateful schemes on the
replay kernel and on the step engine), the §3 analysis on the card against the CPU, the LM
decode step with K5 against its plain attention, and the train step and
checkpoints on the card against the CPU. Imports no JAX (the machine
with the card has none); every test skips where ``torch.cuda.is_available()``
is false."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.core import analysis, torchsim
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.tracegen import make_fleet
from repro_torch.core.traces import mixed_trace, zipf_probs
from repro_torch.kernels import classify as tclassify
from repro_torch.kernels import decode_attn, zipfprob
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segsel as tsegsel
from repro_torch.models import build_model, common
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import AdamWConfig, init_train_state, make_loss_fn, make_train_step
from repro_torch.training.train_loop import loss_and_grads

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
                                   "zipf_bit_sums": 0, "flash_decode": 0, "replay": 0,
                                   "replay_timing": 0}


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
    on_card = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card,
                                                        engine="step"))
    counts = ops.launch_counts()
    on_cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (on_cpu["reclaimed"] > 0).all()
    for key, want in on_cpu.items():
        assert on_card[key].dtype == want.dtype, key
        np.testing.assert_array_equal(on_card[key], want, err_msg=key)
    assert counts["segment_select_batch"] > 0
    assert counts["classify_gc"] > 0 and counts["classify_user"] > 0
    assert counts["replay"] == 0


def _hetero_fleet(seg, n=256, seed=17):
    """Unequal trace lengths (pad steps), per-volume GC thresholds and
    selectors, all five elementwise schemes; the last volume rewrites one
    LBA seg - 1 times under a threshold of 0, so it is over its threshold
    with garbage only in its open segment: no eligible victim, it stalls
    every step."""
    traces = make_fleet("mixed", 6, n, 3 * n, jitter=0.3, seed=seed)
    traces.append(np.zeros(seg - 1, np.int32))
    schemes = np.asarray([2, 2, 0, 1, 7, 8, 2])
    pol = {"p_scheme": schemes, "p_selector": np.asarray([1, 0, 1, 0, 1, 1, 1]),
           "p_gp": np.asarray([0.08, 0.22, 0.12, 0.15, 0.2, 0.1, 0.0], np.float32),
           "p_ncw": np.asarray([16, 8, 16, 16, 24, 16, 16]),
           "p_classes": np.asarray([6, 6, 1, 2, 3, 4, 6]), "p_gcsched": np.zeros(7)}
    sized = TorchSimConfig(n_lbas=n, segment_size=seg, class_slots=6, gp_threshold=0.22)
    cfg = TorchSimConfig(n_lbas=n, segment_size=seg, class_slots=6, n_segments=sized.s_max)
    return cfg, traces, pol


def _replay_both(cfg, traces, pol, device):
    """The fleet under the replay kernel and the step engine on ``device``:
    their final states (numpy), their `ReplayStats` and the launch counts of
    each."""
    out = []
    for engine in ("replay", "step"):
        stats = torchsim.ReplayStats()
        ops.reset_launch_counts()
        st = torchsim.run_fleet(cfg, traces, pol, device=device, stats=stats, engine=engine)
        out.append((convert.state_to_numpy(st), stats, ops.launch_counts()))
    return out


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seg", [8, 64, 128])
def test_replay_kernel_matches_step_engine_and_cpu(card, seg):
    """Bit-equal on every state key: the replay kernel, the step engine on
    the card and the step engine on the CPU; the same `ReplayStats`; one
    launch; a repeat bit-identical."""
    cfg, traces, pol = _hetero_fleet(seg, n=256 if seg == 8 else 2048)
    (rep, rstats, rcounts), (step, sstats, scounts) = _replay_both(cfg, traces, pol, card)
    cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu",
                                                    engine="step"))
    assert (cpu["reclaimed"][:6] > 0).all() and cpu["reclaimed"][6] == 0
    assert cpu["overflow"].sum() == 0
    _assert_same_state(rep, cpu)
    _assert_same_state(step, cpu)
    assert (rstats.steps, rstats.gc_ticks, rstats.tick_iterations) == \
        (sstats.steps, sstats.gc_ticks, sstats.tick_iterations)
    assert rstats.host_syncs == 1 and sstats.host_syncs > sstats.steps
    assert rcounts["replay"] == 1 and rcounts["segment_select_batch"] == 0
    assert rcounts["classify_gc"] == rcounts["classify_user"] == 0
    assert scounts["replay"] == 0 and scounts["segment_select_batch"] > 0
    again = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    _assert_same_state(again, rep)


@pytest.mark.parametrize("max_gc", [1, 2])
def test_replay_kernel_max_gc_per_step(card, max_gc):
    """Thresholds of 0-2 % make steps need several GC iterations, so a cap
    of 1 or 2 binds (the uncapped replay runs more iterations): the kernel
    equals the step engine on the card and on the CPU."""
    cfg, traces, pol = _hetero_fleet(8, n=256, seed=31)
    pol = dict(pol, p_gp=np.asarray([0.0, 0.02, 0.0, 0.01, 0.0, 0.02, 0.0], np.float32))
    capped = dataclasses.replace(cfg, max_gc_per_step=max_gc)
    (rep, rstats, _), (step, sstats, _) = _replay_both(capped, traces, pol, card)
    cpu = convert.state_to_numpy(torchsim.run_fleet(capped, traces, pol, device="cpu"))
    _assert_same_state(rep, cpu)
    _assert_same_state(step, cpu)
    assert (rstats.gc_ticks, rstats.tick_iterations) == (sstats.gc_ticks, sstats.tick_iterations)
    uncapped = torchsim.ReplayStats()
    torchsim.run_fleet(cfg, traces, pol, device=card, stats=uncapped)
    assert uncapped.tick_iterations > rstats.tick_iterations >= max_gc


def test_replay_kernel_single_volume_equals_fleet_row(card):
    """`run` (V = 1) under the replay kernel equals the volume's fleet row,
    and the step engine's single-volume path (K2)."""
    cfg, traces, pol = _hetero_fleet(16, n=512)
    fleet = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    for i in (0, 4):
        one = {k: v[i:i + 1] for k, v in pol.items()}
        ops.reset_launch_counts()
        alone = convert.state_to_numpy(torchsim.run(cfg, traces[i], one, device=card))
        assert ops.launch_counts()["replay"] == 1
        step = convert.state_to_numpy(torchsim.run(cfg, traces[i], one, device=card,
                                                   engine="step"))
        assert ops.launch_counts()["segment_select"] > 0
        for key in fleet:
            np.testing.assert_array_equal(alone[key][0], fleet[key][i], err_msg=key)
            np.testing.assert_array_equal(step[key][0], fleet[key][i], err_msg=key)


def test_replay_kernel_exhaustion_corner_matches_cpu(card):
    """The undersized pool where classes alias the pad row and scatters meet
    duplicate targets: the kernel writes them in slot and class order, so it
    equals the CPU step engine bit for bit."""
    cfg = TorchSimConfig(n_lbas=96, segment_size=8, n_segments=16, gp_threshold=0.10)
    tr = np.asarray(np.random.default_rng(67).integers(0, 96, size=6 * 96), np.int32)
    rep = convert.state_to_numpy(torchsim.run(cfg, tr, device=card))
    cpu = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu", engine="step"))
    assert int(cpu["overflow"][0]) > 0
    _assert_same_state(rep, cpu)


def test_replay_kernel_continues_a_replay(card):
    """A replay split in two (the second half from the first's state) ends
    where one replay of the whole trace ends."""
    cfg, traces, pol = _hetero_fleet(16, n=256)
    padded = torchsim.pad_fleet(traces)
    whole = convert.state_to_numpy(torchsim.run_fleet(cfg, padded, pol, device=card))
    half = padded.shape[1] // 2
    mid = torchsim.run_fleet(cfg, padded[:, :half], pol, device=card)
    end = convert.state_to_numpy(torchsim.run_fleet(cfg, padded[:, half:], device=card,
                                                    state=mid))
    _assert_same_state(end, whole)


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


def _zipf_batch(n_points):
    """(P, 4) exponents cycling through Fig 8 rows (u0, v0 only), Fig 10 rows
    (g0, r0 only), all-zero rows and a mixed row; the rows that are not
    all zero are distinct."""
    G = analysis.BLOCKS_PER_GIB
    kinds = ((0.25 * G, 4 * G, 0.0, 0.0), (0.0, 0.0, 32 * G, 8 * G), (0.0, 0.0, 0.0, 0.0),
             (100.0, 400.0, 2e3, 8e2), (0.0, 900.0, 0.0, 0.0), (0.0, 0.0, 1500.0, 0.0))
    return [tuple(x * (1 + i // len(kinds)) for x in kinds[i % len(kinds)])
            for i in range(n_points)]


@pytest.mark.parametrize("n_of", [lambda chunk: 1000, lambda chunk: 3 * chunk + 17,
                                  lambda chunk: (1 << 20) + 17], ids=["short", "ragged", "large"])
@pytest.mark.parametrize("n_points", [1, 6, 40, zipfprob.MAX_POINTS])
def test_zipf_batch_kernel_matches_plain_and_single_calls(card, n_of, n_points):
    """A batch of one to `MAX_POINTS` points (more than one group of the
    kernel's block reductions from 40 on), with zero-exponent rows, over
    pmfs shorter than a block's chunk and not a multiple of it: within rtol
    2e-4, atol 1e-6 of the plain version; equal bit for bit to its points
    launched one at a time; a repeat bit-identical; one launch; the sums an
    all-zero row leaves at 0 exactly 0."""
    chunk = zipfprob.batch_grid(1)["chunk"]
    n = n_of(chunk)
    assert n % chunk != 0
    p = torch.from_numpy(zipf_probs(n, 1.0)).to(card).float()
    exps = _zipf_batch(n_points)
    ops.reset_launch_counts()
    got = zipfprob.zipf_bit_sums_batch(p, exps)
    assert ops.launch_counts()["zipf_bit_sums"] == 1
    assert ops.point_counts()["zipf_bit_sums"] == n_points
    assert got.shape == (n_points, 4) and got.dtype == torch.float32
    torch.testing.assert_close(got, tref.zipf_bit_sums_batch_ref(p, exps), rtol=2e-4, atol=1e-6)
    assert torch.equal(zipfprob.zipf_bit_sums_batch(p, exps), got)
    singles = [zipfprob.zipf_bit_sums(p, *e) for e in exps[:12]] + [
        zipfprob.zipf_bit_sums(p, *exps[-1])]
    assert torch.equal(torch.stack(singles), torch.cat([got[:12], got[-1:]]))
    zero = got[[i for i, e in enumerate(exps) if not any(e)]]
    assert (zero[:, [0, 1, 3]] == 0).all() and (zero[:, 2] > 0).all()
    no_g0 = got[[i for i, e in enumerate(exps) if e[2] == 0], 2]
    assert (no_g0 == no_g0[0]).all()            # Σp(1-p)^0 is one sum, whatever u0, v0, r0


def test_zipf_batch_kernel_edges(card):
    """An empty pmf gives zero sums; a batch of no points launches nothing;
    a batch over the cap raises before any launch; exponents given as a
    tensor on the card equal the same given as tuples."""
    ops.reset_launch_counts()
    empty = torch.zeros(0, device=card)
    assert torch.equal(zipfprob.zipf_bit_sums_batch(empty, [(1.0, 2.0, 3.0, 4.0)]),
                       torch.zeros(1, 4, device=card))
    p = torch.from_numpy(zipf_probs(5000, 0.6)).to(card).float()
    assert zipfprob.zipf_bit_sums_batch(p, []).shape == (0, 4)
    with pytest.raises(ValueError, match="at most"):
        zipfprob.zipf_bit_sums_batch(p, _zipf_batch(zipfprob.MAX_POINTS + 1))
    assert ops.launch_counts()["zipf_bit_sums"] == 1
    exps = _zipf_batch(9)
    assert torch.equal(zipfprob.zipf_bit_sums_batch(p, torch.tensor(exps, device=card)),
                       zipfprob.zipf_bit_sums_batch(p, exps))


@pytest.mark.parametrize("n, ones_at", [(1, (0,)), (1000, (5,)), ((1 << 20) + 17, (3, 700_000))],
                         ids=["n1", "short", "large"])
def test_zipf_batch_kernel_at_a_p_of_one(card, n, ones_at):
    """A p of 1 makes log1p(-p) -inf, so a zero exponent gives NaN sums in
    the plain version: the kernel skips no zero exponent in a block that
    holds one, and matches it, NaN for NaN, within rtol 2e-4, atol 1e-6
    elsewhere (the other blocks keep their skips); a batch equals its
    single-point launches."""
    p = torch.from_numpy(zipf_probs(n, 1.0)).to(card).float()
    p[list(ones_at)] = 1.0
    exps = _zipf_batch(12)
    got = zipfprob.zipf_bit_sums_batch(p, exps)
    want = tref.zipf_bit_sums_batch_ref(p, exps)
    assert torch.isnan(want).any() and torch.isfinite(want).any()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6, equal_nan=True)
    singles = torch.stack([zipfprob.zipf_bit_sums(p, *e) for e in exps])
    torch.testing.assert_close(singles, got, rtol=0, atol=0, equal_nan=True)


def test_zipf_batch_kernel_on_concurrent_streams(card):
    """Launches on two streams at once, each several batches deep, each
    with its own scratch and ticket: every row equals the same batch on
    the default stream bit for bit."""
    n = (1 << 20) + 17
    p = torch.from_numpy(zipf_probs(n, 0.6)).to(card).float()
    exps = [_zipf_batch(k) for k in (40, 7, zipfprob.MAX_POINTS)]
    want = [zipfprob.zipf_bit_sums_batch(p, e) for e in exps]
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    torch.cuda.synchronize(card)
    got = {}
    for rep in range(4):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[rep, i] = [zipfprob.zipf_bit_sums_batch(p, e) for e in exps]
    torch.cuda.synchronize(card)
    keys = {(p.device, s.cuda_stream) for s in streams}
    assert keys <= set(zipfprob._buffers)
    for rows in got.values():
        for a, b in zip(rows, want):
            assert torch.equal(a, b)


def test_figures_launch_once_per_pmf_on_the_card(card):
    """Each figure launches the kernel once per pmf and reads it once; its
    values equal the points through `pr_user_bit` / `pr_gc_bit` on the card
    bit for bit, and the CPU's within abs 1e-5."""
    n = 1 << 16
    s = n / analysis.PAPER_N
    w = tuple(s * x for x in (0.25, 0.5, 1, 2, 4))
    g = tuple(s * x for x in (2, 4, 8, 16, 32))
    G = analysis.BLOCKS_PER_GIB
    for fig, kwargs, pmfs, point in (
            (analysis.fig8a_grid, dict(u0_gib=w, v0_gib=w), 1,
             lambda k, kw: analysis.pr_user_bit(k[0] * G, k[1] * G, n=n, device=card)),
            (analysis.fig8b_curve, dict(u0_gib=s, v0_gib=w), 6,
             lambda k, kw: analysis.pr_user_bit(s * G, k[1] * G, n=n, alpha=k[0], device=card)),
            (analysis.fig10a_grid, dict(g0_gib=g, r0_gib=tuple(s * x for x in (1, 2, 4, 8))), 1,
             lambda k, kw: analysis.pr_gc_bit(k[0] * G, k[1] * G, n=n, device=card)),
            (analysis.fig10b_curve, dict(r0_gib=8 * s, g0_gib=g), 6,
             lambda k, kw: analysis.pr_gc_bit(k[1] * G, 8 * s * G, n=n, alpha=k[0],
                                              device=card))):
        ops.reset_launch_counts()
        got = fig(n=n, device=card, **kwargs)
        assert ops.launch_counts()["zipf_bit_sums"] == pmfs, fig.__name__
        assert ops.point_counts()["zipf_bit_sums"] == len(got), fig.__name__
        cpu = fig(n=n, device="cpu", **kwargs)
        for key, value in got.items():
            assert value == point(key, kwargs), (fig.__name__, key)
            assert value == pytest.approx(cpu[key], abs=1e-5), (fig.__name__, key)


def _assert_decode_close(got, q, k, v, kl):
    """atol = rtol = 1e-4 in float32, 2e-2 in bfloat16, against the plain
    version with its float32 products in full float32 (TF32 off); and within
    atol 1e-4, rtol 1e-4 (float32) or 2^-8 (bfloat16, half an ulp of the
    output's rounding) of the plain version in float32 on the same values."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), tref.flash_decode_ref(q, k, v, kl).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(),
                               tref.flash_decode_ref(q.float(), k.float(), v.float(), kl),
                               atol=1e-4, rtol=2.0 ** -8 if q.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("B,Hq,Hkv,D,S", [(2, 8, 2, 64, 700), (3, 24, 2, 128, 333),
                                          (2, 32, 32, 96, 300), (2, 64, 8, 128, 1100),
                                          (8, 24, 8, 64, 120), (8, 24, 8, 64, 1056)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(card, B, Hq, Hkv, D, S, dtype):
    """Within the tolerances of `_assert_decode_close`."""
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card, dtype)
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kl = rng.integers(1, S + 1, B)
    kl[0], kl[-1] = S, 1
    kl = torch.from_numpy(kl.astype(np.int32)).to(card)
    ops.reset_launch_counts()
    got = decode_attn.flash_decode(q, k, v, kl)
    assert ops.launch_counts()["flash_decode"] == 1
    _assert_decode_close(got, q, k, v, kl)
    with pytest.raises(ValueError, match=">= 1"):
        decode_attn.flash_decode(q, k, v, torch.zeros_like(kl))


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8, 12, 16, 64])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_edges(card, G, D, dtype):
    """The split kernel at the edges of its chunks: kv_len chunk - 1, chunk,
    chunk + 1, 1 and above S, with S not a multiple of the chunk, at every
    query-head tile (1, 2, 4 and 8, full and partial); within the tolerances
    of `_assert_decode_close`, within atol = rtol = 1e-4 (float32) or 2e-2
    (bfloat16) of the plain split-and-combine version, and bit-identical on
    a repeat."""
    Hkv = 2
    chunk = decode_attn.split_grid(1, 1, Hkv * G, Hkv, D)["chunk"]
    B, S = 5, 2 * chunk + 37
    rng = np.random.default_rng(G * D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card, dtype)
               for s in ((B, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kl = torch.tensor([chunk - 1, chunk, chunk + 1, 1, S + 100], dtype=torch.int32, device=card)
    ops.reset_launch_counts()
    got = decode_attn.flash_decode(q, k, v, kl)
    assert ops.launch_counts()["flash_decode"] == 1
    _assert_decode_close(got, q, k, v, kl)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(),
                               tref.flash_decode_split_ref(q, k, v, kl, chunk).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(decode_attn.flash_decode(q, k, v, kl), got)


def test_flash_decode_rejects_unaligned_tensors(card):
    q = torch.zeros(1, 8, 64, device=card)
    kv = torch.zeros(1 * 16 * 1 * 64 + 1, device=card)[1:].view(1, 16, 1, 64)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attn.flash_decode(q, kv, kv, torch.full((1,), 16, dtype=torch.int32, device=card))


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


def _sms(card):
    return torch.cuda.get_device_properties(card).multi_processor_count


def _policies(V, seed):
    """Per-volume elementwise schemes, selectors and GC thresholds."""
    from repro_torch.core.config import SCHEME_CLASSES
    rng = np.random.default_rng(seed)
    sch = rng.choice([0, 1, 2, 7, 8], V)
    return {"p_scheme": sch, "p_selector": rng.integers(0, 2, V),
            "p_gp": rng.choice(np.asarray([0.08, 0.12, 0.15, 0.2], np.float32), V),
            "p_ncw": np.full(V, 16), "p_classes": np.asarray(SCHEME_CLASSES)[sch],
            "p_gcsched": np.zeros(V)}


def test_replay_kernel_fleet_of_one_more_than_a_multiple_of_the_block(card):
    """V = 4 n_sms + 1 volumes: four a block, the last block holding one
    (its three spare warps return at once); every volume equal to the CPU
    step engine on every key."""
    from repro_torch.kernels import replay as kreplay
    V = 4 * _sms(card) + 1
    cfg = TorchSimConfig(n_lbas=128, segment_size=8, class_slots=6)
    geo = kreplay.geometry(cfg, V, n_sms=_sms(card))
    assert geo.warps == 4 and V % geo.warps == 1 and geo.shared_meta
    traces = make_fleet("mixed", V, 128, 3 * 128, jitter=0.3, seed=41)
    pol = _policies(V, 41)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    _kernel_only(ops.launch_counts())
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state(got, want)


def test_replay_kernel_fleet_past_one_wave(card):
    """More small volumes than the card holds at once (a second wave of
    blocks starts as the first ones end): checked on the CPU on volumes of
    the first and of the last wave, every key."""
    from repro_torch.core.config import init_state
    from repro_torch.kernels import replay as kreplay
    cfg = TorchSimConfig(n_lbas=64, segment_size=8, class_slots=6)
    V = 9000                  # past 16 blocks of 4 on 132 SMs, the most any instance keeps
    traces = make_fleet("mixed", V, 64, 3 * 64, jitter=0.3, seed=43)
    pol = _policies(V, 43)
    padded = torchsim.pad_fleet(traces)
    trace = torch.from_numpy(padded).to(card)
    st = torchsim.own_state(init_state(cfg, pol, card))
    inst = kreplay.check_inputs(cfg, st, trace)
    occ = kreplay.occupancy(cfg, V, inst, card)
    assert occ["shared_meta"] and occ["waves"] >= 2, occ
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    sub = list(range(0, 40)) + list(range(V - 40, V))
    want = convert.state_to_numpy(torchsim.run_fleet(
        cfg, padded[sub], {k: np.asarray(v)[sub] for k, v in pol.items()}, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state({k: x[sub] for k, x in got.items()}, want)


@pytest.mark.parametrize("schemes", ["elementwise", "all"])
def test_replay_kernel_keeps_metadata_in_global_memory(card, schemes):
    """A pool of 6,000 segments: four volumes' metadata would not fit a
    block, so it stays in global memory (the instance without kSharedMeta);
    equal to the CPU on every key, for the elementwise and the stateful
    instance."""
    from repro_torch.kernels import replay as kreplay
    if schemes == "all":
        cfg, traces, pol = _all_schemes_fleet()
        cfg = dataclasses.replace(cfg, n_segments=6000)
    else:
        cfg, traces, pol = _hetero_fleet(8, n=512)
        cfg = dataclasses.replace(cfg, n_segments=6000)
    assert not kreplay.geometry(cfg, len(traces), schemes == "all", n_sms=_sms(card)).shared_meta
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    _kernel_only(ops.launch_counts())
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert want["reclaimed"].sum() > 0
    _assert_same_state(got, want)


def test_replay_kernel_pad_row_counts_past_16_bits(card):
    """The exhaustion corner from a state whose pad row counts 70,000 valid
    blocks: the pad row's counts are 32-bit in shared memory, so the kernel
    equals the CPU on every key (a row's other counts stay in [0, s])."""
    from repro_torch.core.config import init_state
    from repro_torch.kernels import replay as kreplay
    cfg = TorchSimConfig(n_lbas=96, segment_size=8, n_segments=16, gp_threshold=0.10)
    assert kreplay.geometry(cfg, 1).shared_meta
    tr = np.asarray(np.random.default_rng(67).integers(0, 96, size=6 * 96), np.int32)
    st = init_state(cfg, None, "cpu")
    st["seg_nvalid"][:, cfg.pad_row] = 70_000
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card,
                                              state={k: v.to(card) for k, v in st.items()}))
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu", state=st))
    assert int(want["overflow"][0]) > 0 and abs(int(want["seg_nvalid"][0, cfg.pad_row])) > 65_535
    _assert_same_state(got, want)


def test_replay_kernel_stateful_instance_replays_elementwise_volumes_alike(card):
    """The stateful instance (kStateful), handed a fleet of elementwise
    volumes only, equals the step engine on the CPU on every key, with its
    GC ticks and tick iterations, and so does the elementwise instance."""
    from repro_torch.core.config import init_state
    from repro_torch.kernels import replay as kreplay
    cfg, traces, pol = _hetero_fleet(16, n=512)
    trace = torch.from_numpy(torchsim.pad_fleet(traces)).to(card)
    stats = torchsim.ReplayStats()
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu",
                                                     stats=stats))
    assert want["reclaimed"].sum() > 0
    for stateful in (False, True):
        st = torchsim.own_state(init_state(cfg, pol, card))
        inst = kreplay.check_inputs(cfg, st, trace)
        assert not inst.stateful
        iterations = torch.zeros(trace.shape[1], dtype=torch.int32, device=card)
        kreplay.launch(cfg, st, trace, iterations, inst._replace(stateful=stateful))
        _assert_same_state(convert.state_to_numpy(st), want)
        per_step = iterations.cpu()
        assert (int((per_step > 0).sum()), int(per_step.sum())) == \
            (stats.gc_ticks, stats.tick_iterations), stateful


STATEFUL = ["fk", "dac", "ml", "sfs", "eti", "mq", "sfr", "fadac", "warcip"]


def _all_schemes_fleet(n=512, seed=19):
    """One volume per scheme (all 14), unequal lengths, mixed selectors and
    GC thresholds, six class slots; sfs refreshes every 64 writes."""
    from repro_torch.core.config import SCHEME_CLASSES
    V = len(SCHEME_CLASSES)
    traces = make_fleet("mixed", V, n, 3 * n, jitter=0.3, seed=seed)
    sch = np.arange(V)
    pol = {"p_scheme": sch, "p_selector": sch % 2,
           "p_gp": np.asarray([0.08, 0.12, 0.16, 0.22, 0.1, 0.15, 0.2] * 2, np.float32),
           "p_ncw": np.full(V, 16), "p_classes": np.asarray(SCHEME_CLASSES)[sch],
           "p_gcsched": np.zeros(V)}
    sized = TorchSimConfig(n_lbas=n, segment_size=16, class_slots=6, gp_threshold=0.22)
    cfg = TorchSimConfig(n_lbas=n, segment_size=16, class_slots=6, n_segments=sized.s_max,
                         sfs_resample=64)
    return cfg, traces, pol


@pytest.mark.parametrize("scheme", STATEFUL)
def test_stateful_scheme_single_volume_on_the_card_matches_cpu(card, scheme):
    """`run(..., engine="step")` of one volume on the card (victims from
    K2) equals the CPU on every key, ``sch_*`` included."""
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, scheme=scheme, sfs_resample=64)
    tr = mixed_trace(512, 3 * 512, seed=23)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card, engine="step"))
    counts = ops.launch_counts()
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert int(want["reclaimed"][0]) > 0
    _assert_same_state(got, want)
    assert counts["segment_select"] > 0 and counts["replay"] == 0


def test_all_schemes_fleet_on_the_card_matches_cpu(card):
    """The 14-scheme fleet through the step engine on the card (K1, K3)
    equals the CPU on every key; the elementwise volumes alone under the
    replay kernel equal their rows."""
    cfg, traces, pol = _all_schemes_fleet()
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card,
                                                    engine="step"))
    counts = ops.launch_counts()
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state(got, want)
    assert counts["segment_select_batch"] > 0 and counts["classify_gc"] > 0
    assert counts["classify_user"] > 0 and counts["replay"] == 0
    ew = [0, 1, 2, 7, 8]
    alone = convert.state_to_numpy(torchsim.run_fleet(
        cfg, [traces[i] for i in ew], {k: np.asarray(v)[ew] for k, v in pol.items()},
        device=card))
    for key in alone:
        np.testing.assert_array_equal(alone[key], want[key][ew], err_msg=key)


def _kernel_only(counts, name="replay"):
    """One launch of the replay kernel (``name``: its timing model's count
    or not) and none of K1, K2 or K3."""
    assert counts[name] == 1, counts
    assert counts["segment_select_batch"] == counts["segment_select"] == 0, counts
    assert counts["classify_gc"] == counts["classify_user"] == 0, counts


@pytest.mark.parametrize("scheme", STATEFUL)
def test_replay_kernel_stateful_scheme_single_volume_matches_cpu(card, scheme):
    """`run` of one volume under each stateful scheme on the card's default
    engine: one launch of the replay kernel (V = 1), equal to the CPU step
    engine on every key, ``sch_*`` included; sfs refreshes its bounds every
    64 writes (24 times)."""
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, scheme=scheme, sfs_resample=64)
    tr = mixed_trace(512, 3 * 512, seed=23)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card))
    _kernel_only(ops.launch_counts())
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert int(want["reclaimed"][0]) > 0
    _assert_same_state(got, want)
    if scheme == "sfs":
        assert want["sch_sfs_ready"].all() and (want["sch_sfs_bounds"] > 0).all()


def test_replay_kernel_takes_the_14_scheme_fleet(card):
    """The 14-scheme fleet, which the replay kernel refused before ROADMAP
    item 4b: one launch, equal on every key to the CPU step engine and to
    the card's step engine, with the same counts; a repeat bit-identical."""
    cfg, traces, pol = _all_schemes_fleet()
    (rep, rstats, rcounts), (step, sstats, _) = _replay_both(cfg, traces, pol, card)
    _kernel_only(rcounts)
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state(rep, want)
    _assert_same_state(step, want)
    assert (rstats.steps, rstats.gc_ticks, rstats.tick_iterations) == \
        (sstats.steps, sstats.gc_ticks, sstats.tick_iterations)
    _assert_same_state(convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol,
                                                                 device=card)), rep)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_replay_kernel_k_victims_and_fifo_samples_match_cpu(card, k):
    """GC operations of k victims and SepBIT's FIFO samples (the paper's
    Exp#2 and Exp#5) on the 14-scheme fleet: one launch, equal on every key,
    fifo_peak and fifo_last included, to the CPU step engine and to the
    card's step engine, with the same counts; only sepbit's and uw's
    volumes sampled."""
    cfg, traces, pol = _all_schemes_fleet()
    cfg = dataclasses.replace(cfg, gc_batch_segments=k, fifo_occupancy=True)
    (rep, rstats, rcounts), (step, sstats, _) = _replay_both(cfg, traces, pol, card)
    _kernel_only(rcounts)
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state(rep, want)
    _assert_same_state(step, want)
    assert (rstats.steps, rstats.gc_ticks, rstats.tick_iterations) == \
        (sstats.steps, sstats.gc_ticks, sstats.tick_iterations)
    sampled = np.isin(pol["p_scheme"], [2, 7])
    assert (want["fifo_peak"][sampled] > 0).all() and (want["fifo_peak"][~sampled] == -1).all()
    assert (want["fifo_last"] <= want["fifo_peak"]).all()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("where", ["shared", "global", "exhaustion"])
def test_replay_kernel_k_victims_elementwise_match_cpu(card, where, k):
    """GC operations of k victims through the elementwise instance, with
    the segment metadata in shared memory (a stalling volume, pad steps,
    mixed selectors) or in global memory (a pool of 6,000 segments), and in
    the free-pool exhaustion corner, where the pad row is sealed inside an
    operation: equal to the CPU step engine on every key."""
    if where == "exhaustion":
        cfg = TorchSimConfig(n_lbas=96, segment_size=8, n_segments=16, gp_threshold=0.10,
                             gc_batch_segments=k, fifo_occupancy=True)
        traces = [np.asarray(np.random.default_rng(67).integers(0, 96, size=6 * 96), np.int32)]
        pol = None
    else:
        cfg, traces, pol = _hetero_fleet(32, n=1024)
        cfg = dataclasses.replace(cfg, gc_batch_segments=k, fifo_occupancy=True,
                                  n_segments=6000 if where == "global" else cfg.n_segments)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    _kernel_only(ops.launch_counts())
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert want["reclaimed"].sum() > 0
    assert (int(want["overflow"].sum()) > 0) == (where == "exhaustion")
    _assert_same_state(got, want)


@pytest.mark.parametrize("sched", ["greedy", "mixed"])
def test_replay_kernel_all_schemes_timing_and_idle_window(card, sched):
    """The 14-scheme fleet with the timing model on, all greedy or mixing
    the three GC schedules (idle_window volumes among them, so the kernel's
    kTiming, kDefer and kStateful instance runs): one launch, equal to the
    CPU on every key, lat_* and sch_* included."""
    cfg, traces, pol = _all_schemes_fleet()
    cfg = dataclasses.replace(cfg, timing=True, write_cost=0.7, gc_block_cost=1.3)
    pol = dict(pol, p_gcsched=np.zeros(14) if sched == "greedy" else np.arange(14) % 3)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    _kernel_only(ops.launch_counts(), "replay_timing")
    want = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all() and (want["lat_hist"].sum(1) == want["user_writes"]).all()
    _assert_same_state(got, want)


def _state_near(cfg, pol, t0, tables):
    """An initial state whose clock ``t`` starts at ``t0`` and whose ``sch_*``
    entries named in ``tables`` start at the given values."""
    from repro_torch.core.config import init_state
    st = init_state(cfg, pol, "cpu")
    st["t"].fill_(t0)
    for key, value in tables.items():
        st[key].copy_(torch.as_tensor(value, dtype=st[key].dtype).expand_as(st[key]))
    return st


@pytest.mark.parametrize("scheme,period", [("eti", 1 << 15), ("fadac", 1 << 16)])
def test_replay_kernel_stateful_decay_boundaries_match_cpu(card, scheme, period):
    """eti's 2^15-write and fadac's 2^16-write decay: a replay that starts
    just below the boundary with every counter at 1-40 (last updated at
    time, or epoch, 0) crosses it, halving the counters read after it, on
    the user writes and, for fadac, the GC reads; the kernel equals the CPU
    on every key."""
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, scheme=scheme)
    tr = mixed_trace(512, 3 * 512, seed=31)
    rng = np.random.default_rng(5)
    n_tab = -(-512 // (256 if scheme == "eti" else 64))
    st = _state_near(cfg, None, period - 700, {
        f"sch_{scheme}_count": rng.integers(1, 41, n_tab), f"sch_{scheme}_last": 0})
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card,
                                              state={k: v.to(card) for k, v in st.items()}))
    _kernel_only(ops.launch_counts())
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu", state=st))
    assert int(want["reclaimed"][0]) > 0 and int(want["t"][0]) > period
    _assert_same_state(got, want)


def test_replay_kernel_stateful_fk_next_write_stream(card):
    """fk reads its next-write stream beside the trace: made by `run_fleet`
    from the traces (the annotations the CPU makes) or given, here a stream
    that differs from them; each equal to the CPU step engine with the same
    stream, one launch each."""
    from repro_torch.core import annotate
    cfg, traces, pol = _all_schemes_fleet()
    padded = torchsim.pad_fleet(traces)
    made = annotate.fleet_annotations(padded, pol["p_scheme"])
    rng = np.random.default_rng(9)
    T = padded.shape[1]
    odd = np.where(made < 1 << 30, made + rng.integers(0, 64, made.shape), made).astype(np.int32)
    for nxts in (None, made, odd):
        ops.reset_launch_counts()
        got = convert.state_to_numpy(torchsim.run_fleet(cfg, padded, pol, device=card,
                                                        nxts=nxts))
        _kernel_only(ops.launch_counts())
        want = convert.state_to_numpy(torchsim.run_fleet(cfg, padded, pol, device="cpu",
                                                         nxts=made if nxts is None else nxts))
        _assert_same_state(got, want)
    assert T > 1000 and not np.array_equal(odd, made)


# -- the timing model and the GC schedules (replay kernel, step engine) ---------

SCHEDULES = {"greedy": [0] * 7, "rate_limited": [1] * 7, "idle_window": [2] * 7,
             "mixed": [0, 1, 2, 0, 1, 2, 2]}


@pytest.mark.parametrize("costs", [(1.0, 1.0), (0.7, 1.3)])
@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_replay_kernel_timing_matches_step_engine_and_cpu(card, sched, costs):
    """With the timing model on, each GC schedule (and a fleet mixing them),
    unequal lengths with pad steps, a stalling volume and non-unit costs:
    the replay kernel, the step engine on the card and the step engine on
    the CPU end bit-equal on every key, lat_* included, with one launch."""
    cfg, traces, pol = _hetero_fleet(16, n=512, seed=37)
    cfg = dataclasses.replace(cfg, timing=True, write_cost=costs[0], gc_block_cost=costs[1])
    pol = dict(pol, p_gcsched=np.asarray(SCHEDULES[sched]))
    (rep, rstats, rcounts), (step, sstats, _) = _replay_both(cfg, traces, pol, card)
    cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device="cpu"))
    assert (cpu["reclaimed"][:6] > 0).any() and cpu["overflow"].sum() == 0
    assert (cpu["lat_hist"].sum(1) == cpu["user_writes"]).all()
    np.testing.assert_allclose(cpu["lat_charged"] + cpu["lat_debt"],
                               cpu["gc_writes"] * np.float32(costs[1]), rtol=1e-3)
    _assert_same_state(rep, cpu)
    _assert_same_state(step, cpu)
    assert (rstats.steps, rstats.gc_ticks, rstats.tick_iterations) == \
        (sstats.steps, sstats.gc_ticks, sstats.tick_iterations)
    assert rcounts["replay_timing"] == 1 and rcounts["replay"] == 0


def test_replay_kernel_timing_off_leaves_lat_keys_and_decisions(card):
    """Timing off: every lat_* key but the density EWMA stays at its initial
    value, and the other keys equal the timing-on greedy replay's (timing
    only observes greedy and rate_limited GC)."""
    cfg, traces, pol = _hetero_fleet(16, n=512)
    off = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card))
    on = convert.state_to_numpy(torchsim.run_fleet(dataclasses.replace(cfg, timing=True),
                                                   traces, pol, device=card))
    lat = ("lat_now", "lat_busy", "lat_debt", "lat_charged", "lat_sum", "lat_max", "lat_hist")
    for key in off:
        if key in lat:
            assert not off[key].any(), key
        else:
            np.testing.assert_array_equal(off[key], on[key], err_msg=key)
    assert on["lat_hist"].sum() == on["user_writes"].sum()
    rate = dict(pol, p_gcsched=np.ones(7))
    limited = convert.state_to_numpy(torchsim.run_fleet(dataclasses.replace(cfg, timing=True),
                                                        traces, rate, device=card))
    assert (limited["gc_writes"] == on["gc_writes"]).all()


def test_grouped_sweep_equals_ungrouped_on_the_card(card):
    """A timing sweep of the elementwise schemes through the replay kernel:
    grouped (one launch per scheme) equals ungrouped (one launch) and the
    CPU on every key and every sweep row."""
    from repro_torch.core import fleetshard
    from repro_torch.core.tracegen import tiled_fleet
    args = dict(schemes=["nosep", "sepgc", "sepbit", "uw", "gw"], selectors=["greedy"],
                gp_thresholds=[0.1, 0.2], gcsched="rate_limited")
    traces = tiled_fleet("mixed", 10, 2, 512, 3 * 512, jitter=0.25, seed=53)
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, timing=True)
    out = {}
    for name, group, device in (("grouped", True, card), ("ungrouped", False, card),
                                ("cpu", True, "cpu")):
        ops.reset_launch_counts()
        res = fleetshard.simulate_fleet_sweep(traces, cfg, group=group, device=device, **args)
        out[name] = (res, ops.launch_counts()["replay_timing"])
    assert out["grouped"][1] == 5 and out["ungrouped"][1] == 1 and out["cpu"][1] == 0
    for name in ("ungrouped", "cpu"):
        assert out[name][0]["volumes"] == out["grouped"][0]["volumes"]
        assert out[name][0]["sweep"] == out["grouped"][0]["sweep"]


def test_hetero_replay_takes_a_stateful_group(card):
    """A hetero replay with a stateful group, which the replay kernel refused
    before ROADMAP item 4b: one launch per scheme group, the fleet equal to
    the step engine on the card and to the CPU; then a grouped sweep of
    stateful and elementwise schemes, grouped equal to ungrouped (one
    launch) and to the CPU on every volume and sweep row."""
    from repro_torch.core import fleetshard
    from repro_torch.core.tracegen import tiled_fleet
    traces = make_fleet("mixed", 4, 256, 512, seed=3)
    pol = fleetshard.encode_policies(4, schemes=["sepbit", "fk", "sepbit", "nosep"])
    cfg = TorchSimConfig(n_lbas=256, segment_size=16, timing=True)
    ops.reset_launch_counts()
    res = fleetshard.simulate_fleet_hetero(traces, cfg, pol, device=card)
    assert ops.launch_counts()["replay_timing"] == 3
    step = fleetshard.simulate_fleet_hetero(traces, cfg, pol, device=card, engine="step")
    want = fleetshard.simulate_fleet_hetero(traces, cfg, pol, device="cpu")
    assert res["volumes"] == want["volumes"] == step["volumes"]
    args = dict(schemes=["sepbit", "fk", "dac", "sfs", "eti", "warcip"],
                selectors=["greedy", "cost_benefit"], gp_thresholds=[0.12], gcsched="greedy")
    traces = tiled_fleet("mixed", 12, 2, 512, 3 * 512, jitter=0.25, seed=59)
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, sfs_resample=128)
    out = {}
    for name, group, device in (("grouped", True, card), ("ungrouped", False, card),
                                ("cpu", True, "cpu")):
        ops.reset_launch_counts()
        out[name] = (fleetshard.simulate_fleet_sweep(traces, cfg, group=group, device=device,
                                                     **args), ops.launch_counts()["replay"])
    assert out["grouped"][1] == 6 and out["ungrouped"][1] == 1 and out["cpu"][1] == 0
    for name in ("ungrouped", "cpu"):
        assert out[name][0]["volumes"] == out["grouped"][0]["volumes"]
        assert out[name][0]["sweep"] == out["grouped"][0]["sweep"]


def test_fleet_spans_hold_host_work_only_on_the_card(card):
    """A small sweep profiled on the card: the port's spans (``repro_torch.``
    ranges) are host rows only, never device rows (a range that enclosed
    device work would be one too), and on the profiler's one clock the
    traces' gathers end before the first host-to-device copy (the trace's
    upload) starts, the LBA check (the host's wait for the card's verdict on
    the uploaded trace) starts after every upload begun before it has ended,
    and the summaries start after the last device-to-host copy (the state's
    read-back) ends."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fleetshard
    from repro_torch.core.tracegen import tiled_fleet
    args = dict(schemes=["sepbit"], selectors=["greedy"], gp_thresholds=[0.1, 0.2])
    traces = tiled_fleet("mixed", 2, 4, 512, 3 * 512, jitter=0.25, seed=61)
    cfg = TorchSimConfig(n_lbas=512, segment_size=16)
    fleetshard.simulate_fleet_sweep(traces, cfg, device=card, **args)    # loads the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fleetshard.simulate_fleet_sweep(traces, cfg, device=card, **args)
        torch.cuda.synchronize()
    spans, device = {}, []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type.name == "CUDA":
            device.append(row)
        elif e.name.startswith("repro_torch."):
            spans.setdefault(e.name.removeprefix("repro_torch.fleet."), []).append(row[1:])
    assert not [name for name, _, _ in device if name.startswith("repro_torch.")]
    assert set(spans) == {"gather", "check_lbas", "summaries", "sweep_summary"}
    uploads = sorted((s, e) for name, s, e in device if name.startswith("Memcpy HtoD"))
    readbacks = [e for name, _, e in device if name.startswith("Memcpy DtoH")]
    assert uploads and readbacks
    assert max(e for _, e in spans["gather"]) <= uploads[0][0]
    for start, _ in spans["check_lbas"]:
        assert all(e <= start for s, e in uploads if s <= start)
    assert min(s for s, _ in spans["summaries"]) >= max(readbacks)


@pytest.mark.parametrize("entry", ["run_fleet", "run_fleet_step", "simulate_fleet_sweep"])
def test_an_lba_of_n_lbas_is_refused_on_the_card(card, entry):
    """The LBA check runs on the uploaded trace: an LBA of ``n_lbas`` is
    refused with the CPU's ValueError and message, before any launch."""
    from repro_torch.core import fleetshard
    traces = torchsim.pad_fleet(make_fleet("mixed", 4, 64, 2 * 64, jitter=0.25, seed=63))
    traces[-1, -1] = 64
    cfg = TorchSimConfig(n_lbas=64, segment_size=8)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"^trace LBAs must lie in \[0, 64\)$"):
        if entry == "simulate_fleet_sweep":
            fleetshard.simulate_fleet_sweep(traces, cfg, schemes=["sepbit"], selectors=["greedy"],
                                            gp_thresholds=[0.1, 0.2], device=card)
        else:
            torchsim.run_fleet(cfg, traces, device=card,
                               engine="step" if entry == "run_fleet_step" else "replay")
    assert not any(ops.launch_counts().values())


# -- the legacy GC engine (the step engine on the card) --------------------------

def test_legacy_fleet_on_the_card_matches_cpu_and_tick(card):
    """The 14-scheme fleet under ``gc_engine="legacy"`` on the card's step
    engine (K1 at loop entry on every write, K3 on every rewrite) equals the
    CPU on every key, and the tick engine outside exhaustion."""
    cfg, traces, pol = _all_schemes_fleet()
    legacy = dataclasses.replace(cfg, gc_engine="legacy")
    ops.reset_launch_counts()
    stats = torchsim.ReplayStats()
    got = convert.state_to_numpy(torchsim.run_fleet(legacy, traces, pol, device=card,
                                                    engine="step", stats=stats))
    counts = ops.launch_counts()
    want = convert.state_to_numpy(torchsim.run_fleet(legacy, traces, pol, device="cpu"))
    assert (want["reclaimed"] > 0).all()
    _assert_same_state(got, want)
    assert counts["segment_select_batch"] == stats.steps + stats.tick_iterations
    assert counts["classify_gc"] == stats.tick_iterations and counts["replay"] == 0
    tick = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, pol, device=card,
                                                     engine="step"))
    _assert_same_state(tick, want)


@pytest.mark.parametrize("timing", [False, True])
def test_legacy_single_volume_on_the_card_matches_cpu(card, timing):
    """One volume under legacy on the card: victims from K2 on every write."""
    cfg = TorchSimConfig(n_lbas=512, segment_size=16, scheme="sepbit", gc_engine="legacy",
                         timing=timing, write_cost=0.7, gc_block_cost=1.3)
    tr = mixed_trace(512, 3 * 512, seed=29)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card, engine="step"))
    counts = ops.launch_counts()
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert int(want["reclaimed"][0]) > 0
    _assert_same_state(got, want)
    assert counts["segment_select"] >= len(tr) and counts["segment_select_batch"] == 0


@pytest.mark.parametrize("n_segments,seed", [(16, 67), (12, 65)])
def test_legacy_exhaustion_corner_on_the_card_matches_cpu(card, n_segments, seed):
    """Legacy's scatters are sequential, one per class, so its order on the
    card is defined even where several classes' fresh row is the pad row:
    bit-equal to the CPU, and the replay kernel refuses it."""
    cfg = TorchSimConfig(n_lbas=96, segment_size=8, n_segments=n_segments, gp_threshold=0.10,
                         gc_engine="legacy")
    tr = np.asarray(np.random.default_rng(seed).integers(0, 96, size=6 * 96), np.int32)
    got = convert.state_to_numpy(torchsim.run(cfg, tr, device=card, engine="step"))
    want = convert.state_to_numpy(torchsim.run(cfg, tr, device="cpu"))
    assert int(want["overflow"][0]) > 0
    _assert_same_state(got, want)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match='engine="step"'):
        torchsim.run(cfg, tr, device=card)
    assert sum(ops.launch_counts().values()) == 0


def test_gcbench_on_the_card_reproduces_the_committed_bench(card):
    """The JAX package's gcbench fleet: legacy on the step engine and tick on
    the replay kernel, each reproducing ``BENCH_fleet_gc.json``'s per-volume
    reclaimed counts, WA and GC writes, equal to each other on every key."""
    import json
    from pathlib import Path

    from repro_torch.core import fleetshard
    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCH_fleet_gc.json").read_text())
    V, n = bench["n_volumes"], bench["n_lbas"]
    traces = make_fleet(bench["workload"], V, n, 4 * n, jitter=0.25, seed=23)
    policy = fleetshard.encode_policies(V, schemes=bench["scheme"], selectors=bench["selector"],
                                        gp_thresholds=bench["gp_thresholds"])
    base = TorchSimConfig(n_lbas=n, segment_size=bench["segment_size"])
    states = {}
    for gc_engine, engine, group in (("legacy", "step", False), ("tick", "replay", True)):
        res, states[gc_engine] = fleetshard.simulate_fleet_hetero(
            traces, dataclasses.replace(base, gc_engine=gc_engine), policy, group=group,
            return_state=True, device=card, engine=engine)
        assert [v["reclaimed"] for v in res["volumes"]] == bench["gc"]["per_volume_reclaimed"]
        assert [(v["wa"], v["gc_writes"]) for v in res["volumes"]] == [
            (w["wa"], w["gc_writes"]) for w in bench["per_volume"]]
    _assert_same_state(states["legacy"], states["tick"])


# -- the static contracts as runtime properties, on the card ----------------------

CARD_CONTRACT_CASES = [("replay", "tick", "elementwise"), ("step", "tick", "all"),
                       ("step", "legacy", "all")]


@pytest.mark.parametrize("engine,gc_engine,schemes", CARD_CONTRACT_CASES)
@pytest.mark.parametrize("check", ["slices_isolated", "classes_in_range", "state_spec_kept",
                                   "volumes_isolated"])
def test_contracts_on_the_card(card, check, engine, gc_engine, schemes):
    """SA101/102, SA301/302, SA202 and SA501 (`tests/test_torch_contracts.py`)
    on the replay kernel (the elementwise schemes; it takes no other) and on
    the step engine under both GC engines (every scheme)."""
    import test_torch_contracts as contracts
    names = contracts.ELEMENTWISE if schemes == "elementwise" else contracts.ALL
    getattr(contracts, f"check_{check}")(names, gc_engine, device="cuda", engine=engine)


def test_contracts_classify_in_range_on_the_card(card):
    """SA301/302 for the classify kernel on the card, over hypothesis's rows."""
    from hypothesis import given, settings

    import test_torch_contracts as contracts

    @settings(max_examples=100, deadline=None)
    @given(contracts.classify_rows)
    def check(rows):
        contracts.check_classify_in_range(rows, device="cuda")

    check()


# -- the LM serving path: K5 in the decode step, on the card -------------------------

LM_B, LM_S, LM_P = 2, 12, 8       # tests/test_models.py's decode pattern


def _narrow_lm(card, dtype):
    """qwen3-32b's family at a narrow width with K5's head dim 128: 3 layers,
    8 query heads over 2 KV heads, d_model 64."""
    cfg = dataclasses.replace(smoke_config("qwen3-32b"), n_layers=3, head_dim=128, n_heads=8,
                              n_kv_heads=2, param_dtype=dtype, compute_dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init_params(torch.Generator(device=card).manual_seed(0))


def _prefill_then_decode(model, params, toks):
    """Last-prompt logits, then one row of logits per decode step: (S - P + 1, B, V)."""
    cache = model.init_cache(LM_B, LM_S + 4, device=toks.device)
    lg, cache = model.prefill(params, {"tokens": toks[:, :LM_P]}, cache)
    out = [lg]
    for t in range(LM_P, LM_S):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        out.append(lg)
    return torch.stack(out)


def _lm_tokens(cfg, device):
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (LM_B, LM_S)).astype(np.int32)
    return torch.from_numpy(toks).to(device)


def test_lm_decode_on_the_card_matches_plain_attention_and_cpu(card, monkeypatch):
    """float32: the decode step with K5 within 1e-4 of the same step with its
    plain version on the card and of the whole run on the CPU; K5 launched
    n_layers times per decode step and never by prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _narrow_lm(card, "float32")
    toks = _lm_tokens(cfg, card)
    ops.reset_launch_counts()
    cache = model.init_cache(LM_B, LM_S + 4, device=card)
    model.prefill(params, {"tokens": toks[:, :LM_P]}, cache)
    assert ops.launch_counts()["flash_decode"] == 0
    ops.reset_launch_counts()
    got = _prefill_then_decode(model, params, toks)
    assert ops.launch_counts()["flash_decode"] == cfg.n_layers * (LM_S - LM_P)
    on_cpu = _prefill_then_decode(model, tree_map(lambda t: t.cpu(), params), toks.cpu())
    monkeypatch.setattr(decode_attn, "flash_decode_unread", tref.flash_decode_ref)
    plain = _prefill_then_decode(model, params, toks)
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.cpu(), on_cpu, atol=1e-4, rtol=0)


def test_lm_decode_on_the_card_in_bfloat16_follows_forward(card):
    """bfloat16: prefill plus decode against the teacher-forced forward,
    within 2e-2 of the largest |logit| (the two round the softmax weights at
    other places), the greedy token equal at every step."""
    cfg, model, params = _narrow_lm(card, "bfloat16")
    toks = _lm_tokens(cfg, card)
    got = _prefill_then_decode(model, params, toks).float()
    full, _ = model.forward(params, {"tokens": toks})
    want = full[:, LM_P - 1:].transpose(0, 1).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_lm_on_the_card_refuses_a_head_dim_the_kernel_does_not_take(card):
    """The smoke config's head dim 16: prefill runs, the decode step raises
    before any launch (never the plain version on CUDA tensors)."""
    cfg = smoke_config("qwen3-32b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = _lm_tokens(cfg, card)
    cache = model.init_cache(LM_B, LM_S, device=card)
    model.prefill(params, {"tokens": toks[:, :LM_P]}, cache)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 16"):
        model.decode_step(params, toks[:, LM_P:LM_P + 1], cache)
    q = torch.zeros(LM_B, 4, 16, device=card)
    kv = torch.zeros(LM_B, 8, 2, 16, device=card)
    with pytest.raises(ValueError, match="head dim 16"):
        decode_attn.flash_decode_unread(q, kv, kv, torch.ones(LM_B, dtype=torch.int32,
                                                                device=card))
    assert ops.launch_counts()["flash_decode"] == 0


# -- the MoE, local-attention and recurrent blocks, on the card ------------------------

def _block_lm(arch, card, **replace):
    """The smoke config of ``arch`` (granite's at K5's head dim 64, 8 query
    heads over 2 KV heads) with weights from seed 0 on the card."""
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        replace = dict(head_dim=64, n_heads=8, n_kv_heads=2, **replace)
    cfg = dataclasses.replace(cfg, **replace)
    model = build_model(cfg)
    return cfg, model, model.init_params(torch.Generator(device=card).manual_seed(0))


@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_block_on_the_card_routes_as_the_cpu(card, zero_router):
    """float32: the MoE block on the card within 1e-4 of the CPU's output
    and aux; with a zero router (every expert tied) the card keeps experts
    0..K-1 and the first C tokens, as the CPU and lax.top_k do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, params = _block_lm("granite-moe-3b-a800m", card)
    p = dict(params["blocks"]["p0_attn"]["moe"])
    p = {k: v[0] for k, v in p.items()}
    if zero_router:
        p["router"] = torch.zeros_like(p["router"])
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator(device=card).manual_seed(1),
                    device=card)
    got, aux = common.moe_block(cfg, p, x)
    want, want_aux = common.moe_block(cfg, tree_map(lambda t: t.cpu(), p), x.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    if zero_router:
        C = int(1.25 * cfg.moe.experts_per_token * 16 / cfg.moe.n_experts)
        assert torch.equal(got[:, C:].cpu(), torch.zeros_like(want[:, C:]))
        assert bool((got[:, :C] != 0).any(-1).all())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "recurrentgemma-2b", "rwkv6-3b"])
def test_block_lm_decode_on_the_card_matches_the_cpu(card, arch):
    """float32, a stream past the smoke window (16): prefill of 24 tokens
    and 16 decode steps on the card within 1e-4 of the CPU; K5 launched
    once per global-attention layer and step (granite), never for the ring
    attention or the recurrent blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _block_lm(arch, card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
                            .astype(np.int32))

    def run(device, p):
        cache = model.init_cache(2, 40, device=device)
        lg, cache = model.prefill(p, {"tokens": toks[:, :24].to(device)}, cache)
        out = [lg]
        for t in range(24, 40):
            lg, cache = model.decode_step(p, toks[:, t:t + 1].to(device), cache)
            out.append(lg)
        return torch.stack(out), cache
    ops.reset_launch_counts()
    got, cache = run(card, params)
    assert ops.launch_counts()["flash_decode"] == 16 * cfg.pattern.count("attn")
    want, want_cache = run("cpu", tree_map(lambda t: t.cpu(), params))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def test_moe_decode_step_on_the_card_makes_no_host_sync(card):
    """bfloat16 granite (smoke width, K5's head dim): a decode step under
    ``torch.cuda.set_sync_debug_mode("error")`` raises on no synchronizing
    call."""
    cfg, model, params = _block_lm("granite-moe-3b-a800m", card, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    cache = model.init_cache(4, 32, device=card)
    toks = torch.randint(0, cfg.vocab, (4, 8), dtype=torch.int32, device=card)
    lg, cache = model.prefill(params, {"tokens": toks}, cache)
    cur = lg.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            lg, cache = model.decode_step(params, cur, cache)
            cur = lg.argmax(-1).to(torch.int32)[:, None]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cache["pos"].tolist() == [11] * 4


# -- the vlm prefix and whisper, on the card -----------------------------------------

def _stub_lm(arch, card, dtype="float32"):
    """The smoke config of ``arch`` at a head dim K5 takes: paligemma's at
    256 with 8 query heads over its 1 KV head (G 8, its full width's), or
    whisper's at 64 (4 heads, G 1); weights from seed 0 on the card, and
    the stub frontend's embeddings (B 2) from numpy's seed 1."""
    vlm = arch == "paligemma-3b"
    cfg = dataclasses.replace(smoke_config(arch), head_dim=256 if vlm else 64,
                              n_heads=8 if vlm else 4, param_dtype=dtype, compute_dtype=dtype)
    model = build_model(cfg)
    emb = np.random.default_rng(1).standard_normal((LM_B, cfg.n_prefix_tokens, cfg.d_model))
    batch = {"tokens": _lm_tokens(cfg, card),
             "prefix" if vlm else "frames": torch.from_numpy(emb.astype(np.float32)).to(card)}
    return cfg, model, model.init_params(torch.Generator(device=card).manual_seed(0)), batch


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small"])
def test_stub_lm_decode_on_the_card_matches_the_cpu(card, arch):
    """float32: prefill of 8 tokens (after the image prefix, or beside the
    frames), then 4 decode steps into a cache of 10 text positions, the last
    two past its end, on the card within 1e-4 of the CPU, logits and every
    cache leaf; K5 launched once per layer and step (paligemma), twice
    (whisper: self and cross), never by prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params, batch = _stub_lm(arch, card)
    per_step = cfg.n_layers * (2 if cfg.family == "audio" else 1)

    def run(device, p):
        b = {k: v.to(device) for k, v in batch.items()}
        cache = model.init_cache(LM_B, 10, device=device)
        ops.reset_launch_counts()
        lg, cache = model.prefill(p, dict(b, tokens=b["tokens"][:, :LM_P]), cache)
        assert ops.launch_counts()["flash_decode"] == 0
        out = [lg]
        for t in range(LM_P, LM_S):
            lg, cache = model.decode_step(p, b["tokens"][:, t:t + 1], cache)
            out.append(lg)
        return torch.stack(out), cache
    got, cache = run(card, params)
    assert ops.launch_counts()["flash_decode"] == per_step * (LM_S - LM_P)
    want, want_cache = run("cpu", tree_map(lambda t: t.cpu(), params))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small"])
def test_stub_lm_decode_step_on_the_card_makes_no_host_sync(card, arch):
    """bfloat16: three decode steps under ``torch.cuda.set_sync_debug_mode
    ("error")`` raise on no synchronizing call (whisper's cross-attention
    length is made on the card), and follow the teacher-forced forward
    within 2e-2 of the largest |logit|."""
    cfg, model, params, batch = _stub_lm(arch, card, "bfloat16")
    cache = model.init_cache(LM_B, LM_S, device=card)
    lg, cache = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :LM_P]), cache)
    out = [lg]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(LM_P, LM_P + 3):
            lg, cache = model.decode_step(params, batch["tokens"][:, t:t + 1], cache)
            out.append(lg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    full, _ = model.forward(params, dict(batch, tokens=batch["tokens"][:, :LM_P + 3]))
    offset = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    want = full[:, offset + LM_P - 1:].transpose(0, 1).float()
    got = torch.stack(out).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


# -- training and checkpoint, on the card ----------------------------------------------

def _train_inputs(cfg, device, seed=1, B=4, S=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def test_train_step_on_the_card_matches_the_cpu(card):
    """float32, a smoke arch: the loss and every gradient leaf on the card
    against the CPU on the same weights (the loss within 1e-4 relative,
    each leaf within 1e-4 of its largest |grad|), then one whole train step
    each: the step and the lr equal, the grad norm within 1e-4 relative
    (not the params: AdamW turns the rounding of a near-zero gradient into
    a difference of up to 2 lr)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = init_train_state(model, cfg, opt_cfg, torch.Generator(device=card).manual_seed(0))
    cpu_state = tree_map(lambda t: t.cpu(), state)
    batch = _train_inputs(cfg, card)
    loss_fn = make_loss_fn(model, cfg)
    loss, grads = loss_and_grads(loss_fn, state["params"], batch)
    cpu_loss, cpu_grads = loss_and_grads(loss_fn, cpu_state["params"],
                                         {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) - float(cpu_loss)) <= 1e-4 * abs(float(cpu_loss))
    for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())
    step = make_train_step(model, cfg, opt_cfg)
    state, m = step(state, batch)
    cpu_state, cm = step(cpu_state, {k: v.cpu() for k, v in batch.items()})
    assert int(state["opt"]["step"]) == 1 and float(m["lr"]) == float(cm["lr"])
    assert abs(float(m["grad_norm"]) - float(cm["grad_norm"])) <= 1e-4 * float(cm["grad_norm"])


def test_bfloat16_checkpoint_from_the_card_restores_bit_equal(card, tmp_path):
    """A bfloat16 train state made on the card, saved and restored into the
    card's tree by a fresh manager: every leaf bit-equal and on the card."""
    cfg = dataclasses.replace(smoke_config("phi3-mini-3.8b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, cfg, opt_cfg, torch.Generator(device=card).manual_seed(3))
    state, _ = make_train_step(model, cfg, opt_cfg)(state, _train_inputs(cfg, card))
    CheckpointManager(str(tmp_path), keep=1).save(1, state)
    like = init_train_state(model, cfg, opt_cfg, torch.Generator(device=card).manual_seed(4))
    got, manifest = CheckpointManager(str(tmp_path)).restore(like)
    assert manifest["step"] == 1
    assert got["params"]["embed"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_lm_decode_past_the_cache_end_on_the_card(card):
    """A decode step at pos = max_seq: no device assert, the cache as it was,
    pos advanced, the logits equal to the CPU's within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _narrow_lm(card, "float32")
    prompt = torch.tensor([[5, 7, 9, 11]], dtype=torch.int32)

    def run(device, p):
        cache = model.init_cache(1, 4, device=device)
        model.prefill(p, {"tokens": prompt.to(device)}, cache)
        before = {k: v.clone() for k, v in cache["blocks"]["p0_attn"].items()}
        lg, cache = model.decode_step(p, torch.tensor([[3]], dtype=torch.int32, device=device),
                                      cache)
        torch.cuda.synchronize()
        for key in ("k", "v"):
            assert torch.equal(cache["blocks"]["p0_attn"][key], before[key])
        assert cache["pos"].tolist() == [5]
        return lg
    got = run(card, params)
    want = run("cpu", tree_map(lambda t: t.cpu(), params))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_train_lm_example_on_the_card_resumes(card, tmp_path, capsys):
    """``examples/train_lm_torch.py`` on the card (its default device) for a
    few steps, then ``--resume`` from its latest manifest."""
    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--arch", "qwen3-32b", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--seq", "32"]
    first = mod.main(argv + ["--steps", "10"])
    again = mod.main(argv + ["--steps", "12", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 9" in out and out.count("checkpoint-store WA=") == 2
    assert again["start"] == 10 and len(again["losses"]) == 2
    assert np.isfinite(first["losses"] + again["losses"]).all()


@pytest.fixture
def one_rank_nccl(card):
    """A one-rank NCCL group on the card, destroyed after the test, and its
    (1, 1) mesh from ``launch.make_host_mesh``."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def test_sharded_decode_on_the_card_equals_unsharded(one_rank_nccl):
    """The serving functions with a sharder on the one-rank mesh: logits and
    tokens bit-equal to the same calls without one, K5 once per layer and
    step."""
    from repro_torch.distributed import Sharder, place_params
    from repro_torch.serving import make_decode_fn, make_prefill_fn
    cfg, model, params = _narrow_lm(torch.device("cuda"), "bfloat16")
    sh = Sharder(one_rank_nccl, cfg)
    assert one_rank_nccl.device_type == "cuda" and tuple(one_rank_nccl.shape) == (1, 1)
    toks = _lm_tokens(cfg, torch.device("cuda"))

    def serve(sharder):
        p = place_params(params, sharder, model.param_specs()) if sharder is not None \
            else params
        prefill, decode = make_prefill_fn(model, cfg, sharder), make_decode_fn(model, cfg, sharder)
        cache = model.init_cache(LM_B, LM_S + 4, device="cuda")
        lg, cache = prefill(p, {"tokens": toks[:, :LM_P]}, cache)
        out, cur = [lg], lg.argmax(-1).to(torch.int32)[:, None]
        ops.reset_launch_counts()
        for _ in range(LM_S - LM_P):
            nxt, lg, cache = decode(p, cur, cache)
            out.append(lg)
            cur = nxt[:, None]
        return torch.stack(out), ops.launch_counts()["flash_decode"]
    got, launches = serve(sh)
    want, _ = serve(None)
    assert torch.equal(got, want) and launches == cfg.n_layers * (LM_S - LM_P)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_on_the_card_equals_the_cpu(card, dtype):
    from repro_torch.distributed import collectives
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(70_001, generator=g) * torch.rand(70_001, generator=g) * 50).to(dtype)
    x[512:768] = 0                          # an all-zero block
    q, scale = collectives.quantize_int8(x.to(card))
    cq, cscale = collectives.quantize_int8(x)
    assert torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale)
    assert torch.equal(collectives.dequantize_int8(q, scale, x.shape).cpu(),
                       collectives.dequantize_int8(cq, cscale, x.shape))


def test_compressed_allreduce_on_the_card_keeps_the_residual(one_rank_nccl):
    from repro_torch.distributed import collectives
    x = torch.randn(10_000, generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    resid = torch.zeros_like(x)
    for _ in range(3):
        mean, new = collectives.compressed_allreduce(x, resid)
        assert torch.equal(mean + new, x + resid)
        resid = new
