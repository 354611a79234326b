#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together);
3. kernels: each kernel's wrapper on card tensors against its plain PyTorch
   version on the same inputs (bit equality for the replay engine's
   kernels; the Zipf sums within rtol 2e-4 / atol 1e-6 and bit-identical on
   a repeat), and its time;
4. decode: flash-decode attention through its entry point at qwen3-32b's,
   starcoder2-3b's and phi3-mini's decode geometry in bfloat16 and float32,
   against its plain version (1e-4 in float32, 2e-2 in bfloat16), then
   timed at qwen3-32b's in bfloat16 beside scaled_dot_product_attention;
5. analysis: the paper's §3 at its own scale (n = 10 * 2^18): the eight
   Fig 8 / Fig 10 points of the repository's benchmark, five of them held
   to the paper's values, all four figure grids through the Zipf kernel,
   and Figs 9 / 11 on the benchmark-grade volume pool, equal on the card
   and on the CPU;
6. engine parity: a reduced fleet replayed on the card (kernels) and on the
   CPU (plain versions) must end in bit-equal states; one volume replayed
   alone on the card (the single-volume victim kernel) must equal its row
   of the fleet; an undersized segment pool must keep the free-pool
   exhaustion envelope;
7. main run: the 186-volume mixed corpus tiled over the four GC thresholds
   of the repository's gcbench (744 volumes of 64 MiB at 4 KiB blocks),
   SepBIT with cost-benefit selection, then a profiled steady window.

Before the last line it prints the kernel table as one JSON object; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores (same sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bfloat16 on the tensor cores (same sheet)
MAIN_VOLUMES_PER_TILE = 186    # the paper's corpus size (Exp#1/Exp#2)
MAIN_GPS = (0.08, 0.12, 0.16, 0.22)   # gcbench's GC thresholds
MAIN_N_LBAS = 16384            # 64 MiB volumes at 4 KiB blocks
MAIN_SEGMENT = 128
PARITY_N_LBAS = 2048           # the card-against-CPU fleet's volumes
PROFILE_STEPS = 200            # the profiled steady window after the main run
# benchmarks/run.py fig8_user_bit / fig10_gc_bit: (window GiB, window GiB,
# alpha, the paper's percentage or None), and tests/test_analysis.py's
# tolerance for each paper value, in percentage points
FIG8_POINTS = ((0.25, 4, 1.0, 77.1), (1, 0.25, 1.0, None), (1, 4, 1.0, 87.1), (1, 1, 0.0, 9.5))
FIG10_POINTS = ((2, 8, 1.0, 41.2), (32, 8, 1.0, 14.9), (2, 8, 0.2, None), (32, 8, 0.2, None))
PAPER_TOL = {77.1: 0.2, 87.1: 0.3, 9.5: 0.2, 41.2: 0.3, 14.9: 0.3}
# float operations of the Zipf kernel per pmf element: log1pf and each of
# the four expf counted as one, plus 17 multiplies, adds and subtracts
ZIPF_OPS_PER_ELEMENT = 22
# (Hq, Hkv, D) of the decode geometries: src/repro/configs/qwen3_32b.py,
# starcoder2_3b.py, phi3_mini.py; (B, S) timed and checked
QWEN3_32B, STARCODER2_3B, PHI3_MINI = (64, 8, 128), (24, 2, 128), (32, 32, 96)
DECODE_TIMED, DECODE_CHECKED = (16, 8192), (8, 4096)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``fn``, captured
    ``reps`` times into one CUDA graph and replayed between two events (the
    host's launch overhead is outside the measurement)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(n_bytes: int, n_ops: int = 0, flops_per_s: float = F32_FLOPS) -> dict:
    """The least time in ms for moving ``n_bytes`` and doing ``n_ops`` at
    the card's published rates (``bound_ms``), and which of the two bounds
    it (``bound_by``)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries; equal infinities count as 0."""
    import torch
    a, b = a.double(), b.double()
    same = a == b
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def phase_device() -> dict:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": smi[0]}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(logs)} kernel(s) built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")


def _segsel_inputs(rng, V, S, t_hi=60_000, seg=MAIN_SEGMENT):
    """Reachable segment metadata: nv <= n <= seg, stime <= t, states 0..3,
    plus forced ties, all-ineligible rows and mixed selectors."""
    n = rng.integers(0, seg + 1, (V, S))
    nv = np.minimum(rng.integers(0, seg + 1, (V, S)), n)
    t = rng.integers(1, t_hi, V)
    stime = rng.integers(0, t_hi, (V, S)) % t[:, None]
    state = rng.integers(0, 4, (V, S))
    for v in range(0, V, 7):                  # ties: copy segment 5 onto 5 + 100
        for a in (n, nv, stime, state):
            a[v, min(105, S - 1)] = a[v, 5]
    for v in range(3, V, 50):                 # no eligible segment at all
        state[v] = np.where(state[v] == 2, 1, state[v])
    sel = rng.integers(0, 2, V)
    return [np.ascontiguousarray(x, dtype=np.int32) for x in (n, nv, stime, state, t, sel)]


def _classify_row(name, site, v, g, c1, gc, ell, sids, what) -> dict:
    """K3 at one call site: bit equality with the plain version, and times."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.classify import classify
    V, B = v.shape
    out = classify(v, g, c1, gc, ell, sids, site=site)
    rout = ref.classify_ref(v, g, c1, gc, ell, sids)
    torch.cuda.synchronize()
    ok = torch.equal(out, rout)
    log(f"[kernels] K3 {name} ({V}, {B}) over {what}: bit_equal={ok}")
    if not ok:
        raise AssertionError(f"K3 ({name}) disagrees with its plain version")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/classify.cu",
        "replaces": "src/repro/kernels/classify.py:49",
        "shape": [V, B], "bit_equal": ok, "max_abs_err": max_abs_err(out, rout),
        "ms": time_ms(lambda: classify(v, g, c1, gc, ell, sids, site=site)),
        "plain_ms": time_ms(lambda: ref.classify_ref(v, g, c1, gc, ell, sids)),
        **bound(20 * V * B + 8 * V),
        "tolerance": "bit-equal", "library_ms": None}


def phase_kernels(rng, main_shape, single_segments) -> list[dict]:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.segsel import segment_select, segment_select_batch
    dev = torch.device("cuda")
    rows = []

    # K1: the fleet tick's shape
    V, S = main_shape
    arrays = [torch.from_numpy(x).to(dev) for x in _segsel_inputs(rng, V, S)]
    idx, score = segment_select_batch(*arrays)
    ridx, rscore = ref.segment_select_batch_ref(*arrays)
    torch.cuda.synchronize()
    ok = torch.equal(idx, ridx) and torch.equal(score, rscore)
    n_none = int((ridx < 0).sum())
    log(f"[kernels] K1 segment_select_batch ({V}, {S}): bit_equal={ok} "
        f"(rows without a victim: {n_none})")
    if not ok or n_none == 0:
        raise AssertionError("K1 disagrees with its plain version")
    rows.append({
        "name": "segment_select_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segsel.cu",
        "replaces": "src/repro/kernels/segsel.py:150",
        "shape": [V, S], "bit_equal": ok, "max_abs_err": max_abs_err(score, rscore),
        "ms": time_ms(lambda: segment_select_batch(*arrays)),
        "plain_ms": time_ms(lambda: ref.segment_select_batch_ref(*arrays)),
        **bound(16 * V * S + 8 * V + 8 * V),
        "tolerance": "bit-equal", "library_ms": None})

    # K2: the single-volume shape, and the int32 index edge past 2^24
    S1 = single_segments
    one = [torch.from_numpy(x.reshape(-1) if x.ndim == 1 else x[0]).to(dev)
           for x in _segsel_inputs(rng, 1, S1)]
    args1 = (one[0], one[1], one[2], one[3], one[4].reshape(()), one[5].reshape(()))
    i1, s1 = segment_select(*args1)
    ri1, rs1 = ref.segment_select_ref(*args1)
    S_edge = (1 << 24) + (1 << 19)
    hot = (1 << 24) + 1029          # odd: a float32 index carry would round it
    z = torch.zeros(S_edge, dtype=torch.int32, device=dev)
    n_e, nv_e, st_e, state_e = z.clone(), z.clone(), z.clone(), z.clone()
    n_e[hot], nv_e[hot], state_e[hot] = 8, 2, 2
    t_e = torch.tensor(10, dtype=torch.int32, device=dev)
    sel_e = torch.tensor(0, dtype=torch.int32, device=dev)
    ie, se = segment_select(n_e, nv_e, st_e, state_e, t_e, sel_e)
    rie, rse = ref.segment_select_ref(n_e, nv_e, st_e, state_e, t_e, sel_e)
    torch.cuda.synchronize()
    ok = (torch.equal(i1, ri1) and torch.equal(s1, rs1) and int(ie) == hot
          and torch.equal(ie, rie) and torch.equal(se, rse))
    log(f"[kernels] K2 segment_select ({S1},) and edge ({S_edge},) victim {int(ie)} "
        f"(want {hot}): bit_equal={ok}")
    if not ok:
        raise AssertionError("K2 disagrees with its plain version")
    rows.append({
        "name": "segment_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segsel.cu",
        "replaces": "src/repro/kernels/segsel.py:86",
        "shape": [S1], "bit_equal": ok,
        "max_abs_err": max(max_abs_err(s1, rs1), max_abs_err(se, rse)),
        "ms": time_ms(lambda: segment_select(*args1)),
        "plain_ms": time_ms(lambda: ref.segment_select_ref(*args1)),
        **bound(16 * S1 + 8 + 8),
        "tolerance": "bit-equal", "library_ms": None})

    # K3 at its two call sites: the GC rewrite's (volumes, segment_size)
    # shape over all 14 scheme ids, and the user write's (volumes, 1) batch
    V3, B = main_shape[0], MAIN_SEGMENT
    v = torch.from_numpy(rng.integers(0, 100_000, (V3, B), dtype=np.int32)).to(dev)
    g = torch.from_numpy(rng.integers(0, 100_000, (V3, B), dtype=np.int32)).to(dev)
    c1 = torch.from_numpy(rng.integers(0, 2, (V3, B), dtype=np.int32)).to(dev)
    gc = torch.from_numpy(rng.integers(0, 2, (V3, B), dtype=np.int32)).to(dev)
    ells = np.where(np.arange(V3) % 5 == 0, np.inf, rng.uniform(1.0, 30_000.0, V3))
    ell = torch.from_numpy(ells.astype(np.float32)).to(dev)
    sids = torch.from_numpy((np.arange(V3) % 14).astype(np.int32)).to(dev)
    rows.append(_classify_row("classify_gc", "gc", v, g, c1, gc, ell, sids,
                              "all 14 scheme ids"))
    # user writes: is_gc = 0; v = t + 2^30 for a fresh LBA, 2^30 + 65..127
    # (rounds up to 2^30 + 128 in float32) or a rewritten LBA's lifespan; ℓ
    # inf, 2^30 + 128 (where the rounding decides) or a finite estimate;
    # half the rows SepBIT (the main run's scheme), the rest all 14 ids
    i = np.arange(V3)
    kinds = np.stack([rng.integers(0, 60_000, V3) + (1 << 30),
                      rng.integers(65, 128, V3) + (1 << 30), rng.integers(1, 60_000, V3)])
    uv = torch.from_numpy(kinds[i % 3, i][:, None].astype(np.int32)).to(dev)
    uells = np.stack([np.full(V3, np.inf), np.full(V3, 2.0 ** 30 + 128),
                      rng.uniform(1.0, 60_000.0, V3)])[(i // 3) % 3, i]
    uell = torch.from_numpy(uells.astype(np.float32)).to(dev)
    usids = torch.from_numpy(np.where(i % 2 == 0, 2, (i // 2) % 14).astype(np.int32)).to(dev)
    z = torch.zeros_like(uv)
    rows.append(_classify_row("classify_user", "user", uv, z, z, z, uell, usids,
                              "fresh-LBA lifespans"))
    for r in rows:
        log(f"[kernels] {r['name']} {r['shape']}: {r['ms'] * 1e3:.2f} us "
            f"(plain {r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us)")
    return rows


def phase_zipf_kernel() -> list[dict]:
    """K4 at the paper's n against its plain version, for the exponents of
    every Fig 8 / Fig 10 point over the alpha = 1 and alpha = 0 pmfs, with a
    bit-identical repeat; then its time at one point of each figure."""
    import torch

    from repro_torch.core import analysis
    from repro_torch.kernels import ref
    from repro_torch.kernels.zipfprob import zipf_bit_sums
    G, n = analysis.BLOCKS_PER_GIB, analysis.PAPER_N
    exps = {"fig8": [(u0 * G, v0 * G, 0.0, 0.0) for u0, v0, _, _ in FIG8_POINTS],
            "fig10": [(0.0, 0.0, g0 * G, r0 * G) for g0, r0, _, _ in FIG10_POINTS]}
    worst = {"fig8": 0.0, "fig10": 0.0}
    for alpha in (1.0, 0.0):
        p = analysis.zipf_pmf(n, alpha, "cuda")
        for fig, points in exps.items():
            for e in points:
                got, again = zipf_bit_sums(p, *e), zipf_bit_sums(p, *e)
                want = ref.zipf_bit_sums_ref(p, *e)
                torch.cuda.synchronize()
                close = torch.allclose(got, want, rtol=2e-4, atol=1e-6)
                if not (close and torch.equal(got, again)):
                    raise AssertionError(f"K4 at alpha {alpha}, exponents {e}: {got.tolist()} "
                                         f"against plain {want.tolist()}, repeat "
                                         f"{again.tolist()}")
                worst[fig] = max(worst[fig], max_abs_err(got, want))
    log(f"[kernels] K4 zipf_bit_sums ({n},) at the exponents of 8 points x alpha 1.0 and "
        f"0.0: within rtol 2e-4 / atol 1e-6, repeats bit-identical; max |err| {worst}")
    p = analysis.zipf_pmf(n, 1.0, "cuda")
    limit = bound(4 * n + 16, ZIPF_OPS_PER_ELEMENT * n)
    rows = []
    for fig in ("fig8", "fig10"):
        e = exps[fig][0]
        rows.append({
            "name": f"zipf_bit_sums_{fig}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zipfprob.cu",
            "replaces": "src/repro/kernels/zipfprob.py:54",
            "shape": [n], "exponents": list(e), "max_abs_err": worst[fig],
            "ms": time_ms(lambda: zipf_bit_sums(p, *e)),
            "plain_ms": time_ms(lambda: ref.zipf_bit_sums_ref(p, *e)),
            **limit, "tolerance": "rtol 2e-4, atol 1e-6; repeat bit-identical",
            "library_ms": None})
    for r in rows:
        log(f"[kernels] {r['name']} {r['shape']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us, {r['bound_by']})")
    return rows


def _decode_inputs(seed, B, S, heads, dtype):
    """q, k, v from a seeded generator on the card; ragged kv_len from a
    numpy seed with the first row full and the last of length 1."""
    import torch
    Hq, Hkv, D = heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kl = np.random.default_rng(seed).integers(1, S + 1, B)
    kl[0], kl[-1] = S, 1
    return q, k, v, torch.from_numpy(kl.astype(np.int32)).cuda()


def phase_decode() -> tuple[dict, int]:
    """K5's path, its entry point `ops.flash_decode`, at three decode
    geometries in both dtypes; each output against the plain version; then
    the kernel, the plain version and scaled_dot_product_attention timed at
    qwen3-32b's geometry in bfloat16. Returns the K5 row and its launches
    on the path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attn, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full float32
    torch.backends.cudnn.allow_tf32 = False
    cases = [(name, heads, bs, dtype) for name, heads, bs in (
        ("qwen3-32b", QWEN3_32B, DECODE_TIMED), ("starcoder2-3b", STARCODER2_3B, DECODE_CHECKED),
        ("phi3-mini", PHI3_MINI, DECODE_CHECKED)) for dtype in (torch.bfloat16, torch.float32)]
    inputs = [_decode_inputs(i, *bs, heads, dtype) for i, (_, heads, bs, dtype) in enumerate(cases)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [ops.flash_decode(*x) for x in inputs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_decode"]
    log(f"[decode] {len(cases)} calls of ops.flash_decode in {wall:.3f} s; launches {launches}")
    if launches != len(cases):
        raise AssertionError("the decode path did not go through its kernel")
    errs = []
    for (name, heads, bs, dtype), x, out in zip(cases, inputs, outs):
        want = ref.flash_decode_ref(*x)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err = max_abs_err(out.float(), want.float())
        ok = (out.shape == want.shape and out.dtype == x[0].dtype
              and bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), want.float(), atol=tol, rtol=tol))
        log(f"[decode] {name} (B, S) {bs} (Hq, Hkv, D) {heads} {str(dtype)[6:]}: max |err| "
            f"{err:.3e} (tolerance {tol}) ok={ok}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {name} {dtype}")
        errs.append(err)

    q, k, v, kl = inputs[0]          # the timed case: qwen3-32b in bfloat16
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    mask = (torch.arange(S, device="cuda")[None, :] < kl[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    lib_err = max_abs_err(library()[:, :, 0].float(), ref.flash_decode_ref(q, k, v, kl).float())
    rows_read = int(kl.clamp(max=S).sum())
    size = q.element_size()
    limit = bound(rows_read * Hkv * D * 2 * size + 2 * B * Hq * D * size + 4 * B,
                  4 * Hq * D * rows_read, BF16_FLOPS)
    # the wrapper's kv_len check reads the device, which a CUDA graph cannot
    # capture: time the launch behind it
    row = {"name": "flash_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
           "replaces": "src/repro/kernels/decode_attn.py:66",
           "shape": [B, S, Hq, Hkv, D], "dtype": "bfloat16", "kv_rows": rows_read,
           "max_abs_err": errs[0],
           "ms": time_ms(lambda: decode_attn._launch(q, k, v, kl), reps=5),
           "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, k, v, kl), reps=5),
           **limit, "tolerance": "2e-2 (bfloat16), 1e-4 (float32)",
           "library_ms": time_ms(library, reps=5)}
    log(f"[kernels] flash_decode qwen3-32b B={B} S={S} bf16, {rows_read} KV rows: "
        f"{row['ms'] * 1e3:.1f} us (plain {row['plain_ms'] * 1e3:.1f} us, "
        f"scaled_dot_product_attention {row['library_ms'] * 1e3:.1f} us, its max |err| "
        f"{lib_err:.3e}; bound {row['bound_ms'] * 1e3:.1f} us, {row['bound_by']})")
    return row, launches


def _same(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


def phase_analysis() -> dict:
    """The paper's §3 through the port's entry points on the card, at the
    paper's n; returns K4's launches in the Fig 8 and the Fig 10 runs."""
    import torch

    from repro_torch.core import analysis as A
    from repro_torch.core.volumes import default_pool
    from repro_torch.kernels import ops
    G = A.BLOCKS_PER_GIB
    launches, failed = {}, []

    def check(what, value, want, tol):
        ok = abs(value - want) <= tol
        log(f"[analysis] {what}: {value:.4f} (paper {want}, tolerance {tol}) ok={ok}")
        if not ok:
            failed.append(what)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fig8 = {(u0, v0, a): 100 * A.pr_user_bit(u0 * G, v0 * G, alpha=a)
            for u0, v0, a, _ in FIG8_POINTS}
    grid8a, curve8b = A.fig8a_grid(), A.fig8b_curve()
    launches["zipf_bit_sums_fig8"] = ops.launch_counts()["zipf_bit_sums"]
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    fig10 = {(g0, r0, a): 100 * A.pr_gc_bit(g0 * G, r0 * G, alpha=a)
             for g0, r0, a, _ in FIG10_POINTS}
    grid10a, curve10b = A.fig10a_grid(), A.fig10b_curve()
    launches["zipf_bit_sums_fig10"] = ops.launch_counts()["zipf_bit_sums"]
    t2 = time.perf_counter()
    log(f"[analysis] n {A.PAPER_N}: Fig 8 points and grids {t1 - t0:.3f} s, Fig 10 points "
        f"and grids {t2 - t1:.3f} s; K4 launches {launches}")
    for points, values in ((FIG8_POINTS, fig8), (FIG10_POINTS, fig10)):
        for a, b, alpha, paper in points:
            value = values[(a, b, alpha)]
            if paper is None:
                log(f"[analysis] ({a}, {b}) GiB alpha {alpha}: {value:.4f} (no paper value)")
            else:
                check(f"({a}, {b}) GiB alpha {alpha}", value, paper, PAPER_TOL[paper])
    check("Fig 8(a) minimum", 100 * min(grid8a.values()), 77.1, 0.3)
    check("Fig 8(b) alpha 1 minimum", 100 * min(curve8b[(1.0, v)] for v in (0.25, 0.5, 1, 2, 4)),
          87.1, 0.3)
    check("Fig 10(b) separation at alpha 0.2", fig10[(2, 8, 0.2)] - fig10[(32, 8, 0.2)], 3.5, 0.4)
    check("Fig 10(b) separation at alpha 1.0", fig10[(2, 8, 1.0)] - fig10[(32, 8, 1.0)], 26.4, 0.4)
    values = [*grid8a.values(), *curve8b.values(), *grid10a.values(), *curve10b.values()]
    n_evals = len(FIG8_POINTS) + len(FIG10_POINTS) + len(values)
    log(f"[analysis] grids: {len(grid8a)} + {len(curve8b)} + {len(grid10a)} + {len(curve10b)} "
        f"values, all in [0, 1]: {all(0.0 <= x <= 1.0 for x in values)}")
    if (sum(launches.values()) != n_evals or 0 in launches.values()
            or not all(0.0 <= x <= 1.0 for x in values)):
        failed.append("grids")

    t0 = time.perf_counter()
    pool = default_pool(scale=4)
    n = max(int(tr.max()) for _, tr in pool) + 1
    t1 = time.perf_counter()
    log(f"[analysis] pool: {len(pool)} volumes x {n} LBAs x {len(pool[0][1])} writes, made in "
        f"{t1 - t0:.2f} s")
    windows = ([("fig9", A.trace_conditional_user, v0f, int(0.1 * n), int(v0f * n))
                for v0f in (0.1, 0.4)]
               + [("fig11", A.trace_conditional_gc, g0f, int(g0f * n), int(0.5 * n))
                  for g0f in (0.1, 1.0)])
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got = [[fn(tr, a, b, device=device) for _, tr in pool] for _, fn, _, a, b in windows]
        torch.cuda.synchronize()
        log(f"[analysis] Figs 9 / 11 on {device}: {time.perf_counter() - t0:.3f} s")
        if device == "cuda":
            card = got
    for (fig, _, frac, _, _), a, b in zip(windows, card, got):
        same = all(_same(x, y) for x, y in zip(a, b))
        finite = [x for x in a if np.isfinite(x)]
        log(f"[analysis] {fig} at {frac} x WSS: median {100 * np.median(finite):.4f}% over "
            f"{len(finite)} volumes; card == cpu: {same}")
        if not same or not finite:
            failed.append(f"{fig} at {frac}")
    if failed:
        raise AssertionError(f"analysis checks failed: {failed}")
    return launches


def fleet_config(n_lbas: int):
    """SepBIT / cost-benefit volumes of ``n_lbas`` blocks whose segment pool
    is sized from the largest GC threshold, as the JAX package's
    ``fleetshard.hetero_config`` sizes it."""
    from repro_torch.core.config import TorchSimConfig
    sized = TorchSimConfig(n_lbas=n_lbas, segment_size=MAIN_SEGMENT,
                           gp_threshold=max(MAIN_GPS))
    return TorchSimConfig(n_lbas=n_lbas, segment_size=MAIN_SEGMENT, n_segments=sized.s_max)


def fleet_policies(cfg, gps) -> dict:
    """(V,) policy arrays: SepBIT, cost-benefit, GC threshold ``gps[i]``."""
    from repro_torch.core.config import default_policy
    pol = {k: np.full(len(gps), v) for k, v in default_policy(cfg).items()}
    pol["p_gp"] = np.asarray(gps, np.float32)
    return pol


def check_integrity(cfg, st, traces, what):
    """Invariants of a final state: every write counted, one valid copy per
    written LBA, the location map pointing at its block, fill counts within
    capacity. Raises on the first volume that breaks one."""
    for i, tr in enumerate(traces):
        tr = np.asarray(tr)
        wrote = np.unique(tr[tr >= 0])
        seg, off = st["loc_seg"][i][wrote], st["loc_off"][i][wrote]
        if not (int(st["user_writes"][i]) == int((tr >= 0).sum())
                and int(st["total_valid"][i]) == len(wrote)
                and int(st["seg_nvalid"][i].sum()) == len(wrote)
                and int(st["seg_valid"][i].sum()) == len(wrote)
                and (st["seg_lba"][i][seg, off] == wrote).all()
                and (st["seg_n"][i] <= cfg.segment_size).all()):
            raise AssertionError(f"{what}: volume {i} breaks a state invariant")


def phase_parity() -> tuple[int, int]:
    """Card against CPU on a reduced fleet, then one volume alone on the card
    (the single-volume path), then the exhaustion envelope. Returns the
    single-volume path's segment count (K2's shape) and K2's launches there."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.core.tracegen import make_fleet
    from repro_torch.kernels import ops
    V, n = 16, PARITY_N_LBAS
    cfg = fleet_config(n)
    traces = make_fleet("mixed", V, n, 2 * n, jitter=0.25, seed=29)
    policies = fleet_policies(cfg, [MAIN_GPS[i % len(MAIN_GPS)] for i in range(V)])
    t0 = time.perf_counter()
    card = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, policies, device="cuda"))
    t1 = time.perf_counter()
    cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, policies, device="cpu"))
    t2 = time.perf_counter()
    bad = [k for k in cpu
           if not np.array_equal(card[k], cpu[k]) or card[k].dtype != cpu[k].dtype]
    log(f"[parity] fleet V={V} n_lbas={n}: card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s, "
        f"differing keys: {bad}")
    if bad:
        raise AssertionError(f"card and CPU fleets differ in {bad}")
    if not (card["reclaimed"] > 0).all() or card["overflow"].any():
        raise AssertionError("parity fleet: GC did not run everywhere, or the pool overflowed")
    check_integrity(cfg, card, traces, "parity fleet")

    # one volume alone: the single-volume path, victims from segment_select
    i = 1
    single_cfg = dataclasses.replace(cfg, gp_threshold=float(policies["p_gp"][i]))
    ops.reset_launch_counts()
    alone = convert.state_to_numpy(torchsim.run(single_cfg, traces[i], device="cuda"))
    counts = ops.launch_counts()
    bad = [k for k in alone if not np.array_equal(alone[k][0], card[k][i])]
    log(f"[parity] volume {i} alone on the card vs its fleet row: differing keys {bad}; "
        f"launches {counts}")
    if bad or 0 in (counts["segment_select"], counts["classify_gc"], counts["classify_user"]):
        raise AssertionError("single-volume replay disagrees or skipped its kernels")

    # free-pool exhaustion on the card: duplicate scatter targets alias the
    # pad row, where CUDA leaves the order of writes undefined; the envelope
    # (live rows intact, pad row never free, overflow counted) must hold
    ecfg = dataclasses.replace(cfg, n_lbas=96, segment_size=8, n_segments=16,
                               gp_threshold=0.10)
    tr = np.asarray(np.random.default_rng(67).integers(0, 96, size=6 * 96), np.int32)
    st = {k: x[0] for k, x in convert.state_to_numpy(
        torchsim.run(ecfg, tr, device="cuda")).items()}
    live = (st["loc_seg"] >= 0) & (st["loc_seg"] < ecfg.pad_row)
    lbas = np.nonzero(live)[0]
    seg, off = st["loc_seg"][lbas], st["loc_off"][lbas]
    ok = bool(int(st["overflow"]) > 0 and live.any()
              and (st["seg_lba"][seg, off] == lbas).all() and st["seg_valid"][seg, off].all()
              and (off < ecfg.segment_size).all() and (st["seg_n"] <= ecfg.segment_size).all()
              and int(st["seg_state"][ecfg.pad_row]) != 0)
    log(f"[parity] exhaustion envelope on the card: overflow={int(st['overflow'])} ok={ok}")
    if not ok:
        raise AssertionError("free-pool exhaustion envelope broken on the card")
    torch.cuda.synchronize()
    return cfg.n_rows, counts["segment_select"]


def phase_main():
    """The main run; returns its config, final state and kernel launches."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.core.tracegen import tiled_fleet
    from repro_torch.kernels import ops
    P, n = MAIN_VOLUMES_PER_TILE, MAIN_N_LBAS
    V = P * len(MAIN_GPS)
    log(f"[main] cut: volumes of {n} blocks (64 MiB at 4 KiB) instead of the paper's "
        f">= 10 GiB, since the replay runs its trace steps in sequence under a smoke "
        f"time limit")
    t0 = time.perf_counter()
    traces = tiled_fleet("mixed", len(MAIN_GPS), P, n, 2 * n, jitter=0.25, seed=23)
    cfg = fleet_config(n)
    policies = fleet_policies(cfg, np.repeat(MAIN_GPS, P))
    padded = torchsim.coerce_fleet(traces)
    log(f"[main] {V} volumes, n_lbas {n}, segment_size {cfg.segment_size}, n_rows "
        f"{cfg.n_rows}, steps {padded.shape[1]}, writes {int((padded >= 0).sum())}; "
        f"traces made in {time.perf_counter() - t0:.1f} s")

    stats = torchsim.ReplayStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = torchsim.run_fleet(cfg, padded, policies, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    final = convert.state_to_numpy(st)
    res = torchsim.summarize_fleet(cfg, st, V)
    writes = res["fleet"]["user_writes"]
    log(f"[main] wall {wall:.3f} s, user steps {stats.steps}, volume-writes {writes}, "
        f"volume-writes/s {writes / wall:.1f}, s/step {wall / stats.steps:.6f}")
    log(f"[main] GC ticks {stats.gc_ticks}, tick iterations {stats.tick_iterations} "
        f"({stats.tick_iterations / stats.steps:.4f} per step), host syncs per step "
        f"{(stats.steps + stats.tick_iterations) / stats.steps:.4f}, reclaimed "
        f"{int(final['reclaimed'].sum())}, overflow {res['fleet']['overflow']}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    was = np.asarray(res["fleet"]["per_volume_wa"])
    med = {gp: float(np.median(was[j * P:(j + 1) * P])) for j, gp in enumerate(MAIN_GPS)}
    log(f"[main] fleet WA {res['fleet']['wa']:.6f}; median WA per GC threshold {med}")
    log(f"[main] kernel launches {counts}")
    if res["fleet"]["overflow"] != 0:
        raise AssertionError("main run overflowed its segment pool")
    if 0 in (counts["segment_select_batch"], counts["classify_gc"], counts["classify_user"]):
        raise AssertionError("main run did not go through its kernels")
    if not (np.isfinite(was).all() and (was >= 1.0).all() and (final["reclaimed"] > 0).all()):
        raise AssertionError("main run WA out of range, or a volume never ran GC")
    check_integrity(cfg, final, traces, "main run")
    return cfg, st, counts


def _device_us(event) -> float:
    """Device time of a profiler row, under the attribute's newer or older name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def phase_profile(cfg, st, steps: int = PROFILE_STEPS) -> None:
    """A steady window after the main run: ``steps`` more random updates per
    volume under torch.profiler; prints the device's busy share of the wall
    time, the kernel launches per step and the kernels by device time. The
    profiler slows the host, so the busy share is a lower bound of the
    unprofiled run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import torchsim
    V = st["t"].shape[0]
    extra = np.random.default_rng(5).integers(0, cfg.n_lbas, (V, steps), dtype=np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torchsim.run_fleet(cfg, extra, device="cuda", state=st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in rows if e.device_type.name == "CUDA"] or rows
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"[profile] {steps} steady steps x {V} volumes: wall {wall:.3f} s (profiled), "
        f"device busy {busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.2f}% of wall, "
        f"{launches / steps:.1f} kernel launches per step")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:10]:
        log(f"[profile]   {e.key[:70]:70s} {_device_us(e):12.1f} us x{e.count}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails when the script stands without the repo)

    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    main_rows = fleet_config(MAIN_N_LBAS).n_rows
    kernels = phase_kernels(np.random.default_rng(0),
                            (MAIN_VOLUMES_PER_TILE * len(MAIN_GPS), main_rows),
                            fleet_config(PARITY_N_LBAS).n_rows)
    kernels += phase_zipf_kernel()
    decode_row, decode_launches = phase_decode()
    kernels.append(decode_row)
    analysis_launches = phase_analysis()
    single_rows, k2_launches = phase_parity()
    cfg, st, counts = phase_main()
    if (cfg.n_rows, single_rows) != (main_rows, fleet_config(PARITY_N_LBAS).n_rows):
        raise AssertionError("a kernel was timed at another shape than its path's")
    phase_profile(cfg, st)
    launches = {**counts, "segment_select": k2_launches, **analysis_launches,
                "flash_decode": decode_launches}
    for row in kernels:
        row["launches"] = launches[row["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(device["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
