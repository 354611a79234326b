#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together);
3. kernels: each kernel's wrapper on card tensors against its plain PyTorch
   version on the same inputs (bit equality for the replay engine's
   kernels; the Zipf sums within rtol 2e-4 / atol 1e-6 at every alpha of
   the figures, batches of 8, 25, 20, 5 and 5 points bit-equal to their
   points launched one at a time and bit-identical on a repeat), and its
   time (the Zipf sums at one point, and at the Fig 8(a) and Fig 10(a)
   grids' and the Fig 8(b) and Fig 10(b) curves' batches);
4. decode: flash-decode attention through its entry point at qwen3-32b's,
   starcoder2-3b's and phi3-mini's decode geometry in bfloat16 and float32,
   against its plain version (1e-4 in float32, 2e-2 in bfloat16; and within
   atol 1e-4, rtol 2^-8 of the plain version in float32, half an ulp of the
   bfloat16 output), a repeat bit-identical, then timed in bfloat16 beside
   scaled_dot_product_attention at each geometry (qwen3-32b's in the kernel
   table, and again with every row live), with the split grid;
5. serve: the LM serving path at qwen3-32b's full width on SERVE_LAYERS of
   its 64 layers in bfloat16 (random weights made on the card): the decode
   step with K5 against the same step with its plain version (float32 on 2
   layers within 1e-4; bfloat16 on SERVE_LAYERS within SERVE_K5_TOL of the
   largest logit), prefill plus decode against the teacher-forced forward,
   then the reference serving example's traffic (48 requests, batch 8)
   through the port's serving functions, nosep then sepbit, its page
   store's WA equal to the CPU's; K5 launched once per layer and decode
   step and never by prefill; a profiled
   decode window, a longer-context batch (B 8, prompt 1,024), and K5 timed
   at both shapes beside scaled_dot_product_attention;
6. train: the training path at stablelm-1.6b's full width and TRAIN_LAYERS
   of its 24 layers (bfloat16 weights made on the card, float32 AdamW
   moments, remat): (a) one loss and backward in float32 on 2 layers,
   card against CPU (the loss within 1e-4 relative, every gradient leaf
   within 1e-4 of its largest |grad|); (b) 30 AdamW steps at B 8, S 1,024
   on the synthetic pipeline, every loss finite and the last five's mean at
   least TRAIN_MARGIN under the first, the step timed against 6 N T and
   8 N T over the bf16 peak, its host syncs counted, two steps profiled;
   (c) the whole train state (46 leaves) saved through the
   port's SepBIT checkpoint store and restored onto the card, every leaf
   bit-equal, save and restore rates and the store's WA printed;
7. blocks: the MoE block, local attention and the recurrent blocks at full
   width (random weights made on the card): (a) granite-moe-3b-a800m (2 of
   32 layers), recurrentgemma-2b (one period, 3 of 26) and rwkv6-3b (2 of
   32) in float32, card against CPU over 130 tokens (forward, then prefill
   of 120 and 10 decode steps; logits within 1e-4 of the largest, the aux
   within 1e-4 relative; MoE routings that differ are printed with their
   top-K margin); (b) granite-moe-3b-a800m on MOE_LAYERS of its 32 layers
   in bfloat16 through the serving path: K5 against its plain version in
   the decode step, decode against forward (5e-2, the reference's MoE
   tolerance), [serve]'s traffic under both policies with the CPU's WA, K5
   launched once per layer and decode step, no host sync, a profiled
   window, K5 timed at this shape; (c) five granite AdamW steps on
   MOE_LAYERS layers at B 8, S 1,024 with remat, every
   loss and aux finite, against 6 N_active T; (d) recurrentgemma-2b (prompt
   2,080 past its 2,048-slot ring) and rwkv6-3b (prompt 1,000) at full
   depth in bfloat16, B 8, 64 decode steps against forward over the stream
   (2e-2), timed against their bytes bound, host syncs counted, profiled;
8. vlm_audio: the vlm prefix and whisper: (a) paligemma-3b (2 of 18
   layers) and whisper-small (2 + 2 of 12 + 12) at full width in float32,
   card against CPU (logits within 1e-4 of the largest, every cache leaf
   within 1e-4 of its largest); (b) paligemma-3b at full depth in bfloat16,
   B 8 rows of 256 image embeddings and 16 tokens, 64 greedy decode steps
   through the serving functions: K5 at head dim 256 18 times a step, no
   host sync, K5 = its plain version and decode = forward within 2e-2 of
   the largest |logit|, a profiled window; (c) whisper-small the same, B 8
   rows of 1,500 frames and 4 tokens, a self cache of 448: K5 24 times a
   step (self and cross); (d) one AdamW step of each at full width on
   ``input_specs``' inputs, loss and grad norm finite, no host sync; (e) K5
   timed at the three served shapes beside scaled_dot_product_attention;
9. dist: the distribution layer: (a) stablelm-1.6b at full width and
   depth in bfloat16 served through ``make_prefill_fn`` / ``make_decode_fn``
   with a ``Sharder`` on the (1, 1) mesh of a one-rank NCCL group
   (``launch.make_host_mesh``), B 8, prompt 128, 32 greedy steps: every
   logit bit-equal to the same calls without a sharder, K5 24 times a step,
   no host sync, the step against its bytes bound; (b) the int8
   error-feedback all-reduce over that group on a float32 tree of its
   parameter shapes: q and scales card = CPU, sent + residual == y exactly,
   20 rounds' mean within one quantum of the gradient, a round's GB/s
   against its bytes bound; (c) the dry run's command line in a subprocess
   (a fake process group of 256 ranks, meta tensors) at qwen3-32b's
   train_4k, prefill_32k and decode_32k on the 16 x 16 mesh, every cell ok,
   its per-chip bytes against the card's memory and FLOPs against 2 N T
   (6 or 8 N T), then the H100 roofline table;
10. analysis: the paper's §3 at its own scale (n = 10 * 2^18): the eight
   Fig 8 / Fig 10 points of the repository's benchmark, five of them held
   to the paper's values, all four figure grids through the Zipf kernel
   (one launch per pmf: 11 in each figure's part; every point counted;
   points shared by two calls equal bit for bit; the pmf made on the card
   compared with numpy's, printed), and Figs 9 / 11 on the benchmark-grade
   volume pool, equal on the card and on the CPU;
11. engine parity: a reduced fleet replayed on the card by the replay kernel
   and by the step engine (kernels K1 and K3 between PyTorch ops) must end
   in states bit-equal to the step engine's on the CPU; one volume replayed
   alone on the card under both engines (the replay kernel at V = 1, and the
   single-volume victim kernel K2) must equal its row of the fleet; in the
   free-pool exhaustion corner the replay kernel must equal the CPU and the
   step engine keep its envelope; a fleet of all 14 schemes, one volume
   each, through the replay kernel's stateful instance must equal the CPU
   on every key, sch_* included;
12. main run: the 186-volume mixed corpus tiled over the four GC thresholds
   of the repository's gcbench (744 volumes of 64 MiB at 4 KiB blocks),
   SepBIT with cost-benefit selection, replayed by the replay kernel; the
   step engine on its first 24,576 steps, every final key equal to the
   replay kernel's replay of the same prefix; eight of its volumes
   replayed over the whole trace by the step engine on the CPU, the replay
   kernel's plain version, equal to their rows; the replay kernel timed
   alone on both inputs;
13. scale: the replay kernel alone on 32 volumes of 1 GiB, held to the
   state invariants, its time and its victim scans' bytes per user write;
14. profile: steady windows of both engines under torch.profiler;
15. schemes: the paper's 14-scheme comparison (Exp#1): the 186-volume
    corpus under each of the 14 placement schemes, 2,604 volumes in one
    launch of the replay kernel (its stateful instance). (a) 8 MiB
    volumes: WA per scheme, ranked; one volume per scheme equal to the step
    engine on the CPU on every key; every volume equal to the card's step
    engine (K1 and K3, the stateful branches between them) over steps
    4,096-5,119 from the kernel's state; a profiled steady window of the
    step engine. (b) 64 MiB volumes (the main run's), the kernel alone: WA
    per scheme, ranked, the invariants, the rows of one volume per stateful
    scheme equal to the CPU over the whole trace (three workers); the
    kernel timed at both sizes, and at 64 MiB each scheme's 186 volumes
    alone and the elementwise ones through the stateful instance too, each
    equal to its rows of the fleet's replay;
16. paper: the paper's Exp#2, Exp#3 and Exp#5 on the main run's corpus
    through the replay kernel, cost-benefit: Exp#2 under nosep, sepgc,
    warcip, sepbit and fk at (segment, victims per GC operation) (32, 4),
    (64, 2) and (128, 1), 930 volumes a launch; Exp#3 the same five schemes
    at GP 0.10-0.25 as per-volume policies, 3,720 volumes in one launch;
    Exp#5 the 186 volumes under sepbit with SepBIT's FIFO samples on; rows
    as ``benchmarks/run.py`` prints them. Gates: two reduced 14-scheme
    fleets (2,048 blocks, k victims, FIFO on) equal to the CPU step engine
    on every key; per timed fleet, overflow 0, the invariants, the FIFO
    samples' bounds, the kernel equal to the card's step engine over a
    window of steps from its own state and, on one volume, to the CPU step
    engine over the first 24,576 steps; each timed on three fresh states;
17. sweep: the heterogeneous sweep of ``core/fleetshard.py`` at full width,
    the main run's corpus under 5 elementwise schemes x 2 selectors x GP
    0.10 / 0.15 / 0.20 (5,580 volumes of 64 MiB), timing model on, through
    the replay kernel's timing instance: grouped (one launch per scheme)
    equal to ungrouped (one launch) on every key, one volume of each
    (scheme, selector) pair equal to the step engine on the CPU (run in a
    worker beside the card), the accounting conserved; per cell WA, mean
    +- CI and p50 / p99; the kernel timed alone with timing on and off;
18. latency: the committed ``BENCH_gc_latency.json`` reproduced on every
    field (nosep / sepgc / sepbit on the replay kernel, fk on the step
    engine), then greedy / rate_limited / idle_window x nosep / sepgc /
    sepbit at full width (1,674 volumes): overflow 0, rate_limited's GC
    writes equal to greedy's, the accounting conserved, one volume per cell
    equal to the CPU on every key;
19. gcbench: the JAX package's gcbench fleet (16 volumes of 1 MiB, segment
    32, sepbit, cost-benefit, GC thresholds 0.08-0.22) under the legacy GC
    engine on the step engine and the tick engine on the replay kernel, each
    reproducing ``BENCH_fleet_gc.json``'s per-volume reclaimed counts, WA and
    GC writes, equal to each other on every key, with each engine's steady
    volumes/s; one volume alone under legacy (K2) equal to its fleet row;
20. legacy: the main run's 744 volumes through a prefix of their steps
    under the legacy GC engine on the card's step engine (K1 at loop entry on
    every write, K3 on every rewrite), equal on every key to the replay
    kernel on the same prefix and, on eight volumes, to the legacy engine on
    the CPU; overflow 0 and every volume past its first GC; a closing window
    timed under both GC engines on the step engine; K1, K2 and K3 timed at
    this path's shapes.

Each [kernels] line of the replay kernel (replay, replay_timing,
replay_stateful) names its instance with its registers, spills, volumes a
block, shared memory a block, resident volumes and waves.

Before the last line it prints the kernel table as one JSON object; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA it exits 1
before printing any result.

``python3 chip_smoke.py --replay-times SRC [SRC ...]`` (``PYTHONPATH=src``)
times the replay kernel of each given source tree instead, in turns on one
card (`replay_times`).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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
PARITY_SFS_RESAMPLE = 256      # [parity]'s 14-scheme fleet: sfs refreshes every 256 writes
PROFILE_REPLAY_STEPS = 8192    # the profiled steady windows after the main run, per engine
PROFILE_STEP_STEPS = 25        # the profiler's analysis of a step-engine window grows with it
PLAIN_VOLUMES_PER_TILE = 2     # main-run volumes per GC threshold replayed by the CPU step engine
MAIN_STEP_PREFIX = 24576       # the main run's steps the card's step engine replays ([legacy]'s)
SCHEMES_VOLUMES_PER_SCHEME = 186   # [schemes]: the corpus, replayed under each of the 14 schemes
SCHEMES_N_LBAS = 2048          # [schemes] (a): 8 MiB volumes at 4 KiB blocks
SCHEMES_WINDOW_START = 4096    # (a): the card's step engine replays steps 4,096-5,119 (host-bound
SCHEMES_STEP_WINDOW = 1024     # per step), past every volume's first GC, from the kernel's state
SCHEMES_CPU_WORKERS = 3        # (b): 64 MiB; the CPU step engine's workers, each replaying three
                               # of the nine stateful volumes over the whole trace
SCHEMES_TIMED = 3              # (b): launches of the replay kernel timed, each on a fresh state
SCHEMES_GP = 0.15
SCHEMES_PROFILE_STEPS = 25
REPLAY_TIMED = 5               # launches of the replay kernel timed, each on a fresh state
SCALE_N_LBAS = 262144          # [scale]: 1 GiB volumes at 4 KiB blocks
SCALE_VOLUMES_PER_TILE = 8
# benchmarks/run.py fig8_user_bit / fig10_gc_bit: (window GiB, window GiB,
# alpha, the paper's percentage or None), and tests/test_analysis.py's
# tolerance for each paper value, in percentage points
FIG8_POINTS = ((0.25, 4, 1.0, 77.1), (1, 0.25, 1.0, None), (1, 4, 1.0, 87.1), (1, 1, 0.0, 9.5))
FIG10_POINTS = ((2, 8, 1.0, 41.2), (32, 8, 1.0, 14.9), (2, 8, 0.2, None), (32, 8, 0.2, None))
PAPER_TOL = {77.1: 0.2, 87.1: 0.3, 9.5: 0.2, 41.2: 0.3, 14.9: 0.3}
# (Hq, Hkv, D) of the decode geometries: src/repro/configs/qwen3_32b.py,
# starcoder2_3b.py, phi3_mini.py; (B, S) timed and checked
QWEN3_32B, STARCODER2_3B, PHI3_MINI = (64, 8, 128), (24, 2, 128), (32, 32, 96)
DECODE_TIMED, DECODE_CHECKED = (16, 8192), (8, 4096)
PREV_DECODE_MS = 1.472         # K5 before the split-KV design, at the timed shape (PERF.md, run D)
SERVE_ARCH = "qwen3-32b"       # [serve]: K5's timed geometry, at full width in bfloat16
SERVE_LAYERS = 32              # of its 64: the decode steps are host-bound, launches per layer
SERVE_SEED = 20
# examples/serve_paged.py's defaults: requests, batch, prompt, page, max new tokens
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_PAGE, SERVE_MAX_NEW = 48, 8, 16, 8, 96
SERVE_WA = {"nosep": 3.990, "sepbit": 2.193}   # the example's store accounting on the CPU
SERVE_STEPS, SERVE_PREFILLS = 140, 48          # per policy, the same accounting
CHECK_B, CHECK_PROMPT, CHECK_STEPS = 2, 8, 4   # tests/test_models.py's decode-vs-forward pattern
CHECK_F32_LAYERS = 2
CHECK_F32_TOL = 1e-4           # (a) K5 against its plain version in float32, logits, absolute
# (b) and (c) in bfloat16: the largest logit difference over the largest |logit|. The
# first run on the card (NVIDIA H100 80GB HBM3, 700 W) measured 6.33e-3 in both: one
# bfloat16 ulp (2^-5) of a logit in [4, 8), at a largest |logit| of 4.94
SERVE_K5_TOL = 2e-2
SERVE_FWD_TOL = 2e-2
LONG_B, LONG_PROMPT, LONG_STEPS = 8, 1024, 32  # [serve]'s longer-context batch
PROFILE_SERVE_STEPS = 4
K5_KERNELS = ("split_kernel", "combine_kernel")   # csrc/decode_attn.cu's two passes
TRAIN_ARCH = "stablelm-1.6b"   # [train]: fits one card with its AdamW state at full width
TRAIN_LAYERS = 8               # of its 24: the checkpoint round trip is host-bound by the bytes
TRAIN_SEED = 21
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 30
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
TRAIN_TIMED_FROM = 5           # steps 5..29 timed, their syncs counted
TRAIN_MARGIN = 1.0             # mean of the last five losses at least this far under the first
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 128   # (a), float32, card against CPU
TRAIN_CHECK_TOL = 1e-4         # (a): loss relative; each gradient leaf of its largest |grad|
PROFILE_TRAIN_STEPS = 2
BLOCKS_SEED = 22
# [blocks] (a): float32 at full width, cut depth (granite 2 of 32, recurrentgemma one period of
# 3 of 26, rwkv6 2 of 32), B 1, a stream of 130 crossing RWKV's 64-token chunk edge
BLOCKS_CHECK_LAYERS = {"granite-moe-3b-a800m": 2, "recurrentgemma-2b": 3, "rwkv6-3b": 2}
BLOCKS_CHECK_S, BLOCKS_CHECK_PROMPT = 130, 120
BLOCKS_CHECK_TOL = 1e-4        # logits of the largest |logit|; the aux relative
MOE_ARCH = "granite-moe-3b-a800m"   # (b) served through K5, (c) trained
MOE_LAYERS = 16                # of its 32 in (b) and (c): the decode steps are host-bound
MOE_FWD_TOL = 5e-2             # (b) decode against forward: tests/test_models.py's MoE tolerance
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 8, 1024, 5
# (d): recurrentgemma's prompt wraps its ring of W = 2,048; rwkv6's is not a multiple of 64
RECURRENT_PROMPT = {"recurrentgemma-2b": 2080, "rwkv6-3b": 1000}
RECURRENT_B, RECURRENT_STEPS = 8, 64
RECURRENT_TOL = 2e-2
PROFILE_BLOCK_STEPS = 4
VLM_ARCH, AUDIO_ARCH = "paligemma-3b", "whisper-small"   # [vlm_audio]: the stub frontends
STUB_SEED = 23
# (a): float32, full width, cut depth (paligemma 2 of 18 layers, whisper 2 + 2 of 12 + 12),
# B 1, the stub frontend's 256 embeddings or 1,500 frames, 16 text tokens: forward over all
# 16, prefill of 12 and 4 decode steps
STUB_CHECK_LAYERS, STUB_CHECK_TOKENS, STUB_CHECK_STEPS = 2, 16, 4
STUB_CHECK_TOL = 1e-4          # logits of the largest |logit|; each cache leaf of its largest
# (b), (c): B 8 served in bfloat16, 64 greedy decode steps; paligemma's prompt 16 tokens after
# its 256 image embeddings, whisper's 4 (the start-of-transcript sequence's length) beside
# 1,500 frames (a 30-second window), its self cache Whisper's decoder context of 448
STUB_B, STUB_STEPS, VLM_PROMPT, AUDIO_PROMPT, AUDIO_MAX_SEQ = 8, 64, 16, 4, 448
STUB_TOL = 2e-2                # K5 = plain and decode = forward, of the largest |logit|
PROFILE_STUB_STEPS = 4
# (d): one AdamW step at full width: paligemma B 4 x (256 prefix + 128 text), whisper B 8 x
# (1,500 frames, 448 tokens), inputs by input_specs
STUB_TRAIN = {VLM_ARCH: (4, 256 + 128), AUDIO_ARCH: (8, 448)}


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


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch
    smi = _smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "smi": smi}


REPLAY_PTXAS: dict = {}    # replay kernel instance flags -> ptxas' registers and spill bytes


def _replay_ptxas(text: str) -> dict:
    """ptxas' -v lines of the replay kernel, per instance: the template's
    flags (kTiming, kDefer, kStateful[, kSharedMeta[, kPaper]]) as a string of 0 / 1
    -> registers, stack frame and spill store / load bytes (a function the
    instance calls has lines of its own, not counted here)."""
    import re

    def flags(name):
        m = re.search(r"replay_kernelI((?:Lb[01]E)+)E", name)
        return "".join(re.findall(r"Lb([01])E", m[1])) if m else None

    out, cur, props, frame = {}, None, None, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur, frame = flags(m[1]), None
        elif m := re.search(r"Function properties for (\S+)", line):
            props = flags(m[1])
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                            r"spill loads", line):
            if props is not None and props == cur:
                frame = [int(x) for x in m.groups()]
        elif (m := re.search(r"Used (\d+) registers", line)) and cur is not None:
            out[cur] = {"registers": int(m[1]), "stack_frame": frame and frame[0],
                        "spill_stores": frame and frame[1], "spill_loads": frame and frame[2]}
            cur = None
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(logs)} kernel(s) built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line:          # the instance whose lines follow
                log(f"[build] {name}: {line.split(chr(39))[1][:96]}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")
    REPLAY_PTXAS.update(_replay_ptxas(logs.get("replay", "")))


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


def _fig_exponents() -> dict:
    """K4's batches on the path, as (u0, v0, g0, r0) rows in blocks: the
    eight Fig 8 / Fig 10 points, the default Fig 8(a) and Fig 10(a) grids,
    and the Fig 8(b) and Fig 10(b) curves' batch at one alpha."""
    from repro_torch.core import analysis as A
    G = A.BLOCKS_PER_GIB
    fig8 = [(u0 * G, v0 * G, 0.0, 0.0) for u0, v0, _, _ in FIG8_POINTS]
    fig10 = [(0.0, 0.0, g0 * G, r0 * G) for g0, r0, _, _ in FIG10_POINTS]
    return {"fig8": fig8, "fig10": fig10, "points": fig8 + fig10,
            "fig8a": [(u0 * G, v0 * G, 0.0, 0.0) for u0 in A.FIG8_WINDOWS_GIB
                      for v0 in A.FIG8_WINDOWS_GIB],
            "fig10a": [(0.0, 0.0, g0 * G, r0 * G) for g0 in A.FIG10_G0_GIB
                       for r0 in A.FIG10A_R0_GIB],
            "fig8b": [(A.FIG8B_U0_GIB * G, v0 * G, 0.0, 0.0) for v0 in A.FIG8_WINDOWS_GIB],
            "fig10b": [(0.0, 0.0, g0 * G, A.FIG10B_R0_GIB * G) for g0 in A.FIG10_G0_GIB]}


def zipf_ops(n: int, exps) -> int:
    """K4's float operations over an (n,) pmf whose p are all below 1, for
    the batch ``exps``, by the kernel table's rule: only the arithmetic the
    kernel does. Per element the negation, log1pf and the Σp add once; per
    point a multiply and an expf for each nonzero exponent (u0, v0, g0 and
    g0 + r0 added in float32), 7 operations for s0 and s1 unless u0 = v0 =
    0, and 5 for s2 and s3 where g0 is nonzero, else 3 for s3 where g0 + r0
    is (s2 is then the shared Σp)."""
    per_element = 3
    for u0, v0, g0, r0 in exps:
        u0, v0, g0 = (np.float32(x) for x in (u0, v0, g0))
        gr = g0 + np.float32(r0)
        per_element += 2 * sum(bool(x != 0) for x in (u0, v0, g0, gr))
        per_element += 7 if u0 != 0 or v0 != 0 else 0
        per_element += 5 if g0 != 0 else 3 if gr != 0 else 0
    return n * per_element


def phase_zipf_kernel() -> list[dict]:
    """K4 at the paper's n against its plain version over the pmf of every
    alpha of the figures: the eight Fig 8 / Fig 10 points as one batch, the
    Fig 8(a) and Fig 10(a) grids as batches of 25 and 20 and the Fig 8(b)
    and Fig 10(b) curves' batches of 5, each batch equal bit for bit to its
    points launched one at a time and to a repeat. Then, over the alpha = 1
    pmf, the time of a single-point launch at one point of each figure, and
    of the grids' and the curves' launches."""
    import torch

    from repro_torch.core import analysis
    from repro_torch.kernels import ref
    from repro_torch.kernels.zipfprob import batch_grid, zipf_bit_sums, zipf_bit_sums_batch
    n = analysis.PAPER_N
    batches = _fig_exponents()
    checked = ("points", "fig8a", "fig10a", "fig8b", "fig10b")
    worst = {"fig8": 0.0, "fig10": 0.0, "fig8a": 0.0, "fig10a": 0.0, "fig8b": 0.0, "fig10b": 0.0}
    for alpha in analysis.FIG_ALPHAS:
        p = analysis.zipf_pmf(n, alpha, "cuda")
        for name in checked:
            exps = batches[name]
            got, again = zipf_bit_sums_batch(p, exps), zipf_bit_sums_batch(p, exps)
            singles = torch.stack([zipf_bit_sums(p, *e) for e in exps])
            want = ref.zipf_bit_sums_batch_ref(p, exps)
            torch.cuda.synchronize()
            close = torch.allclose(got, want, rtol=2e-4, atol=1e-6)
            if not (close and torch.equal(got, again) and torch.equal(got, singles)):
                raise AssertionError(f"K4 batch {name} at alpha {alpha}: {got.tolist()} against "
                                     f"plain {want.tolist()}, repeat {again.tolist()}, single "
                                     f"calls {singles.tolist()}")
            if name == "points":
                half = len(batches["fig8"])
                worst["fig8"] = max(worst["fig8"], max_abs_err(got[:half], want[:half]))
                worst["fig10"] = max(worst["fig10"], max_abs_err(got[half:], want[half:]))
            else:
                worst[name] = max(worst[name], max_abs_err(got, want))
    log(f"[kernels] K4 zipf_bit_sums_batch ({n},) over alpha {analysis.FIG_ALPHAS}, batches "
        f"of {', '.join(f'{len(batches[k])} ({k})' for k in checked)} points: within rtol 2e-4 "
        f"/ atol 1e-6, equal bit for bit to single-point launches, repeats bit-identical; max "
        f"|err| {worst}; grid {batch_grid(n)}")
    p = analysis.zipf_pmf(n, 1.0, "cuda")
    timed = {"fig8": batches["fig8"][:1], "fig10": batches["fig10"][:1],
             "fig8a_batch": batches["fig8a"], "fig10a_batch": batches["fig10a"],
             "fig8b_batch": batches["fig8b"], "fig10b_batch": batches["fig10b"]}
    rows = []
    for name, exps in timed.items():
        on_card = torch.tensor(exps, dtype=torch.float32, device="cuda")
        rows.append({
            "name": f"zipf_bit_sums_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zipfprob.cu",
            "replaces": "src/repro/kernels/zipfprob.py:54",
            "shape": [n], "points": len(exps), "exponents": [list(e) for e in exps],
            "max_abs_err": worst[name.removesuffix("_batch")],
            "ms": time_ms(lambda: zipf_bit_sums_batch(p, on_card)),
            "plain_ms": time_ms(lambda: ref.zipf_bit_sums_batch_ref(p, exps), reps=10),
            **bound(4 * n + 32 * len(exps), zipf_ops(n, exps)),
            "tolerance": "rtol 2e-4, atol 1e-6; bit-equal to single-point launches; repeat "
                         "bit-identical",
            "library_ms": None})
    for r in rows:
        log(f"[kernels] {r['name']} {r['shape']} x {r['points']} points: {r['ms'] * 1e3:.2f} us, "
            f"{r['ms'] * 1e3 / r['points']:.3f} us per point (plain {r['plain_ms'] * 1e3:.2f} us, "
            f"bound {r['bound_ms'] * 1e3:.3f} us, {r['bound_by']}, "
            f"{zipf_ops(1, r['exponents'])} operations per element)")
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
    geometries in both dtypes; each output against the plain version and a
    repeat bit-identical; the split grid of each geometry; then the kernel
    and scaled_dot_product_attention timed at each geometry in bfloat16, and
    the plain version too at qwen3-32b's. Returns the K5 row and its
    launches on the path."""
    import torch

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
        ok, err, err32 = _decode_check(out, *x)
        log(f"[decode] {name} (B, S) {bs} (Hq, Hkv, D) {heads} {str(dtype)[6:]}: max |err| "
            f"{err:.3e}, against float32 {err32:.3e} ok={ok}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {name} {dtype}")
        errs.append(err)

    for x, out in zip(inputs, outs):
        if not torch.equal(decode_attn._launch(*x), out):
            raise AssertionError("K5 is not bit-identical on a repeat of the same input")
    for (name, heads, bs, dtype), x in zip(cases, inputs):
        if dtype != torch.bfloat16:
            continue
        B, S = bs
        grid = decode_attn.split_grid(B, S, *heads)
        live = sum(-(-n // grid["chunk"]) for n in x[3].clamp(max=S).tolist())
        per_chunk = heads[1] * grid["tiles"]
        log(f"[decode] {name} grid: chunk {grid['chunk']} rows, {grid['chunks']} chunks x "
            f"{per_chunk} (KV head, query-head tile) x {B} rows = "
            f"{grid['chunks'] * per_chunk * B} blocks, {live * per_chunk} live, "
            f"{grid['threads']} threads each; query-head tile {grid['tile']} "
            f"({grid['tiles']} per KV head); combine {heads[0] * B} blocks")
        if name != "qwen3-32b":      # the timed case's row is below
            ms = time_ms(lambda: decode_attn._launch(*x), reps=5)
            log(f"[decode] {name} bf16: {ms * 1e3:.2f} us, scaled_dot_product_attention "
                f"{_decode_library(*x)[1] * 1e3:.2f} us, "
                f"bound {_decode_bound(*x)['bound_ms'] * 1e3:.2f} us")

    q, k, v, kl = inputs[0]          # the timed case: qwen3-32b in bfloat16
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    library, library_ms = _decode_library(q, k, v, kl)
    lib_err = max_abs_err(library()[:, :, 0].float(), ref.flash_decode_ref(q, k, v, kl).float())
    rows_read = int(kl.clamp(max=S).sum())
    limit = _decode_bound(q, k, v, kl)
    # the wrapper's kv_len check reads the device, which a CUDA graph cannot
    # capture: time the launch behind it
    row = {"name": "flash_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
           "replaces": "src/repro/kernels/decode_attn.py:66",
           "shape": [B, S, Hq, Hkv, D], "dtype": "bfloat16", "kv_rows": rows_read,
           "max_abs_err": errs[0],
           "ms": time_ms(lambda: decode_attn._launch(q, k, v, kl), reps=5),
           "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, k, v, kl), reps=5),
           **limit, "tolerance": "2e-2 (bfloat16), 1e-4 (float32); against the float32 "
           "plain version atol 1e-4, rtol 2^-8 (bfloat16) or 1e-4", "library_ms": library_ms}
    log(f"[kernels] flash_decode qwen3-32b B={B} S={S} bf16, {rows_read} KV rows: "
        f"{row['ms'] * 1e3:.1f} us (the kernel before the split-KV design, recorded in PERF.md, "
        f"not this run: {PREV_DECODE_MS * 1e3:.0f} us; "
        f"plain {row['plain_ms'] * 1e3:.1f} us, "
        f"scaled_dot_product_attention {row['library_ms'] * 1e3:.1f} us, its max |err| "
        f"{lib_err:.3e}; bound {row['bound_ms'] * 1e3:.1f} us, {row['bound_by']})")
    # the same inputs with every row live: the kernel's gain above comes
    # from skipping the rows past kv_len, which the library reads masked
    full = (q, k, v, torch.full_like(kl, S))
    ok, err, err32 = _decode_check(decode_attn._launch(*full), *full)
    log(f"[decode] qwen3-32b bf16, every row live ({B * S} KV rows): max |err| {err:.3e}, "
        f"against float32 {err32:.3e} ok={ok}")
    if not ok:
        raise AssertionError("K5 disagrees with its plain version with every row live")
    log(f"[decode] qwen3-32b bf16, every row live: "
        f"{time_ms(lambda: decode_attn._launch(*full), reps=5) * 1e3:.2f} us, "
        f"scaled_dot_product_attention {_decode_library(*full)[1] * 1e3:.2f} us, "
        f"bound {_decode_bound(*full)['bound_ms'] * 1e3:.2f} us")
    return row, launches


def _decode_check(out, q, k, v, kl) -> tuple[bool, float, float]:
    """K5's output against the plain version on the same inputs: within
    atol = rtol = 1e-4 (float32) or 2e-2 (bfloat16); and against the plain
    version in float32 on the same values, before the output's rounding,
    within atol 1e-4 and rtol 1e-4 (float32) or 2^-8 (bfloat16: half an
    ulp). Returns (ok, max |err|, max |err| against float32)."""
    import torch

    from repro_torch.kernels import ref
    want = ref.flash_decode_ref(q, k, v, kl)
    want32 = ref.flash_decode_ref(q.float(), k.float(), v.float(), kl)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    rtol32 = 2.0 ** -8 if q.dtype == torch.bfloat16 else 1e-4
    ok = (out.shape == want.shape and out.dtype == q.dtype and bool(torch.isfinite(out).all())
          and torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
          and torch.allclose(out.float(), want32, atol=1e-4, rtol=rtol32))
    return ok, max_abs_err(out.float(), want.float()), max_abs_err(out.float(), want32)


def _decode_bound(q, k, v, kl) -> dict:
    """K5's bound: the K and V rows up to kv_len, q, the output and kv_len
    once each; 4 * Hq * D operations per row at the bf16 tensor-core rate."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    rows_read = int(kl.clamp(max=S).sum())
    size = q.element_size()
    return bound(rows_read * Hkv * D * 2 * size + 2 * B * Hq * D * size + 4 * B,
                 4 * Hq * D * rows_read, BF16_FLOPS)


def _decode_library(q, k, v, kl):
    """scaled_dot_product_attention on the decode inputs (the yardstick, not
    used by the port), and its time in ms."""
    import torch
    import torch.nn.functional as F
    S = k.shape[1]
    mask = (torch.arange(S, device="cuda")[None, :] < kl[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    return library, time_ms(library, reps=5)


def _same(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


def phase_analysis() -> dict:
    """The paper's §3 through the port's entry points on the card, at the
    paper's n; returns K4's launches in the Fig 8 and the Fig 10 parts, by
    row of the kernel table: the single-point launches of the eight points,
    the Fig 8(a) / Fig 10(a) grids' batched launches and the Fig 8(b) /
    Fig 10(b) curves' launches, one per alpha."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import analysis as A
    from repro_torch.core.traces import zipf_probs
    from repro_torch.core.volumes import default_pool
    from repro_torch.kernels import ops
    G = A.BLOCKS_PER_GIB
    failed = []

    def check(what, value, want, tol):
        ok = abs(value - want) <= tol
        log(f"[analysis] {what}: {value:.4f} (paper {want}, tolerance {tol}) ok={ok}")
        if not ok:
            failed.append(what)

    def k4() -> int:
        return ops.launch_counts()["zipf_bit_sums"]

    def parts() -> dict:
        """Both figure parts through the entry points: their values, K4's
        (launches, points) in each part, its launches by row of the kernel
        table, and each part's wall."""
        out = {"counts": {}, "rows": {}, "wall": {}}
        for part, points, pr, grid, curve, sub in (
                ("fig8", FIG8_POINTS, A.pr_user_bit, A.fig8a_grid, A.fig8b_curve, "8"),
                ("fig10", FIG10_POINTS, A.pr_gc_bit, A.fig10a_grid, A.fig10b_curve, "10")):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out[part] = {(a, b, alpha): pr(a * G, b * G, alpha=alpha) for a, b, alpha, _ in points}
            out["rows"][f"zipf_bit_sums_{part}"] = before = k4()
            out[f"{part}_grid"] = grid()
            out["rows"][f"zipf_bit_sums_fig{sub}a_batch"] = k4() - before
            before = k4()
            out[f"{part}_curve"] = curve()
            out["rows"][f"zipf_bit_sums_fig{sub}b_batch"] = k4() - before
            out["wall"][part] = time.perf_counter() - t0
            out["counts"][part] = (k4(), ops.point_counts()["zipf_bit_sums"])
        return out

    first = parts()
    warm = parts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        parts()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, counts = first["rows"], first["counts"]
    fig8, grid8a, curve8b = first["fig8"], first["fig8_grid"], first["fig8_curve"]
    fig10, grid10a, curve10b = first["fig10"], first["fig10_grid"], first["fig10_curve"]
    log(f"[analysis] n {A.PAPER_N}: Fig 8 points and grids {first['wall']['fig8']:.3f} s, "
        f"Fig 10 points and grids {first['wall']['fig10']:.3f} s (again: "
        f"{warm['wall']['fig8']:.3f} s, {warm['wall']['fig10']:.3f} s); K4 (launches, points) "
        f"per part {counts}, launches by row {launches}")
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type.name == "CUDA"]
    busy_us = sum(_device_us(e) for e in kernels)
    log(f"[analysis] both parts under torch.profiler: wall {wall:.4f} s, device busy "
        f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.2f}% of wall, "
        f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:6]:
        log(f"[analysis]   {e.key[:70]:70s} {_device_us(e):10.1f} us x{e.count}")
    repeat = all(first[k] == warm[k] for k in first if k != "wall")
    log(f"[analysis] repeat: every value, count and launch bit-identical: {repeat}")
    if not repeat:
        failed.append("repeat")
    for points, values in ((FIG8_POINTS, fig8), (FIG10_POINTS, fig10)):
        for a, b, alpha, paper in points:
            value = 100 * values[(a, b, alpha)]
            if paper is None:
                log(f"[analysis] ({a}, {b}) GiB alpha {alpha}: {value:.4f} (no paper value)")
            else:
                check(f"({a}, {b}) GiB alpha {alpha}", value, paper, PAPER_TOL[paper])
    check("Fig 8(a) minimum", 100 * min(grid8a.values()), 77.1, 0.3)
    check("Fig 8(b) alpha 1 minimum", 100 * min(curve8b[(1.0, v)] for v in A.FIG8_WINDOWS_GIB),
          87.1, 0.3)
    check("Fig 10(b) separation at alpha 0.2",
          100 * (fig10[(2, 8, 0.2)] - fig10[(32, 8, 0.2)]), 3.5, 0.4)
    check("Fig 10(b) separation at alpha 1.0",
          100 * (fig10[(2, 8, 1.0)] - fig10[(32, 8, 1.0)]), 26.4, 0.4)
    values = [*grid8a.values(), *curve8b.values(), *grid10a.values(), *curve10b.values()]
    log(f"[analysis] grids: {len(grid8a)} + {len(curve8b)} + {len(grid10a)} + {len(curve10b)} "
        f"values, all in [0, 1]: {all(0.0 <= x <= 1.0 for x in values)}")
    # one launch per pmf built: the points one at a time, each grid's one pmf,
    # and each curve's pmf per alpha; every evaluation counted as a point
    pmfs = {"fig8": len(FIG8_POINTS) + 1 + len({a for a, _ in curve8b}),
            "fig10": len(FIG10_POINTS) + 1 + len({a for a, _ in curve10b})}
    evals = {"fig8": len(FIG8_POINTS) + len(grid8a) + len(curve8b),
             "fig10": len(FIG10_POINTS) + len(grid10a) + len(curve10b)}
    for part in ("fig8", "fig10"):
        if counts[part] != (pmfs[part], evals[part]):
            failed.append(f"{part} part: K4 (launches, points) {counts[part]}, expected "
                          f"{(pmfs[part], evals[part])}")
    if 0 in launches.values() or not all(0.0 <= x <= 1.0 for x in values):
        failed.append("grids")
    # a point evaluated alone (a batch of one) equals the same point in a batch
    pairs = []
    for u0, v0, a, _ in FIG8_POINTS:
        if a == 1.0 and (u0, v0) in grid8a:
            pairs.append((f"Fig 8(a) {(u0, v0)}", fig8[(u0, v0, a)], grid8a[(u0, v0)]))
        if u0 == A.FIG8B_U0_GIB and (a, v0) in curve8b:
            pairs.append((f"Fig 8(b) {(a, v0)}", fig8[(u0, v0, a)], curve8b[(a, v0)]))
    for g0, r0, a, _ in FIG10_POINTS:
        if a == 1.0 and (g0, r0) in grid10a:
            pairs.append((f"Fig 10(a) {(g0, r0)}", fig10[(g0, r0, a)], grid10a[(g0, r0)]))
        if r0 == A.FIG10B_R0_GIB and (a, g0) in curve10b:
            pairs.append((f"Fig 10(b) {(a, g0)}", fig10[(g0, r0, a)], curve10b[(a, g0)]))
    u0, r0 = A.FIG8B_U0_GIB, A.FIG10B_R0_GIB
    pairs += [(f"Fig 8(a) = 8(b) at u0 {u0}, v0 {v}", grid8a[(u0, v)], curve8b[(1.0, v)])
              for v in A.FIG8_WINDOWS_GIB]
    pairs += [(f"Fig 10(a) = 10(b) at g0 {g}, r0 {r0}", grid10a[(g, r0)], curve10b[(1.0, g)])
              for g in A.FIG10_G0_GIB]
    unequal = [what for what, x, y in pairs if x != y]
    log(f"[analysis] batch == single: {len(pairs) - len(unequal)} of {len(pairs)} values equal "
        f"bit for bit{'; unequal: ' + ', '.join(unequal) if unequal else ''}")
    if unequal or not pairs:
        failed.append("batch == single")
    for alpha in sorted({a for a, _ in curve8b} | {a for a, _ in curve10b}):
        made = A.zipf_pmf(A.PAPER_N, alpha).cpu().numpy().view(np.int32).astype(np.int64)
        host = zipf_probs(A.PAPER_N, alpha).astype(np.float32).view(np.int32).astype(np.int64)
        ulps = np.abs(made - host)
        log(f"[analysis] pmf at alpha {alpha}, card against numpy in float32: "
            f"{int((ulps != 0).sum())} of {A.PAPER_N} elements differ, max {int(ulps.max())} ulp")

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


def _differing_keys(got: dict, want: dict) -> list[str]:
    return [k for k in want
            if not np.array_equal(got[k], want[k]) or got[k].dtype != want[k].dtype]


def phase_parity() -> tuple[int, int]:
    """The replay kernel and the step engine on the card against the step
    engine on the CPU: a reduced fleet under both engines, then one volume
    alone under both (the single-volume paths: the replay kernel at V = 1,
    and the step engine's K2), then the free-pool exhaustion corner (the
    replay kernel bit-equal to the CPU; the step engine, whose scatters
    leave the order of duplicate targets undefined on the card, within its
    envelope). Returns the single-volume segment count (K2's shape) and
    K2's launches there."""
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
    # the 14-scheme fleet's CPU replay, in a worker beside the rest of the phase
    cfg14 = schemes_config(n, sfs_resample=PARITY_SFS_RESAMPLE)
    traces14 = torchsim.coerce_fleet(make_fleet("mixed", 14, n, 2 * n, jitter=0.25, seed=31))
    pol14 = schemes_policies(cfg14, 1)
    worker = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    cpu14 = worker.submit(_replay_on_cpu, cfg14, traces14, pol14)
    t0 = time.perf_counter()
    cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, policies, device="cpu",
                                                    engine="step"))
    log(f"[parity] fleet V={V} n_lbas={n}: step engine on the cpu {time.perf_counter() - t0:.1f} s")
    if not (cpu["reclaimed"] > 0).all() or cpu["overflow"].any():
        raise AssertionError("parity fleet: GC did not run everywhere, or the pool overflowed")
    card = {}
    for engine in ("replay", "step"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card[engine] = convert.state_to_numpy(torchsim.run_fleet(cfg, traces, policies,
                                                                 device="cuda", engine=engine))
        wall = time.perf_counter() - t0
        bad = _differing_keys(card[engine], cpu)
        log(f"[parity] fleet V={V} engine={engine} on the card {wall:.2f} s, differing keys "
            f"against the cpu: {bad}; launches {ops.launch_counts()}")
        if bad:
            raise AssertionError(f"engine={engine} on the card and the CPU differ in {bad}")
    check_integrity(cfg, card["replay"], traces, "parity fleet")

    # one volume alone: the replay kernel at V = 1, and the step engine's
    # single-volume path with victims from segment_select (K2)
    i = 1
    single_cfg = dataclasses.replace(cfg, gp_threshold=float(policies["p_gp"][i]))
    for engine in ("replay", "step"):
        ops.reset_launch_counts()
        alone = convert.state_to_numpy(torchsim.run(single_cfg, traces[i], device="cuda",
                                                    engine=engine))
        counts = ops.launch_counts()
        bad = [k for k in alone if not np.array_equal(alone[k][0], cpu[k][i])]
        log(f"[parity] volume {i} alone, engine={engine}, vs its fleet row: differing keys "
            f"{bad}; launches {counts}")
        wanted = (("replay",) if engine == "replay"
                  else ("segment_select", "classify_gc", "classify_user"))
        if bad or 0 in (counts[k] for k in wanted):
            raise AssertionError(f"single-volume replay (engine={engine}) disagrees or "
                                 f"skipped its kernels")
    k2_launches = counts["segment_select"]

    # free-pool exhaustion: classes alias the pad row and scatters meet
    # duplicate targets
    ecfg = dataclasses.replace(cfg, n_lbas=96, segment_size=8, n_segments=16,
                               gp_threshold=0.10)
    tr = np.asarray(np.random.default_rng(67).integers(0, 96, size=6 * 96), np.int32)
    want = convert.state_to_numpy(torchsim.run(ecfg, tr, device="cpu", engine="step"))
    got = convert.state_to_numpy(torchsim.run(ecfg, tr, device="cuda"))
    bad = _differing_keys(got, want)
    log(f"[parity] exhaustion corner, engine=replay on the card vs the cpu: overflow="
        f"{int(got['overflow'][0])}, differing keys {bad}")
    if bad or int(want["overflow"][0]) == 0:
        raise AssertionError("replay kernel differs from the CPU in the exhaustion corner")
    st = {k: x[0] for k, x in convert.state_to_numpy(
        torchsim.run(ecfg, tr, device="cuda", engine="step")).items()}
    live = (st["loc_seg"] >= 0) & (st["loc_seg"] < ecfg.pad_row)
    lbas = np.nonzero(live)[0]
    seg, off = st["loc_seg"][lbas], st["loc_off"][lbas]
    ok = bool(int(st["overflow"]) > 0 and live.any()
              and (st["seg_lba"][seg, off] == lbas).all() and st["seg_valid"][seg, off].all()
              and (off < ecfg.segment_size).all() and (st["seg_n"] <= ecfg.segment_size).all()
              and int(st["seg_state"][ecfg.pad_row]) != 0)
    log(f"[parity] exhaustion envelope, engine=step on the card: overflow={int(st['overflow'])} "
        f"ok={ok}")
    if not ok:
        raise AssertionError("free-pool exhaustion envelope broken on the card")

    # all 14 schemes, one volume each, through the replay kernel's stateful
    # instance (sfs refreshing every PARITY_SFS_RESAMPLE writes)
    ops.reset_launch_counts()
    got = convert.state_to_numpy(torchsim.run_fleet(cfg14, traces14, pol14, device="cuda"))
    counts = ops.launch_counts()
    with worker:
        want, cpu_wall = cpu14.result()
    bad = _differing_keys(got, want)
    log(f"[parity] 14-scheme fleet n_lbas={n} (sfs_resample {cfg14.sfs_resample}), engine=replay "
        f"on the card vs the step engine on the cpu ({cpu_wall:.1f} s, in a worker): differing "
        f"keys {bad} of {len(want)} ({sum(k.startswith('sch_') for k in want)} sch_*); launches "
        f"{counts}; reclaimed {want['reclaimed'].tolist()}")
    if bad or counts["replay"] != 1 or not (want["reclaimed"] > 0).all():
        raise AssertionError(f"the replay kernel's 14-scheme fleet differs from the CPU in {bad}")
    check_integrity(cfg14, got, traces14, "parity 14-scheme fleet")
    torch.cuda.synchronize()
    return cfg.n_rows, k2_launches


def replay_bound(st: dict, trace, timing: bool = False, defer: bool = False,
                 stateful: bool = False, nxt=None) -> dict:
    """The replay kernel's bound: the trace and every state key the kernel
    instance takes read once, every key it writes (all but the policy's
    ``p_*``) and its (T,) iteration counts written once. The timing model's
    keys count only for the timing instance, ``p_gcsched`` only for it or
    the deferring one, and the stateful schemes' ``sch_*`` keys only for the
    stateful instance, each only in the rows of the volumes whose scheme
    owns it (the kernel touches no other scheme's tables); fk's next-write
    stream ``nxt``, where the fleet has one, is read once in the fk volumes'
    rows; the FIFO samples, where the state has them, read and written
    once."""
    from repro_torch.core.config import FIFO_KEYS, TorchSimConfig
    from repro_torch.core.placement import stateful as schemes
    from repro_torch.kernels.replay import FK, SCHEME_FIELDS, STATE_FIELDS, TIMING_FIELDS
    V = trace.shape[0]
    sch = st["p_scheme"]
    owners = {k: int((sch == sid).sum()) for sid, impl in schemes.STATEFUL.items()
              for k in impl.spec(TorchSimConfig(n_lbas=1))}
    n_fk = int((sch == FK).sum())
    fields = [k for k in STATE_FIELDS if (timing or k not in TIMING_FIELDS)
              and (timing or defer or k != "p_gcsched") and (stateful or k not in SCHEME_FIELDS)]
    size = {k: st[k].nbytes // V * owners[k] if k in SCHEME_FIELDS else st[k].nbytes
            for k in fields}
    fields += [k for k in FIFO_KEYS if k in st]
    size.update({k: st[k].nbytes for k in FIFO_KEYS if k in st})
    n_bytes = (trace.nbytes + sum(size.values())
               + sum(size[k] for k in fields if not k.startswith("p_"))
               + 4 * trace.shape[1] + (0 if nxt is None else nxt.nbytes // V * n_fk))
    return {**bound(n_bytes), "bytes": n_bytes}


def scan_bytes_per_write(cfg, final: dict) -> float:
    """Bytes of segment metadata the victim scans read per user write: 16
    per row (fill, valid count, seal time, state) for every reclaimed
    victim. It grows with ``n_rows``, i.e. with the volume's size."""
    return 16 * cfg.n_rows * float(final["reclaimed"].sum()) / float(final["user_writes"].sum())


def _state_digest(st: dict) -> str:
    """A digest of a state on the card: per key, its bytes as int32 (or
    bytes) summed with position weights in int64, all keys folded into one
    hex string; two replays that end bit-equal have equal digests."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for key in sorted(st):
        x = st[key].reshape(-1)
        x = x.view(torch.int32) if x.element_size() == 4 else x.to(torch.int32)
        w = torch.arange(1, x.numel() + 1, dtype=torch.int64, device=x.device) % 1_000_003 + 1
        h.update(f"{key}:{int((x.to(torch.int64) * w).sum())};".encode())
    return h.hexdigest()[:16]


def time_replay(cfg, policies, trace, want, reps: int = REPLAY_TIMED, nxt=None,
                stateful=None, info=None) -> float:
    """Median device time in ms of ``reps`` launches of the replay kernel,
    each on a fresh state, between two CUDA events; the wrapper's checks,
    the state and the counts buffer are made before the first event. Each
    final state must equal ``want`` bit for bit (numpy arrays, or tensors on
    the card, compared there; None: the first launch's, whose digest goes
    to ``info``). ``nxt``: fk's next-write stream, where some volume runs
    fk. ``stateful``: run the stateful instance (True) or not (False)
    whatever the fleet's schemes (the instance `check_inputs` picks when
    None). ``info``, a dict, receives the instance launched and the times."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.core.config import init_state
    from repro_torch.kernels import replay as kreplay
    times = []
    for _ in range(reps):
        st = torchsim.own_state(init_state(cfg, policies, "cuda"))
        inst = kreplay.check_inputs(cfg, st, trace, nxt)
        if stateful is not None:
            inst = inst._replace(stateful=stateful)
        iterations = torch.zeros(trace.shape[1], dtype=torch.int32, device="cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        kreplay.launch(cfg, st, trace, iterations, inst, nxt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if want is None:
            want = {k: x.clone() for k, x in st.items()}
            if info is not None:
                info["digest"] = _state_digest(st)
        if isinstance(next(iter(want.values())), torch.Tensor):
            same = all(torch.equal(st[k], want[k]) for k in want)
        else:
            same = not _differing_keys(convert.state_to_numpy(st), want)
        if not same:
            raise AssertionError("the replay kernel is not bit-identical on a repeat")
        del st
    if info is not None:
        info.update(inst=inst, times=times)
    return float(np.median(times))


def replay_geometry(cfg, V: int, inst, T: int, ms: float, bound_ms: float) -> dict:
    """The replay kernel instance a launch ran, for its [kernels] line and
    JSON row: registers and spill bytes (ptxas, from [build]; local memory
    bytes from the runtime), volumes a block (W), shared memory a block,
    the volumes resident at once and the waves the fleet took, with the
    time per step and against its bound."""
    from repro_torch.kernels import replay as kreplay
    occ = kreplay.occupancy(cfg, V, inst)
    flags = "".join(str(int(f)) for f in (cfg.timing, inst.defer, inst.stateful,
                                          occ["shared_meta"],
                                          cfg.gc_batch_segments > 1 or cfg.fifo_occupancy))
    ptxas = REPLAY_PTXAS.get(flags, {})
    return {"instance": flags, "registers": occ["registers"],
            "spill_stores": ptxas.get("spill_stores"), "spill_loads": ptxas.get("spill_loads"),
            "local_bytes": occ["local_bytes"], "warps": occ["warps"],
            "block_bytes": occ["block_bytes"], "blocks_per_sm": occ["blocks_per_sm"],
            "resident": occ["resident"], "waves": occ["waves"], "us_per_step": 1e3 * ms / T,
            "x_bound": ms / bound_ms}


def geometry_text(g: dict) -> str:
    return (f"instance TDSMP={g['instance']}: {g['registers']} registers, spills "
            f"{g['spill_stores']} / {g['spill_loads']} B (local {g['local_bytes']} B), W "
            f"{g['warps']}, {g['block_bytes']} B shared a block, {g['blocks_per_sm']} blocks an "
            f"SM, {g['resident']} volumes resident, {g['waves']} wave(s); "
            f"{g['us_per_step']:.4f} us per step, {g['x_bound']:.1f}x its bound")


def _main_run(cfg, padded, policies, traces, engine: str, tag: str) -> dict:
    """One replay of the main run's fleet (or a prefix of its steps) on the
    card by ``engine``: its wall, counts, launches and final state, logged
    and held to the state invariants."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    P, V = MAIN_VOLUMES_PER_TILE, padded.shape[0]
    stats = torchsim.ReplayStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = torchsim.run_fleet(cfg, padded, policies, device="cuda", stats=stats, engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    final = convert.state_to_numpy(st)
    res = torchsim.summarize_fleet(cfg, st, V)
    writes = res["fleet"]["user_writes"]
    log(f"[main] {tag}: wall {wall:.3f} s, user steps {stats.steps}, volume-writes "
        f"{writes}, volume-writes/s {writes / wall:.1f}, s/step {wall / stats.steps:.9f}")
    log(f"[main] {tag}: GC ticks {stats.gc_ticks}, tick iterations "
        f"{stats.tick_iterations} ({stats.tick_iterations / stats.steps:.4f} per step), "
        f"host syncs {stats.host_syncs} ({stats.host_syncs / stats.steps:.7f} per step), "
        f"reclaimed {int(final['reclaimed'].sum())}, overflow {res['fleet']['overflow']}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    was = np.asarray(res["fleet"]["per_volume_wa"])
    med = {gp: float(np.median(was[j * P:(j + 1) * P])) for j, gp in enumerate(MAIN_GPS)}
    log(f"[main] {tag}: fleet WA {res['fleet']['wa']:.6f}; median WA per GC threshold {med}")
    log(f"[main] {tag}: kernel launches {counts}")
    if res["fleet"]["overflow"] != 0:
        raise AssertionError(f"[main] {tag} overflowed its segment pool")
    if not (np.isfinite(was).all() and (was >= 1.0).all() and (final["reclaimed"] > 0).all()):
        raise AssertionError(f"[main] {tag}: WA out of range, or a volume never ran GC")
    check_integrity(cfg, final, traces, f"main run, {tag}")
    return {"st": st, "final": final, "stats": stats, "wall": wall, "counts": counts,
            "writes": writes}


def phase_main():
    """The main run: the replay kernel (the card's main path) over every
    step; the step engine over the first MAIN_STEP_PREFIX steps, every final
    key equal to the replay kernel's replay of the same prefix (the step
    engine replays the steps in sequence, host-bound, so its wall is cut by
    steps). Then the step engine on the CPU, the kernel's plain version,
    replays a subset of the volumes over the whole trace
    (PLAIN_VOLUMES_PER_TILE per GC threshold), which must equal their rows;
    and the kernel alone is timed on the main run's inputs and on the
    subset's. Returns the config, the replay kernel's final state, the
    launches of each engine's run and the replay kernel's row."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.core.tracegen import tiled_fleet
    P, n = MAIN_VOLUMES_PER_TILE, MAIN_N_LBAS
    V = P * len(MAIN_GPS)
    log(f"[main] cut: volumes of {n} blocks (64 MiB at 4 KiB) instead of the paper's "
        f">= 10 GiB, so that the step engine, which replays the trace steps in sequence, "
        f"fits the smoke time limit beside the replay kernel ([scale] times the replay "
        f"kernel alone on 1 GiB volumes)")
    t0 = time.perf_counter()
    traces = tiled_fleet("mixed", len(MAIN_GPS), P, n, 2 * n, jitter=0.25, seed=23)
    cfg = fleet_config(n)
    policies = fleet_policies(cfg, np.repeat(MAIN_GPS, P))
    padded = torchsim.coerce_fleet(traces)
    log(f"[main] {V} volumes, n_lbas {n}, segment_size {cfg.segment_size}, n_rows "
        f"{cfg.n_rows}, steps {padded.shape[1]}, writes {int((padded >= 0).sum())}; "
        f"traces made in {time.perf_counter() - t0:.1f} s")

    replay = _main_run(cfg, padded, policies, traces, "replay", "engine=replay")
    prefix = np.ascontiguousarray(padded[:, :MAIN_STEP_PREFIX])
    log(f"[main] cut: the step engine replays the first {MAIN_STEP_PREFIX} of the "
        f"{padded.shape[1]} steps (the prefix [legacy] replays; the thresholds' first GC falls "
        f"between steps 17,809 and 21,006), held on every key to the replay kernel on the same "
        f"prefix; the step engine is host-bound per step, so fewer volumes would save nothing")
    step = _main_run(cfg, prefix, policies, list(prefix), "step",
                     f"engine=step, first {MAIN_STEP_PREFIX} steps")
    head = _main_run(cfg, prefix, policies, list(prefix), "replay",
                     f"engine=replay, first {MAIN_STEP_PREFIX} steps")
    if replay["counts"]["replay"] != 1 or any(
            replay["counts"][k] for k in ("segment_select_batch", "classify_gc", "classify_user")):
        raise AssertionError("the replay engine's main run did not go through the replay kernel")
    if 0 in (step["counts"]["segment_select_batch"], step["counts"]["classify_gc"],
             step["counts"]["classify_user"]):
        raise AssertionError("the step engine's main run did not go through its kernels")
    bad = _differing_keys(head["final"], step["final"])
    same = (head["stats"].steps, head["stats"].gc_ticks, head["stats"].tick_iterations) \
        == (step["stats"].steps, step["stats"].gc_ticks, step["stats"].tick_iterations)
    log(f"[main] replay kernel vs step engine on the card over the first {MAIN_STEP_PREFIX} "
        f"steps: differing keys {bad}; same steps, GC ticks and tick iterations: {same}; wall "
        f"{head['wall']:.3f} s against {step['wall']:.3f} s = "
        f"{step['wall'] / head['wall']:.1f}x")
    if bad or not same:
        raise AssertionError(f"the replay kernel and the step engine differ: {bad}, stats {same}")
    runs = {"replay": replay, "step": step}

    # the kernel's plain version, the step engine on the CPU, on a subset of
    # the volumes over the whole padded trace: the arithmetic at the main
    # run's widths held to code that shares nothing with the kernel
    sub = [j * P + i * (P // PLAIN_VOLUMES_PER_TILE) for j in range(len(MAIN_GPS))
           for i in range(PLAIN_VOLUMES_PER_TILE)]
    sub_policies = {k: x[sub] for k, x in policies.items()}
    sub_trace = np.ascontiguousarray(padded[sub])
    t0 = time.perf_counter()
    cpu = convert.state_to_numpy(torchsim.run_fleet(cfg, sub_trace, sub_policies, device="cpu",
                                                    engine="step"))
    plain_ms = 1e3 * (time.perf_counter() - t0)
    bad = [k for k in cpu if not np.array_equal(replay["final"][k][sub], cpu[k])]
    err = max(max_abs_err(torch.from_numpy(replay["final"][k][sub].astype(np.float64)),
                          torch.from_numpy(cpu[k].astype(np.float64))) for k in cpu)
    log(f"[main] replay kernel vs the step engine on the cpu, volumes {sub} over all "
        f"{padded.shape[1]} steps: differing keys {bad}, max abs err {err}; cpu "
        f"{plain_ms / 1e3:.3f} s, reclaimed {cpu['reclaimed'].tolist()}")
    if bad or not (cpu["reclaimed"] > 0).all():
        raise AssertionError(f"the replay kernel differs from the CPU step engine in {bad}")

    trace = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    info = {}
    ms = time_replay(cfg, policies, trace, replay["final"], info=info)
    ms_sub = time_replay(cfg, sub_policies, torch.from_numpy(sub_trace).cuda(), cpu)
    T = padded.shape[1]
    limit = replay_bound(replay["st"], trace)
    geo = replay_geometry(cfg, V, info["inst"], T, ms, limit["bound_ms"])
    row = {"name": "replay", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/replay.cu",
           "replaces": "src/repro/kernels/segsel.py:150; src/repro/kernels/classify.py:49",
           "shape": [V, T], "steps": T, "max_abs_err": err,
           "ms": ms, "ms_per_step": ms / T, "plain_ms": plain_ms, "plain_volumes": sub,
           "ms_plain_volumes": ms_sub, **limit, **geo, "times_ms": info["times"],
           "tolerance": "bit-equal on every state key: to engine='step' on the card over all "
                        f"volumes and the first {MAIN_STEP_PREFIX} steps, to the step engine on "
                        "the CPU (the plain version; plain_ms) over plain_volumes and every "
                        "step, whose kernel time is ms_plain_volumes",
           "library_ms": None}
    log(f"[kernels] replay ({V}, {T}): {ms:.3f} ms per replay (median of {REPLAY_TIMED}, "
        f"checks outside), {1e3 * ms / T:.4f} us per step, repeats bit-identical; bound "
        f"{limit['bound_ms']:.3f} ms ({limit['bound_by']}, {limit['bytes']} bytes) = "
        f"{ms / limit['bound_ms']:.1f}x; victim scans {scan_bytes_per_write(cfg, replay['final']):.1f} "
        f"bytes per user write; on volumes {sub}: {ms_sub:.3f} ms, step engine on the cpu "
        f"{plain_ms:.1f} ms")
    log(f"[kernels] replay ({V}, {T}): {geometry_text(geo)}")
    return cfg, replay["st"], {k: runs[k]["counts"] for k in runs}, row


def phase_scale() -> None:
    """The replay kernel alone on volumes of SCALE_N_LBAS blocks (1 GiB at 4
    KiB), SCALE_VOLUMES_PER_TILE per GC threshold: its time, and the victim
    scans' bytes per user write against the main run's. No engine replays
    this size beside it (the step engines replay its steps in sequence, far
    past the smoke's limit); the final state is held to the invariants."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.core.config import init_state
    from repro_torch.core.tracegen import tiled_fleet
    from repro_torch.kernels import replay as kreplay
    P, n = SCALE_VOLUMES_PER_TILE, SCALE_N_LBAS
    traces = tiled_fleet("mixed", len(MAIN_GPS), P, n, 2 * n, jitter=0.25, seed=23)
    cfg = fleet_config(n)
    policies = fleet_policies(cfg, np.repeat(MAIN_GPS, P))
    padded = torchsim.coerce_fleet(traces)
    V, T = padded.shape
    trace = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    st = torchsim.own_state(init_state(cfg, policies, "cuda"))
    inst = kreplay.check_inputs(cfg, st, trace)
    iterations = torch.zeros(T, dtype=torch.int32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    kreplay.launch(cfg, st, trace, iterations, inst)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    final = convert.state_to_numpy(st)
    res = torchsim.summarize_fleet(cfg, st, V)
    was = np.asarray(res["fleet"]["per_volume_wa"])
    if res["fleet"]["overflow"] != 0 or not (np.isfinite(was).all() and (was >= 1.0).all()
                                             and (final["reclaimed"] > 0).all()):
        raise AssertionError("scale run overflowed, or its WA is out of range")
    check_integrity(cfg, final, traces, "scale run")
    writes = res["fleet"]["user_writes"]
    limit = replay_bound(st, trace)
    med = {gp: float(np.median(was[j * P:(j + 1) * P])) for j, gp in enumerate(MAIN_GPS)}
    log(f"[scale] {V} volumes of {n} blocks (1 GiB at 4 KiB), n_rows {cfg.n_rows}, steps {T}, "
        f"writes {writes}: replay kernel {ms:.3f} ms, {writes / ms * 1e3:.1f} volume-writes/s "
        f"(kernel time), {1e3 * ms / T:.4f} us per step; bound {limit['bound_ms']:.3f} ms "
        f"({limit['bytes']} bytes) = {ms / limit['bound_ms']:.1f}x")
    log(f"[scale] tick iterations {int(iterations.sum())}, reclaimed "
        f"{int(final['reclaimed'].sum())}, overflow 0, fleet WA {res['fleet']['wa']:.6f}, "
        f"median WA per GC threshold {med}; victim scans "
        f"{scan_bytes_per_write(cfg, final):.1f} bytes per user write")


def _device_us(event) -> float:
    """Device time of a profiler row, under the attribute's newer or older name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


RANGE_PREFIX = "stateful_schemes"   # the stateful branches' record_function ranges


def _kernels_under(event) -> int:
    """Device kernels launched inside a profiler event and its children (the
    ranges' own device-side annotations are not kernels)."""
    own = sum(1 for k in event.kernels if not k.name.startswith(RANGE_PREFIX))
    return own + sum(_kernels_under(c) for c in event.cpu_children)


def profile_window(cfg, st, engine: str, steps: int, tag: str) -> dict:
    """``steps`` steps of random updates per volume replayed on the final
    state ``st`` by ``engine`` under torch.profiler: the device's busy share
    of the wall time, the kernel launches per step, those inside the stateful
    schemes' ranges (``stateful_schemes.*``), and the kernels by device time.
    The profiler slows the host, so a busy share is a lower bound of the
    unprofiled run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import torchsim
    V = st["t"].shape[0]
    extra = np.random.default_rng(5).integers(0, cfg.n_lbas, (V, steps), dtype=np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torchsim.run_fleet(cfg, extra, device="cuda", state=st, engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a range's device-side annotation spans its kernels: not a kernel itself
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and not e.key.startswith(RANGE_PREFIX)]
    kernels = [e for e in rows if e.device_type.name == "CUDA"] or rows
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    branch = sum(_kernels_under(e) for e in prof.events() if e.name.startswith(RANGE_PREFIX))
    log(f"[{tag}] engine={engine}: {steps} steady steps x {V} volumes: wall {wall:.3f} s "
        f"(profiled), device busy {busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.2f}% "
        f"of wall, {launches / steps:.4f} kernel launches per step ({branch / steps:.4f} in the "
        f"stateful schemes' branches, {(launches - branch) / steps:.4f} in the rest), "
        f"{V * steps / wall:.1f} volume-writes/s")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:8]:
        log(f"[{tag}]   {e.key[:70]:70s} {_device_us(e):12.1f} us x{e.count}")
    return {"wall": wall, "busy": busy_us / 1e6 / wall, "launches_per_step": launches / steps,
            "branch_launches_per_step": branch / steps}


def phase_profile(cfg, st) -> None:
    """Steady windows after the main run under torch.profiler: the replay
    kernel (PROFILE_REPLAY_STEPS) and the step engine (PROFILE_STEP_STEPS)."""
    for engine, steps in (("replay", PROFILE_REPLAY_STEPS), ("step", PROFILE_STEP_STEPS)):
        profile_window(cfg, st, engine, steps, "profile")


def schemes_config(n_lbas: int = SCHEMES_N_LBAS, **kw):
    """The [schemes] volumes: ``n_lbas`` blocks, segment 128, cost-benefit,
    GP 0.15, nc window 16, six class slots (the widest scheme)."""
    from repro_torch.core.config import TorchSimConfig
    return TorchSimConfig(n_lbas=n_lbas, segment_size=MAIN_SEGMENT, class_slots=6,
                          gp_threshold=SCHEMES_GP, **kw)


def schemes_policies(cfg, P: int) -> dict:
    """(14 * P,) policy arrays, cell-major: scheme j's P volumes first."""
    from repro_torch.core.config import SCHEME_CLASSES, default_policy
    sch = np.repeat(np.arange(len(SCHEME_CLASSES)), P).astype(np.int32)
    pol = {k: np.full(len(sch), v) for k, v in default_policy(cfg).items()}
    pol["p_scheme"] = sch
    pol["p_classes"] = np.asarray(SCHEME_CLASSES, np.int32)[sch]
    return pol


def _path_kernel_rows(tag, rng, V, S, B, counts, single_rows=None) -> dict:
    """K1 and K3 (and K2 at ``single_rows`` segments, when given) at a path's
    shapes, held bit-equal to their plain versions and timed; by kernel
    name, with the path's launches from ``counts``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.segsel import segment_select, segment_select_batch
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(x).to(dev) for x in _segsel_inputs(rng, V, S, seg=B)]
    idx, score = segment_select_batch(*arrays)
    ridx, rscore = ref.segment_select_batch_ref(*arrays)
    torch.cuda.synchronize()
    if not (torch.equal(idx, ridx) and torch.equal(score, rscore)):
        raise AssertionError(f"K1 disagrees with its plain version at the [{tag}] shape")
    out = {"segment_select_batch": {
        "shape": [V, S], "ms": time_ms(lambda: segment_select_batch(*arrays)),
        "plain_ms": time_ms(lambda: ref.segment_select_batch_ref(*arrays)),
        "max_abs_err": max_abs_err(score, rscore), **bound(16 * V * S + 16 * V)}}
    if single_rows is not None:
        one = [torch.from_numpy(x).to(dev) for x in _segsel_inputs(rng, 1, single_rows, seg=B)]
        args1 = (one[0][0], one[1][0], one[2][0], one[3][0], one[4].reshape(()),
                 one[5].reshape(()))
        i1, s1 = segment_select(*args1)
        ri1, rs1 = ref.segment_select_ref(*args1)
        torch.cuda.synchronize()
        if not (torch.equal(i1, ri1) and torch.equal(s1, rs1)):
            raise AssertionError(f"K2 disagrees with its plain version at the [{tag}] shape")
        out["segment_select"] = {
            "shape": [single_rows], "ms": time_ms(lambda: segment_select(*args1)),
            "plain_ms": time_ms(lambda: ref.segment_select_ref(*args1)),
            "max_abs_err": max_abs_err(s1, rs1), **bound(16 * single_rows + 16)}
    sids = torch.from_numpy((np.arange(V) % 14).astype(np.int32)).to(dev)
    ell = torch.from_numpy(rng.uniform(1.0, 30_000.0, V).astype(np.float32)).to(dev)
    for name, site, width in (("classify_gc", "gc", B), ("classify_user", "user", 1)):
        v, g = (torch.from_numpy(rng.integers(0, 100_000, (V, width), dtype=np.int32)).to(dev)
                for _ in range(2))
        flags = torch.from_numpy(rng.integers(0, 2, (V, width), dtype=np.int32)).to(dev)
        is_gc = torch.full_like(flags, 1 if site == "gc" else 0)
        row = _classify_row(name, site, v, g, flags, is_gc, ell, sids, "the 14 schemes' ids")
        out[name] = {k: row[k] for k in ("shape", "ms", "plain_ms", "max_abs_err", "bound_ms",
                                         "bound_by")}
    for name, row in out.items():
        row["launches"] = counts[name]
        log(f"[{tag}] {name} {row['shape']}: {row['ms'] * 1e3:.2f} us (plain "
            f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.3f} us), launches "
            f"on this path {row['launches']}")
    return out


def _replay_row_run(cfg, padded, policies, tag: str, state=None, nxts=None,
                    phase: str = "schemes") -> dict:
    """One replay of a [schemes] fleet by the replay kernel (from ``state``
    when given, with fk's next-write stream ``nxts`` when given), the launch
    counts zeroed just before it and read just after: the final state (on
    the card and as numpy), its counts, stats and wall, held to one launch
    of the replay kernel and none of K1, K2 or K3."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    stats = torchsim.ReplayStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = torchsim.run_fleet(cfg, padded, policies, device="cuda", state=state, stats=stats,
                            nxts=nxts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{phase}] {tag}: engine=replay on the card: wall {wall:.3f} s (trace upload, fk's "
        f"next-write stream, the state's copies and one launch), steps {stats.steps}, tick "
        f"iterations {stats.tick_iterations}, host syncs {stats.host_syncs}, peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    if counts["replay"] != 1 or any(counts[k] for k in ("segment_select_batch", "segment_select",
                                                        "classify_gc", "classify_user")):
        raise AssertionError(f"[{phase}] {tag} did not go through the replay kernel alone")
    return {"st": st, "final": convert.state_to_numpy(st), "counts": counts, "stats": stats,
            "wall": wall, "peak": peak}


def _window_check(cfg, padded, policies, nxts, W0: int, W1: int, tag: str, phase: str) -> tuple:
    """The card's step engine (K1, K3 and the stateful branches between
    them) and the replay kernel on steps W0..W1-1, both from the kernel's
    state after steps 0..W0-1 (fk's stream ``nxts``, where given, is the
    whole trace's, sliced): every key and the step counts must be equal and
    K1 / K3 must have run. Returns the kernel's run of the prefix and the
    step engine's launches."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops

    def cut(x, a, b):
        return None if x is None else np.ascontiguousarray(x[:, a:b])

    start = _replay_row_run(cfg, cut(padded, 0, W0), policies, f"{tag} steps 0-{W0 - 1}",
                            nxts=cut(nxts, 0, W0), phase=phase)
    window, window_nxts = cut(padded, W0, W1), cut(nxts, W0, W1)
    ops.reset_launch_counts()
    stats = torchsim.ReplayStats()
    t0 = time.perf_counter()
    step = torchsim.run_fleet(cfg, window, device="cuda", state=start["st"], stats=stats,
                              engine="step", nxts=window_nxts)
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    step = convert.state_to_numpy(step)
    head = _replay_row_run(cfg, window, None, f"{tag} steps {W0}-{W1 - 1}", state=start["st"],
                           nxts=window_nxts, phase=phase)
    bad = _differing_keys(head["final"], step)
    same = (head["stats"].steps, head["stats"].gc_ticks, head["stats"].tick_iterations) == (
        stats.steps, stats.gc_ticks, stats.tick_iterations)
    k_launches = sum(counts[k] for k in ("segment_select_batch", "classify_gc", "classify_user"))
    log(f"[{phase}] {tag} engine=step on the card, steps {W0}-{W1 - 1}: wall "
        f"{step_wall:.3f} s, s/step {step_wall / stats.steps:.9f}, tick iterations "
        f"{stats.tick_iterations}, host syncs {stats.host_syncs}; launches {counts}: K1 + K3 "
        f"{k_launches / stats.steps:.4f} per step; against the replay kernel on the same "
        f"steps: differing keys {bad}, same steps, GC ticks and tick iterations: {same}; "
        f"kernel wall {head['wall']:.3f} s = {step_wall / head['wall']:.1f}x faster")
    if bad or not same or 0 in (counts["segment_select_batch"], counts["classify_gc"],
                                counts["classify_user"]):
        raise AssertionError(f"[{phase}] {tag}: the step engine and the replay kernel differ on "
                             f"the window ({bad}, stats {same}), or K1 / K3 did not run")
    return start, counts


def _schemes_table(tag: str, cfg, run: dict, traces, P: int) -> None:
    """The WA of each scheme over its P volumes, ranked; fails unless no
    volume overflowed its pool, every scheme ran GC and every volume passes
    the state invariants."""
    from repro_torch.core import torchsim
    from repro_torch.core.config import SCHEME_NAMES
    final = run["final"]
    V = final["t"].shape[0]
    res = torchsim.summarize_fleet(cfg, final, V)
    vols = res["volumes"]
    table = []
    for j, name in enumerate(SCHEME_NAMES):
        mine = vols[j * P:(j + 1) * P]
        user = sum(v["user_writes"] for v in mine)
        gc = sum(v["gc_writes"] for v in mine)
        table.append((name, (user + gc) / user, float(np.median([v["wa"] for v in mine])), gc))
    for rank, (name, wa, med, gc) in enumerate(sorted(table, key=lambda r: r[1]), 1):
        log(f"[schemes] {tag}: rank {rank:2d} {name:7s} fleet WA {wa:.6f}, median WA {med:.6f}, "
            f"GC writes {gc}")
    writes = res["fleet"]["user_writes"]
    log(f"[schemes] {tag}: fleet WA over all {V} volumes {res['fleet']['wa']:.6f}, volume-writes "
        f"{writes}, volume-writes/s {writes / run['wall']:.1f} (run_fleet's wall), reclaimed "
        f"{int(final['reclaimed'].sum())}, overflow {res['fleet']['overflow']}")
    if res["fleet"]["overflow"] != 0 or (final["overflow"] != 0).any():
        raise AssertionError(f"a [schemes] {tag} volume overflowed its segment pool")
    if any(gc == 0 for *_, gc in table):
        raise AssertionError(f"a scheme never ran GC in [schemes] {tag}")
    t0 = time.perf_counter()
    check_integrity(cfg, final, traces, f"[schemes] {tag}")
    log(f"[schemes] {tag}: state invariants hold on every volume "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_schemes() -> dict:
    """The paper's Exp#1 comparison through the replay kernel: every one of
    the 14 schemes replays the main run's 186-volume corpus, 2,604 volumes in
    one launch. (a) At SCHEMES_N_LBAS blocks: one volume per scheme replayed
    by the step engine on the CPU over the whole trace equals its row on
    every key, and the step engine on the card (K1, K3 and the stateful
    branches between them) over SCHEMES_STEP_WINDOW steps from
    SCHEMES_WINDOW_START, past the first GC, equals the kernel's replay of
    that window from the same state on every key; a profiled window of
    the step engine. (b) At the main run's MAIN_N_LBAS blocks, the kernel
    alone: the ranked WA table, the invariants, and the rows of one volume
    per stateful scheme held to the CPU step engine over the whole trace
    (SCHEMES_CPU_WORKERS workers), so the launch that is timed is the one
    that is checked. The CPU replays run in worker processes beside the
    card runs. Returns K1's and K3's rows at (a)'s
    window with its launches, and the kernel table's ``replay_stateful``
    row."""
    import torch

    from repro_torch.core import annotate, torchsim
    from repro_torch.core.config import SCHEME_NAMES
    from repro_torch.core.placement.schemes import ELEMENTWISE_IDS
    from repro_torch.core.tracegen import tiled_fleet
    P, n, S = SCHEMES_VOLUMES_PER_SCHEME, SCHEMES_N_LBAS, len(SCHEME_NAMES)
    t_phase = time.perf_counter()
    log(f"[schemes] cuts: (a) volumes of {n} blocks ({n * 4 // 1024} MiB at 4 KiB) at 2 * n_lbas "
        f"updates, the card's step engine on {SCHEMES_STEP_WINDOW} steps from step "
        f"{SCHEMES_WINDOW_START} (past the first GC); (b) "
        f"volumes of {MAIN_N_LBAS} blocks (64 MiB, the main run's), the CPU check on one volume "
        f"per stateful scheme over the whole trace. ETI's 2^15-write decay period elapses only "
        f"in (b)'s traces, FADaC's 2^16-write half-life in neither (the card tests start a "
        f"state near both boundaries)")
    t0 = time.perf_counter()
    cfg = schemes_config()
    policies = schemes_policies(cfg, P)
    traces = tiled_fleet("mixed", S, P, n, 2 * n, jitter=0.25, seed=23)
    padded = torchsim.coerce_fleet(traces)
    V, T = padded.shape
    big_cfg = schemes_config(MAIN_N_LBAS)
    big_traces = tiled_fleet("mixed", S, P, MAIN_N_LBAS, 2 * MAIN_N_LBAS, jitter=0.25, seed=23)
    big = torchsim.coerce_fleet(big_traces)
    log(f"[schemes] (a) {V} volumes ({S} schemes x {P} traces), n_lbas {n}, segment_size "
        f"{cfg.segment_size}, n_rows {cfg.n_rows}, class slots {cfg.n_class_slots}, "
        f"sfs_resample {cfg.sfs_resample}, steps {T}, writes {int((padded >= 0).sum())}; (b) "
        f"n_lbas {MAIN_N_LBAS}, n_rows {big_cfg.n_rows}, steps {big.shape[1]}, writes "
        f"{int((big >= 0).sum())}; traces made in {time.perf_counter() - t0:.1f} s")

    # the CPU subsets: (a) one volume per scheme (corpus trace 0) over the
    # whole trace, (b) one per stateful scheme over the whole trace, in
    # SCHEMES_CPU_WORKERS chunks, without the fleet's pad steps past the
    # subset's last write (no-ops for a volume)
    sub = [j * P for j in range(S)]
    big_sub = [j * P for j in range(S) if j not in ELEMENTWISE_IDS]
    chunks = [big_sub[i::SCHEMES_CPU_WORKERS] for i in range(SCHEMES_CPU_WORKERS)]
    big_steps = int((big[big_sub] >= 0).sum(1).max())
    sub_pol = {k: x[sub] for k, x in policies.items()}
    big_pol = {k: x[big_sub] for k, x in policies.items()}
    workers = ProcessPoolExecutor(1 + SCHEMES_CPU_WORKERS,
                                  mp_context=multiprocessing.get_context("spawn"))
    with workers:
        on_cpu = workers.submit(_replay_on_cpu, cfg, np.ascontiguousarray(padded[sub]), sub_pol)
        big_on_cpu = [workers.submit(_replay_on_cpu, big_cfg,
                                     np.ascontiguousarray(big[chunk, :big_steps]),
                                     {k: x[chunk] for k, x in policies.items()})
                      for chunk in chunks]

        # (a) the kernel over the whole trace
        run = _replay_row_run(cfg, padded, policies, "(a) 8 MiB")
        _schemes_table("(a) 8 MiB", cfg, run, traces, P)
        _check_subset("schemes", run["final"], sub, on_cpu)
        # the card's step engine, and the kernel, on a window of steps past
        # the first GC, both from the kernel's state at the window's start;
        # fk reads the whole trace's next-write stream, sliced
        W0, W1 = SCHEMES_WINDOW_START, SCHEMES_WINDOW_START + SCHEMES_STEP_WINDOW
        nxts = annotate.fleet_annotations(padded, policies["p_scheme"])
        _, counts = _window_check(cfg, padded, policies, nxts, W0, W1, "(a)", "schemes")
        t0 = time.perf_counter()
        profile_window(cfg, run["st"], "step", SCHEMES_PROFILE_STEPS, "schemes")
        log(f"[schemes] profiled window with its analysis {time.perf_counter() - t0:.1f} s")
        trace = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
        nxt = torchsim._next_writes(run["st"], trace)
        ms_small = time_replay(cfg, policies, trace, run["st"], reps=SCHEMES_TIMED, nxt=nxt)
        bound_small = replay_bound(run["st"], trace, stateful=True, nxt=nxt)
        del run, trace, nxt
        torch.cuda.empty_cache()

        # (b) the kernel alone at the main run's 64 MiB
        run = _replay_row_run(big_cfg, big, policies, "(b) 64 MiB")
        launches = run["counts"]["replay"]
        _schemes_table("(b) 64 MiB", big_cfg, run, big_traces, P)
        cpu_walls = [_check_subset("schemes", run["final"], chunk, on)[0]
                     for chunk, on in zip(chunks, big_on_cpu)]
        err = max(max_abs_err(torch.from_numpy(run["final"][k][chunk].astype(np.float64)),
                              torch.from_numpy(x.astype(np.float64)))
                  for chunk, on in zip(chunks, big_on_cpu) for k, x in on.result()[0].items())
        if not (run["final"]["reclaimed"][big_sub] > 0).all():
            raise AssertionError(f"[schemes] (b) a volume of {big_sub} ran no GC")
    trace = torch.from_numpy(np.ascontiguousarray(big)).cuda()
    nxt = torchsim._next_writes(run["st"], trace)
    info = {}
    ms = time_replay(big_cfg, policies, trace, run["st"], reps=SCHEMES_TIMED, nxt=nxt, info=info)
    limit = replay_bound(run["st"], trace, stateful=True, nxt=nxt)
    geo = replay_geometry(big_cfg, V, info["inst"], int(big.shape[1]), ms, limit["bound_ms"])
    per_scheme = schemes_alone(big_cfg, policies, trace, run["final"], nxt, P)
    sub_trace = torch.from_numpy(np.ascontiguousarray(big[big_sub, :big_steps])).cuda()
    sub_pol = {"p_scheme": torch.from_numpy(big_pol["p_scheme"]).cuda()}
    ms_sub = time_replay(big_cfg, big_pol, sub_trace,
                         {k: x[big_sub] for k, x in run["final"].items()},
                         nxt=torchsim._next_writes(sub_pol, sub_trace))
    row = {"name": "replay_stateful", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/replay.cu (kStateful instance); "
                     "src/repro_torch/kernels/csrc/stateful_ops.cuh",
           "replaces": "src/repro/kernels/segsel.py:150; src/repro/kernels/classify.py:49",
           "shape": [V, int(big.shape[1])], "n_lbas": MAIN_N_LBAS, "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": 1e3 * sum(cpu_walls),
           "plain_volumes": big_sub, "plain_steps": big_steps,
           "plain_workers": SCHEMES_CPU_WORKERS,
           "ms_plain_volumes": ms_sub,
           **limit, **geo, "times_ms": info["times"], "per_scheme": per_scheme,
           "shape_8mib": [V, T], "ms_8mib": ms_small,
           "bound_ms_8mib": bound_small["bound_ms"],
           "tolerance": "bit-equal on every state key, sch_* included: at 8 MiB to the step "
                        "engine on the CPU (14 volumes, every step) and on the card (every "
                        f"volume, {SCHEMES_STEP_WINDOW} steps from step {SCHEMES_WINDOW_START}); "
                        "at 64 MiB, the timed launch's rows plain_volumes to the step engine "
                        "on the CPU over the whole trace (plain_steps, its last write; "
                        "plain_ms: the sum of plain_workers "
                        "workers' walls, against the kernel's ms_plain_volumes)",
           "library_ms": None}
    log(f"[kernels] replay_stateful ({V}, {big.shape[1]}) at 64 MiB: {ms:.3f} ms per replay "
        f"(median of {SCHEMES_TIMED}, checks outside), repeats bit-identical; bound "
        f"{limit['bound_ms']:.3f} ms ({limit['bound_by']}, {limit['bytes']} bytes) = "
        f"{ms / limit['bound_ms']:.1f}x; at 8 MiB ({V}, {T}): {ms_small:.3f} ms, bound "
        f"{bound_small['bound_ms']:.3f} ms = {ms_small / bound_small['bound_ms']:.1f}x; volumes "
        f"{big_sub} alone: {ms_sub:.3f} ms, step engine on the cpu {1e3 * sum(cpu_walls):.1f} ms "
        f"(the sum of {SCHEMES_CPU_WORKERS} workers' walls)")
    log(f"[kernels] replay_stateful ({V}, {big.shape[1]}): {geometry_text(geo)}")
    del run, trace, sub_trace
    torch.cuda.empty_cache()
    rows = _path_kernel_rows("schemes", np.random.default_rng(3), V, cfg.n_rows,
                             cfg.segment_size, counts)
    log(f"[schemes] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"path_rows": rows, "row": row}


PAPER_SCHEMES = ("nosep", "sepgc", "warcip", "sepbit", "fk")   # benchmarks/run.py's Exp#2 and #3
PAPER_EXP2 = ((32, 4), (64, 2), (128, 1))   # (segment, victims per GC operation): fixed GC I/O
PAPER_GPS = (0.10, 0.15, 0.20, 0.25)        # Exp#3's GC thresholds
PAPER_PARITY = ((16, 2), (32, 4))           # the reduced fleets' (segment, victims), FIFO on
PAPER_WINDOW = 128             # steps of each timed launch replayed by the card's step engine
PAPER_CPU_WORKERS = 5          # the reduced fleets and the plain volumes' prefixes on the CPU
PAPER_CHECKED = 31             # the state invariants on every 31st volume of a fleet
PAPER_TIMED = 3                # launches timed per fleet, each on a fresh state
# each timed fleet's volume that the CPU step engine replays over the first
# MAIN_STEP_PREFIX steps: the corpus' trace 0 under this scheme (in Exp#3 at
# the largest GP)
PAPER_PLAIN = {"exp2_seg32": "warcip", "exp2_seg64": "sepbit", "exp3": "sepbit",
               "exp5": "sepbit"}


def _paper_policies(cfg, schemes, per: int) -> dict:
    """(len(schemes) * per,) policy arrays, cell-major: ``schemes[j]``'s
    ``per`` volumes j-th, under ``cfg``'s selector and GC threshold."""
    from repro_torch.core.config import SCHEME_CLASSES, SCHEME_IDS, default_policy
    sch = np.repeat([SCHEME_IDS[s] for s in schemes], per).astype(np.int32)
    pol = {k: np.full(len(sch), v) for k, v in default_policy(cfg).items()}
    pol["p_scheme"] = sch
    pol["p_classes"] = np.asarray(SCHEME_CLASSES, np.int32)[sch]
    return pol


def _tiled_nxts(corpus_nxt, p_scheme):
    """fk's next-write stream of a fleet that tiles the corpus: the corpus'
    annotations on the fk volumes, ``NOBIT`` elsewhere (what
    `annotate.fleet_annotations` makes from the tiled traces)."""
    from repro_torch.core.config import SCHEME_IDS
    from repro_torch.core.placement.schemes import NOBIT
    fk = np.asarray(p_scheme) == SCHEME_IDS["fk"]
    if not fk.any():
        return None
    P = corpus_nxt.shape[0]
    out = np.full((len(fk), corpus_nxt.shape[1]), NOBIT, np.int32)
    for c in range(len(fk) // P):
        rows = slice(c * P, (c + 1) * P)
        out[rows][fk[rows]] = corpus_nxt[fk[rows]]
    return out


def _paper_parity_fleet(seg: int, k: int):
    """[paper]'s reduced fleet: [parity]'s 14-scheme fleet of PARITY_N_LBAS
    blocks at segment ``seg``, GC operations of ``k`` victims, FIFO on."""
    from repro_torch.core import torchsim
    from repro_torch.core.tracegen import make_fleet
    n = PARITY_N_LBAS
    cfg = schemes_config(n, sfs_resample=PARITY_SFS_RESAMPLE)
    cfg = dataclasses.replace(cfg, segment_size=seg, gc_batch_segments=k, fifo_occupancy=True)
    traces = torchsim.coerce_fleet(make_fleet("mixed", 14, n, 2 * n, jitter=0.25, seed=31))
    return cfg, traces, schemes_policies(cfg, 1)


def _paper_launch(tag: str, cfg, padded, policies, nxts, plain_on_cpu, smi: str) -> dict:
    """One of [paper]'s full-size fleets through the replay kernel: the
    launch with its counts zeroed before and read after (one launch of the
    replay kernel, none of K1-K3), overflow 0, the state invariants, the
    FIFO samples' bounds; the kernel from its own state at step
    MAIN_STEP_PREFIX equal to the card's step engine over PAPER_WINDOW
    steps; the prefix's rows equal to the CPU step engine's replay of them
    (``plain_on_cpu``: the rows and a worker's future); the launch timed on
    PAPER_TIMED fresh states. Returns the final state, the summary and the
    kernel table's row (without its name)."""
    import torch

    from repro_torch.core import torchsim
    V, T = padded.shape
    run = _replay_row_run(cfg, padded, policies, tag, nxts=nxts, phase="paper")
    final = run["final"]
    res = torchsim.summarize_fleet(cfg, final, V)
    if res["fleet"]["overflow"] != 0 or not (final["reclaimed"] > 0).all():
        raise AssertionError(f"[paper] {tag}: a volume overflowed its pool or ran no GC")
    t0 = time.perf_counter()
    checked = list(range(0, V, PAPER_CHECKED))
    check_integrity(cfg, {key: x[checked] for key, x in final.items()}, padded[checked],
                    f"[paper] {tag}")
    if cfg.fifo_occupancy:
        _check_fifo(tag, final)
    log(f"[paper] {tag}: overflow 0, every volume ran GC, the state invariants hold on "
        f"{len(checked)} volumes ({time.perf_counter() - t0:.1f} s)")

    # the card's step engine and the kernel on a window of steps from the
    # kernel's state at MAIN_STEP_PREFIX (past every volume's first GC)
    W0 = MAIN_STEP_PREFIX
    start, _ = _window_check(cfg, padded, policies, nxts, W0, W0 + PAPER_WINDOW, tag, "paper")
    # the plain version: the step engine on the CPU, one volume over the prefix
    rows, cpu_wall = plain_on_cpu
    cpu, wall = cpu_wall.result()
    bad = [key for key in cpu if not np.array_equal(start["final"][key][rows], cpu[key])]
    err = max(max_abs_err(torch.from_numpy(start["final"][key][rows].astype(np.float64)),
                          torch.from_numpy(cpu[key].astype(np.float64))) for key in cpu)
    log(f"[paper] {tag}: volumes {rows} over steps 0-{W0 - 1} by the step engine on the cpu in "
        f"{wall:.1f} s (a worker): differing keys against the kernel {bad}, max abs err {err}")
    if bad or not (cpu["reclaimed"] > 0).all():
        raise AssertionError(f"[paper] {tag}: the kernel and the CPU step engine differ in {bad}")
    del start
    trace = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    nxt = torchsim._next_writes(run["st"], trace, nxts)
    info = {}
    ms = time_replay(cfg, policies, trace, run["st"], reps=PAPER_TIMED, nxt=nxt, info=info)
    limit = replay_bound(run["st"], trace, stateful=info["inst"].stateful, nxt=nxt)
    geo = replay_geometry(cfg, V, info["inst"], T, ms, limit["bound_ms"])
    sub_trace = torch.from_numpy(np.ascontiguousarray(padded[rows, :W0])).cuda()
    sub_pol = {key: x[rows] for key, x in policies.items()}
    ms_sub = time_replay(cfg, sub_pol, sub_trace, cpu, reps=1,
                         nxt=None if nxt is None else nxt[rows, :W0].contiguous())
    row = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/replay.cu",
           "replaces": "src/repro/kernels/segsel.py:150; src/repro/kernels/classify.py:49",
           "shape": [V, T], "n_lbas": cfg.n_lbas, "segment_size": cfg.segment_size,
           "gc_batch_segments": cfg.gc_batch_segments, "fifo_occupancy": cfg.fifo_occupancy,
           "launches": run["counts"]["replay"], "max_abs_err": err, "ms": ms,
           "plain_ms": 1e3 * wall, "plain_volumes": rows, "plain_steps": W0,
           "ms_plain_volumes": ms_sub, **limit, **geo, "times_ms": info["times"],
           "tolerance": "bit-equal on every state key: to the card's step engine over all "
                        f"volumes on steps {W0}-{W0 + PAPER_WINDOW - 1} from the kernel's state, "
                        "to the step "
                        "engine on the CPU (the plain version; plain_ms) over plain_volumes and "
                        "the first plain_steps steps, whose kernel time is ms_plain_volumes",
           "library_ms": None, "smi": smi}
    log(f"[kernels] replay {tag} ({V}, {T}): {ms:.3f} ms per replay (median of {PAPER_TIMED}, "
        f"checks outside), {1e3 * ms / T:.4f} us per step, repeats bit-identical; bound "
        f"{limit['bound_ms']:.3f} ms ({limit['bound_by']}, {limit['bytes']} bytes) = "
        f"{ms / limit['bound_ms']:.1f}x; volumes {rows} over {W0} steps: {ms_sub:.3f} ms, step "
        f"engine on the cpu {1e3 * wall:.1f} ms; {smi}")
    log(f"[kernels] replay {tag} ({V}, {T}): {geometry_text(geo)}")
    del trace, nxt, sub_trace
    return {"st": run["st"], "final": final, "res": res, "row": row}


def _check_fifo(tag: str, final: dict) -> None:
    """-1 <= fifo_last <= fifo_peak <= the working set on every volume, and
    -1 exactly on the volumes that took no sample: those that do not run
    sepbit or uw, or whose ℓ was never refreshed."""
    from repro_torch.core.config import BIG
    from repro_torch.core.placement.schemes import FIFO_IDS
    wss = (final["last_uw"] > -BIG).sum(1)
    peak, last = final["fifo_peak"], final["fifo_last"]
    sampled = np.isin(final["p_scheme"], FIFO_IDS) & np.isfinite(final["ell"])
    ok = bool(((-1 <= last) & (last <= peak) & (peak <= wss)).all()
              and ((peak == -1) == ~sampled).all() and ((last == -1) == ~sampled).all())
    log(f"[paper] {tag}: -1 <= fifo_last <= fifo_peak <= wss on every volume, -1 exactly where "
        f"no sample was taken ({int((~sampled).sum())} of {len(peak)} volumes): {ok}")
    if not ok:
        raise AssertionError(f"[paper] {tag}: the FIFO samples break their bounds")


def _wa_rows(prefix: str, res: dict, cells, P: int) -> None:
    """``benchmarks/run.py``'s rows: the traffic-weighted WA of each cell's
    P volumes."""
    vols = res["volumes"]
    for j, cell in enumerate(cells):
        mine = vols[j * P:(j + 1) * P]
        user = sum(v["user_writes"] for v in mine)
        gc = sum(v["gc_writes"] for v in mine)
        log(f"{prefix(cell)} WA={(user + gc) / user:.4f}")


def phase_paper(smi: str) -> list:
    """The paper's Exp#2, Exp#3 and Exp#5 through the replay kernel, on the
    main run's 186-volume corpus of 64 MiB volumes, cost-benefit: (Exp#2)
    PAPER_SCHEMES under each (segment, GC operation of k victims) of
    PAPER_EXP2, one launch of 930 volumes each; (Exp#3) PAPER_SCHEMES x
    PAPER_GPS as per-volume policies, one launch of 3,720 volumes, the pool
    sized from the largest GP; (Exp#5) the 186 volumes under sepbit with the
    FIFO samples on. Before them, the reduced fleets of PAPER_PARITY (the
    14 schemes, k victims, FIFO on) through the kernel, held at the end to
    the CPU step engine on every key. Returns the kernel table's rows
    replay_exp2_seg32, replay_exp2_seg64, replay_exp3 and replay_exp5."""
    import torch

    from repro_torch.core import annotate, fleetshard, torchsim
    from repro_torch.core.config import BIG, SCHEME_IDS, TorchSimConfig
    P = MAIN_VOLUMES_PER_TILE
    t_phase = time.perf_counter()
    corpus = _full_width_traces(1)
    T = corpus.shape[1]
    corpus_nxt = annotate.fleet_annotations(corpus, np.full(P, SCHEME_IDS["fk"]))
    fleets = {}
    for seg, k in sorted(PAPER_EXP2, key=lambda sk: sk[1]):    # the untimed k = 1 first
        cfg = TorchSimConfig(n_lbas=MAIN_N_LBAS, segment_size=seg, class_slots=6,
                             gc_batch_segments=k)
        fleets[f"exp2_seg{seg}"] = (cfg, _paper_policies(cfg, PAPER_SCHEMES, P))
    policy, cells3 = fleetshard.policy_grid(PAPER_SCHEMES, ("cost_benefit",), PAPER_GPS,
                                            volumes_per_cell=P)
    cfg3 = fleetshard.hetero_config(TorchSimConfig(n_lbas=MAIN_N_LBAS,
                                                   segment_size=MAIN_SEGMENT), policy)
    fleets["exp3"] = (cfg3, policy.as_state_arrays())
    cfg5 = TorchSimConfig(n_lbas=MAIN_N_LBAS, segment_size=MAIN_SEGMENT, fifo_occupancy=True)
    fleets["exp5"] = (cfg5, _paper_policies(cfg5, ("sepbit",), P))
    log(f"[paper] cuts: the main run's corpus ({P} volumes of {MAIN_N_LBAS} blocks, 64 MiB, "
        f"{T} steps) instead of the paper's volumes of >= 10 GiB; the card's step engine on "
        f"{PAPER_WINDOW} steps of each timed fleet; the CPU on one volume of each over its first "
        f"{MAIN_STEP_PREFIX} steps and on the reduced fleets (n_lbas {PARITY_N_LBAS}, 14 "
        f"schemes, (segment, k) {PAPER_PARITY}, FIFO on)")

    workers = ProcessPoolExecutor(PAPER_CPU_WORKERS,
                                  mp_context=multiprocessing.get_context("spawn"))
    with workers:
        # submitted longest first (the segment-32 volume, then the reduced fleets)
        plain = {}
        for tag, scheme in PAPER_PLAIN.items():
            cfg, pol = fleets[tag]
            row = int(np.flatnonzero((pol["p_scheme"] == SCHEME_IDS[scheme])
                                     & (pol["p_gp"] == pol["p_gp"].max()))[0])
            sub = np.ascontiguousarray(corpus[[row % P], :MAIN_STEP_PREFIX])
            plain[tag] = ([row], workers.submit(_replay_on_cpu, cfg, sub,
                                                {key: x[[row]] for key, x in pol.items()}))
            if tag == "exp2_seg32":
                parity = {sk: workers.submit(_replay_on_cpu, *_paper_parity_fleet(*sk))
                          for sk in PAPER_PARITY}
        # the reduced fleets through the kernel (held to the CPU at the end)
        reduced = {sk: _replay_row_run(*_paper_parity_fleet(*sk),
                                       f"reduced seg{sk[0]} k{sk[1]}", phase="paper")
                   for sk in PAPER_PARITY}

        rows = {}
        for tag, (cfg, pol) in fleets.items():
            V = len(pol["p_scheme"])
            padded = np.ascontiguousarray(np.tile(corpus, (V // P, 1)))
            nxts = _tiled_nxts(corpus_nxt, pol["p_scheme"])
            log(f"[paper] {tag}: {V} volumes, segment {cfg.segment_size}, k "
                f"{cfg.gc_batch_segments}, n_rows {cfg.n_rows}, class slots "
                f"{cfg.n_class_slots}, FIFO {cfg.fifo_occupancy}")
            if tag in PAPER_PLAIN:
                out = _paper_launch(tag, cfg, padded, pol, nxts, plain[tag], smi)
                rows[tag] = {"name": f"replay_{tag}", **out["row"]}
                res, final = out["res"], out["final"]
            else:
                run = _replay_row_run(cfg, padded, pol, tag, nxts=nxts, phase="paper")
                final = run["final"]
                res = torchsim.summarize_fleet(cfg, final, V)
                if res["fleet"]["overflow"] != 0 or not (final["reclaimed"] > 0).all():
                    raise AssertionError(f"[paper] {tag}: a volume overflowed or ran no GC")
            if tag.startswith("exp2"):
                _wa_rows(lambda s, seg=cfg.segment_size: f"exp2/seg{seg}/{s}", res,
                         PAPER_SCHEMES, P)
            elif tag == "exp3":
                _wa_rows(lambda c: f"exp3/gp{round(100 * c[2])}/{c[0]}", res, cells3, P)
            else:
                wss = (final["last_uw"] > -BIG).sum(1)
                peak, last = final["fifo_peak"], final["fifo_last"]
                got = peak > 0
                if not got.any():
                    raise AssertionError("[paper] exp5: no volume took a FIFO sample")
                worst = 100 * (1 - peak[got] / wss[got])
                snap = 100 * (1 - last[got] / wss[got])
                log(f"exp5/memory_reduction_worst median={np.median(worst):.1f}%;"
                    f"min={worst.min():.1f}% (of {int(got.sum())} volumes with a sample)")
                log(f"exp5/memory_reduction_snapshot median={np.median(snap):.1f}%;"
                    f"max={snap.max():.1f}%")
                rows[tag]["memory_reduction"] = {
                    "worst_median": float(np.median(worst)), "worst_min": float(worst.min()),
                    "snapshot_median": float(np.median(snap)), "snapshot_max": float(snap.max()),
                    "sampled": int(got.sum())}
            del final, res
            torch.cuda.empty_cache()

        for (seg, k), on_cpu in parity.items():
            want, wall = on_cpu.result()
            bad = _differing_keys(reduced[(seg, k)]["final"], want)
            log(f"[paper] reduced fleet (14 schemes, n_lbas {PARITY_N_LBAS}, segment {seg}, k "
                f"{k}, FIFO on) on the card vs the step engine on the cpu ({wall:.1f} s, a "
                f"worker): differing keys {bad} of {len(want)}; fifo_peak "
                f"{want['fifo_peak'].tolist()}")
            if bad or not (want["reclaimed"] > 0).all():
                raise AssertionError(f"[paper] the reduced fleet at segment {seg}, k {k} differs "
                                     f"from the CPU in {bad}")
            _check_fifo(f"reduced seg{seg} k{k}", reduced[(seg, k)]["final"])
    log(f"[paper] phase wall {time.perf_counter() - t_phase:.1f} s")
    return [rows[tag] for tag in PAPER_PLAIN]


SWEEP_SCHEMES = ("nosep", "sepgc", "sepbit", "uw", "gw")   # [sweep]: the elementwise schemes
SWEEP_SELECTORS = ("greedy", "cost_benefit")
SWEEP_GPS = (0.10, 0.15, 0.20)
SWEEP_TIMED = 3                # launches of the sweep's replay timed, timing on and off each
LATENCY_SCHEMES = ("nosep", "sepgc", "sepbit")
LATENCY_SCHEDULES = ("greedy", "rate_limited", "idle_window")
LATENCY_GP = 0.15              # benchmarks/run.py latbench's threshold


def schemes_alone(cfg, policies, trace, final, nxt, P: int, what: str = "[schemes] (b)") -> dict:
    """Each scheme's P volumes replayed alone through the instance its
    fleet takes (one launch each, on a fresh state), then the elementwise
    schemes' volumes once through the elementwise instance and once through
    the stateful one: where the stateful instance's time goes, scheme by
    scheme. Every final state equals its rows of ``final`` (numpy), the
    whole fleet's replay; with ``final`` None, its digest is printed. Returns
    the times in ms by scheme and instance."""
    from repro_torch.core.config import SCHEME_NAMES
    from repro_torch.core.placement.schemes import ELEMENTWISE_IDS
    T = trace.shape[1]
    out = {}

    def one(tag, rows, stateful=None):
        sub = {k: x[rows] for k, x in policies.items()}
        want = None if final is None else {k: x[rows] for k, x in final.items()}
        info = {}
        ms = time_replay(cfg, sub, trace[rows].contiguous(), want, reps=1,
                         nxt=None if nxt is None else nxt[rows].contiguous(), stateful=stateful,
                         info=info)
        inst = info["inst"]
        out[tag] = {"ms": ms, "us_per_step": 1e3 * ms / T, "volumes": len(rows),
                    "stateful_instance": bool(inst.stateful)}
        checked = (f"digest {info['digest']}" if final is None
                   else "equal to their rows of the fleet's replay")
        log(f"{what} {tag}: {len(rows)} volumes alone, {ms:.3f} ms, {1e3 * ms / T:.4f} us per "
            f"step, instance kStateful={int(inst.stateful)}, {checked}")

    for j, name in enumerate(SCHEME_NAMES):
        one(name, list(range(j * P, (j + 1) * P)))
    ew = [j * P + i for j in sorted(ELEMENTWISE_IDS) for i in range(P)]
    one("elementwise", ew)
    one("elementwise through kStateful", ew, stateful=True)
    return out


def _replay_on_cpu(cfg, trace, policies) -> tuple[dict, float]:
    """``trace`` replayed by the step engine on the CPU, in a worker process
    beside the card run: the final state (numpy) and its wall in s."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    st = torchsim.run_fleet(cfg, trace, policies, device="cpu", engine="step")
    return convert.state_to_numpy(st), time.perf_counter() - t0


def _full_width_traces(cells: int, n: int = MAIN_N_LBAS, per: int = MAIN_VOLUMES_PER_TILE):
    """The main run's corpus (``per`` volumes of ``n`` blocks, 2 * n
    updates, jitter 0.25, seed 23; 186 of 64 MiB by default) tiled once per
    policy cell, padded."""
    from repro_torch.core import torchsim
    from repro_torch.core.tracegen import tiled_fleet
    return torchsim.coerce_fleet(tiled_fleet("mixed", cells, per, n, 2 * n, jitter=0.25,
                                             seed=23))


def _sweep_policy():
    """[sweep]'s policy grid and the config its volumes share (timing on),
    before `fleetshard.hetero_config`."""
    from repro_torch.core import fleetshard
    from repro_torch.core.config import TorchSimConfig
    policy, cells = fleetshard.policy_grid(SWEEP_SCHEMES, SWEEP_SELECTORS, SWEEP_GPS,
                                           volumes_per_cell=MAIN_VOLUMES_PER_TILE)
    base = TorchSimConfig(n_lbas=MAIN_N_LBAS, segment_size=MAIN_SEGMENT, timing=True)
    return base, policy, cells


def _sweep_setup():
    """[sweep]'s fleet: the policy grid, its shared config (timing on) and
    the padded traces; the CPU subset: one volume of each (scheme, selector)
    pair, its GC threshold rotating over the grid."""
    P = MAIN_VOLUMES_PER_TILE
    base, policy, cells = _sweep_policy()
    padded = _full_width_traces(len(cells))
    pairs = len(SWEEP_SCHEMES) * len(SWEEP_SELECTORS)
    sub = [(j * len(SWEEP_GPS) + j % len(SWEEP_GPS)) * P + j for j in range(pairs)]
    return base, policy, cells, padded, sub


def _latency_setup():
    """[latency] (b)'s fleet: {greedy, rate_limited, idle_window} x {nosep,
    sepgc, sepbit}, cell-major, cost-benefit at GP 0.15, timing on; the CPU
    subset: one volume per cell."""
    from repro_torch.core import fleetshard
    from repro_torch.core.config import TorchSimConfig
    P = MAIN_VOLUMES_PER_TILE
    cells = [(g, sch) for g in LATENCY_SCHEDULES for sch in LATENCY_SCHEMES]
    policy = fleetshard.encode_policies(
        len(cells) * P, schemes=[sch for _, sch in cells for _ in range(P)],
        selectors="cost_benefit", gp_thresholds=LATENCY_GP,
        gcscheds=[g for g, _ in cells for _ in range(P)])
    base = TorchSimConfig(n_lbas=MAIN_N_LBAS, segment_size=MAIN_SEGMENT, timing=True)
    padded = _full_width_traces(len(cells))
    sub = [c * P + c for c in range(len(cells))]
    return base, policy, cells, padded, sub


def _submit_cpu(pool, setup):
    """Submit a setup's CPU subset to ``pool``; returns the future."""
    from repro_torch.core import fleetshard
    base, policy, _, padded, sub = setup
    cfg = fleetshard.hetero_config(base, policy)
    pol = {k: v[sub] for k, v in policy.as_state_arrays().items()}
    return pool.submit(_replay_on_cpu, cfg, np.ascontiguousarray(padded[sub]), pol)


def _check_subset(tag, final, sub, on_cpu) -> tuple[float, float]:
    """The card's rows ``sub`` of ``final`` against the CPU worker's result,
    every key; returns the CPU's wall and the time waited for it."""
    t0 = time.perf_counter()
    cpu, cpu_wall = on_cpu.result()
    waited = time.perf_counter() - t0
    bad = [k for k in cpu if not np.array_equal(final[k][sub], cpu[k])
           or final[k].dtype != cpu[k].dtype]
    log(f"[{tag}] volumes {sub} by the step engine on the cpu in {cpu_wall:.1f} s (a worker "
        f"beside the card run; waited {waited:.1f} s): differing keys against the card {bad}, "
        f"of {len(cpu)}")
    if bad:
        raise AssertionError(f"[{tag}] card and CPU differ in {bad}")
    return cpu_wall, waited


def _check_conservation(tag, final, cfg) -> None:
    """lat_charged + lat_debt == gc_writes * gc_block_cost on every volume,
    and the histogram counts every user write."""
    ok = ((final["lat_charged"] + final["lat_debt"]
           == final["gc_writes"].astype(np.float32) * np.float32(cfg.gc_block_cost)).all()
          and (final["lat_hist"].sum(1) == final["user_writes"]).all())
    log(f"[{tag}] conservation lat_charged + lat_debt == gc_writes * gc_block_cost and the "
        f"histogram's count on all {len(final['t'])} volumes: {bool(ok)}")
    if not ok:
        raise AssertionError(f"[{tag}] the timing model's accounting is not conserved")


def phase_sweep(setup, on_cpu) -> dict:
    """The heterogeneous sweep at full width: SWEEP_SCHEMES x SWEEP_SELECTORS
    x SWEEP_GPS, the main run's corpus under each of the 30 cells (5,580
    volumes of 64 MiB), timing on, greedy GC, through
    ``fleetshard.simulate_fleet_hetero`` on the replay kernel, grouped (one
    launch per scheme) and ungrouped (one launch), every key equal; the CPU
    subset equal on every key; the kernel timed alone with timing on and
    off (the off instance equal on every other key). Returns the kernel's
    ``replay_timing`` row."""
    import torch

    from repro_torch.core import fleetshard, torchsim
    from repro_torch.core.config import init_state
    from repro_torch.kernels import ops
    from repro_torch.kernels.replay import TIMING_FIELDS
    base, policy, cells, padded, sub = setup
    cfg = fleetshard.hetero_config(base, policy)
    V, T = padded.shape
    t_phase = time.perf_counter()
    log(f"[sweep] cut: volumes of {MAIN_N_LBAS} blocks (64 MiB at 4 KiB) at 2 * n_lbas "
        f"updates, as [main]: the CPU step engine replays the subset's steps in sequence, and "
        f"the replay kernel's victim scan grows with the volume")
    log(f"[sweep] {len(cells)} cells ({len(SWEEP_SCHEMES)} schemes x {len(SWEEP_SELECTORS)} "
        f"selectors x GP {SWEEP_GPS}) x {MAIN_VOLUMES_PER_TILE} = {V} volumes, n_rows "
        f"{cfg.n_rows}, class slots {cfg.n_class_slots}, steps {T}, writes "
        f"{int((padded >= 0).sum())}, timing on, greedy GC")
    runs = {}
    for group in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, st = fleetshard.simulate_fleet_hetero(padded, cfg, policy, group=group,
                                                   return_state=True, device="cuda")
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        res["sweep"] = fleetshard.sweep_summary(res, policy, cells)
        runs[group] = (res, st, wall, counts)
        writes = res["fleet"]["user_writes"]
        log(f"[sweep] group={group}: wall {wall:.3f} s (states made, replayed and read back), "
            f"volume-writes {writes}, volume-writes/s {writes / wall:.1f}, scheme groups "
            f"{res['fleet']['n_scheme_groups']}, devices {res['fleet']['n_devices']}, launches "
            f"{counts}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if counts["replay_timing"] != res["fleet"]["n_scheme_groups"] or any(
                counts[k] for k in ("replay", "segment_select_batch", "classify_gc")):
            raise AssertionError("[sweep] did not go through the replay kernel's timing instance")
        if res["fleet"]["overflow"] != 0:
            raise AssertionError("[sweep] a volume overflowed its segment pool")
    (res, final, wall_g, counts), (res_u, final_u, wall_u, _) = runs[True], runs[False]
    for row in res["sweep"]:
        log(f"[sweep] {row['scheme']:6s} {row['selector']:12s} gp {row['gp_threshold']:.2f}: WA "
            f"{row['wa']:.6f}, mean {row['wa_mean']:.6f} +- {row['wa_ci95']:.6f}, p50 "
            f"{row['lat_p50']:.3f}, p99 {row['lat_p99']:.3f}, max {row['lat_max']:.1f}")
    bad = _differing_keys(final_u, final)
    same = res_u["sweep"] == res["sweep"] and res_u["volumes"] == res["volumes"]
    log(f"[sweep] grouped vs ungrouped: differing keys {bad}, rows equal {same}; walls "
        f"{wall_g:.3f} s grouped ({counts['replay_timing']} launches), {wall_u:.3f} s ungrouped "
        f"(1 launch)")
    if bad or not same:
        raise AssertionError(f"[sweep] grouped and ungrouped differ: {bad}")
    check_integrity(cfg, final, [padded[i] for i in range(V)], "[sweep]")
    _check_conservation("sweep", final, cfg)
    del runs, res_u, final_u
    cpu_wall, _ = _check_subset("sweep", final, sub, on_cpu)

    trace = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    pol = policy.as_state_arrays()
    info, info_off = {}, {}
    ms = time_replay(cfg, pol, trace, final, reps=SWEEP_TIMED, info=info)
    off = dataclasses.replace(cfg, timing=False)
    ms_off = time_replay(off, pol, trace, {k: x for k, x in final.items()
                                            if k not in TIMING_FIELDS}, reps=SWEEP_TIMED,
                         info=info_off)
    st0 = torchsim.own_state(init_state(cfg, pol, "cuda"))
    limit = replay_bound(st0, trace, timing=True)
    limit_off = replay_bound(st0, trace)
    del st0
    geo = replay_geometry(cfg, V, info["inst"], T, ms, limit["bound_ms"])
    geo_off = replay_geometry(off, V, info_off["inst"], T, ms_off, limit_off["bound_ms"])
    log(f"[kernels] replay_timing ({V}, {T}): {ms:.3f} ms per replay (median of "
        f"{SWEEP_TIMED}, fresh states, checks outside), {1e3 * ms / T:.4f} us per step; bound "
        f"{limit['bound_ms']:.3f} ms ({limit['bound_by']}, {limit['bytes']} bytes) = "
        f"{ms / limit['bound_ms']:.1f}x; timing off on the same inputs {ms_off:.3f} ms (bound "
        f"{limit_off['bound_ms']:.3f} ms), on/off {ms / ms_off:.4f}; every other key equal")
    log(f"[kernels] replay_timing ({V}, {T}): {geometry_text(geo)}")
    log(f"[kernels] replay_timing ({V}, {T}), timing off: {geometry_text(geo_off)}")
    log(f"[sweep] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"name": "replay_timing", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/replay.cu",
            "replaces": "src/repro/kernels/segsel.py:150; src/repro/kernels/classify.py:49",
            "shape": [V, T], "steps": T, "max_abs_err": 0.0, "ms": ms, "ms_per_step": ms / T,
            "ms_timing_off": ms_off, "plain_ms": 1e3 * cpu_wall, "plain_volumes": sub, **limit,
            **geo, "times_ms": info["times"], "timing_off": geo_off,
            "launches": counts["replay_timing"],
            "tolerance": "bit-equal on every state key: grouped to ungrouped over all volumes, "
                         "to the step engine on the CPU (the plain version; plain_ms) over "
                         "plain_volumes; the timing-off instance on every key but lat_*",
            "library_ms": None}


def _log_latency_rows(part: str, rows) -> None:
    for r in rows:
        log(f"[latency] {part} {r['gcsched']:12s} {r['scheme']:6s} WA {r['wa']:.6f} p50 "
            f"{r['p50']:.3f} p99 {r['p99']:.3f} max {r['max']:.1f} mean {r['mean']:.6f} debt "
            f"{r['gc_debt']:.1f}")


def phase_latency(setup, on_cpu) -> dict:
    """(a) The committed latency bench (``BENCH_gc_latency.json``: 24
    volumes, n_lbas 256, segment 32, seed 47, cost-benefit, GP 0.15):
    nosep / sepgc / sepbit on the replay kernel and fk on the step engine,
    two calls whose volumes go back in input order; every field of the 12
    cells and the slo row reproduced. (b) At full width: LATENCY_SCHEDULES x
    LATENCY_SCHEMES x 186 volumes of 64 MiB on the replay kernel: overflow
    0, rate_limited's GC writes equal to greedy's volume by volume, the
    accounting conserved, one volume per cell equal to the CPU on every
    key. Returns the launches and the kernel's time of (b)."""
    import torch

    from repro_torch.core import fleetshard
    from repro_torch.core.config import TorchSimConfig
    from repro_torch.core.tracegen import tiled_fleet
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    bench = json.loads((Path(__file__).resolve().parent / "BENCH_gc_latency.json").read_text())
    cells = [(g, sch) for g in bench["gcscheds"] for sch in bench["schemes"]]
    per, n = bench["volumes_per_cell"], bench["n_lbas"]
    traces = tiled_fleet(bench["workload"], len(cells), per, n, bench["n_updates"],
                         jitter=0.25, seed=47)
    policy = fleetshard.encode_policies(
        len(cells) * per, schemes=[sch for _, sch in cells for _ in range(per)],
        selectors=bench["selector"], gp_thresholds=bench["gp_threshold"],
        gcscheds=[g for g, _ in cells for _ in range(per)])
    cfg = fleetshard.hetero_config(
        TorchSimConfig(n_lbas=n, segment_size=bench["segment_size"], timing=True), policy)
    is_fk = np.asarray([sch == "fk" for _, sch in cells for _ in range(per)])
    vols = [None] * len(is_fk)
    ops.reset_launch_counts()
    for engine, idx in (("replay", np.nonzero(~is_fk)[0]), ("step", np.nonzero(is_fk)[0])):
        t0 = time.perf_counter()
        res = fleetshard.simulate_fleet_hetero([traces[i] for i in idx], cfg,
                                               fleetshard._policy_rows(policy, idx),
                                               engine=engine, device="cuda")
        for i, vol in zip(idx, res["volumes"]):
            vols[i] = vol
        log(f"[latency] (a) {len(idx)} volumes on engine={engine}: "
            f"{time.perf_counter() - t0:.2f} s")
    counts = ops.launch_counts()
    rows, slo = fleetshard.latency_cells(vols, cells, per, cfg.write_cost)
    bad = [(r["gcsched"], r["scheme"]) for r, want in zip(rows, bench["cells"]) if r != want]
    log(f"[latency] (a) the committed latency bench's 12 cells: differing cells {bad}; slo row "
        f"equal {slo == bench['slo']} ({slo['gcsched']}/{slo['scheme']} p99 {slo['p99']} against "
        f"{slo['p99_greedy']}); launches {counts}")
    _log_latency_rows("(a)", rows)
    if bad or slo != bench["slo"] or 0 in (counts["replay_timing"],
                                           counts["segment_select_batch"], counts["classify_gc"]):
        raise AssertionError(f"[latency] (a) the committed cells are not reproduced: {bad}")

    base, policy, cells, padded, sub = setup
    cfg = fleetshard.hetero_config(base, policy)
    V, T = padded.shape
    log(f"[latency] (b) cut: volumes of {MAIN_N_LBAS} blocks (64 MiB at 4 KiB), as [main]")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, final = fleetshard.simulate_fleet_hetero(padded, cfg, policy, return_state=True,
                                                  device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    writes = res["fleet"]["user_writes"]
    log(f"[latency] (b) {V} volumes ({len(cells)} cells x {MAIN_VOLUMES_PER_TILE}), n_rows "
        f"{cfg.n_rows}, steps {T}: wall {wall:.3f} s, volume-writes {writes}, volume-writes/s "
        f"{writes / wall:.1f}, overflow {res['fleet']['overflow']}, launches {counts}")
    rows, _ = fleetshard.latency_cells(res["volumes"], cells, MAIN_VOLUMES_PER_TILE,
                                       cfg.write_cost)
    _log_latency_rows("(b)", rows)
    if res["fleet"]["overflow"] != 0 or counts["replay_timing"] != len(LATENCY_SCHEMES):
        raise AssertionError("[latency] (b) overflowed, or skipped the replay kernel")
    P = MAIN_VOLUMES_PER_TILE
    s = len(LATENCY_SCHEMES)
    same = all(np.array_equal(final["gc_writes"][j * P:(j + 1) * P],
                              final["gc_writes"][(s + j) * P:(s + j + 1) * P]) for j in range(s))
    log(f"[latency] (b) rate_limited's GC writes equal greedy's, volume by volume: {same}")
    if not same:
        raise AssertionError("[latency] (b) rate_limited made other GC decisions than greedy")
    check_integrity(cfg, final, [padded[i] for i in range(V)], "[latency]")
    _check_conservation("latency", final, cfg)
    _check_subset("latency", final, sub, on_cpu)
    log(f"[latency] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": counts["replay_timing"], "wall": wall}


def phase_sweep_and_latency(before=None) -> tuple:
    """[sweep] then [latency], with both CPU subsets replayed from the start
    in two worker processes beside the card runs; ``before()``, where given,
    runs first while those workers already replay (the CPU subsets take
    longer than the sweep's card run). Returns the kernel table's
    ``replay_timing`` row and ``before()``'s result."""
    sweep_setup, latency_setup = _sweep_setup(), _latency_setup()
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        sweep_cpu, latency_cpu = _submit_cpu(pool, sweep_setup), _submit_cpu(pool, latency_setup)
        first = before() if before is not None else None
        row = phase_sweep(sweep_setup, sweep_cpu)
        del sweep_setup
        row["latency_path"] = phase_latency(latency_setup, latency_cpu)
    return row, first


LEGACY_PREFIX = 24576          # [legacy]: 1.5 * n_lbas steps, past every threshold's first GC
LEGACY_WINDOW = 512            # [legacy]: the closing window both engines replay on the step engine


def phase_gcbench(smi: str) -> dict:
    """The JAX package's gcbench on the card: its 16 volumes under the legacy
    engine on the step engine (ungrouped, as the bench runs it) and under
    the tick engine on the replay kernel (grouped), each run twice (cold,
    then steady); each must reproduce ``BENCH_fleet_gc.json``'s per-volume
    reclaimed counts, WA and GC writes, and the two end equal on every key.
    Then volume 1 alone under legacy (the single-volume path: K2 at loop
    entry on every write) equal to its fleet row. Returns K2's launches
    there and its segment count."""
    import torch

    from repro_torch import convert
    from repro_torch.core import fleetshard, torchsim
    from repro_torch.core.config import TorchSimConfig
    from repro_torch.core.tracegen import make_fleet
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    bench = json.loads((Path(__file__).resolve().parent / "BENCH_fleet_gc.json").read_text())
    V, n = bench["n_volumes"], bench["n_lbas"]
    traces = make_fleet(bench["workload"], V, n, 4 * n, jitter=0.25, seed=23)
    policy = fleetshard.encode_policies(V, schemes=bench["scheme"], selectors=bench["selector"],
                                        gp_thresholds=bench["gp_thresholds"])
    base = TorchSimConfig(n_lbas=n, segment_size=bench["segment_size"])
    want = [(v["reclaimed"], v["wa"], v["gc_writes"]) for v in bench["per_volume"]]
    runs = {}
    for gc_engine, engine, group in (("legacy", "step", False), ("tick", "replay", True)):
        cfg = dataclasses.replace(base, gc_engine=gc_engine)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res, st = fleetshard.simulate_fleet_hetero(traces, cfg, policy, group=group,
                                                       return_state=True, device="cuda",
                                                       engine=engine)
            walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        got = [(v["reclaimed"], v["wa"], v["gc_writes"]) for v in res["volumes"]]
        runs[gc_engine] = {"st": st, "cold_s": walls[0], "steady_s": walls[1],
                           "volumes_per_s": V / walls[1], "counts": counts}
        log(f"[gcbench] gc_engine={gc_engine} engine={engine} group={group}: cold "
            f"{walls[0]:.3f} s, steady {walls[1]:.3f} s = {V / walls[1]:.2f} volumes/s; reclaimed "
            f"{sum(g[0] for g in got)}, per volume as BENCH_fleet_gc.json (reclaimed, WA, GC "
            f"writes): {got == want}; launches {counts}")
        if got != want:
            raise AssertionError(f"[gcbench] gc_engine={gc_engine} does not reproduce the bench")
    bad = _differing_keys(runs["legacy"]["st"], runs["tick"]["st"])
    ratio = runs["tick"]["volumes_per_s"] / runs["legacy"]["volumes_per_s"]
    log(f"[gcbench] legacy vs tick: differing keys {bad}")
    log(f"[gcbench] steady volumes/s: legacy (step engine) {runs['legacy']['volumes_per_s']:.2f}, "
        f"tick (replay kernel) {runs['tick']['volumes_per_s']:.2f}, tick / legacy {ratio:.2f}, "
        f"on {smi}")
    lc = runs["legacy"]["counts"]
    if bad or runs["tick"]["counts"]["replay"] != 1 or 0 in (
            lc["segment_select_batch"], lc["classify_gc"], lc["classify_user"]):
        raise AssertionError(f"[gcbench] legacy and tick differ in {bad}, or skipped kernels")

    i = 1
    cfg = fleetshard.matching_single_config(dataclasses.replace(base, gc_engine="legacy"),
                                            policy, i)
    ops.reset_launch_counts()
    alone = convert.state_to_numpy(torchsim.run(cfg, traces[i], device="cuda", engine="step"))
    counts = ops.launch_counts()
    bad = [k for k in alone if not np.array_equal(alone[k][0], runs["legacy"]["st"][k][i])]
    log(f"[gcbench] volume {i} alone under legacy (K2 at loop entry, {len(traces[i])} writes): "
        f"differing keys against its fleet row {bad}; launches {counts}")
    if bad or counts["segment_select"] < len(traces[i]):
        raise AssertionError("[gcbench] the single-volume legacy path disagrees or skipped K2")
    log(f"[gcbench] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"k2_launches": counts["segment_select"], "k2_rows": cfg.n_rows,
            "legacy_volumes_per_s": runs["legacy"]["volumes_per_s"],
            "tick_volumes_per_s": runs["tick"]["volumes_per_s"]}


def _step_window(cfg, start: dict, trace, tag: str):
    """``trace`` replayed on the card's step engine from the numpy state
    ``start``: the final state (numpy) and its counts."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    state = convert.state_from_numpy(start, "cuda")
    stats = torchsim.ReplayStats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = torchsim.run_fleet(cfg, trace, device="cuda", state=state, stats=stats, engine="step")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    T = stats.steps
    log(f"[legacy] window gc_engine={tag}: {T} steps, {wall / T:.6f} s/step, "
        f"{sum(counts.values()) / T:.2f} kernel launches of K1/K3 per step ({counts}), host "
        f"syncs {stats.host_syncs / T:.4f} per step, tick iterations "
        f"{stats.tick_iterations / T:.4f} per step")
    return convert.state_to_numpy(st), wall / T


def phase_legacy() -> dict:
    """The legacy GC engine at full width: the main run's fleet (744 volumes
    of 64 MiB, segment 128, gcbench's four GC thresholds) through its first
    LEGACY_PREFIX steps under ``gc_engine="legacy"`` on the card's step
    engine (K1 at loop entry on every write and after each rewrite, K3 on
    every rewrite and user write), against the replay kernel's tick engine
    on the same prefix (every key equal), eight of its volumes by the legacy
    engine on the CPU (in a worker; every key equal), overflow 0 and every
    volume past its first GC. Then the closing LEGACY_WINDOW steps again on
    the card's step engine under both GC engines from the replay kernel's
    state, timed side by side. Returns the path's launches."""
    import torch

    from repro_torch import convert
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    P, n = MAIN_VOLUMES_PER_TILE, MAIN_N_LBAS
    V = P * len(MAIN_GPS)
    full = _full_width_traces(len(MAIN_GPS))
    padded = np.ascontiguousarray(full[:, :LEGACY_PREFIX])
    tick = fleet_config(n)
    cfg = dataclasses.replace(tick, gc_engine="legacy")
    policies = fleet_policies(cfg, np.repeat(MAIN_GPS, P))
    sub = [j * P + i * (P // PLAIN_VOLUMES_PER_TILE) for j in range(len(MAIN_GPS))
           for i in range(PLAIN_VOLUMES_PER_TILE)]
    log(f"[legacy] cut: the first {LEGACY_PREFIX} of the main run's {full.shape[1]} steps "
        f"(1.5 x n_lbas: the fill ends at {n} and the thresholds' first GC falls between "
        f"steps 17,809 and 21,006), because the legacy engine's wall grows with the steps and "
        f"adds a victim selection and a host sync to every one of them")
    workers = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    with workers:
        on_cpu = workers.submit(_replay_on_cpu, cfg, np.ascontiguousarray(padded[sub]),
                                {k: x[sub] for k, x in policies.items()})
        stats = torchsim.ReplayStats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st = torchsim.run_fleet(cfg, padded, policies, device="cuda", stats=stats, engine="step")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        final = convert.state_to_numpy(st)
        del st
        T = stats.steps
        k_launches = sum(counts[k] for k in ("segment_select_batch", "classify_gc",
                                             "classify_user"))
        log(f"[legacy] {V} volumes, n_rows {cfg.n_rows}, {T} steps on the card's step engine: "
            f"wall {wall:.3f} s, s/step {wall / T:.6f}, volume-writes/s {V * T / wall:.1f}")
        log(f"[legacy] tick iterations {stats.tick_iterations} "
            f"({stats.tick_iterations / T:.4f} per step), host syncs {stats.host_syncs} "
            f"({stats.host_syncs / T:.4f} per step), kernel launches {counts}: K1 + K3 "
            f"{k_launches / T:.4f} per step; reclaimed {int(final['reclaimed'].sum())}, overflow "
            f"{int(final['overflow'].sum())}")
        if (counts["replay"] or counts["segment_select_batch"] != T + stats.tick_iterations
                or counts["classify_gc"] != stats.tick_iterations):
            raise AssertionError("[legacy] K1 was not launched at loop entry on every write and "
                                 "after every rewrite, or K3 not on every rewrite")
        if final["overflow"].any() or not (final["reclaimed"] > 0).all():
            raise AssertionError("[legacy] a volume overflowed, or one never ran GC")
        check_integrity(cfg, final, list(padded), "[legacy]")

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = convert.state_to_numpy(torchsim.run_fleet(tick, padded, policies, device="cuda"))
        rep_wall = time.perf_counter() - t0
        rep_counts = ops.launch_counts()
        bad = _differing_keys(final, rep)
        log(f"[legacy] the replay kernel (tick engine) on the same prefix ({rep_counts['replay']} "
            f"launch, {rep_wall:.3f} s): differing keys against legacy {bad}")
        if bad or rep_counts["replay"] != 1:
            raise AssertionError(f"[legacy] legacy and the replay kernel differ in {bad}")
        t0 = time.perf_counter()
        cpu, cpu_wall = on_cpu.result()
        waited = time.perf_counter() - t0
    bad = [k for k in cpu if not np.array_equal(final[k][sub], cpu[k])
           or final[k].dtype != cpu[k].dtype]
    log(f"[legacy] volumes {sub} by the legacy engine on the cpu in {cpu_wall:.1f} s (a worker "
        f"beside the card run; waited {waited:.1f} s): differing keys against the card {bad}, of "
        f"{len(cpu)}")
    if bad:
        raise AssertionError(f"[legacy] card and CPU differ in {bad}")

    # the closing window again from the replay kernel's state at its start,
    # on the card's step engine under each GC engine, timed side by side
    head = padded[:, :LEGACY_PREFIX - LEGACY_WINDOW]
    start = convert.state_to_numpy(torchsim.run_fleet(tick, np.ascontiguousarray(head),
                                                      policies, device="cuda"))
    window = np.ascontiguousarray(padded[:, LEGACY_PREFIX - LEGACY_WINDOW:])
    w_legacy, s_legacy = _step_window(cfg, start, window, "legacy")
    w_tick, s_tick = _step_window(tick, start, window, "tick")
    bad = _differing_keys(w_legacy, final) + _differing_keys(w_tick, final)
    log(f"[legacy] window: legacy / tick s/step {s_legacy / s_tick:.2f}; both end equal to the "
        f"whole prefix's state: differing keys {bad}")
    if bad:
        raise AssertionError(f"[legacy] the window's replays differ in {bad}")
    log(f"[legacy] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "steps": T, "wall": wall, "rows": cfg.n_rows, "V": V}


def _generate(model, params, toks, prompt: int):
    """Prefill ``toks[:, :prompt]`` into a fresh cache, then decode the rest
    of ``toks`` one teacher-forced step at a time: (1 + steps, B, V) float32
    logits, the prefill's first."""
    import torch
    B, S = toks.shape
    cache = model.init_cache(B, S, device="cuda")
    lg, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, cache)
    out = [lg.float()]
    for t in range(prompt, S):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        out.append(lg.float())
    return torch.stack(out)


def _k5_against_plain(model, params, toks) -> tuple:
    """The same weights and tokens decoded with K5 and with its plain version
    (`ref.flash_decode_ref` in the decode step's place): (K5's logits, the
    plain run's, the largest difference, the largest |logit| of the plain
    run)."""
    from unittest import mock

    from repro_torch.kernels import decode_attn, ref
    got = _generate(model, params, toks, CHECK_PROMPT)
    with mock.patch.object(decode_attn, "flash_decode_unread", ref.flash_decode_ref):
        plain = _generate(model, params, toks, CHECK_PROMPT)
    return got, plain, float((got - plain).abs().max()), float(plain.abs().max())


def _take_launches() -> int:
    """K5's launches since the last reset; the counts reset."""
    from repro_torch.kernels import ops
    n = ops.launch_counts()["flash_decode"]
    ops.reset_launch_counts()
    return n


def _weights_read(cfg, params, B: int) -> tuple[int, int]:
    """(parameters a decode step at batch B reads, parameters its products
    use): every one but the embedding table, plus the B embedding rows, or
    the whole table where the logits are the tied embedding's product."""
    from repro_torch.models.common import tree_leaves
    embed = params["embed"].numel()
    weights = sum(t.numel() for t in tree_leaves(params)) - embed
    if cfg.tie_embeddings:
        return weights + embed, weights + embed
    return weights + B * cfg.d_model, weights


def decode_step_bound(cfg, params, kv_lens) -> dict:
    """The least time of one decode step at batch B = len(kv_lens): the
    weights of `_weights_read` read once, each global-attention layer's K
    and V rows up to kv_len read and the new row written, the bfloat16
    logits written; the products' operations at the bf16 rate (under the MoE
    block's dense dispatch every expert's weights take part)."""
    B = len(kv_lens)
    size = cfg.pdtype().itemsize
    read, used = _weights_read(cfg, params, B)
    kv_row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * size
    n_bytes = read * size + (sum(kv_lens) + B) * kv_row + B * cfg.vocab * size
    n_ops = 2 * B * used + 4 * cfg.n_layers * cfg.n_heads * cfg.hd * sum(kv_lens)
    return {**bound(n_bytes, n_ops, BF16_FLOPS), "bytes": n_bytes, "kv_row_bytes": kv_row}


class _StepTimer:
    """Wraps a step function: CUDA events around each call (device stream
    time, idle gaps included) and the host's time to enqueue it."""

    def __init__(self, fn):
        self.fn, self.events, self.host = fn, [], []

    def __call__(self, *args):
        import torch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.fn(*args)
        end.record()
        self.host.append(time.perf_counter() - t0)
        self.events.append((start, end))
        return out

    def device_ms(self) -> float:
        """Mean device ms per call (after a synchronize)."""
        return float(np.mean([s.elapsed_time(e) for s, e in self.events]))


def _count_syncs(fn, tag: str = "[serve]"):
    """``fn()`` with PyTorch's sync debug mode on: (its result, the number of
    synchronizing calls it warned of). Logs where each was made."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # PyTorch's warning for each synchronizing call (not its one-time prototype notice)
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    for w in syncs:
        log(f"{tag}   host sync at {w.filename}:{w.lineno}: {str(w.message)[:100]}")
    return out, len(syncs)


def _k5_row(tag, q, k, v, kl, phase: str = "[serve]") -> dict:
    """K5 at a serving shape against its plain version, timed beside the
    plain version and scaled_dot_product_attention on the same inputs."""
    from repro_torch.kernels import decode_attn, ref
    out = decode_attn.flash_decode(q, k, v, kl)
    ok, err, err32 = _decode_check(out, q, k, v, kl)
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    row = {"shape": [B, S, Hq, Hkv, D], "kv_rows": int(kl.clamp(max=S).sum()),
           "max_abs_err": err, "ms": time_ms(lambda: decode_attn._launch(q, k, v, kl), reps=20),
           "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, k, v, kl), reps=5),
           **_decode_bound(q, k, v, kl), "library_ms": _decode_library(q, k, v, kl)[1]}
    log(f"{phase} K5 at the {tag} shape (B, S, Hq, Hkv, D) {row['shape']}, {row['kv_rows']} KV "
        f"rows: {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, "
        f"scaled_dot_product_attention {row['library_ms'] * 1e3:.2f} us, bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); max |err| {err:.3e}, against "
        f"float32 {err32:.3e} ok={ok}")
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version at the {tag} shape")
    return row


def phase_serve() -> dict:
    """The LM serving path at qwen3-32b's full width in bfloat16 on the card
    (weights random from a seeded generator on the card, not JAX's values):
    (a) K5 against its plain version in float32 on 2 of the 64 layers; (b)
    the same in bfloat16 on SERVE_LAYERS; (c) prefill plus decode against the
    teacher-forced forward; the reference example's traffic served through
    the port's serving functions, nosep then sepbit, its WA equal to the CPU
    accounting's; a profiled decode step; a longer-context batch. K5's
    launches equal n_layers per decode step; prefill and forward launch
    none. Returns K5's serving rows and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import make_decode_fn, make_prefill_fn, request_traffic, serve_paged

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smi = _smi()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    rng = np.random.default_rng(SERVE_SEED)
    check_toks = torch.from_numpy(rng.integers(0, cfg.vocab, (CHECK_B, CHECK_PROMPT + CHECK_STEPS),
                                               dtype=np.int32)).cuda()
    log(f"[serve] {smi}; {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / {cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_params():,} parameters; weights random from torch.Generator(cuda) seed "
        f"{SERVE_SEED} by the reference's init rule (stacked fan-in), not JAX's values")
    ops.reset_launch_counts()
    k5_steps = 0                       # n_layers x decode steps through K5 in the phase
    seen = 0                           # K5 launches counted in the phase

    # (a) float32, 2 layers: K5 against its plain version, tight
    cfg32 = dataclasses.replace(cfg, n_layers=CHECK_F32_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(cfg32)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(SERVE_SEED))
    _, _, err, top = _k5_against_plain(model, params, check_toks)
    k5_steps += cfg32.n_layers * CHECK_STEPS
    log(f"[serve] (a) float32, {cfg32.n_layers} layers, B {CHECK_B}, prompt {CHECK_PROMPT}, "
        f"{CHECK_STEPS} decode steps: logits with K5 against its plain version, max |diff| "
        f"{err:.3e} (tolerance {CHECK_F32_TOL:.0e}), max |logit| {top:.3f}")
    if not err <= CHECK_F32_TOL:
        raise AssertionError(f"[serve] (a) K5 and its plain version differ by {err:.3e}")
    del model, params
    torch.cuda.empty_cache()

    # the model at full width in bfloat16, made on the card
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[serve] bfloat16 weights made on the card in {time.perf_counter() - t0:.2f} s: "
        f"{weight_bytes:,} bytes ({weight_bytes / 2**30:.2f} GiB); device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (b) bfloat16, all layers: K5 against its plain version
    got, plain, err, top = _k5_against_plain(model, params, check_toks)
    k5_steps += cfg.n_layers * CHECK_STEPS
    log(f"[serve] (b) bfloat16, {cfg.n_layers} layers: logits with K5 against its plain version, "
        f"max |diff| {err:.4e} = {err / top:.4e} of max |logit| {top:.4f} (tolerance "
        f"{SERVE_K5_TOL}); greedy token equal at {int((got.argmax(-1) == plain.argmax(-1)).sum())} "
        f"of {got.shape[0] * got.shape[1]}")
    if not err <= SERVE_K5_TOL * top:
        raise AssertionError(f"[serve] (b) K5 and its plain version differ by {err / top:.3e}")

    # (c) prefill + stepwise decode against the teacher-forced forward
    seen += _take_launches()
    full = model.forward(params, {"tokens": check_toks})[0][:, CHECK_PROMPT - 1:].float()
    full = full.transpose(0, 1)
    if _take_launches() != 0:
        raise AssertionError("[serve] forward launched K5")
    err, top = float((got - full).abs().max()), float(full.abs().max())
    agree = int((got.argmax(-1) == full.argmax(-1)).sum())
    log(f"[serve] (c) prefill + {CHECK_STEPS} decode steps against the teacher-forced forward: "
        f"max |diff| {err:.4e} = {err / top:.4e} of max |logit| {top:.4f} (tolerance "
        f"{SERVE_FWD_TOL}); greedy token equal at {agree} of {full.shape[0] * full.shape[1]}")
    if not err <= SERVE_FWD_TOL * top:
        raise AssertionError(f"[serve] (c) decode and forward differ by {err / top:.3e}")
    del got, plain, full
    log(f"[serve] peak device memory so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the served run: the reference example's traffic at full width; the sync
    # counter first shown to see a known synchronizing call
    if _count_syncs(lambda: torch.ones(1, device="cuda").item())[1] < 1:
        raise AssertionError("[serve] the sync counter does not see .item()")
    lengths, prompts = request_traffic(SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_PROMPT, cfg.vocab)
    prompts = torch.from_numpy(prompts.astype(np.int32)).cuda()   # uploaded outside the loop
    prefill = make_prefill_fn(model, cfg)
    served = {}
    ops.reset_launch_counts()          # the main path: counts from 0, read just after
    for policy in ("nosep", "sepbit"):
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_MAX_NEW + 8, device="cuda")
        decode = _StepTimer(make_decode_fn(model, cfg))
        timed_prefill = _StepTimer(prefill)
        st, syncs = _count_syncs(lambda: serve_paged(
            timed_prefill, decode, params, cache, prompts, lengths, policy=policy,
            page_tokens=SERVE_PAGE))
        served[policy] = dict(st, syncs=syncs, step_ms=decode.device_ms(),
                              host_ms=1e3 * float(np.mean(decode.host)),
                              prefill_ms=timed_prefill.device_ms())
        log(f"[serve] {policy}: WA {st['wa']:.3f} (gc_pages {st['gc_writes']}, alloc failures "
            f"{st['alloc_failures']}), {st['decode_steps']} decode steps, {st['prefills']} "
            f"prefills, {st['tokens']} tokens in {st['wall']:.3f} s = "
            f"{st['tokens'] / st['wall']:.1f} tokens/s; decode step "
            f"{served[policy]['step_ms']:.3f} "
            f"ms on the device, {served[policy]['host_ms']:.3f} ms to enqueue; prefill (B "
            f"{SERVE_BATCH}, S {SERVE_PROMPT}) {served[policy]['prefill_ms']:.3f} ms; host syncs "
            f"in the loop {syncs} ({syncs / st['decode_steps']:.4f} per decode step)")
        if (round(st["wa"], 3), st["alloc_failures"], st["decode_steps"], st["prefills"]) != (
                SERVE_WA[policy], 0, SERVE_STEPS, SERVE_PREFILLS):
            raise AssertionError(f"[serve] {policy}: the store's accounting differs from the "
                                 f"CPU's (WA {SERVE_WA[policy]}, {SERVE_STEPS} steps, "
                                 f"{SERVE_PREFILLS} prefills, 0 alloc failures)")
        del cache
    served_launches = _take_launches()
    seen += served_launches
    steps = sum(s["decode_steps"] for s in served.values())
    log(f"[serve] served run: flash_decode launches {served_launches} = {cfg.n_layers} x "
        f"{steps} decode steps (its {2 * SERVE_PREFILLS} prefills none): "
        f"{served_launches == cfg.n_layers * steps}")
    if served_launches != cfg.n_layers * steps:
        raise AssertionError("[serve] the served run's decode steps did not all go through K5")
    k5_steps += cfg.n_layers * steps

    # a profiled decode window at the served shape
    decode = make_decode_fn(model, cfg)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_MAX_NEW + 8, device="cuda")
    lg, cache = prefill(params, {"tokens": prompts[0].expand(SERVE_BATCH, -1)}, cache)
    cur = lg.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_SERVE_STEPS):
            cur, _, cache = decode(params, cur, cache)
            cur = cur[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k5_steps += cfg.n_layers * PROFILE_SERVE_STEPS
    rows = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in rows if e.device_type.name == "CUDA"] or rows
    busy = sum(_device_us(e) for e in kernels) or float("nan")   # nan: no device time seen
    k5_us = sum(_device_us(e) for e in kernels if any(n in e.key for n in K5_KERNELS))
    n_kernels = sum(e.count for e in kernels)
    log(f"[serve] profiled {PROFILE_SERVE_STEPS} decode steps (B {SERVE_BATCH}, kv_len "
        f"{SERVE_PROMPT + 1}-{SERVE_PROMPT + PROFILE_SERVE_STEPS}): wall {wall * 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.2f}% of wall, "
        f"{n_kernels / PROFILE_SERVE_STEPS:.1f} kernels per step; K5 {k5_us / 1e3:.3f} ms = "
        f"{100 * k5_us / busy:.2f}% of the device time")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:8]:
        log(f"[serve]   {e.key[:70]:70s} {_device_us(e):12.1f} us x{e.count}")
    served_cache = cache

    # the longer-context batch
    decode = _StepTimer(make_decode_fn(model, cfg))
    cache = model.init_cache(LONG_B, LONG_PROMPT + LONG_STEPS, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LONG_B, LONG_PROMPT),
                                         dtype=np.int32)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cur = lg.argmax(-1).to(torch.int32)[:, None]

    def long_decode():
        nonlocal cur, cache
        for _ in range(LONG_STEPS):
            nxt, _, cache = decode(params, cur, cache)
            cur = nxt[:, None]
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(long_decode)
    wall = time.perf_counter() - t0
    k5_steps += cfg.n_layers * LONG_STEPS
    limit = {"bound_ms": float(np.mean([    # each step's, kv_len = prompt + step
        decode_step_bound(cfg, params, [LONG_PROMPT + t] * LONG_B)["bound_ms"]
        for t in range(1, LONG_STEPS + 1)]))}
    limit.update({k: v for k, v in decode_step_bound(cfg, params, [LONG_PROMPT + 1] * LONG_B)
                  .items() if k != "bound_ms"})
    long_ms = decode.device_ms()
    log(f"[serve] long context B {LONG_B}, prompt {LONG_PROMPT}: prefill {t_prefill:.3f} s; "
        f"{LONG_STEPS} decode steps in {wall:.3f} s, {long_ms:.3f} ms per step on the device "
        f"({1e3 * float(np.mean(decode.host)):.3f} ms to enqueue), bound {limit['bound_ms']:.3f} "
        f"ms, the mean of its steps' ({limit['bound_by']}; {limit['bytes']:,} bytes at the first, "
        f"{limit['kv_row_bytes']:,} KV bytes per cached token) = "
        f"{long_ms / limit['bound_ms']:.3f}x "
        f"the bound, {LONG_B * 1e3 / long_ms:.1f} tokens/s; host syncs {syncs}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    served_limit = decode_step_bound(cfg, params, [SERVE_PROMPT + 1] * SERVE_BATCH)
    log(f"[serve] served decode step bound {served_limit['bound_ms']:.3f} ms at kv_len "
        f"{SERVE_PROMPT + 1}, the run's least (the weights dominate): the served run's "
        f"{served['sepbit']['step_ms']:.3f} ms is "
        f"{served['sepbit']['step_ms'] / served_limit['bound_ms']:.3f}x")
    seen += _take_launches()
    log(f"[serve] flash_decode launches over the phase {seen} = n_layers x decode steps "
        f"{k5_steps}: {seen == k5_steps}")
    if seen != k5_steps:
        raise AssertionError("[serve] K5's launches differ from n_layers x decode steps")

    # K5 alone at the two shapes, on layer 0's cache (launches not counted)
    rows = {}
    for tag, c, B in (("served", served_cache, SERVE_BATCH), ("long-context", cache, LONG_B)):
        q = torch.randn(B, cfg.n_heads, cfg.hd, generator=torch.Generator(
            device="cuda").manual_seed(SERVE_SEED), device="cuda").to(torch.bfloat16)
        layer0 = c["blocks"]["p0_attn"]
        rows[tag] = _k5_row(tag, q, layer0["k"][0], layer0["v"][0], c["pos"])
    del cache, served_cache, layer0, params, model
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] peak device memory {peak / 2**30:.2f} GiB; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": served_launches, "decode_steps": steps,
            "served": {**rows["served"], "step_ms": served["sepbit"]["step_ms"],
                       "step_bound_ms": served_limit["bound_ms"]},
            "long_context": {**rows["long-context"], "step_ms": long_ms,
                             "step_bound_ms": limit["bound_ms"]},
            "peak_gib": peak / 2**30}


def _train_batch(pipe, step: int) -> dict:
    """The pipeline's batch ``step`` on the card."""
    import torch
    toks, labels = pipe.batch(step)
    return {"tokens": torch.from_numpy(toks).cuda(), "labels": torch.from_numpy(labels).cuda()}


def _bits(t):
    """A float tensor's bits as the integer of its width (bit equality)."""
    import torch
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


def _grad_check(model, cfg) -> tuple[float, float, float]:
    """(a): one loss and backward of ``cfg`` (float32) on the card and on the
    CPU from the same weights: (the card's loss, its relative difference,
    the largest gradient difference over its leaf's largest |grad|)."""
    import torch

    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import make_loss_fn
    from repro_torch.training.train_loop import loss_and_grads
    params = model.init_params(torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    rng = np.random.default_rng(TRAIN_SEED)
    toks = rng.integers(0, cfg.vocab, (TRAIN_CHECK_B, TRAIN_CHECK_S), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((TRAIN_CHECK_B, 1), -1, np.int32)], axis=1)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss_fn = make_loss_fn(model, cfg)
    loss, grads = loss_and_grads(loss_fn, params, {k: v.cuda() for k, v in batch.items()})
    cpu_loss, cpu_grads = loss_and_grads(loss_fn, tree_map(lambda t: t.detach().cpu(), params),
                                         batch)
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    gerr = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30))
               for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)))
    return float(loss), rel, gerr


def _checkpoint_round_trip(state, what: str, smi: str) -> dict:
    """(c): ``state`` saved through the port's CheckpointManager(keep=1) into
    a fresh temporary directory and restored into the port's tree on the
    card; every leaf bit-equal. Removes the directory."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(state)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cm = CheckpointManager(root, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.save(TRAIN_STEPS - 1, state)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, manifest = CheckpointManager(root).restore(state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        bad = [i for i, (a, b) in enumerate(zip(tree_leaves(got), leaves))
               if a.device != b.device or a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b))]
        wa = cm.store.write_amplification
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[train] (c) {smi}; checkpoint round trip of {what}: {len(leaves)} leaves, "
        f"{n_bytes:,} bytes ({n_bytes / 1e9:.2f} GB); save {t_save:.2f} s = "
        f"{n_bytes / 1e9 / t_save:.3f} GB/s, restore to the card {t_restore:.2f} s = "
        f"{n_bytes / 1e9 / t_restore:.3f} GB/s; store WA {wa:.3f}; step {manifest['step']}; "
        f"leaves not bit-equal {bad}")
    if bad or len(manifest["entries"]) != len(leaves):
        raise AssertionError(f"[train] (c) the restored state differs in leaves {bad}")
    return {"bytes": n_bytes, "save_s": t_save, "restore_s": t_restore, "wa": wa}


def phase_train() -> dict:
    """The training path at stablelm-1.6b's full width on the card (weights
    random from a seeded generator on the card, not JAX's values): (a) one
    loss and backward on the card against the CPU in float32 on 2 of the 24
    layers; (b) TRAIN_STEPS AdamW steps in bfloat16 on TRAIN_LAYERS with
    remat, the loss falling, timed against 6 N T and 8 N T over the card's
    bf16 peak, its host syncs counted and a window profiled; (c) the whole
    train state through the SepBIT checkpoint store and back, bit-equal.
    No kernel of the port runs on this path (the JAX train step reaches no
    Pallas call)."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM, init_train_state,
                                      make_train_step)

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    smi = _smi()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    n_params = sum(int(np.prod(sp.shape)) for sp in tree_leaves(model.param_specs()))
    n_leaves = len(tree_leaves(model.param_specs()))
    log(f"[train] {smi}; {cfg.name}: {cfg.n_layers} of {get_config(TRAIN_ARCH).n_layers} "
        f"layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / {cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.norm}, rotary fraction {cfg.rope_fraction}, remat {cfg.remat}, microbatches "
        f"{cfg.microbatches}; {n_params:,} parameters in {n_leaves} leaves by lm_specs "
        f"(ArchConfig.n_params {cfg.n_params():,} leaves out the norms); weights random from "
        f"torch.Generator(cuda) seed {TRAIN_SEED}, not JAX's values")

    # (a) float32, 2 layers: the card against the CPU
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    t0 = time.perf_counter()
    loss32, rel, gerr = _grad_check(build_model(cfg32), cfg32)
    log(f"[train] (a) {smi}; float32, {cfg32.n_layers} layers, B {TRAIN_CHECK_B}, S "
        f"{TRAIN_CHECK_S}, remat {cfg32.remat}: loss {loss32:.6f} on the card, relative "
        f"difference to the CPU {rel:.3e}; largest gradient difference over its leaf's largest "
        f"|grad| {gerr:.3e} (tolerance {TRAIN_CHECK_TOL:.0e} each); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (rel <= TRAIN_CHECK_TOL and gerr <= TRAIN_CHECK_TOL):
        raise AssertionError(f"[train] (a) card and CPU differ: loss {rel:.3e}, grads {gerr:.3e}")
    torch.cuda.empty_cache()

    # (b) bfloat16 at full depth: AdamW steps on the synthetic pipeline
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(model, cfg, opt_cfg,
                             torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    torch.cuda.synchronize()
    sizes = {k: sum(t.numel() * t.element_size() for t in tree_leaves(state[k]))
             for k in ("params", "opt")}
    log(f"[train] (b) state made on the card in {time.perf_counter() - t0:.2f} s: bfloat16 "
        f"weights {sizes['params']:,} bytes, float32 moments {sizes['opt']:,} bytes; device "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B))
    batches = [_train_batch(pipe, i) for i in range(TRAIN_STEPS + PROFILE_TRAIN_STEPS)]
    step_fn = make_train_step(model, cfg, opt_cfg)
    losses, timer = [], _StepTimer(step_fn)
    for i in range(TRAIN_TIMED_FROM):
        state, m = timer(state, batches[i])
        losses.append(m["loss"])
    torch.cuda.synchronize()

    def timed_steps():
        nonlocal state
        for i in range(TRAIN_TIMED_FROM, TRAIN_STEPS):
            state, m = timer(state, batches[i])
            losses.append(m["loss"])
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(timed_steps, "[train]")
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    n_timed = TRAIN_STEPS - TRAIN_TIMED_FROM
    ms = float(np.median([a.elapsed_time(b) for a, b in timer.events[TRAIN_TIMED_FROM:]]))
    host_ms = 1e3 * float(np.median(timer.host[TRAIN_TIMED_FROM:]))
    T = TRAIN_B * TRAIN_S
    bound6, bound8 = 1e3 * 6 * n_params * T / BF16_FLOPS, 1e3 * 8 * n_params * T / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    log(f"[train] (b) {smi}; bfloat16, {cfg.n_layers} layers, B {TRAIN_B}, S {TRAIN_S} "
        f"({T} tokens a step), {TRAIN_STEPS} steps at {TRAIN_OPT}: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[train] (b) {smi}; step {ms:.3f} ms on the device (median of steps "
        f"{TRAIN_TIMED_FROM}-{TRAIN_STEPS - 1}; {host_ms:.3f} ms to enqueue; "
        f"{wall / n_timed * 1e3:.3f} ms of wall each); 6 N T / 989 TFLOP/s = {bound6:.3f} ms, "
        f"{bound6 / ms:.4f} of the step; with the recompute 8 N T = {bound8:.3f} ms, "
        f"{bound8 / ms:.4f}; {T * 1e3 / ms:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; host syncs in steps "
        f"{TRAIN_TIMED_FROM}-{TRAIN_STEPS - 1} {syncs} ({syncs / n_timed:.4f} per step)")
    log(f"[train] (b) the loss: first {first:.4f}, mean of the last five {last5:.4f}, "
        f"{first - last5:.4f} under it (margin {TRAIN_MARGIN}); all finite: "
        f"{bool(np.isfinite(losses).all())}")
    if not np.isfinite(losses).all() or not last5 < first - TRAIN_MARGIN:
        raise AssertionError(f"[train] (b) the loss did not fall by {TRAIN_MARGIN}: {losses}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS, TRAIN_STEPS + PROFILE_TRAIN_STEPS):
            state, _ = step_fn(state, batches[i])
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in rows if e.device_type.name == "CUDA"] or rows
    busy = sum(_device_us(e) for e in kernels) or float("nan")   # nan: no device time seen
    n_kernels = sum(e.count for e in kernels)
    log(f"[train] (b) profiled {PROFILE_TRAIN_STEPS} steps: wall {p_wall * 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms = {100 * busy / 1e6 / p_wall:.2f}% of wall, "
        f"{n_kernels / PROFILE_TRAIN_STEPS:.1f} kernels per step")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:10]:
        log(f"[train]   {e.key[:70]:70s} {_device_us(e):12.1f} us x{e.count}")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"[train] the training path launched the port's kernels {launched}")

    # (c) the train state through the checkpoint store and back
    need = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    probe = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(probe).free
    shutil.rmtree(probe)
    log(f"[train] (c) temporary directory {tempfile.gettempdir()}: {free / 1e9:.2f} GB free, "
        f"one save needs {need / 1e9:.2f} GB")
    if free > 1.1 * need:
        ckpt = _checkpoint_round_trip(state, f"the whole {cfg.name} train state", smi)
        ckpt["what"] = "full"
    else:
        log(f"[train] (c) recorded cut: the disk holds no save of the whole state; the "
            f"{TRAIN_CHECK_LAYERS}-layer float32 state of (a) is checkpointed instead")
        del state
        torch.cuda.empty_cache()
        small = build_model(cfg32)
        small_state = init_train_state(small, cfg32, opt_cfg,
                                       torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
        ckpt = _checkpoint_round_trip(small_state, f"(a)'s {TRAIN_CHECK_LAYERS}-layer state",
                                      smi)
        ckpt["what"] = "cut"
    state = None
    torch.cuda.empty_cache()
    log(f"[train] phase wall {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"ms": ms, "bound6_ms": bound6, "losses": losses, "syncs": syncs, "ckpt": ckpt}


def _profile_steps(step, steps: int, tag: str, smi: str, what: str = "decode steps") -> dict:
    """``step()`` ``steps`` times under torch.profiler: wall, device busy
    (its share of wall), kernels per step; logs the six largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = [e for e in rows if e.device_type.name == "CUDA"] or rows
    busy = sum(_device_us(e) for e in kernels) or float("nan")   # nan: no device time seen
    per_step = sum(e.count for e in kernels) / steps
    log(f"{tag} {smi}; profiled {steps} {what}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.2f}% of wall, {per_step:.1f} kernels "
        f"per step")
    for e in sorted(kernels, key=lambda e: -_device_us(e))[:6]:
        log(f"{tag}   {e.key[:70]:70s} {_device_us(e):12.1f} us x{e.count}")
    return {"wall_ms": wall * 1e3, "busy_share": busy / 1e6 / wall, "kernels_per_step": per_step}


def _state_step_bound(cfg, params, cache, B: int) -> dict:
    """The least time of one decode step of a model without global attention:
    the weights of `_weights_read` read once, the whole cache read once, the
    recurrent states (every leaf but the rings' k, v and position maps)
    written and one ring row per layer, the logits written; 2 B operations
    per parameter used at the bf16 rate."""
    from repro_torch.models.common import tree_leaves
    size = cfg.pdtype().itemsize
    weights, used = _weights_read(cfg, params, B)
    read = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    rings = [c for c in list(cache["blocks"].values()) + cache["tail"] if "k" in c]
    ring_bytes = sum(c[k].numel() * c[k].element_size() for c in rings for k in ("k", "v", "pos"))
    ring_rows = sum(c[k][..., 0, :, :].numel() * c[k].element_size() if k != "pos"
                    else c[k][..., 0].numel() * c[k].element_size()
                    for c in rings for k in ("k", "v", "pos"))
    n_bytes = weights * size + read + read - ring_bytes + ring_rows + B * cfg.vocab * size
    return {**bound(n_bytes, 2 * B * used, BF16_FLOPS), "bytes": n_bytes}


def _blocks_check(arch: str, smi: str) -> dict:
    """(a): ``arch`` at full width and cut depth in float32, on the card and
    on the CPU from the same weights: forward's logits and aux over
    BLOCKS_CHECK_S tokens, then prefill of BLOCKS_CHECK_PROMPT and stepwise
    decode of the rest. Where an MoE token's chosen experts differ between
    the devices, logs the token and its top-K margin."""
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, common
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=BLOCKS_CHECK_LAYERS[arch],
                              param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(BLOCKS_SEED))
    toks = torch.from_numpy(np.random.default_rng(BLOCKS_SEED).integers(
        0, cfg.vocab, (1, BLOCKS_CHECK_S), dtype=np.int32))
    routes = {}
    top_k = common.top_k

    def run(device, p):
        calls = routes.setdefault(device, [])

        def recording(x, k):
            vals, idx = top_k(x, k)
            calls.append((x.detach().cpu(), idx.cpu()))
            return vals, idx
        with mock.patch.object(common, "top_k", recording):
            t = toks.to(device)
            logits, aux = model.forward(p, {"tokens": t})
            cache = model.init_cache(1, BLOCKS_CHECK_S, device=device)
            lg, cache = model.prefill(p, {"tokens": t[:, :BLOCKS_CHECK_PROMPT]}, cache)
            steps = [lg]
            for i in range(BLOCKS_CHECK_PROMPT, BLOCKS_CHECK_S):
                lg, cache = model.decode_step(p, t[:, i:i + 1], cache)
                steps.append(lg)
        return logits.float().cpu(), float(aux), torch.stack(steps).float().cpu()
    t0 = time.perf_counter()
    card = run("cuda", params)
    cpu = run("cpu", tree_map(lambda t: t.cpu(), params))
    fwd_err = float((card[0] - cpu[0]).abs().max()) / float(cpu[0].abs().max())
    dec_err = float((card[2] - cpu[2]).abs().max()) / float(cpu[2].abs().max())
    aux_err = abs(card[1] - cpu[1]) / abs(cpu[1]) if cpu[1] else abs(card[1])
    flips = 0
    for n, ((_, gi), (probs, ci)) in enumerate(zip(routes["cuda"], routes["cpu"])):
        K = gi.shape[-1]
        differ = (gi.sort(-1).values != ci.sort(-1).values).any(-1).reshape(-1)
        flat = probs.reshape(-1, probs.shape[-1]).sort(-1, descending=True).values
        for tok in differ.nonzero().flatten().tolist():
            flips += 1
            log(f"[blocks] (a) {arch}: top-k call {n}, token {tok}: experts "
                f"{gi.reshape(-1, K)[tok].tolist()} on the card, {ci.reshape(-1, K)[tok].tolist()} "
                f"on the CPU; top-K margin {float(flat[tok, K - 1] - flat[tok, K]):.3e}")
    ok = max(fwd_err, dec_err, aux_err) <= BLOCKS_CHECK_TOL
    routings = sum(idx.numel() // idx.shape[-1] for _, idx in routes["cpu"])
    log(f"[blocks] (a) {smi}; {arch} float32, {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers, full width, B 1, S {BLOCKS_CHECK_S} (prefill {BLOCKS_CHECK_PROMPT}, "
        f"{BLOCKS_CHECK_S - BLOCKS_CHECK_PROMPT} decode steps), card against CPU: forward "
        f"{fwd_err:.3e}, prefill + decode {dec_err:.3e} of the largest |logit| "
        f"({float(cpu[0].abs().max()):.3f}); aux {card[1]:.6e} vs {cpu[1]:.6e} ({aux_err:.3e}); "
        f"tolerance {BLOCKS_CHECK_TOL:.0e}; routing differs at {flips} of {routings} token "
        f"routings; {time.perf_counter() - t0:.1f} s; ok={ok}")
    if not ok:
        raise AssertionError(f"[blocks] (a) {arch}: card and CPU differ")
    return {"fwd_err": fwd_err, "dec_err": dec_err, "aux_err": aux_err, "flips": flips}


def _moe_serve(smi: str) -> dict:
    """(b): granite-moe-3b-a800m at full width on MOE_LAYERS layers in
    bfloat16 through the serving path: K5 against its plain version in the decode step, decode
    against forward, then [serve]'s traffic served under both policies (the
    main path: K5 launched n_layers times per decode step, no host sync);
    a profiled decode window; K5 timed at the served shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import make_decode_fn, make_prefill_fn, request_traffic, serve_paged
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(BLOCKS_SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[blocks] (b) {smi}; {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / {cfg.n_kv_heads}, head_dim {cfg.hd}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.experts_per_token}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, route_group "
        f"{cfg.moe.route_group}; {n_params:,} parameters by lm_specs, {weight_bytes:,} bytes of "
        f"bfloat16 weights made on the card from seed {BLOCKS_SEED}")
    rng = np.random.default_rng(BLOCKS_SEED)
    check_toks = torch.from_numpy(rng.integers(0, cfg.vocab, (CHECK_B, CHECK_PROMPT + CHECK_STEPS),
                                               dtype=np.int32)).cuda()
    got, plain, err, top = _k5_against_plain(model, params, check_toks)
    full = model.forward(params, {"tokens": check_toks})[0][:, CHECK_PROMPT - 1:].float()
    full = full.transpose(0, 1)
    ferr, ftop = float((got - full).abs().max()), float(full.abs().max())
    log(f"[blocks] (b) {smi}; decode step with K5 against its plain version: max |diff| "
        f"{err:.4e} = "
        f"{err / top:.4e} of max |logit| {top:.4f} (tolerance {SERVE_K5_TOL}); prefill + "
        f"{CHECK_STEPS} decode steps against forward: {ferr / ftop:.4e} of {ftop:.4f} (tolerance "
        f"{MOE_FWD_TOL}); greedy token equal at {int((got.argmax(-1) == full.argmax(-1)).sum())} "
        f"of {full.shape[0] * full.shape[1]}")
    if not (err <= SERVE_K5_TOL * top and ferr <= MOE_FWD_TOL * ftop):
        raise AssertionError("[blocks] (b) K5 against its plain version, or decode against "
                             "forward, out of tolerance")
    del got, plain, full

    lengths, prompts = request_traffic(SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_PROMPT, cfg.vocab)
    prompts = torch.from_numpy(prompts.astype(np.int32)).cuda()
    prefill = make_prefill_fn(model, cfg)
    served = {}
    ops.reset_launch_counts()          # the main path: counts from 0, read just after
    for policy in ("nosep", "sepbit"):
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_MAX_NEW + 8, device="cuda")
        decode = _StepTimer(make_decode_fn(model, cfg))
        st, syncs = _count_syncs(lambda: serve_paged(prefill, decode, params, cache, prompts,
                                                     lengths, policy=policy,
                                                     page_tokens=SERVE_PAGE), "[blocks]")
        served[policy] = dict(st, syncs=syncs, step_ms=decode.device_ms(),
                              host_ms=1e3 * float(np.mean(decode.host)))
        log(f"[blocks] (b) {smi}; {policy}: WA {st['wa']:.3f} (gc_pages {st['gc_writes']}), "
            f"{st['decode_steps']} decode steps, {st['prefills']} prefills, {st['tokens']} tokens "
            f"in {st['wall']:.3f} s = {st['tokens'] / st['wall']:.1f} tokens/s; decode step "
            f"{served[policy]['step_ms']:.3f} ms on the device, {served[policy]['host_ms']:.3f} "
            f"ms to enqueue; host syncs {syncs} ({syncs / st['decode_steps']:.4f} per step)")
        if (round(st["wa"], 3), st["alloc_failures"], st["decode_steps"], st["prefills"],
                syncs) != (SERVE_WA[policy], 0, SERVE_STEPS, SERVE_PREFILLS, 0):
            raise AssertionError(f"[blocks] (b) {policy}: the accounting differs from the CPU's, "
                                 f"or the loop synchronized")
    launches = ops.launch_counts()["flash_decode"]
    steps = sum(v["decode_steps"] for v in served.values())
    log(f"[blocks] (b) {smi}; flash_decode launches {launches} = {cfg.n_layers} x {steps} "
        f"decode steps: "
        f"{launches == cfg.n_layers * steps}")
    if launches != cfg.n_layers * steps:
        raise AssertionError("[blocks] (b) the served decode steps did not all go through K5")
    limit = decode_step_bound(cfg, params, [SERVE_PROMPT + 1] * SERVE_BATCH)
    step_ms = served["sepbit"]["step_ms"]
    log(f"[blocks] (b) {smi}; decode step bound {limit['bound_ms']:.3f} ms ({limit['bound_by']}; "
        f"{limit['bytes']:,} bytes: every expert's weights each step, the dense dispatch) at "
        f"kv_len {SERVE_PROMPT + 1}: the served step {step_ms:.3f} ms is "
        f"{step_ms / limit['bound_ms']:.3f}x")

    decode = make_decode_fn(model, cfg)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_MAX_NEW + 8, device="cuda")
    lg, cache = prefill(params, {"tokens": prompts[0].expand(SERVE_BATCH, -1)}, cache)
    cur = [lg.argmax(-1).to(torch.int32)[:, None]]

    def one():
        nxt, _, _ = decode(params, cur[0], cache)
        cur[0] = nxt[:, None]
    prof = _profile_steps(one, PROFILE_BLOCK_STEPS, "[blocks] (b)", smi)
    q = torch.randn(SERVE_BATCH, cfg.n_heads, cfg.hd, generator=torch.Generator(
        device="cuda").manual_seed(BLOCKS_SEED), device="cuda").to(torch.bfloat16)
    layer0 = cache["blocks"]["p0_attn"]
    k5 = _k5_row("granite served", q, layer0["k"][0], layer0["v"][0], cache["pos"],
                 f"[blocks] (b) {smi};")
    ops.reset_launch_counts()
    return {"launches": launches, "decode_steps": steps, "served": {**k5, "step_ms": step_ms,
            "step_bound_ms": limit["bound_ms"]}, "tokens_per_s": {
                p: v["tokens"] / v["wall"] for p, v in served.items()}, "profile": prof}


class _AuxRecorder:
    """A model whose ``forward`` is the wrapped model's, each call's aux kept
    (detached) for the train step's log."""

    def __init__(self, model):
        self.model, self.aux = model, []

    def forward(self, params, batch, sharder=None):
        logits, aux = self.model.forward(params, batch, sharder)
        self.aux.append(aux.detach())
        return logits, aux


def _moe_train(smi: str) -> dict:
    """(c): granite-moe-3b-a800m at full width on MOE_LAYERS layers,
    MOE_TRAIN_STEPS AdamW steps at B 8, S 1,024 (routing groups of 512) with
    remat: every
    loss and aux finite; the step against 6 N_active T over the bf16 peak."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM, init_train_state,
                                      make_train_step)
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=MOE_TRAIN_STEPS)
    state = init_train_state(model, cfg, opt_cfg,
                             torch.Generator(device="cuda").manual_seed(BLOCKS_SEED))
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
    n_active = n_params - cfg.n_layers * (E - K) * 3 * cfg.d_model * cfg.d_ff
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    recorder = _AuxRecorder(model)
    step_fn = _StepTimer(make_train_step(recorder, cfg, opt_cfg))
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MOE_TRAIN_S, global_batch=MOE_TRAIN_B))
    losses = []
    for i in range(MOE_TRAIN_STEPS):
        state, m = step_fn(state, _train_batch(pipe, i))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    aux = [float(x) for x in recorder.aux]
    ms = [a.elapsed_time(b) for a, b in step_fn.events]
    batch = _train_batch(pipe, MOE_TRAIN_STEPS)

    def one():
        nonlocal state
        state, _ = step_fn.fn(state, batch)
    prof = _profile_steps(one, 1, "[blocks] (c)", smi, "train step")
    T = MOE_TRAIN_B * MOE_TRAIN_S
    bound6 = 1e3 * 6 * n_active * T / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    log(f"[blocks] (c) {smi}; {cfg.name} bfloat16, {cfg.n_layers} layers, B {MOE_TRAIN_B}, S "
        f"{MOE_TRAIN_S} (routing groups of {cfg.moe.route_group}), remat {cfg.remat}, "
        f"{MOE_TRAIN_STEPS} AdamW steps: train state {state_bytes:,} bytes; losses "
        f"{[round(x, 4) for x in losses]}; aux {[f'{x:.5f}' for x in aux]}; step ms on the "
        f"device {[round(x, 3) for x in ms]}; 6 N_active T / 989 TFLOP/s = {bound6:.3f} ms "
        f"(N_active {n_active:,} of {n_params:,}), {bound6 / float(np.median(ms[1:])):.4f} of "
        f"the median step after the first; {T * 1e3 / float(np.median(ms[1:])):.1f} tokens/s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if not (np.isfinite(losses).all() and np.isfinite(aux).all()
            and len(aux) == MOE_TRAIN_STEPS and min(aux) > 0):
        raise AssertionError(f"[blocks] (c) a loss or aux is not finite: {losses} {aux}")
    del state
    return {"ms": float(np.median(ms[1:])), "bound6_ms": bound6, "losses": losses, "aux": aux,
            "peak_gib": peak / 2**30, **prof}


def _recurrent_decode(arch: str, smi: str) -> dict:
    """(d): ``arch`` at full width and depth in bfloat16: prefill of
    RECURRENT_PROMPT[arch] tokens at B 8, then RECURRENT_STEPS decode steps,
    against forward over the whole stream; timed, host syncs counted, a
    window profiled."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(BLOCKS_SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    P = RECURRENT_PROMPT[arch]
    T = P + RECURRENT_STEPS
    toks = torch.from_numpy(np.random.default_rng(BLOCKS_SEED).integers(
        0, cfg.vocab, (RECURRENT_B, T), dtype=np.int32)).cuda()
    cache = model.init_cache(RECURRENT_B, T, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, {"tokens": toks[:, :P]}, cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    out = [lg]
    decode = _StepTimer(lambda t, c: model.decode_step(params, t, c))

    def loop():
        nonlocal cache
        for i in range(P, T):
            lg, cache = decode(toks[:, i:i + 1], cache)
            out.append(lg)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(loop, "[blocks]")
    wall = time.perf_counter() - t0
    limit = _state_step_bound(cfg, params, cache, RECURRENT_B)
    step_ms = decode.device_ms()
    got = torch.stack(out).float()
    full = model.forward(params, {"tokens": toks})[0][:, P - 1:].float().transpose(0, 1)
    err, top = float((got - full).abs().max()), float(full.abs().max())
    agree = int((got.argmax(-1) == full.argmax(-1)).sum())
    del got, full, out
    cur = [toks[:, -1:]]

    def one():
        lg, _ = model.decode_step(params, cur[0], cache)
        cur[0] = lg.argmax(-1).to(torch.int32)[:, None]
    prof = _profile_steps(one, PROFILE_BLOCK_STEPS, f"[blocks] (d) {arch}", smi)
    log(f"[blocks] (d) {smi}; {arch} bfloat16, {cfg.n_layers} layers, {n_params:,} parameters by "
        f"lm_specs; B {RECURRENT_B}, prefill {P} tokens {prefill_ms:.3f} ms; {RECURRENT_STEPS} "
        f"decode steps in {wall:.3f} s, {step_ms:.3f} ms per step on the device "
        f"({1e3 * float(np.mean(decode.host)):.3f} ms to enqueue), bound {limit['bound_ms']:.3f} "
        f"ms ({limit['bound_by']}, {limit['bytes']:,} bytes) = {step_ms / limit['bound_ms']:.3f}x; "
        f"{RECURRENT_B * 1e3 / step_ms:.1f} tokens/s; host syncs {syncs} "
        f"({syncs / RECURRENT_STEPS:.4f} per step); decode against forward over the stream "
        f"{err / top:.4e} of max |logit| {top:.4f} (tolerance {RECURRENT_TOL}), greedy token "
        f"equal at {agree} of {RECURRENT_B * (RECURRENT_STEPS + 1)}")
    if not (err <= RECURRENT_TOL * top and syncs == 0):
        raise AssertionError(f"[blocks] (d) {arch}: decode differs from forward, or the loop "
                             f"synchronized")
    return {"prefill_ms": prefill_ms, "step_ms": step_ms, "bound_ms": limit["bound_ms"],
            "syncs": syncs, "err": err / top, **prof}


def phase_blocks() -> dict:
    """The MoE, local-attention and recurrent block kinds on the card
    (weights random from a seeded generator on the card, by the reference's
    init rule; not JAX's values): (a) granite-moe-3b-a800m, recurrentgemma-2b
    and rwkv6-3b at full width and cut depth in float32, card against CPU;
    (b) granite served at full width on MOE_LAYERS layers through K5; (c)
    five granite train steps on as many; (d) recurrentgemma-2b and rwkv6-3b
    decoded at full width and depth. Returns K5's row on granite's serving
    path."""
    import torch
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smi = _smi()
    for arch in BLOCKS_CHECK_LAYERS:
        _blocks_check(arch, smi)
        torch.cuda.empty_cache()
    serve = _moe_serve(smi)
    torch.cuda.empty_cache()
    _moe_train(smi)
    torch.cuda.empty_cache()
    for arch in RECURRENT_PROMPT:
        _recurrent_decode(arch, smi)
        torch.cuda.empty_cache()
    log(f"[blocks] {smi}; phase wall {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return serve


def _stub_batch(cfg, B: int, n_tokens: int, device) -> dict:
    """Tokens (B, n_tokens) and the stub frontend's embeddings (B, P or T, D)
    in float32, from numpy's generator seeded with STUB_SEED."""
    import torch
    rng = np.random.default_rng(STUB_SEED)
    toks = rng.integers(0, cfg.vocab, (B, n_tokens), dtype=np.int32)
    emb = rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model), dtype=np.float32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "prefix" if cfg.family == "vlm" else "frames": torch.from_numpy(emb).to(device)}


def _stub_check(arch: str, smi: str) -> dict:
    """(a): ``arch`` at full width, STUB_CHECK_LAYERS decoder (and encoder)
    layers, float32, on the card and on the CPU from the same weights and
    inputs: forward's logits, prefill's logits and every cache leaf, and
    STUB_CHECK_STEPS decode steps with every leaf after them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    full = get_config(arch)
    cut = {"encoder_layers": STUB_CHECK_LAYERS} if full.encoder_layers else {}
    cfg = dataclasses.replace(full, n_layers=STUB_CHECK_LAYERS, param_dtype="float32",
                              compute_dtype="float32", **cut)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(STUB_SEED))
    batch = _stub_batch(cfg, 1, STUB_CHECK_TOKENS, "cpu")
    prompt = STUB_CHECK_TOKENS - STUB_CHECK_STEPS

    def run(device, p):
        b = {k: v.to(device) for k, v in batch.items()}
        logits, _ = model.forward(p, b)
        cache = model.init_cache(1, STUB_CHECK_TOKENS, device=device)
        lg, cache = model.prefill(p, dict(b, tokens=b["tokens"][:, :prompt]), cache)
        leaves = [t.cpu().clone() for t in tree_leaves(cache)]
        steps = [lg]
        for t in range(prompt, STUB_CHECK_TOKENS):
            lg, cache = model.decode_step(p, b["tokens"][:, t:t + 1], cache)
            steps.append(lg)
        leaves += [t.cpu() for t in tree_leaves(cache)]
        return logits.cpu(), torch.stack(steps).cpu(), leaves
    t0 = time.perf_counter()
    card = run("cuda", params)
    cpu = run("cpu", tree_map(lambda t: t.cpu(), params))
    top = float(cpu[0].abs().max())
    fwd_err = float((card[0] - cpu[0]).abs().max()) / top
    dec_err = float((card[1] - cpu[1]).abs().max()) / float(cpu[1].abs().max())
    leaf_err = max(float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(card[2], cpu[2]))
    ok = max(fwd_err, dec_err, leaf_err) <= STUB_CHECK_TOL
    log(f"[vlm_audio] (a) {smi}; {arch} float32, {cfg.n_layers} of {full.n_layers} decoder "
        f"layers{f', {cfg.encoder_layers} of {full.encoder_layers} encoder' if cut else ''}, "
        f"full width, B 1, {cfg.n_prefix_tokens} "
        f"{'frames' if cfg.family == 'audio' else 'image embeddings'}"
        f", {STUB_CHECK_TOKENS} tokens (prefill {prompt}, {STUB_CHECK_STEPS} decode steps), card "
        f"against CPU: forward {fwd_err:.3e}, prefill + decode {dec_err:.3e} of the largest "
        f"|logit| ({top:.3f}); {len(card[2])} cache leaves after prefill and after decode, the "
        f"worst {leaf_err:.3e} of its largest |value|; tolerance {STUB_CHECK_TOL:.0e}; "
        f"{time.perf_counter() - t0:.1f} s; ok={ok}")
    if not ok:
        raise AssertionError(f"[vlm_audio] (a) {arch}: card and CPU differ")
    return {"fwd_err": fwd_err, "dec_err": dec_err, "leaf_err": leaf_err}


def _stub_step_bound(cfg, params, kv_lens) -> dict:
    """The least time of one decode step of the stub-frontend archs at batch
    B = len(kv_lens). paligemma: `decode_step_bound` without
    ``vision_proj`` (the decode step never reads it). whisper: the decoder's
    weights, ``lm_head`` and B embedding rows read once, every layer's
    cross K and V read whole and its self K and V rows up to kv_len, the new
    self row written, the logits written; the products at the bf16 rate."""
    from repro_torch.models.common import tree_leaves
    if cfg.family == "vlm":
        return decode_step_bound(cfg, {k: v for k, v in params.items() if k != "vision_proj"},
                                 kv_lens)
    B, size = len(kv_lens), cfg.pdtype().itemsize
    used = sum(t.numel() for key in ("decoder", "final_norm", "lm_head")
               for t in tree_leaves(params[key]))
    row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * size
    cross = B * cfg.n_prefix_tokens * row
    n_bytes = ((used + B * cfg.d_model) * size + cross + (sum(kv_lens) + B) * row
               + B * cfg.vocab * size)
    n_ops = 2 * B * used + 4 * cfg.n_layers * cfg.n_heads * cfg.hd * (
        sum(kv_lens) + B * cfg.n_prefix_tokens)
    return {**bound(n_bytes, n_ops, BF16_FLOPS), "bytes": n_bytes, "cross_bytes": cross}


def _stub_serve(arch: str, smi: str) -> dict:
    """(b) paligemma-3b or (c) whisper-small at full width and depth in
    bfloat16: STUB_B rows, each with its own stub-frontend embeddings, a
    prompt, then STUB_STEPS greedy decode steps through ``make_prefill_fn``
    / ``make_decode_fn`` (the main path: K5 launched once per attention per
    layer and step, no host sync); decode against the teacher-forced forward
    over the whole stream, and against the same steps with K5's plain
    version; a profiled window; K5 timed at the served shapes."""
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn, ref
    from repro_torch.models import build_model, whisper
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import make_decode_fn, make_prefill_fn
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    audio = cfg.family == "audio"
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(STUB_SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompt = AUDIO_PROMPT if audio else VLM_PROMPT
    max_seq = AUDIO_MAX_SEQ if audio else prompt + STUB_STEPS + 8
    offset = 0 if audio else cfg.n_prefix_tokens
    per_step = cfg.n_layers * (2 if audio else 1)       # whisper: self and cross
    batch = _stub_batch(cfg, STUB_B, prompt, "cuda")
    prefill, decode = make_prefill_fn(model, cfg), _StepTimer(make_decode_fn(model, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_ms = None
    if audio:
        whisper.encode(cfg, params, batch["frames"])
        torch.cuda.synchronize()
        enc_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
    cache = model.init_cache(STUB_B, max_seq, device="cuda")
    lg, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    out, fed = [lg], []
    cur = lg.argmax(-1).to(torch.int32)[:, None]

    def loop():
        nonlocal cur, cache
        for _ in range(STUB_STEPS):
            fed.append(cur)
            nxt, lg, cache = decode(params, cur, cache)
            out.append(lg)
            cur = nxt[:, None]
        torch.cuda.synchronize()
    _take_launches()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(loop, "[vlm_audio]")      # the main path: K5's counts from 0
    wall = time.perf_counter() - t0
    launches = _take_launches()
    step_ms = decode.device_ms()
    got = torch.stack(out).float()
    stream = torch.cat([batch["tokens"]] + fed, dim=1)
    kv_lens = [offset + prompt + t for t in range(1, STUB_STEPS + 1)]
    limit = {"bound_ms": float(np.mean([_stub_step_bound(cfg, params, [n] * STUB_B)["bound_ms"]
                                        for n in kv_lens]))}
    limit.update({k: v for k, v in _stub_step_bound(cfg, params, [kv_lens[0]] * STUB_B).items()
                  if k != "bound_ms"})

    # decode against the teacher-forced forward over the stream: prompt and fed tokens
    full = model.forward(params, dict(batch, tokens=stream))[0]
    full = full[:, offset + prompt - 1:].float().transpose(0, 1)
    if _take_launches() != 0:
        raise AssertionError("[vlm_audio] forward launched K5")
    ferr, ftop = float((got - full).abs().max()), float(full.abs().max())
    agree = int((got.argmax(-1) == full.argmax(-1)).sum())
    del full
    # the same steps with K5's plain version in the decode step's place
    with mock.patch.object(decode_attn, "flash_decode_unread", ref.flash_decode_ref):
        pcache = model.init_cache(STUB_B, max_seq, device="cuda")
        plg, pcache = model.prefill(params, batch, pcache)
        plain = [plg]
        for tok in fed:
            plg, pcache = model.decode_step(params, tok, pcache)
            plain.append(plg)
    plain = torch.stack(plain).float()
    perr, ptop = float((got - plain).abs().max()), float(plain.abs().max())
    del pcache, plain, got, out
    peak = torch.cuda.max_memory_allocated()

    def one():
        nonlocal cur
        nxt, _, _ = decode.fn(params, cur, cache)
        cur = nxt[:, None]
    prof = _profile_steps(one, PROFILE_STUB_STEPS, f"[vlm_audio] {arch}", smi)
    log(f"[vlm_audio] {'(c)' if audio else '(b)'} {smi}; {arch} bfloat16, {cfg.n_layers} "
        f"layers{f' + {cfg.encoder_layers} encoder' if audio else ''}, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads} / {cfg.n_kv_heads}, head_dim {cfg.hd}, vocab {cfg.vocab}, "
        f"{n_params:,} parameters made on the card from seed {STUB_SEED}; B {STUB_B}, "
        f"{cfg.n_prefix_tokens} {'frames' if audio else 'image embeddings'} a row, prompt "
        f"{prompt}{f', encoder {enc_ms:.3f} ms' if audio else ''}, prefill {prefill_ms:.3f} ms; "
        f"{STUB_STEPS} decode steps in {wall:.3f} s, {step_ms:.3f} ms per step on the device "
        f"({1e3 * float(np.mean(decode.host)):.3f} ms to enqueue), bound {limit['bound_ms']:.3f} "
        f"ms, the mean of its steps' ({limit['bound_by']}; {limit['bytes']:,} bytes at the "
        f"first) = {step_ms / limit['bound_ms']:.3f}x; {STUB_B * 1e3 / step_ms:.1f} tokens/s; "
        f"host syncs {syncs} ({syncs / STUB_STEPS:.4f} per step); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[vlm_audio] {'(c)' if audio else '(b)'} {smi}; {arch}: flash_decode launches "
        f"{launches} = {per_step} x {STUB_STEPS} decode steps: {launches == per_step * STUB_STEPS}"
        f"; decode with K5 against its plain version {perr / ptop:.4e} of max |logit| "
        f"{ptop:.4f}; prefill + decode against forward over the stream {ferr / ftop:.4e} of "
        f"{ftop:.4f} (tolerance {STUB_TOL}); greedy token equal at {agree} of "
        f"{STUB_B * (STUB_STEPS + 1)}")
    if not (launches == per_step * STUB_STEPS and syncs == 0 and perr <= STUB_TOL * ptop
            and ferr <= STUB_TOL * ftop):
        raise AssertionError(f"[vlm_audio] {arch}: K5's launches, a host sync, K5 against its "
                             f"plain version or decode against forward failed")
    q = torch.randn(STUB_B, cfg.n_heads, cfg.hd, generator=torch.Generator(
        device="cuda").manual_seed(STUB_SEED), device="cuda").to(torch.bfloat16)
    tag = f"[vlm_audio] {smi};"
    if audio:
        rows = {"served_self": _k5_row("whisper self", q, cache["self_k"][0],
                                       cache["self_v"][0], cache["pos"], tag),
                "served_cross": _k5_row("whisper cross", q, cache["cross_k"][0],
                                        cache["cross_v"][0],
                                        torch.full_like(cache["pos"], cfg.n_prefix_tokens), tag)}
    else:
        layer0 = cache["blocks"]["p0_attn"]
        rows = {"served": _k5_row("paligemma served", q, layer0["k"][0], layer0["v"][0],
                                  cache["pos"], tag)}
    _take_launches()
    for row in rows.values():
        row.update(step_ms=step_ms, step_bound_ms=limit["bound_ms"])
    return {"launches": launches, "decode_steps": STUB_STEPS, **rows, "prefill_ms": prefill_ms,
            "encoder_ms": enc_ms, "peak_gib": peak / 2**30, **prof}


def _stub_train(arch: str, smi: str) -> dict:
    """(d): one AdamW step of ``arch`` at full width and depth in bfloat16 on
    ``input_specs``' inputs of a train shape (STUB_TRAIN): loss and gradient
    norm finite, no host sync; the step against 6 N T over the bf16 peak
    (whisper: its encoder's parameters over the frames, its decoder's over
    the tokens)."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    state = init_train_state(model, cfg, opt_cfg,
                             torch.Generator(device="cuda").manual_seed(STUB_SEED))
    B, seq = STUB_TRAIN[arch]
    batch = model.input_specs(ShapeConfig(f"{arch}-train", seq, B, "train"), abstract=False,
                              generator=torch.Generator(device="cuda").manual_seed(STUB_SEED))
    step = _StepTimer(make_train_step(model, cfg, opt_cfg))
    out = {}

    def one():
        _, out["m"] = step(state, batch)
        torch.cuda.synchronize()
    _, syncs = _count_syncs(one, "[vlm_audio]")
    loss, gnorm = float(out["m"]["loss"]), float(out["m"]["grad_norm"])
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    if cfg.family == "audio":
        enc = sum(t.numel() for k in ("enc_in", "encoder", "enc_norm")
                  for t in tree_leaves(state["params"][k]))
        work = enc * B * cfg.n_prefix_tokens + (n_params - enc) * B * seq
    else:
        work = n_params * B * seq
    bound6 = 1e3 * 6 * work / BF16_FLOPS
    ms = step.device_ms()
    peak = torch.cuda.max_memory_allocated()
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    remat = "none (as the reference's)" if cfg.family == "audio" else cfg.remat
    log(f"[vlm_audio] (d) {smi}; {arch} bfloat16, {n_params:,} parameters, remat {remat}, "
        f"one AdamW step on input_specs {shapes}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
        f"{ms:.3f} ms on the device; 6 N T / 989 TFLOP/s = {bound6:.3f} ms, {bound6 / ms:.4f} of "
        f"the step; host syncs {syncs}; peak device memory {peak / 2**30:.2f} GiB")
    if not (np.isfinite(loss) and np.isfinite(gnorm) and syncs == 0):
        raise AssertionError(f"[vlm_audio] (d) {arch}: loss {loss}, grad norm {gnorm}, "
                             f"host syncs {syncs}")
    return {"ms": ms, "bound6_ms": bound6, "loss": loss, "peak_gib": peak / 2**30}


def phase_vlm_audio() -> dict:
    """The vlm prefix and whisper on the card (weights random from a seeded
    generator on the card, by the reference's init rule; not JAX's values):
    (a) paligemma-3b and whisper-small at full width and cut depth in
    float32, card against CPU; (b) paligemma-3b and (c) whisper-small served
    at full width and depth in bfloat16 through K5 (D 256 at G 8; D 64 at
    G 1, self and cross); (d) one train step of each; (e) K5 timed at the
    three served shapes. Returns K5's rows on the two paths."""
    import torch
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    smi = _smi()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        _stub_check(arch, smi)
        torch.cuda.empty_cache()
    paths = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        paths[arch] = _stub_serve(arch, smi)
        torch.cuda.empty_cache()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        paths[arch]["train"] = _stub_train(arch, smi)
        torch.cuda.empty_cache()
    log(f"[vlm_audio] {smi}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"vlm_path": paths[VLM_ARCH], "audio_path": paths[AUDIO_ARCH]}


DIST_ARCH = "stablelm-1.6b"     # [dist] (a): served through the sharder at full width and depth
DIST_SEED = 24
DIST_B, DIST_PROMPT, DIST_STEPS = 8, 128, 32
DIST_ROUNDS = 20               # (b): error-feedback rounds with a fixed gradient
DIST_BLOCK = 256               # (b): the int8 quantization's block, the reference's default
DIST_DRY_ARCH = "qwen3-32b"    # (c): the dry run's cells on the 16 x 16 production mesh
DIST_DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DIST_FLOPS = {"decode": (0.99, 1.1), "prefill": (0.9, 1.3), "train": (0.9, 1.3)}
#   (c): FLOPs per chip over the useful ones plus the attention's share (`_dist_dry_check`);
#   N counts the embedding table, which costs no product


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _attention_flops(cfg, shape) -> float:
    """The score and value products of every attention layer over the whole
    step, which 2 N T leaves out: 4 hd FLOPs per query head, query token and
    key; prefill and train over the whole S x S (the port masks it, it does
    not skip it), train three times over (forward, two in backward) plus
    one with remat; decode one query against S keys."""
    B, S = shape.global_batch, shape.seq_len
    per_key = 4 * cfg.n_heads * cfg.hd * cfg.n_layers
    if shape.kind == "decode":
        return per_key * B * S
    return per_key * B * S * S * ((4 if cfg.remat else 3) if shape.kind == "train" else 1)


def _dist_serve(smi: str, sharder) -> dict:
    """(a) DIST_ARCH at full width and depth in bfloat16 (weights random from
    a seeded generator on the card), DIST_B rows of a DIST_PROMPT-token
    prompt and DIST_STEPS greedy decode steps through ``make_prefill_fn`` /
    ``make_decode_fn(model, cfg, sharder)`` on the one-rank mesh (the main
    path: K5's counts from 0), then the same calls without a sharder: every
    logit equal bit for bit, K5 once per layer and step, no host sync."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import place_params
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import make_decode_fn, make_prefill_fn
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(DIST_ARCH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(DIST_SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab, (DIST_B, DIST_PROMPT), device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(DIST_SEED))
    max_seq = DIST_PROMPT + DIST_STEPS + 8

    def serve(sh, timer=None):
        p = params if sh is None else place_params(params, sh, model.param_specs())
        prefill = make_prefill_fn(model, cfg, sh)
        decode = make_decode_fn(model, cfg, sh)
        step = decode if timer is None else timer(decode)
        cache = model.init_cache(DIST_B, max_seq, device="cuda")
        lg, cache = prefill(p, {"tokens": toks}, cache)
        out = [lg]
        cur = lg.argmax(-1).to(torch.int32)[:, None]
        _take_launches()

        def loop():
            nonlocal cur, cache
            for _ in range(DIST_STEPS):
                nxt, lg, cache = step(p, cur, cache)
                out.append(lg)
                cur = nxt[:, None]
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs = _count_syncs(loop, "[dist]")
        wall = time.perf_counter() - t0
        return torch.stack(out), syncs, _take_launches(), wall, step

    got, syncs, launches, wall, timer = serve(sharder, _StepTimer)
    want, _, _, _, _ = serve(None)
    equal = bool(torch.equal(got, want))
    step_ms = timer.device_ms()
    kv_lens = [DIST_PROMPT + t for t in range(1, DIST_STEPS + 1)]
    limit = float(np.mean([decode_step_bound(cfg, params, [n] * DIST_B)["bound_ms"]
                           for n in kv_lens]))
    by = decode_step_bound(cfg, params, [kv_lens[0]] * DIST_B)["bound_by"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[dist] (a) {smi}; {DIST_ARCH} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params:,} parameters from seed {DIST_SEED} on the {sharder.axis_sizes} "
        f"mesh (attn_mode {sharder.attn_mode}); B {DIST_B}, prompt {DIST_PROMPT}, {DIST_STEPS} "
        f"decode steps through the sharded serving functions in {wall:.3f} s, {step_ms:.3f} ms "
        f"per step on the device ({1e3 * float(np.mean(timer.host)):.3f} ms to enqueue), bound "
        f"{limit:.3f} ms ({by}) = {step_ms / limit:.3f}x; flash_decode launches {launches} = "
        f"{cfg.n_layers} x {DIST_STEPS}: {launches == cfg.n_layers * DIST_STEPS}; host syncs "
        f"{syncs}; every logit of {tuple(got.shape)} equal to the unsharded calls': {equal}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if not (equal and syncs == 0 and launches == cfg.n_layers * DIST_STEPS):
        raise AssertionError("[dist] (a): the sharded serving path differs from the unsharded "
                             "one, synced with the host or missed K5 launches")
    return {"launches": launches, "decode_steps": DIST_STEPS, "step_ms": step_ms,
            "step_bound_ms": limit, "host_syncs": syncs}


def _dist_allreduce(smi: str) -> dict:
    """(b) `compressed_allreduce` over the one-rank NCCL group on a float32
    tree of DIST_ARCH's parameter shapes from a seed: q and the scales on the
    card bit-equal to the CPU's on three leaves; sent + residual == y on
    every leaf, exactly; over DIST_ROUNDS rounds with a fixed gradient, the
    mean of the reduced values within one quantum of the gradient; each
    round timed against the bytes it must move (x, the residual and the
    outputs: 16 bytes a value)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    specs = tree_leaves(build_model(get_config(DIST_ARCH)).param_specs())
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
    grads = [torch.randn(s.shape, generator=gen, device="cuda") * 1e-3 for s in specs]
    n = sum(g.numel() for g in grads)
    for g in sorted(grads, key=lambda t: -t.numel())[:3]:     # the three largest leaves
        q, scale = collectives.quantize_int8(g, DIST_BLOCK)
        cq, cscale = collectives.quantize_int8(g.cpu(), DIST_BLOCK)
        if not (torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale)):
            raise AssertionError("[dist] (b): quantize_int8 on the card differs from the CPU")
    resid = [torch.zeros_like(g) for g in grads]
    total = [torch.zeros_like(g) for g in grads]
    exact = True
    ms = []
    for r in range(DIST_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [collectives.compressed_allreduce(g, e, block=DIST_BLOCK)
                for g, e in zip(grads, resid)]
        end.record()
        if r == 0:      # one rank: the reduced value is the sent one
            exact = all(bool(torch.equal(m + e2, g + e)) for (m, e2), g, e in
                        zip(outs, grads, resid))
        for t, (m, _) in zip(total, outs):
            t.add_(m)
        resid = [e2 for _, e2 in outs]
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    worst = 0.0
    for t, g in zip(total, grads):
        _, scale = collectives.quantize_int8(g, DIST_BLOCK)
        err = collectives.quantize_int8((t / DIST_ROUNDS - g).abs(), DIST_BLOCK)[1]
        worst = max(worst, float((err * 127.0 / scale).max()))    # |mean - g| in quanta
    limit = bound(16 * n)
    round_ms = float(np.median(ms))
    log(f"[dist] (b) {smi}; int8 error-feedback all-reduce over the one-rank NCCL group, "
        f"{len(grads)} float32 leaves of {DIST_ARCH}'s shapes ({n:,} values), block "
        f"{DIST_BLOCK}: q and scales card = CPU on the three largest leaves; sent + residual "
        f"== y on every leaf: {exact}; after {DIST_ROUNDS} rounds the mean of the reduced "
        f"values lies within {worst:.4f} quanta of the gradient; a round {round_ms:.3f} ms "
        f"(median), {16 * n / round_ms / 1e6:.1f} GB/s against the bytes bound "
        f"{limit['bound_ms']:.3f} ms at 3.35 TB/s = {round_ms / limit['bound_ms']:.2f}x")
    if not (exact and worst <= 1.0):
        raise AssertionError("[dist] (b): the residual or the error feedback is off")
    return {"round_ms": round_ms, "bound_ms": limit["bound_ms"], "quanta": worst}


def _dist_dry_check(smi: str, proc, path: str) -> dict:
    """(c) the dry run's records (`dryrun`'s command line, started in a
    subprocess at the phase's start: a fake process group cannot share a
    process with the NCCL one), then ``roofline.build_table`` on them:
    every cell ok, its per-chip argument bytes against the card's memory,
    its FLOPs per chip within DIST_FLOPS of the useful 2 N_active T / chips
    (6 or 8 N T for train) plus the attention's share: the chip's share of
    the products (prefill and train: q split over every chip), or in
    head_dim mode's decode K5 on whole heads on every rank of the model axis
    (the products of B / data rows, the model axis's width times a chip's
    share). The axes' widths come from the record's mesh."""
    import torch

    from repro_torch import roofline
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import Sharder, ShapeMesh
    from repro_torch.launch import dryrun
    out, _ = proc.communicate(timeout=600)
    for line in out.splitlines()[-8:]:
        log(f"[dist] (c)   {line[:300]}")
    with open(path) as f:
        recs = {r["shape"]: r for r in json.load(f)}
    cfg = get_config(DIST_DRY_ARCH)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    ok = True
    for name in DIST_DRY_SHAPES:
        rec = recs.get(name, {"status": "missing"})
        if rec["status"] != "ok":
            log(f"[dist] (c) {name}: {rec}")
            ok = False
            continue
        shape, chips = SHAPES[name], rec["n_chips"]
        widths = tuple(int(n) for n in rec["mesh"].split("x"))
        mesh = ShapeMesh(("pod", "data", "model")[-len(widths):], widths)
        whole = shape.kind == "decode" and Sharder(mesh, cfg).attn_mode == "head_dim"
        useful = dryrun.model_flops_per_chip(cfg, shape, chips)
        attn = _attention_flops(cfg, shape) * (widths[-1] if whole else 1) / chips
        lo, hi = [f * (useful + attn) for f in DIST_FLOPS[shape.kind]]
        fits = rec["memory"]["argument_bytes"] < total_mem
        ok &= lo <= rec["flops"] <= hi
        coll = rec["collective_bytes"]
        log(f"[dist] (c) {smi}; {DIST_DRY_ARCH} {name} on {rec['mesh']} ({chips} chips, fake "
            f"group, meta tensors): argument bytes per chip {rec['memory']['argument_bytes']:,} "
            f"against the card's {total_mem:,} (fits: {fits}), output "
            f"{rec['memory']['output_bytes']:,}; "
            f"FLOPs per chip {rec['flops']:.4e} = {rec['flops'] / useful:.3f}x the useful "
            f"{useful:.4e}, {rec['flops'] / (useful + attn):.3f}x it plus the attention's share "
            f"{attn:.4e}, within [{lo:.4e}, {hi:.4e}]: {lo <= rec['flops'] <= hi}; bytes "
            f"accessed {rec['bytes_accessed']:.4e}; collectives {coll['total']:,} bytes "
            f"(all-gather {coll['all-gather']:,}, all-reduce {coll['all-reduce']:,}, "
            f"reduce-scatter {coll['reduce-scatter']:,}, all-to-all {coll['all-to-all']:,}); "
            f"traced in {rec['compile_s'] + rec['analysis_compile_s']:.1f} s")
    rows = roofline.build_table(path)
    for line in roofline.format_table(rows).splitlines():
        log(f"[dist] (c) roofline (H100: {roofline.PEAK_FLOPS:.3g} FLOP/s, HBM "
            f"{roofline.HBM_BW:.3g} B/s, NVLink {roofline.LINK_BW:.3g} B/s) {line}")
    if not (ok and proc.returncode == 0 and len(rows) == len(DIST_DRY_SHAPES)):
        raise AssertionError("[dist] (c): a dry-run cell failed or its FLOPs left their bounds")
    return {name: recs[name] for name in DIST_DRY_SHAPES}


def phase_dist() -> dict:
    """The distribution layer on the card: (c)'s dry run starts in a
    subprocess on the CPU; (a) the sharded serving path on a one-rank NCCL
    group's (1, 1) mesh (``launch.make_host_mesh``); (b) the int8
    error-feedback all-reduce over that group; then (c)'s records and the
    roofline. Returns K5's counts on (a)'s path."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import Sharder
    from repro_torch.launch import make_host_mesh
    t_phase = time.perf_counter()
    smi = _smi()
    root = Path(__file__).resolve().parent
    out_dir = root / "build"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "dryrun_qwen3.json")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             DIST_DRY_ARCH, "--out", path], cwd=root, text=True,
                            env=dict(os.environ, PYTHONPATH=str(root / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = make_host_mesh()
            path_a = _dist_serve(smi, Sharder(mesh, get_config(DIST_ARCH)))
            torch.cuda.empty_cache()
            _dist_allreduce(smi)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        _dist_dry_check(smi, proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[dist] {smi}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return path_a


REPLAY_AB_REPS = 3             # --replay-times: launches timed per fleet and tree


def replay_times(srcs: list[str]) -> None:
    """``python3 chip_smoke.py --replay-times SRC [SRC ...]``: the replay
    kernel of each source tree (a checkout's ``src`` directory), built and
    timed in this process one tree after the other, on the smoke's fleets
    (`replay_fleets`) and on [schemes] (b)'s schemes alone
    (`schemes_alone`). Each time is the median of REPLAY_AB_REPS launches
    on fresh states (one for [scale] and a scheme alone), printed with a
    digest of the final state (equal digests: bit-equal replays) and, where
    the tree has it, the instance's geometry. Give the trees in turns
    (A B B A) to compare them on one card."""
    import torch
    corpus = scale = None
    for src in srcs:
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(Path(src).resolve()))
        try:
            from repro_torch.kernels import replay as kreplay
            REPLAY_PTXAS.clear()
            phase_build()
            log(f"[replay-times] {src}: {kreplay.__file__}, instances "
                f"{sorted(REPLAY_PTXAS.items())}")
            if corpus is None:
                corpus = _full_width_traces(1)
                scale = _full_width_traces(len(MAIN_GPS), SCALE_N_LBAS, SCALE_VOLUMES_PER_TILE)
            for tag, cfg, pol, trace, nxt in replay_fleets(corpus, scale):
                info = {}
                ms = time_replay(cfg, pol, trace, None, reps=1 if tag == "scale" else
                                 REPLAY_AB_REPS, nxt=nxt, info=info)
                V, T = trace.shape
                geo = ""
                if hasattr(kreplay, "occupancy"):
                    g = kreplay.occupancy(cfg, V, info["inst"])
                    geo = (f"; W {g['warps']}, shared meta {g['shared_meta']}, "
                           f"{g['registers']} registers, local {g['local_bytes']} B, "
                           f"{g['resident']} resident, {g['waves']} wave(s)")
                log(f"[replay-times] {src}: {tag} ({V}, {T}): "
                    f"{' '.join(f'{x:.3f}' for x in info['times'])} ms, median {ms:.3f} ms, "
                    f"{1e3 * ms / T:.4f} us per step, digest {info['digest']}{geo}")
                if tag == "schemes":
                    schemes_alone(cfg, pol, trace, None, nxt, MAIN_VOLUMES_PER_TILE,
                                  f"[replay-times] {src}: schemes")
                del trace, nxt
        finally:
            sys.path.pop(0)
            torch.cuda.empty_cache()


def replay_fleets(corpus, scale):
    """The fleets `replay_times` launches, on the card, made with the
    phases' own configs and policies from the main run's ``corpus`` (186
    volumes) and [scale]'s padded traces: [main] (744 volumes) and its
    first volume alone (V = 1, as a single-volume `run` launches the
    kernel), [schemes] (b) (2,604, fk's stream with it), [sweep] (5,580)
    with the timing model on and off, [scale] (32 of 1 GiB). Yields (tag,
    cfg, policies, trace, nxt)."""
    import torch

    from repro_torch.core import fleetshard, torchsim
    from repro_torch.core.config import SCHEME_NAMES
    P = MAIN_VOLUMES_PER_TILE

    def tiled(m: int):
        return torch.from_numpy(np.ascontiguousarray(np.tile(corpus, (m, 1)))).cuda()

    cfg = fleet_config(MAIN_N_LBAS)
    pol = fleet_policies(cfg, np.repeat(MAIN_GPS, P))
    yield "main", cfg, pol, tiled(len(MAIN_GPS)), None
    one = corpus[:1, :int((corpus[0] >= 0).sum())]
    yield ("main volume 0 alone", cfg, {k: x[:1] for k, x in pol.items()},
           torch.from_numpy(np.ascontiguousarray(one)).cuda(), None)
    cfg = schemes_config(MAIN_N_LBAS)
    pol = schemes_policies(cfg, P)
    trace = tiled(len(SCHEME_NAMES))
    nxt = torchsim._next_writes({"p_scheme": torch.from_numpy(pol["p_scheme"]).cuda()}, trace)
    yield "schemes", cfg, pol, trace, nxt
    del trace, nxt
    base, policy, cells = _sweep_policy()
    cfg = fleetshard.hetero_config(base, policy)
    trace = tiled(len(cells))
    yield "sweep", cfg, policy.as_state_arrays(), trace, None
    yield "sweep timing off", dataclasses.replace(cfg, timing=False), \
        policy.as_state_arrays(), trace, None
    del trace
    cfg = fleet_config(SCALE_N_LBAS)
    yield ("scale", cfg, fleet_policies(cfg, np.repeat(MAIN_GPS, SCALE_VOLUMES_PER_TILE)),
           torch.from_numpy(scale).cuda(), None)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--replay-times"]:
        phase_device()
        replay_times(sys.argv[2:])
        return 0
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
    serve = phase_serve()
    phase_train()
    blocks = phase_blocks()
    decode_row.update(phase_vlm_audio())
    decode_row["dist_path"] = phase_dist()
    decode_row["serve_path"] = {key: serve[key] for key in ("launches", "decode_steps", "served",
                                                           "long_context")}
    decode_row["moe_serve_path"] = {key: blocks[key] for key in ("launches", "decode_steps",
                                                                "served")}
    kernels.append(decode_row)
    analysis_launches = phase_analysis()
    single_rows, k2_launches = phase_parity()
    cfg, st, counts, replay_row = phase_main()
    kernels.append(replay_row)
    if (cfg.n_rows, single_rows) != (main_rows, fleet_config(PARITY_N_LBAS).n_rows):
        raise AssertionError("a kernel was timed at another shape than its path's")
    phase_scale()
    phase_profile(cfg, st)
    del st
    sweep_row, (schemes, paper_rows) = phase_sweep_and_latency(
        before=lambda: (phase_schemes(), phase_paper(device["smi"])))
    schemes_rows = schemes["path_rows"]
    kernels.append(sweep_row)
    kernels.append(schemes["row"])
    kernels += paper_rows
    gcbench = phase_gcbench(device["smi"])
    legacy = phase_legacy()
    legacy_rows = _path_kernel_rows(
        "legacy", np.random.default_rng(4), legacy["V"], legacy["rows"], MAIN_SEGMENT,
        {**legacy["counts"], "segment_select": gcbench["k2_launches"]},
        single_rows=legacy["rows"])
    legacy_rows["segment_select"]["launches_from"] = (
        f"[gcbench] volume 1 alone ({gcbench['k2_rows']} rows); [legacy] is a fleet")
    launches = {**counts["step"], "segment_select": k2_launches, **analysis_launches,
                "flash_decode": decode_launches, "replay": counts["replay"]["replay"]}
    for row in kernels:
        row["launches"] = row.get("launches", launches.get(row["name"]))
        if row["name"] in schemes_rows:
            row["schemes_path"] = schemes_rows[row["name"]]
        if row["name"] in legacy_rows:
            row["legacy_path"] = legacy_rows[row["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(device["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
