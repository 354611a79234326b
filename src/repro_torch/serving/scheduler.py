"""Continuous-batching scheduler + serving-workload simulator (the port's copy
of the JAX package's ``serving/scheduler.py``, numpy only).

Drives the SepBIT LogKVStore with realistic request traffic (skewed decode
lengths — the serving analogue of the paper's skewed write workloads) and
accounts compaction WA. Also hosts the Engine glue used by the runnable
serving example (examples/serve_paged_torch.py): admit up to ``max_batch``
sequences, decode them in lockstep, allocate a KV page every ``page_tokens``
steps, release pages on finish.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .logkv import LogKVConfig, LogKVStore


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 2000
    max_batch: int = 32
    page_tokens: int = 16
    # decode-length mixture: mostly short, heavy tail (chat + long-form)
    short_mean: float = 8.0     # pages
    long_mean: float = 64.0     # pages
    long_frac: float = 0.2
    max_pages: int = 192        # per-request cap (context limit)
    decode_prob: float = 0.7    # per-tick progress probability (speed
                                # heterogeneity: real batches are not lockstep)
    seed: int = 0


def sample_lengths(w: WorkloadConfig, rng) -> np.ndarray:
    is_long = rng.random(w.n_requests) < w.long_frac
    short = rng.geometric(1.0 / w.short_mean, w.n_requests)
    longs = rng.geometric(1.0 / w.long_mean, w.n_requests)
    return np.where(is_long, longs, short).clip(1, w.max_pages)


def run_serving_sim(kv_cfg: LogKVConfig, w: WorkloadConfig) -> dict:
    """Lockstep continuous batching: each tick, every running sequence decodes
    one page('s worth of tokens); finished sequences release pages and free
    slots are refilled from the queue. Returns the store's WA stats."""
    rng = np.random.default_rng(w.seed)
    lengths = sample_lengths(w, rng)
    store = LogKVStore(kv_cfg)

    queue = list(range(w.n_requests))
    running: dict[int, int] = {}     # seq_id -> remaining pages
    ticks = preemptions = 0
    pool_cap = kv_cfg.n_frames * kv_cfg.pages_per_frame
    while queue or running:
        ticks += 1
        # admission control: admit only if the request's full KV footprint
        # fits beside the currently-live pages (over-admission causes
        # preemption thrash — real engines gate on free KV memory)
        while (queue and len(running) < w.max_batch
               and store._live + lengths[queue[-1]] <= 0.9 * pool_cap):
            seq = queue.pop()
            running[seq] = int(lengths[seq])
        finished = []
        appended = blocked = 0
        for seq in list(running):
            if rng.random() > w.decode_prob:
                continue          # scheduled out this tick (not starvation)
            if store.append_page(seq) is None:
                blocked += 1      # pool exhausted for this sequence
                continue
            appended += 1
            running[seq] -= 1
            if running[seq] <= 0:
                finished.append(seq)
        for seq in finished:
            store.finish_sequence(seq)
            del running[seq]
        if appended == 0 and blocked > 0 and running:
            # memory deadlock (all pool pages live): preempt the sequence
            # with the most remaining work (least progress lost), vLLM-style
            # recompute-on-resume, and requeue it.
            victim = max(running, key=lambda s_: running[s_])
            store.release_sequence(victim)
            queue.append(victim)
            del running[victim]
            preemptions += 1
        if ticks > 2_000_000:
            raise RuntimeError("serving sim did not terminate")
    out = store.stats()
    out["ticks"] = ticks
    out["preemptions"] = preemptions
    return out


def compare_policies(w: WorkloadConfig | None = None, *, n_frames=48,
                     pages_per_frame=32, gp_threshold=0.15,
                     selector="cost_benefit") -> dict:
    """WA of sepbit vs sepgc vs nosep on the same traffic (benchmark kv_wa)."""
    w = w or WorkloadConfig()
    out = {}
    for policy in ("nosep", "sepgc", "sepbit"):
        cfg = LogKVConfig(n_frames=n_frames, pages_per_frame=pages_per_frame,
                          gp_threshold=gp_threshold, selector=selector,
                          policy=policy)
        out[policy] = run_serving_sim(cfg, w)
    return out
