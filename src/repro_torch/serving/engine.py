"""Serving step factories (prefill / decode) and the paged-serving loop.

``make_prefill_fn`` / ``make_decode_fn`` are the twins of the JAX package's
``serving/engine.py``: plain functions over the model (PyTorch runs eagerly),
each passing its ``sharder`` (``distributed.sharding.Sharder``, default None)
to the model, as the reference's do; on a multi-rank mesh the parameters,
cache and tokens are DTensors and the logits and next tokens come back as
DTensors too. `serve_paged` is the
admission loop of the JAX package's ``examples/serve_paged.py``, with the
SepBIT log-structured KV page store (`logkv`) accounting every page.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..distributed.sharding import scope
from .logkv import LogKVConfig, LogKVStore

STORE_FRAMES, STORE_PAGES_PER_FRAME = 48, 16     # the reference example's page store


def make_prefill_fn(model, cfg, sharder=None):
    def prefill_fn(params, batch, cache):
        return model.prefill(params, batch, cache, sharder)
    return prefill_fn


def make_decode_fn(model, cfg, sharder=None):
    def decode_fn(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache, sharder)
        with scope(sharder):
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)   # greedy, as int32
        return next_tok, logits, cache
    return decode_fn


def request_traffic(requests: int, max_new: int, prompt_len: int, vocab: int, seed: int = 0):
    """The reference example's traffic: heavy-tailed decode lengths (chat +
    long-form mixture) clipped to [1, max_new], and random prompts, from
    ``np.random.default_rng(seed)``. Returns (lengths (R,), prompts (R, P))."""
    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(requests) < 0.25,
                       rng.geometric(1 / 48.0, requests),
                       rng.geometric(1 / 8.0, requests)).clip(1, max_new)
    prompts = rng.integers(0, vocab, (requests, prompt_len))
    return lengths, prompts


def serve_paged(prefill, decode, params, cache, prompts, lengths, *, policy: str,
                page_tokens: int) -> dict:
    """Serve every request through ``prefill`` and ``decode`` (the step
    functions above) as the reference example does: requests leave the queue
    from its end; each is admitted into a free batch row by a whole-batch
    prefill of its prompt tiled over the B rows of ``cache`` (which rewrites
    every row's cache and position: the reference's behaviour, kept), then
    all live rows decode in lockstep, one greedy token a step. Its KV pages
    go to a `LogKVStore` of ``policy``: one per ``page_tokens`` prompt
    tokens at admission, one each time its remaining count is a multiple of
    ``page_tokens``; it finishes after ``lengths[req]`` decode steps.

    ``prompts`` (R, P) is a numpy array or an integer tensor, ``lengths``
    (R,) a numpy array; the prompts go to the device once, before the loop,
    and the loop reads nothing from the device. Returns the store's stats
    with ``tokens`` (decoded tokens of live rows), ``decode_steps``,
    ``prefills`` and ``wall`` (seconds, after a synchronize on CUDA)."""
    store = LogKVStore(LogKVConfig(n_frames=STORE_FRAMES, pages_per_frame=STORE_PAGES_PER_FRAME,
                                   policy=policy))
    device = cache["pos"].device
    B = cache["pos"].shape[0]
    P = prompts.shape[1]
    tiled = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    queue = list(range(len(prompts)))
    slots = [None] * B          # request id per batch row
    remaining = np.zeros(B, dtype=np.int64)
    tokens = decode_steps = prefills = 0
    t0 = time.perf_counter()
    cur = torch.zeros((B, 1), dtype=torch.int32, device=device)
    while queue or any(s is not None for s in slots):
        for b in range(B):
            if slots[b] is None and queue:
                req = queue.pop()
                slots[b] = req
                remaining[b] = lengths[req]
                lg, cache = prefill(params, {"tokens": tiled[req].expand(B, P)}, cache)
                prefills += 1
                cur[b, 0] = torch.argmax(lg[b]).to(torch.int32)
                for _ in range(P // page_tokens):
                    store.append_page(req)
        live = [b for b in range(B) if slots[b] is not None]
        if not live:
            break
        nxt, _, cache = decode(params, cur, cache)
        decode_steps += 1
        cur = nxt[:, None]
        tokens += len(live)
        for b in live:
            remaining[b] -= 1
            if remaining[b] % page_tokens == 0:
                store.append_page(slots[b])
            if remaining[b] <= 0:
                store.finish_sequence(slots[b])
                slots[b] = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {**store.stats(), "tokens": tokens, "decode_steps": decode_steps,
            "prefills": prefills, "wall": time.perf_counter() - t0}
