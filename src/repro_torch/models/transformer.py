"""Decoder LM of the port: dense / MoE / hybrid (RG-LRU with local attention)
/ SSM (RWKV-6), the twin of the JAX package's ``models/transformer.py``.

Parameters keep the reference's tree: per period position, a stack over the
repeats (``blocks/p<i>_<kind>``, leading layers axis), then the remainder
layers (``tail``). A Python loop over the layers takes the place of
``lax.scan``; each layer's slice of a stacked tensor is a view.

Three entry points:
  forward(cfg, params, tokens)          -> (logits, aux)
  prefill(cfg, params, tokens, cache)   -> (last-token logits, cache)
  decode_step(cfg, params, tokens, cache) -> (logits, cache)

The cache is written in place (JAX returns a new one): ``prefill`` and
``decode_step`` return the cache they were given, its leaves updated where
they lie, with a new ``pos``. The vlm family's stub image prefix comes in
through ``forward`` and ``prefill``'s ``prefix_embeds``; the audio family is
``models/whisper.py``.

Each entry point takes the reference's ``sharder`` (keyword, default None)
and puts its constraints where the reference does: the embedded stream,
each block's output in ``forward``, the logits, and inside ``mha``, ``mlp``,
``moe_block`` and ``rglru_forward``. On a multi-rank mesh the parameters
and caches are DTensors (``distributed.sharding.place_params``) and the
entry points run under ``Sharder.scope``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.local import assign, local_write, vocab_embed
from ..distributed.sharding import scope
from . import rglru, rwkv6
from .common import (
    ParamSpec,
    apply_norm,
    attention_specs,
    attn_out,
    constrain,
    decode_attend,
    gqa_attend,
    masked_attend,
    mha,
    mlp,
    mlp_specs,
    moe_block,
    moe_specs,
    norm_specs,
    qkv,
    rope_for,
    sinusoidal_pos,
    stack_tree,
    tree_index,
    tree_unstack,
    write_row,
)


FAMILIES = ("dense", "moe", "hybrid", "vlm", "ssm", "audio")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` unless the port has a model of ``cfg``'s family:
    this module's (dense, moe, hybrid, vlm, ssm) or ``models/whisper.py``'s
    (audio)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"no model of family {cfg.family!r}; the port has {FAMILIES}")


def _layout(cfg):
    """(pattern, period, full repeats): the stacked and the tail layers."""
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    return cfg.pattern, period, cfg.n_layers // period


def _layers(cfg, params, cache=None):
    """(kind, layer params, layer cache or None) of every layer in order:
    views into the stacks (`tree_unstack`), then the tail."""
    pattern, period, n_full = _layout(cfg)
    stacks = {key: tree_unstack(p, n_full) for key, p in params["blocks"].items()}
    for r in range(n_full):
        for i, kind in enumerate(pattern[:period]):
            key = f"p{i}_{kind}"
            c = tree_index(cache["blocks"][key], r) if cache is not None else None
            yield kind, stacks[key][r], c
    for j, kind in enumerate(pattern[n_full * period:]):
        yield kind, params["tail"][j], cache["tail"][j] if cache is not None else None


# -- per-block specs -----------------------------------------------------------

def block_specs(cfg, kind: str):
    if kind == "rwkv":
        return {
            "ln1": norm_specs(cfg),
            "time_mix": rwkv6.rwkv_specs(cfg),
            "ln2": norm_specs(cfg),
        }
    specs = {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg)}
    if kind in ("attn", "attn_local"):
        specs["attn"] = attention_specs(cfg)
    elif kind == "rglru":
        specs["rec"] = rglru.rglru_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.moe is not None:
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    return specs


def lm_specs(cfg):
    pattern, period, n_full = _layout(cfg)
    tail = pattern[n_full * period:]
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "final_norm": norm_specs(cfg),
        "blocks": {
            f"p{i}_{kind}": stack_tree(block_specs(cfg, kind), n_full)
            for i, kind in enumerate(pattern[:period])
        } if n_full else {},
        "tail": [block_specs(cfg, kind) for kind in tail],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend == "siglip_stub":
        # projection from (stub) vision embeddings into the LM stream
        specs["vision_proj"] = ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed2"))
    return specs


# -- block application ---------------------------------------------------------

def _embed(cfg, params, tokens, sharder=None):
    cd = cfg.cdtype()
    h = vocab_embed(sharder, tokens, params["embed"]).to(cd)
    if cfg.tie_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cd)
    return h


def _stream(cfg, params, tokens, prefix_embeds, sharder=None):
    """The embedded stream (B, P + S, D) and its prefix lengths: the
    tokens' embeddings after the stub frontend's ``prefix_embeds`` (B, P, D),
    cast to the compute dtype and projected by ``vision_proj`` where the
    model has one (no √d scaling), with ``prefix_len`` a (B,) int32 tensor of
    P; without a prefix, the tokens' embeddings and None."""
    h = _embed(cfg, params, tokens, sharder)
    if prefix_embeds is None:
        return h, None
    pe = prefix_embeds.to(h.dtype)
    if "vision_proj" in params:
        pe = pe @ params["vision_proj"].to(h.dtype)
    prefix_len = torch.full((h.shape[0],), prefix_embeds.shape[1], dtype=torch.int32,
                            device=h.device)
    return torch.cat([pe, h], dim=1), prefix_len


def _second_half(cfg, kind, p, h, c=None, carry=False, sharder=None):
    """``h`` plus the block's second half: rwkv's channel mix, the MoE block
    or the MLP, each after ``ln2``. Returns (h, the MoE aux or None). Given
    a layer cache ``c``, rwkv's channel-mix shift ``cm`` is written there,
    and with ``carry`` also read from there first (decode)."""
    h = constrain(sharder, h, "batch", "seq", "act_embed")
    y = apply_norm(cfg, p["ln2"], h)
    aux = None
    if kind == "rwkv":
        if c is None:
            y = rwkv6.rwkv_channel_mix(cfg, p["time_mix"], y, sharder=sharder)
        else:
            y, cm = rwkv6.rwkv_channel_mix(cfg, p["time_mix"], y,
                                           shift_prev=c["cm"] if carry else None,
                                           return_state=True, sharder=sharder)
            assign(sharder, c["cm"], cm)
    elif cfg.moe is not None:
        y, aux = moe_block(cfg, p["moe"], y, sharder=sharder)
    else:
        y = mlp(cfg, p["mlp"], y, sharder=sharder)
    return h + y, aux


def _apply_block(cfg, kind, p, h, positions, aux, prefix_len=None, sharder=None):
    """One block of `forward`: (h, aux plus the block's MoE aux)."""
    y = apply_norm(cfg, p["ln1"], h)
    if kind in ("attn", "attn_local"):
        local = kind == "attn_local"
        y = mha(cfg, p["attn"], y, positions, sharder=sharder,
                mode="window" if local else "causal",
                prefix_len=prefix_len, window=cfg.window if local else 0)
    elif kind == "rglru":
        y = rglru.rglru_forward(cfg, p["rec"], y, sharder=sharder)
    else:
        y = rwkv6.rwkv_time_mix(cfg, p["time_mix"], y, sharder=sharder)
    h, a = _second_half(cfg, kind, p, h + y, sharder=sharder)
    h = constrain(sharder, h, "batch", "seq", "act_embed")
    return h, aux if a is None else aux + a


def forward(cfg, params, tokens, sharder=None, *, prefix_embeds=None):
    """tokens: (B, S) int; ``prefix_embeds`` (B, P, D), the vlm stub
    frontend's embeddings, go before them (`_stream`), bidirectional among
    themselves (the prefix-LM mask). Returns (logits (B, P + S, V), aux_loss),
    the aux loss the float32 sum of the MoE blocks' (zero without MoE). With
    ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of each
    block): its activations are recomputed in the backward pass, the values
    unchanged."""
    with scope(sharder):
        h, prefix_len = _stream(cfg, params, tokens, prefix_embeds, sharder)
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
        if cfg.pos == "sinusoidal":
            h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
        h = constrain(sharder, h, "batch", "seq", "act_embed")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for kind, p, _ in _layers(cfg, params):
            if remat:
                h, aux = checkpoint(_apply_block, cfg, kind, p, h, positions, aux, prefix_len,
                                    sharder, use_reentrant=False)
            else:
                h, aux = _apply_block(cfg, kind, p, h, positions, aux, prefix_len, sharder)
        h = apply_norm(cfg, params["final_norm"], h)
        return _lm_logits(cfg, params, h, sharder), aux


def _lm_logits(cfg, params, h, sharder=None):
    cd = h.dtype
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(cd).T
    else:
        logits = h @ params["lm_head"].to(cd)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return constrain(sharder, logits, "batch", "seq", "vocab")


# -- KV / recurrent cache ------------------------------------------------------

def cache_specs(cfg, batch: int, max_seq: int):
    """Cache layout per period position (stacked over repeats): ``k`` / ``v``
    for global attention; a ring of ``W = min(window, max_seq)`` slots with
    its position map ``pos`` for local attention; ``h`` and the conv window
    for RG-LRU; the state ``s`` and the two token shifts for RWKV-6."""
    pattern, period, n_full = _layout(cfg)
    w = cfg.lru_width or cfg.d_model

    def one(kind, n=None):
        lead = (n,) if n else ()
        lax = ("layers",) if n else ()
        kv_axes = lax + ("batch", "kv_seq", "kv_heads", "head_dim")
        if kind == "attn":
            shape = lead + (batch, max_seq, cfg.n_kv_heads, cfg.hd)
            return {"k": ParamSpec(shape, kv_axes, "zeros"),
                    "v": ParamSpec(shape, kv_axes, "zeros")}
        if kind == "attn_local":
            W = min(cfg.window, max_seq)
            shape = lead + (batch, W, cfg.n_kv_heads, cfg.hd)
            return {"k": ParamSpec(shape, kv_axes, "zeros"),
                    "v": ParamSpec(shape, kv_axes, "zeros"),
                    "pos": ParamSpec(lead + (batch, W), lax + ("batch", None), "zeros")}
        if kind == "rglru":
            return {"h": ParamSpec(lead + (batch, w), lax + ("batch", "lru"), "zeros"),
                    "conv": ParamSpec(lead + (batch, rglru.CONV_W - 1, w),
                                      lax + ("batch", None, "lru"), "zeros")}
        if kind == "rwkv":
            H, N = cfg.n_heads, cfg.rnn_head_dim
            emb_axes = lax + ("batch", None, "act_embed")
            return {"s": ParamSpec(lead + (batch, H, N, N),
                                   lax + ("batch", None, None, "rnn_state"), "zeros"),
                    "tm": ParamSpec(lead + (batch, 1, cfg.d_model), emb_axes, "zeros"),
                    "cm": ParamSpec(lead + (batch, 1, cfg.d_model), emb_axes, "zeros")}
        raise ValueError(kind)

    return {"blocks": {f"p{i}_{kind}": one(kind, n_full)
                       for i, kind in enumerate(pattern[:period])} if n_full else {},
            "tail": [one(kind) for kind in pattern[n_full * period:]],
            "pos": ParamSpec((batch,), ("batch",), "zeros")}


def cache_dtype(key: str, default):
    """Leaf dtypes: position maps int32, the RWKV state ``s`` and the RG-LRU
    state ``h`` float32, everything else ``default``. JAX's ``cache_dtype``
    gives ``h`` the cache dtype, but its prefill and decode steps replace
    ``h`` by a float32 array, so from the first step on JAX carries it in
    float32; the port writes its cache in place, and a bfloat16 ``h`` would
    round the state at every step."""
    if key == "pos":
        return torch.int32
    if key in ("s", "h"):
        return torch.float32
    return default


def init_cache(cfg, batch, max_seq, dtype, device):
    """`cache_specs`' shapes on ``device``, each leaf of `cache_dtype`:
    zeros, except the rings' position maps, filled with -1 (no position)."""
    def make(tree, key=None):
        if isinstance(tree, ParamSpec):
            fill = -1 if key == "pos" and len(tree.shape) > 1 else 0
            return torch.full(tree.shape, fill, dtype=cache_dtype(key, dtype), device=device)
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        return [make(v, key) for v in tree]
    return make(cache_specs(cfg, batch, max_seq))


# -- prefill / decode ----------------------------------------------------------

def _ring_fill(ck, cv, cp, k, v, positions):
    """The last ``min(S, W)`` positions' k and v into ring slots ``p % W``,
    with the position map: token p lives in slot p % W, and decode
    continues the same ring."""
    W = ck.shape[1]
    last = min(k.shape[1], W)
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    pw = positions[:, -last:]
    slots = pw % W
    ck[rows, slots] = k[:, -last:].to(ck.dtype)
    cv[rows, slots] = v[:, -last:].to(cv.dtype)
    cp[rows, slots] = pw


def _fill_prefix(ck, cv, k, v):
    S = k.shape[1]
    ck[:, :S] = k
    cv[:, :S] = v


def prefill(cfg, params, tokens, cache, sharder=None, *, prefix_embeds=None):
    """Run the prompt, after ``prefix_embeds`` where given (`forward`'s),
    from a fresh state, fill the caches in place (global attention's first
    S positions of the stream, the rings, the recurrent states), set every
    row's ``pos`` to S, the stream's length; return last-position logits
    (B, V) and the cache."""
    with scope(sharder):
        h, prefix_len = _stream(cfg, params, tokens, prefix_embeds, sharder)
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
        if cfg.pos == "sinusoidal":
            h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
        h = constrain(sharder, h, "batch", "seq", "act_embed")
        rope = rope_for(cfg, positions)
        for kind, p, c in _layers(cfg, params, cache):
            y = apply_norm(cfg, p["ln1"], h)
            if kind in ("attn", "attn_local"):
                q, k, v = qkv(cfg, p["attn"], y, rope, sharder=sharder)
                local = kind == "attn_local"
                out = gqa_attend(q, k, v, mode="window" if local else "causal",
                                 q_pos=positions, k_pos=positions, prefix_len=prefix_len,
                                 window=cfg.window, sharder=sharder)
                if local:
                    local_write(sharder, _ring_fill, [c["k"], c["v"], c["pos"]],
                                [k, v, positions])
                else:
                    local_write(sharder, _fill_prefix, [c["k"], c["v"]], [k, v])
                y = attn_out(cfg, p["attn"], out, sharder)
            elif kind == "rglru":
                y, (hs, conv) = rglru.rglru_forward(cfg, p["rec"], y, sharder=sharder,
                                                    return_state=True)
                # h in the compute dtype, then float32, as the reference
                assign(sharder, c["h"], hs)
                assign(sharder, c["conv"], conv)
            else:
                y, (st, tm) = rwkv6.rwkv_time_mix(cfg, p["time_mix"], y, return_state=True,
                                                  sharder=sharder)
                assign(sharder, c["s"], st)
                assign(sharder, c["tm"], tm)
            h, _ = _second_half(cfg, kind, p, h + y, c, sharder=sharder)
            h = constrain(sharder, h, "batch", "seq", "act_embed")
        h = apply_norm(cfg, params["final_norm"], h[:, -1:])
        logits = _lm_logits(cfg, params, h, sharder)
        cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
        return logits[:, 0], cache


def _max_seq(cfg, cache):
    """The length S of the global-attention caches (B, S, Hk, hd), or None
    where the model has no global attention."""
    pattern, period, n_full = _layout(cfg)
    for i, kind in enumerate(pattern[:period] if n_full else ()):
        if kind == "attn":
            return cache["blocks"][f"p{i}_attn"]["k"].shape[2]
    for c, kind in zip(cache["tail"], pattern[n_full * period:]):
        if kind == "attn":
            return c["k"].shape[1]
    return None


def _ring_write(ck, cv, cp, k, v, pos, *, rows):
    slot = pos % ck.shape[1]
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cp[rows, slot] = pos


def _ring_decode(cfg, c, q, k, v, rows, pos, sharder=None):
    """Local attention's decode step: k, v and ``pos`` into ring slot
    ``pos % W``, then attention over the slots whose position lies in
    ``(pos - W, pos]``, the reference's plain ring attention (K5 takes no
    window)."""
    W = c["k"].shape[1]
    local_write(sharder, _ring_write, [c["k"], c["v"], c["pos"]], [k, v, pos], rows=rows)
    B, _, H, hd = q.shape
    Hk = cfg.n_kv_heads
    qg = q.reshape(B, Hk, H // Hk, hd)
    scores = torch.einsum("bhgk,bshk->bhgs", qg, c["k"]).to(torch.float32) / (cfg.hd ** 0.5)
    pc = c["pos"]
    ok = (pc >= 0) & (pc <= pos[:, None]) & (pc > pos[:, None] - W)
    return masked_attend(scores, ok, c["v"], q.dtype).reshape(B, 1, H, hd)


def decode_step(cfg, params, tokens, cache, sharder=None):
    """tokens: (B, 1) -> (logits (B, V), cache), every layer's state updated
    in place at each row's own ``pos`` (continuous batching): global
    attention writes k and v at ``pos`` and attends over ``kv_len = pos + 1``
    by K5 on CUDA (a row at or past the cache's end writes nothing and
    attends over the whole cache, as in the reference); local attention
    writes its ring slot; the recurrent blocks step their states. ``pos``
    advances. Reads nothing from the device."""
    with scope(sharder):
        pos = cache["pos"]
        kv_len = pos + 1
        h = _embed(cfg, params, tokens, sharder)
        if cfg.pos == "sinusoidal":
            h = h + sinusoidal_pos(pos[:, None], cfg.d_model).to(h.dtype)
        h = constrain(sharder, h, "batch", "seq", "act_embed")
        rows = torch.arange(h.shape[0], device=h.device)
        S = _max_seq(cfg, cache)
        if S is not None:
            at, inside = pos.clamp(max=S - 1), (pos < S)[:, None, None]
        rope = rope_for(cfg, pos[:, None])
        for kind, p, c in _layers(cfg, params, cache):
            y = apply_norm(cfg, p["ln1"], h)
            if kind in ("attn", "attn_local"):
                q, k, v = qkv(cfg, p["attn"], y, rope, sharder=sharder)
                if kind == "attn":
                    local_write(sharder, write_row, [c["k"]], [at, inside, k], rows=rows)
                    local_write(sharder, write_row, [c["v"]], [at, inside, v], rows=rows)
                    out = decode_attend(q, c["k"], c["v"], kv_len, sharder=sharder)
                else:
                    out = _ring_decode(cfg, c, q, k, v, rows, pos, sharder)
                y = attn_out(cfg, p["attn"], out, sharder)
            elif kind == "rglru":
                y, (hs, conv) = rglru.rglru_decode(cfg, p["rec"], y, (c["h"], c["conv"]),
                                                   sharder)
                assign(sharder, c["h"], hs)
                assign(sharder, c["conv"], conv)
            else:
                y, (st, tm) = rwkv6.rwkv_decode(cfg, p["time_mix"], y, (c["s"], c["tm"], None),
                                                sharder)
                assign(sharder, c["s"], st)
                assign(sharder, c["tm"], tm)
            h, _ = _second_half(cfg, kind, p, h + y, c, carry=True, sharder=sharder)
            h = constrain(sharder, h, "batch", "seq", "act_embed")
        h = apply_norm(cfg, params["final_norm"], h)
        logits = _lm_logits(cfg, params, h, sharder)
        cache["pos"] = kv_len
        return logits[:, 0], cache
