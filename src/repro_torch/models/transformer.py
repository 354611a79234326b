"""Decoder LM of the port, dense family: the twin of the JAX package's
``models/transformer.py`` for ``"attn"`` blocks with the dense MLP.

Parameters keep the reference's tree: per period position, a stack over the
repeats (``blocks/p<i>_<kind>``, leading layers axis), then the remainder
layers (``tail``). A Python loop over the layers takes the place of
``lax.scan``; each layer's slice of a stacked tensor is a view.

Three entry points:
  forward(cfg, params, tokens)          -> (logits, aux)
  prefill(cfg, params, tokens, cache)   -> (last-token logits, cache)
  decode_step(cfg, params, tokens, cache) -> (logits, cache)

The KV cache is written in place (JAX returns a new one): ``prefill`` and
``decode_step`` return the cache they were given, its ``k`` / ``v`` updated
where they lie, with a new ``pos``. The other block kinds, MoE, and the
vlm / audio stubs raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (
    ParamSpec,
    apply_norm,
    attention_specs,
    attn_out,
    decode_attend,
    gqa_attend,
    mha,
    mlp,
    mlp_specs,
    norm_specs,
    qkv,
    rope_for,
    sinusoidal_pos,
    stack_tree,
    tree_index,
    tree_unstack,
)

_NOT_PORTED = {
    "attn_local": "local attention (attn_local) is not ported yet: ROADMAP Queue 1 item 9.2",
    "rglru": "rglru.py (the RG-LRU block) is not ported yet: ROADMAP Queue 1 item 9.2",
    "rwkv": "rwkv6.py (the RWKV-6 block) is not ported yet: ROADMAP Queue 1 item 9.2",
}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of whatever the
    port cannot run yet: the audio family, MoE, the vlm prefix, and every
    block kind but ``"attn"``."""
    if cfg.family == "audio":
        raise NotImplementedError("whisper.py (the audio family) is not ported yet: "
                                  "ROADMAP Queue 1 item 9.3")
    if cfg.moe is not None:
        raise NotImplementedError("moe_specs / moe_block are not ported yet: "
                                  "ROADMAP Queue 1 item 9.1")
    if cfg.frontend is not None or cfg.n_prefix_tokens:
        raise NotImplementedError("the vlm prefix (prefix_embeds, prefix_len) is not ported "
                                  "yet: ROADMAP Queue 1 item 9.3")
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(_NOT_PORTED.get(kind, f"unknown block kind {kind!r}"))


def _layout(cfg):
    """(pattern, period, full repeats): the stacked and the tail layers."""
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    return cfg.pattern, period, cfg.n_layers // period


def _layers(cfg, params, cache=None):
    """(layer params, layer cache or None) of every layer in order: views
    into the stacks (`tree_unstack`), then the tail."""
    pattern, period, n_full = _layout(cfg)
    stacks = {key: tree_unstack(p, n_full) for key, p in params["blocks"].items()}
    for r in range(n_full):
        for i, kind in enumerate(pattern[:period]):
            key = f"p{i}_{kind}"
            c = tree_index(cache["blocks"][key], r) if cache is not None else None
            yield stacks[key][r], c
    for j in range(len(pattern) - n_full * period):
        yield params["tail"][j], cache["tail"][j] if cache is not None else None


# -- per-block specs -----------------------------------------------------------

def block_specs(cfg):
    """An ``"attn"`` block's specs (the only kind `check_supported` lets by)."""
    return {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg), "attn": attention_specs(cfg),
            "mlp": mlp_specs(cfg)}


def lm_specs(cfg):
    check_supported(cfg)
    pattern, period, n_full = _layout(cfg)
    tail = pattern[n_full * period:]
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "final_norm": norm_specs(cfg),
        "blocks": {
            f"p{i}_{kind}": stack_tree(block_specs(cfg), n_full)
            for i, kind in enumerate(pattern[:period])
        } if n_full else {},
        "tail": [block_specs(cfg) for _ in tail],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return specs


# -- block application ---------------------------------------------------------

def _embed(cfg, params, tokens):
    cd = cfg.cdtype()
    h = F.embedding(tokens, params["embed"]).to(cd)
    if cfg.tie_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cd)
    return h


def _mlp_half(cfg, p, h):
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], h))


def _block(cfg, p, h, positions):
    h = h + mha(cfg, p["attn"], apply_norm(cfg, p["ln1"], h), positions, mode="causal")
    return _mlp_half(cfg, p, h)


def forward(cfg, params, tokens):
    """tokens: (B, S) int. Returns (logits (B, S, V), aux_loss), the aux loss
    a float32 zero (no MoE). With ``cfg.remat`` and grad enabled, each layer
    runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    of each block): its activations are recomputed in the backward pass, the
    values unchanged."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for p, _ in _layers(cfg, params):
        if remat:
            h = checkpoint(_block, cfg, p, h, positions, use_reentrant=False)
        else:
            h = _block(cfg, p, h, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    return _lm_logits(cfg, params, h), torch.zeros((), dtype=torch.float32, device=h.device)


def _lm_logits(cfg, params, h):
    cd = h.dtype
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(cd).T
    else:
        logits = h @ params["lm_head"].to(cd)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# -- KV cache -----------------------------------------------------------------

def cache_specs(cfg, batch: int, max_seq: int):
    """Cache layout per period position (stacked over repeats)."""
    check_supported(cfg)
    pattern, period, n_full = _layout(cfg)

    def one(n=None):
        lead = (n,) if n else ()
        lax = ("layers",) if n else ()
        shape = lead + (batch, max_seq, cfg.n_kv_heads, cfg.hd)
        kv_axes = lax + ("batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": ParamSpec(shape, kv_axes, "zeros"),
                "v": ParamSpec(shape, kv_axes, "zeros")}

    return {"blocks": {f"p{i}_{kind}": one(n_full)
                       for i, kind in enumerate(pattern[:period])} if n_full else {},
            "tail": [one() for _ in pattern[n_full * period:]],
            "pos": ParamSpec((batch,), ("batch",), "zeros")}


def cache_dtype(key: str, default):
    """Leaf dtypes: positions int32, everything else ``default``."""
    return torch.int32 if key == "pos" else default


def init_cache(cfg, batch, max_seq, dtype, device):
    """Zeros of `cache_specs`' shapes on ``device``, each leaf of
    `cache_dtype`."""
    def make(tree, key=None):
        if isinstance(tree, ParamSpec):
            return torch.zeros(tree.shape, dtype=cache_dtype(key, dtype), device=device)
        if isinstance(tree, dict):
            return {k: make(v, k) for k, v in tree.items()}
        return [make(v, key) for v in tree]
    return make(cache_specs(cfg, batch, max_seq))


# -- prefill / decode ----------------------------------------------------------

def prefill(cfg, params, tokens, cache):
    """Run the prompt, fill the caches' first S positions in place, set every
    row's ``pos`` to S; return last-position logits (B, V) and the cache."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
    rope = rope_for(cfg, positions)
    for p, c in _layers(cfg, params, cache):
        q, k, v = qkv(cfg, p["attn"], apply_norm(cfg, p["ln1"], h), rope)
        out = gqa_attend(q, k, v, mode="causal", q_pos=positions, k_pos=positions)
        c["k"][:, :S] = k
        c["v"][:, :S] = v
        h = _mlp_half(cfg, p, h + attn_out(cfg, p["attn"], out))
    h = apply_norm(cfg, params["final_norm"], h[:, -1:])
    logits = _lm_logits(cfg, params, h)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
    return logits[:, 0], cache


def _max_seq(cache) -> int:
    """The cache's length S (every layer's ``k`` is (B, S, Hk, hd))."""
    stacks = list(cache["blocks"].values())
    return stacks[0]["k"].shape[2] if stacks else cache["tail"][0]["k"].shape[1]


def _write_row(cache, rows, at, inside, new):
    """``cache[b, at[b]] = new[b, 0]`` in place for every row b ``inside``
    the cache, ``at`` being ``pos`` clamped to the last slot; a row at or
    past the end writes its old value back, as the reference's scatter
    drops an index out of range: no read of the device."""
    cache[rows, at] = torch.where(inside, new[:, 0].to(cache.dtype), cache[rows, at])


def decode_step(cfg, params, tokens, cache):
    """tokens: (B, 1) -> (logits (B, V), cache): each row's k and v written
    at its own ``pos`` in place (continuous batching), attention over
    ``kv_len = pos + 1`` by K5 on CUDA, ``pos`` advanced. A row whose ``pos``
    is at or past the cache's end writes nothing and attends over the whole
    cache, as in the reference. Reads nothing from the device."""
    check_supported(cfg)
    pos = cache["pos"]
    kv_len = pos + 1
    h = _embed(cfg, params, tokens)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_pos(pos[:, None], cfg.d_model).to(h.dtype)
    rows = torch.arange(h.shape[0], device=h.device)
    S = _max_seq(cache)
    at, inside = pos.clamp(max=S - 1), (pos < S)[:, None, None]
    rope = rope_for(cfg, pos[:, None])
    for p, c in _layers(cfg, params, cache):
        q, k, v = qkv(cfg, p["attn"], apply_norm(cfg, p["ln1"], h), rope)
        _write_row(c["k"], rows, at, inside, k)
        _write_row(c["v"], rows, at, inside, v)
        out = decode_attend(q, c["k"], c["v"], kv_len)
        h = _mlp_half(cfg, p, h + attn_out(cfg, p["attn"], out))
    h = apply_norm(cfg, params["final_norm"], h)
    logits = _lm_logits(cfg, params, h)
    cache["pos"] = kv_len
    return logits[:, 0], cache
