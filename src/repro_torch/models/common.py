"""Shared model substrate of the port: param specs, norms, RoPE, attention, MLP, MoE.

The twin of the JAX package's ``models/common.py``, op for op in its order and
dtypes. Parameters are described by ``ParamSpec`` trees (shape + logical axes
+ init); `init_tree` makes them on a device from a ``torch.Generator``. The
values are not JAX's (the generators differ); the CPU tests carry JAX's
parameters across with ``convert.lm_params_from_numpy``.

RoPE uses the interleaved (even/odd pair) formulation, as the reference does.
Decode attention without a window is K5, ``kernels.decode_attn``: the CUDA
kernel for CUDA tensors (a head dim it does not take raises), its plain
version for CPU ones; windowed decode attention has no kernel (K5's TPU
original takes no window) and is plain PyTorch on either device. Prefill
attention, the projections, the MLP and the MoE block are plain matrix
products, as the JAX package leaves them to XLA.

Every function that takes a ``sharder`` (``distributed.sharding.Sharder``)
puts the reference's sharding constraints at the reference's places
(`constrain`), ``mha``'s sequence-parallel branch included, and runs the
head projections, the attention core and K5 on each rank's local shards
(``distributed.local.shard_local``: DTensor has no rule for K5, and its
view rules cannot split every head layout); without one, or on a one-rank
mesh, each is the plain function and nothing changes.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..distributed.local import shard_local
from ..kernels import decode_attn

INIT_CHUNK = 1 << 26            # normal draws per call, so no float32 copy of a whole tensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                      # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 1.0               # stddev multiplier / fan-in override


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples (a ``ParamSpec``
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def make_param(spec: ParamSpec, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """One parameter on ``generator``'s device by the reference's rule: a
    normal draw times ``scale / sqrt(fan_in)`` (fan_in = every axis but the
    last for 3-D and up, so a stacked tensor's layers axis counts), or times
    ``scale`` for ``embed``; drawn in float32 and cast, INIT_CHUNK values at
    a time."""
    device = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)  # constant init
    if spec.init == "embed":
        std = spec.scale
    else:
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
        if len(spec.shape) >= 3:  # (.., in, out) conventions: all but last are in
            fan_in = math.prod(spec.shape[:-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for a in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - a)
        flat[a:a + n] = (torch.randn(n, generator=generator, device=device) * std).to(dtype)
    return out


def init_tree(specs, generator: torch.Generator, dtype: torch.dtype):
    """Every ``ParamSpec`` of ``specs`` made by `make_param`, in tree order."""
    return tree_map(lambda s: make_param(s, generator, dtype), specs)


def stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a stacked-layers axis."""
    return ParamSpec((n,) + spec.shape, ("layers",) + spec.axes, spec.init, spec.scale)


def stack_tree(specs, n: int):
    return tree_map(lambda s: stack_spec(s, n), specs)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, no copies."""
    return tree_map(lambda a: a[i], tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of views, by one
    ``unbind`` per leaf: autograd sums the layers' gradients into a stacked
    leaf with one ``stack``, where views by indexing would cost a zero
    gradient of the whole stack per layer."""
    layers = [a.unbind(0) for a in tree_leaves(tree)]
    out = []
    for r in range(n):
        it = iter(layers)
        out.append(tree_map(lambda _: next(it)[r], tree))
    return out


# -- norms --------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + scale.to(x.dtype))


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def norm_specs(cfg, dim_axis="act_embed", dim=None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), (dim_axis,), "ones"),
                "bias": ParamSpec((d,), (dim_axis,), "zeros")}
    return {"scale": ParamSpec((d,), (dim_axis,), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# -- positions ----------------------------------------------------------------

def rope_freqs(hd: int, fraction: float, theta: float, device=None):
    rot = int(hd * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def rope_angles(positions, hd: int, fraction: float, theta: float):
    """(cos, sin) of the rotation at ``positions`` (..., S), each (..., S, 1,
    rot/2); None where no dim rotates. The decode and prefill steps make
    them once for all layers."""
    inv, rot = rope_freqs(hd, fraction, theta, positions.device)
    if rot == 0:
        return None
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x, angles):
    """Interleaved RoPE of x (..., S, H, D) by `rope_angles`' tables."""
    if angles is None:
        return x
    cos, sin = angles
    rot = 2 * cos.shape[-1]
    xr = x[..., :rot].to(torch.float32)
    x_even = xr[..., 0::2]
    x_odd = xr[..., 1::2]
    r_even = x_even * cos - x_odd * sin
    r_odd = x_even * sin + x_odd * cos
    out = torch.stack([r_even, r_odd], dim=-1).reshape(xr.shape).to(x.dtype)
    return out if rot == x.shape[-1] else torch.cat([out, x[..., rot:]], dim=-1)


def apply_rope(x, positions, *, fraction=1.0, theta=1e4):
    """Interleaved RoPE. x: (..., S, H, D); positions: (..., S)."""
    return rotate(x, rope_angles(positions, x.shape[-1], fraction, theta))


def sinusoidal_pos(positions, d):
    inv = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=positions.device) / d))
    ang = positions[..., None].to(torch.float32) * inv
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe[..., :d]


# -- attention ----------------------------------------------------------------

def attention_specs(cfg):
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, Hk, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Hk, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((Hk, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((Hk, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bo"] = ParamSpec((d,), ("act_embed",), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "zeros")
    return specs


def heads_in(x, w, sharder=None, heads="heads"):
    """einsum("bsd,dhk->bshk"): one matrix product over the flattened heads,
    on each rank's shards of ``heads`` ("heads" or "kv_heads") and the head
    dim with w's embed dim gathered (FSDP's gather on use)."""
    return shard_local(sharder, _heads_in, ("batch", "seq", heads, "head_dim"),
                       (("batch", "seq", None), (None, heads, "head_dim")))(x, w)


def _heads_in(x, w):
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def heads_out(o, w, sharder=None):
    """einsum("bshk,hkd->bsd"): one matrix product over the flattened heads;
    on each rank's shards of the heads or the head dim, a pending sum."""
    return shard_local(sharder, _heads_out, ("batch", "seq", None),
                       (("batch", "seq", "heads", "head_dim"), ("heads", "head_dim", None)))(o, w)


def _heads_out(o, w):
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


def rope_for(cfg, positions):
    """`rope_angles` of ``cfg``'s RoPE at ``positions``, or None without it."""
    if cfg.pos != "rope":
        return None
    return rope_angles(positions, cfg.hd, cfg.rope_fraction, cfg.rope_theta)


def qkv(cfg, p, x, rope, kv=None, sharder=None):
    """q, k, v of the attention block, biased, qk-normed and rotated by
    ``rope`` (`rope_for`) as the reference's ``mha``, ``_prefill_block`` and
    ``_decode_block`` each do; k and v from ``kv`` where it is given
    (cross-attention, whose caller passes no ``rope``)."""
    cd = x.dtype
    src = x if kv is None else kv
    q = heads_in(x, p["wq"].to(cd), sharder)
    k = heads_in(src, p["wk"].to(cd), sharder, "kv_heads")
    v = heads_in(src, p["wv"].to(cd), sharder, "kv_heads")
    if cfg.use_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return rotate(q, rope), rotate(k, rope), v


def attn_out(cfg, p, out, sharder=None):
    y = heads_out(out, p["wo"].to(out.dtype), sharder)
    if cfg.use_bias:
        y = y + p["bo"].to(out.dtype)
    return y


def constrain(sharder, x, *axes):
    """``sharder.constraint(x, *axes)``, or x itself without a sharder."""
    return x if sharder is None else sharder.constraint(x, *axes)


def _mask_bias(mode, q_pos, k_pos, window=0):
    """(..., Sq, Sk) additive mask. mode: causal | prefix | full | window."""
    if mode == "full":
        return None
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    if mode == "window":
        ok = (diff >= 0) & (diff < window)
    else:
        ok = diff >= 0
    return torch.where(ok, 0.0, -1e30)


def mha(cfg, p, x, positions, *, sharder=None, mode="causal", kv=None, kv_positions=None,
        prefix_len=None, window=0):
    """Attention. x: (B, S, D) -> (B, S, D). With ``kv`` (B, T, D), k and v
    come from it (cross-attention at ``kv_positions``) and RoPE applies to
    neither side, as in the reference. A ``sharder`` constrains q, k, v and
    the output as the reference does; in head_dim mode with
    ``sp_attention``, outside windowed attention, the sequence-parallel
    branch keeps q sequence-sharded with whole heads, so the scores never
    cross ranks."""
    q, k, v = qkv(cfg, p, x, rope_for(cfg, positions) if kv is None else None, kv, sharder)
    use_sp = (getattr(getattr(sharder, "options", None), "sp_attention", False)
              and getattr(sharder, "attn_mode", "heads") == "head_dim"
              and mode != "window" and window == 0)
    if use_sp:
        q = constrain(sharder, q, "batch", "seq_attn", "heads_full", "head_dim_full")
        k = constrain(sharder, k, "batch", None, "heads_full", "head_dim_full")
        v = constrain(sharder, v, "batch", None, "heads_full", "head_dim_full")
    else:
        q = constrain(sharder, q, "batch", "seq", "heads", "head_dim")
        k = constrain(sharder, k, "batch", "seq", "kv_heads", "head_dim")
    out = gqa_attend(q, k, v, mode=mode, q_pos=positions,
                     k_pos=positions if kv_positions is None else kv_positions,
                     prefix_len=prefix_len, window=window, sharder=sharder)
    if use_sp:
        out = constrain(sharder, out, "batch", "seq_attn", "heads_full", "head_dim_full")
    out = constrain(sharder, out, "batch", "seq", "heads", "head_dim")
    return attn_out(cfg, p, out, sharder)


Q_AXES = ("batch", "seq_attn", "heads", None)    # the attention core's layouts on the
KV_AXES = ("batch", None, "kv_heads", None)     # ranks: whole head dims
DECODE_Q_AXES = ("batch", None, "heads", None)


def gqa_attend(q, k, v, *, mode, q_pos, k_pos, prefix_len=None, window=0, sharder=None):
    """(B,Sq,H,hd) x (B,Sk,Hk,hd) -> (B,Sq,H,hd), fp32 softmax. The float32
    scores are scaled and masked in place (the reference's values; one
    (B, Hk, G, Sq, Sk) float32 buffer fewer). With a ``sharder``, on each
    rank's shards: q on its batch and its heads (heads mode) or its sequence
    (head_dim mode's sequence-parallel layout), k and v whole along theirs,
    so the scores never cross ranks."""
    return shard_local(sharder, _gqa_attend, Q_AXES,
                       (Q_AXES, KV_AXES, KV_AXES, Q_AXES[:2], KV_AXES[:2], ("batch",)))(
        q, k, v, q_pos, k_pos, prefix_len, mode=mode, window=window)


def _gqa_attend(q, k, v, q_pos, k_pos, prefix_len, *, mode, window):
    B, Sq, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Sq, Hk, G, hd)
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k).to(torch.float32)
    scores.div_(math.sqrt(hd))
    bias = _mask_bias(mode, q_pos, k_pos, window)
    if bias is not None:
        if bias.dim() == 2:
            bias = bias[None, None, None]
        elif bias.dim() == 3:  # (B, Sq, Sk)
            bias = bias[:, None, None]
        scores.add_(bias)
    if prefix_len is not None:  # prefix-LM: bidirectional attention in prefix
        both_prefix = (q_pos[..., :, None] < prefix_len[..., None, None]) & \
                      (k_pos[..., None, :] < prefix_len[..., None, None])
        raw = torch.einsum("bqhgk,bshk->bhgqs", qg, k).to(torch.float32) / math.sqrt(hd)
        scores = torch.where(both_prefix[:, None, None], raw, scores)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = torch.einsum("bhgqs,bshk->bqhgk", w, v)
    return out.reshape(B, Sq, H, hd)


def decode_attend(q, k_cache, v_cache, kv_len, *, window=0, sharder=None):
    """Single-token decode. q: (B,1,H,hd); caches: (B,S,Hk,hd), contiguous;
    kv_len (B,) int32, each at least 1. Without a window: K5 on CUDA
    tensors, its plain version on CPU ones; both keep the softmax weights in
    float32 for the PV product, where the reference casts them to q's dtype
    first (equal in float32, within bfloat16's rounding otherwise). With
    ``window`` W: the reference's plain computation, positions in
    ``[kv_len - W, kv_len)`` attended, on either device; K5's TPU original
    takes no window, so no kernel computes this. Reads nothing from the
    device. With a ``sharder``, K5 runs on each rank's local whole heads:
    its batch rows and KV heads (heads mode), or every head, gathered over
    the model axis (head_dim mode)."""
    if window:
        return _windowed_decode_attend(q, k_cache, v_cache, kv_len, window)
    return shard_local(sharder, _flash_decode, DECODE_Q_AXES,
                       (DECODE_Q_AXES, KV_AXES, KV_AXES, ("batch",)))(
        q, k_cache, v_cache, kv_len)


def _flash_decode(q, k_cache, v_cache, kv_len):
    B, _, H, hd = q.shape
    q3 = q.reshape(B, H, hd).contiguous()
    if q.device.type == "meta":     # the dry run: shapes only, no kernel runs on meta
        out = decode_attn.flash_decode_ref(q3, k_cache, v_cache, kv_len)
    else:
        out = decode_attn.flash_decode_unread(q3, k_cache, v_cache, kv_len)
    return out.reshape(B, 1, H, hd)


def write_row(cache, at, inside, new, *, rows):
    """``cache[b, at[b]] = new[b, 0]`` in place for every row b ``inside``
    the cache, ``at`` being ``pos`` clamped to the last slot; a row at or
    past the end writes its old value back, as the reference's scatter
    drops an index out of range: no read of the device. ``rows`` is
    ``arange(B)``, made once per step (``distributed.local.local_write``
    runs this on each rank's rows)."""
    cache[rows, at] = torch.where(inside, new[:, 0].to(cache.dtype), cache[rows, at])


def _windowed_decode_attend(q, k_cache, v_cache, kv_len, window):
    """The reference's ``decode_attend`` with a window, op for op."""
    B, _, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hk, H // Hk, hd)
    scores = torch.einsum("bhgk,bshk->bhgs", qg, k_cache).to(torch.float32)
    scores = scores / math.sqrt(hd)
    idx = torch.arange(S, device=q.device)[None]
    ok = (idx < kv_len[:, None]) & (idx >= (kv_len[:, None] - window))
    return masked_attend(scores, ok, v_cache, q.dtype).reshape(B, 1, H, hd)


def masked_attend(scores, ok, v, dtype):
    """softmax over the last axis of float32 ``scores`` (B, Hk, G, S) where
    ``ok`` (B, S), -1e30 elsewhere, cast to ``dtype``, then the product with
    ``v`` (B, S, Hk, hd): (B, Hk, G, hd), as the reference's decode paths."""
    scores = torch.where(ok[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhgs,bshk->bhgk", w, v)


# -- MLP / MoE ----------------------------------------------------------------

def mlp_specs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        specs = {
            "wi": ParamSpec((d, f), ("embed", "ffn")),
            "wg": ParamSpec((d, f), ("embed", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
    else:
        specs = {
            "wi": ParamSpec((d, f), ("embed", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
    if cfg.use_bias:
        specs["bi"] = ParamSpec((f,), ("ffn",), "zeros")
        specs["bo"] = ParamSpec((d,), ("act_embed",), "zeros")
    return specs


def mlp(cfg, p, x, *, sharder=None):
    cd = x.dtype
    h = x @ p["wi"].to(cd)
    if cfg.use_bias:
        h = h + p["bi"].to(cd)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"].to(cd)) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    h = constrain(sharder, h, "batch", "seq", "ffn")
    y = h @ p["wo"].to(cd)
    if cfg.use_bias:
        y = y + p["bo"].to(cd)
    return y


def moe_specs(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", "experts")),
        "wi": ParamSpec((E, d, f), ("experts", "embed", "ffn")),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "ffn")),
        "wo": ParamSpec((E, f, d), ("experts", "ffn", "embed")),
    }


def dataclasses_replace_route(cfg):
    """cfg with route_group disabled (recursion guard for grouped moe)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, route_group=0))


def top_k(x, k: int):
    """The ``k`` largest of the last axis in descending order with their
    indices, ties toward the lower index: ``lax.top_k``'s order on either
    device (``torch.topk`` promises no order among ties on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(cfg, p, x, *, sharder=None, capacity_factor=1.25):
    """Top-k MoE with capacity-based one-hot dispatch, the reference's
    ``moe_block``: tokens go to an (E, capacity) buffer in sequence order,
    overflow tokens are dropped and pass through the residual only. Returns
    (y, aux), the float32 Switch-style load-balance loss.

    With ``cfg.moe.route_group = G``, ``0 < G < S`` and ``S % G == 0``, the
    sequence is split into routing groups of G tokens, each with its own
    capacity, and the aux is that of the grouped call, as in the reference.

    The reference builds ``dispatch`` through a (B, S, K, E, C) product and
    sums it over K. A token's K chosen experts are distinct, so each (b, s,
    e) has at most one nonzero term in that sum: ``dispatch`` (B, S, E, C)
    is built here from the one position per (b, s, e), with the same 0 / 1
    values and K times less memory. No shape depends on the data and
    nothing is read from the device."""
    B, S, D = x.shape
    G = cfg.moe.route_group
    if G and G < S and S % G == 0:
        xg = x.reshape(B * (S // G), G, D)
        y, aux = moe_block(dataclasses_replace_route(cfg), p, xg, sharder=sharder,
                           capacity_factor=capacity_factor)
        # back to the groups' batch layout, which unflattens cleanly
        y = constrain(sharder, y, "batch", "seq", "act_embed")
        return y.reshape(B, S, D), aux
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
    cd = x.dtype
    C = max(int(capacity_factor * K * S / E), 1)

    logits = (x @ p["router"].to(cd)).to(torch.float32)              # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                              # (B,S,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    experts = torch.arange(E, device=x.device)
    onehot = (gate_idx[..., None] == experts).to(torch.float32)        # (B,S,K,E)
    # position within each expert's buffer (priority by sequence position)
    pos_in_expert = torch.cumsum(onehot.reshape(B, S * K, E), dim=1).reshape(B, S, K, E)
    pos_in_expert = ((pos_in_expert - 1.0) * onehot).sum(2)           # (B,S,E)
    chosen = onehot.sum(2)                                             # (B,S,E), 0 or 1
    keep = (pos_in_expert < C) & (chosen > 0)
    slots = torch.arange(C, device=x.device, dtype=torch.float32)
    dispatch = (keep[..., None] & (pos_in_expert[..., None] == slots)).to(torch.float32)
    combine = (gate_vals[..., None] * onehot).sum(2)[..., None] * dispatch  # (B,S,E,C)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(cd), x)          # (E,B,C,D)
    if getattr(getattr(sharder, "options", None), "moe_2d", False):
        # 2D weight-stationary experts: d_model data-sharded like the weights
        xin = constrain(sharder, xin, "experts", None, None, "embed")
    xin = xin.reshape(E, B * C, D)
    h = torch.bmm(xin, p["wi"].to(cd))
    g = torch.bmm(xin, p["wg"].to(cd))
    h = (F.silu(g) * h).reshape(E, B, C, -1)
    h = constrain(sharder, h, "experts", "batch", None, "ffn").flatten(1, 2)
    eout = torch.bmm(h, p["wo"].to(cd)).reshape(E, B, C, D)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(cd), eout)

    # aux load-balance loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                        # (E,)
    ce = chosen.mean(dim=(0, 1))                                       # fraction routed
    aux = E * torch.sum(me * ce) * cfg.moe.load_balance_coef
    return y, aux
