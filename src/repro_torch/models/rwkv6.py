"""RWKV-6 "Finch" block (arXiv:2404.05892), the twin of the JAX package's
``models/rwkv6.py``: attention-free time mix with data-dependent per-channel
decay, plus squared-ReLU channel mix.

Time mix (per head, head dim N):
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  o_t = r_t · (S_{t-1} + diag(u ⊙ k_t) v_t)      (u: per-channel bonus)

Training and prefill use the chunked-parallel form: within a chunk of
length C the cumulative decays A_t = Π_{τ<=t} w_τ turn the recurrence into
two masked products; the (H, N, N) state is carried across chunks. Every
chunk's intra-chunk terms are computed at once here, and only the state's
carry (two ops per chunk) runs chunk after chunk, where the reference's
``lax.scan`` runs the whole chunk step; the values are the same ops. Decode
is the plain one-step recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.local import shard_local
from .common import ParamSpec

CHUNK = 64
LORA_R = 64


def rwkv_specs(cfg):
    d = cfg.d_model
    H = cfg.n_heads
    N = cfg.rnn_head_dim
    if H * N != d:
        raise ValueError(f"n_heads * rnn_head_dim must be d_model, got {H} * {N} != {d}")
    f = cfg.d_ff
    return {
        # time mix
        "mix_r": ParamSpec((d,), ("act_embed",), "zeros"),
        "mix_k": ParamSpec((d,), ("act_embed",), "zeros"),
        "mix_v": ParamSpec((d,), ("act_embed",), "zeros"),
        "mix_g": ParamSpec((d,), ("act_embed",), "zeros"),
        "mix_w": ParamSpec((d,), ("act_embed",), "zeros"),
        "w_r": ParamSpec((d, d), ("embed", "rnn_out")),
        "w_k": ParamSpec((d, d), ("embed", "rnn_out")),
        "w_v": ParamSpec((d, d), ("embed", "rnn_out")),
        "w_g": ParamSpec((d, d), ("embed", "rnn_out")),
        "w_o": ParamSpec((d, d), ("rnn_out", "embed")),
        "decay_base": ParamSpec((d,), ("act_embed",), "ones", -6.0),
        "decay_lora_a": ParamSpec((d, LORA_R), ("embed", None)),
        "decay_lora_b": ParamSpec((LORA_R, d), (None, "rnn_out")),
        "bonus": ParamSpec((d,), ("act_embed",), "ones", 0.5),
        "ln_x_scale": ParamSpec((d,), ("act_embed",), "ones"),
        # channel mix
        "cmix_k": ParamSpec((d,), ("act_embed",), "zeros"),
        "w_ck": ParamSpec((d, f), ("embed", "ffn")),
        "w_cv": ParamSpec((f, d), ("ffn", "embed")),
    }


def _token_shift(x, mix, prev=None):
    """lerp(x_{t-1}, x_t, mix). prev: (B, 1, D) carry for decode/chunk edge."""
    if prev is None:
        prev_x = F.pad(x[:, :-1], (0, 0, 1, 0))
    else:
        prev_x = torch.cat([prev, x[:, :-1]], dim=1)
    m = torch.sigmoid(mix).to(x.dtype)
    return x * m + prev_x * (1 - m)


def _decay(p, xw, cd):
    """log-decay (negative) per channel/time: w_t in (0,1)."""
    lora = torch.tanh(xw @ p["decay_lora_a"].to(cd)) @ p["decay_lora_b"].to(cd)
    logw = -torch.exp(torch.clamp(p["decay_base"].to(torch.float32)
                                  + lora.to(torch.float32), -8.0, 2.0))
    return logw  # (B, S, D), <= 0


def _heads(x, H, N):
    return x.reshape(x.shape[0], x.shape[1], H, N)


def _group_norm(o, p, cd):
    """Per-head groupnorm of float32 ``o`` (..., H, N) over N (population
    variance, as ``jnp.var``), flattened to D, cast and scaled."""
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = ((o - mu) * torch.rsqrt(var + 1e-5)).flatten(-2)
    return o.to(cd) * p["ln_x_scale"].to(cd)


BATCH = ("batch",)      # a sharder's layout of the blocks: each rank its batch rows, the
#                         parameters gathered whole (the heads' reshapes do not shard:
#                         RWKV-6's 40 heads over a model axis of 16)


def rwkv_time_mix(cfg, p, x, *, state=None, shift_prev=None, return_state=False, sharder=None):
    """x: (B, S, D). state: (B, H, N, N) carried k→v outer-product memory.
    With ``return_state``, also (the state after the last chunk, x[:, -1:]).
    With a ``sharder``, on each rank's batch rows (`BATCH`)."""
    return shard_local(sharder, _time_mix, [BATCH] * (3 if return_state else 1),
                       (None, (), BATCH, BATCH, BATCH))(cfg, p, x, state, shift_prev,
                                                        return_state=return_state)


def _time_mix(cfg, p, x, state, shift_prev, *, return_state):
    B, S, D = x.shape
    H, N = cfg.n_heads, cfg.rnn_head_dim
    cd = x.dtype

    xr = _token_shift(x, p["mix_r"], shift_prev)
    xk = _token_shift(x, p["mix_k"], shift_prev)
    xv = _token_shift(x, p["mix_v"], shift_prev)
    xg = _token_shift(x, p["mix_g"], shift_prev)
    xw = _token_shift(x, p["mix_w"], shift_prev)

    r = _heads(xr @ p["w_r"].to(cd), H, N)
    k = _heads(xk @ p["w_k"].to(cd), H, N)
    v = _heads(xv @ p["w_v"].to(cd), H, N)
    g = F.silu(xg @ p["w_g"].to(cd))
    logw = _heads(_decay(p, xw, cd), H, N)               # (B,S,H,N) fp32
    u = p["bonus"].to(torch.float32).reshape(H, N)

    if state is None:
        state = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)

    S_pad = ((S + CHUNK - 1) // CHUNK) * CHUNK
    n_chunks = S_pad // CHUNK

    def chunks(t):                                        # (B, n, C, H, N)
        t = F.pad(t, (0, 0, 0, 0, 0, S_pad - S))
        return t.reshape(B, n_chunks, CHUNK, H, N)

    rc, kc, vc = (chunks(t).to(torch.float32) for t in (r, k, v))
    wc = chunks(logw)                                     # log decays (<=0)

    # every chunk's own terms at once (the reference's chunk step, less the carry)
    cum = torch.cumsum(wc, dim=2)                         # logA_t, inclusive
    cum_prev = cum - wc                                   # logA_{t-1} (exclusive)
    q_in = rc * torch.exp(cum_prev)                       # inter-chunk query, and q_f
    k_f = kc * torch.exp(torch.clamp(-cum, max=30.0))
    qk = torch.einsum("bjchn,bjdhn->bjhcd", q_in, k_f)
    mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.float32, device=x.device), -1)
    qk = qk * mask
    # diagonal bonus term: (r_t ⊙ u ⊙ k_t) · v_t
    diag = torch.einsum("bjchn,hn,bjchn->bjch", rc, u, kc)
    o_intra = torch.einsum("bjhcd,bjdhn->bjchn", qk, vc) + diag[..., None] * vc
    decay_all = torch.exp(cum[:, :, -1])                  # (B,n,H,N)
    k_scaled = kc * torch.exp(torch.clamp(cum[:, :, -1:] - cum, -60.0, 30.0))
    kv = torch.einsum("bjchn,bjchm->bjhnm", k_scaled, vc)

    # the state carried from chunk to chunk; o_inter from the state at each chunk's start
    starts = []
    for j in range(n_chunks):
        starts.append(state)
        state = state * decay_all[:, j][..., None] + kv[:, j]
    o_inter = torch.einsum("bjchn,bjhnm->bjchm", q_in, torch.stack(starts, dim=1))
    o = (o_inter + o_intra).reshape(B, S_pad, H, N)[:, :S]

    # per-head groupnorm, then gate + out proj
    o = _group_norm(o, p, cd)
    y = (o * g) @ p["w_o"].to(cd)
    if return_state:
        return y, (state, x[:, -1:])
    return y


def rwkv_channel_mix(cfg, p, x, shift_prev=None, return_state=False, sharder=None):
    return shard_local(sharder, _channel_mix, [BATCH] * (2 if return_state else 1),
                       ((), BATCH, BATCH))(p, x, shift_prev, return_state=return_state)


def _channel_mix(p, x, shift_prev, *, return_state):
    cd = x.dtype
    xk = _token_shift(x, p["cmix_k"], shift_prev)
    h = torch.square(torch.relu(xk @ p["w_ck"].to(cd)))
    y = h @ p["w_cv"].to(cd)
    if return_state:
        return y, x[:, -1:]
    return y


def rwkv_decode(cfg, p, x_t, state, sharder=None):
    """One token. state: (S (B,H,N,N) fp32, tm_prev (B,1,D), cm_prev (B,1,D)).
    Returns (y, (the new S, x_t)). With a ``sharder``, on each rank's batch
    rows (`BATCH`)."""
    return shard_local(sharder, _decode, [BATCH] * 3, (None, (), BATCH, BATCH))(cfg, p, x_t,
                                                                               state)


def _decode(cfg, p, x_t, state):
    B, _, D = x_t.shape
    H, N = cfg.n_heads, cfg.rnn_head_dim
    cd = x_t.dtype
    st, tm_prev, cm_prev = state

    xr = _token_shift(x_t, p["mix_r"], tm_prev)
    xk = _token_shift(x_t, p["mix_k"], tm_prev)
    xv = _token_shift(x_t, p["mix_v"], tm_prev)
    xg = _token_shift(x_t, p["mix_g"], tm_prev)
    xw = _token_shift(x_t, p["mix_w"], tm_prev)

    r = (xr @ p["w_r"].to(cd)).reshape(B, H, N).to(torch.float32)
    k = (xk @ p["w_k"].to(cd)).reshape(B, H, N).to(torch.float32)
    v = (xv @ p["w_v"].to(cd)).reshape(B, H, N).to(torch.float32)
    g = F.silu(xg @ p["w_g"].to(cd))
    logw = _decay(p, xw, cd).reshape(B, H, N)
    u = p["bonus"].to(torch.float32).reshape(H, N)

    kv = torch.einsum("bhn,bhm->bhnm", k, v)
    o = torch.einsum("bhn,bhnm->bhm", r, st + u[None, :, :, None] * kv)
    st = st * torch.exp(logw)[..., None] + kv

    o = _group_norm(o, p, cd).reshape(B, 1, D)
    y = (o * g) @ p["w_o"].to(cd)
    return y, (st, x_t)
