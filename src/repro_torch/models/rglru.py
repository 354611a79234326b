"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
twin of the JAX package's ``models/rglru.py``.

Block: x -> {gate branch: Linear+GeLU} ⊙ {recurrent branch: Linear -> causal
Conv1D(width 4) -> RG-LRU} -> out Linear.

RG-LRU (per channel):
  r_t = sigmoid(W_r x_t + b_r)          recurrence gate
  i_t = sigmoid(W_i x_t + b_i)          input gate
  a_t = a^(c * r_t),  a = sigmoid(Λ)    (c = 8)
  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Training and prefill run the diagonal linear recurrence as a log-depth scan
(`linear_scan`, where the reference calls ``jax.lax.associative_scan``: the
same combine, another tree, so float32 sums in another order); decode
carries the (h, conv window) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.local import shard_local
from .common import ParamSpec, constrain

C_RGLRU = 8.0
CONV_W = 4


def rglru_specs(cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_in": ParamSpec((d, w), ("embed", "lru")),
        "w_gate": ParamSpec((d, w), ("embed", "lru")),
        "conv": ParamSpec((CONV_W, w), (None, "lru")),
        "w_r": ParamSpec((w, w), ("lru_in", "lru")),
        "b_r": ParamSpec((w,), ("lru",), "zeros"),
        "w_i": ParamSpec((w, w), ("lru_in", "lru")),
        "b_i": ParamSpec((w,), ("lru",), "zeros"),
        "lam": ParamSpec((w,), ("lru",), "ones", 2.0),   # a = sigmoid(lam*?) init toward ~0.9
        "w_out": ParamSpec((w, d), ("lru", "embed")),
    }


def _gates(p, u, cd, sharder=None):
    r = torch.sigmoid(u @ p["w_r"].to(cd) + p["b_r"].to(cd))
    i = torch.sigmoid(u @ p["w_i"].to(cd) + p["b_i"].to(cd))
    # on each rank's shard: DTensor has no rule for log_sigmoid's backward
    log_a_base = shard_local(sharder, F.logsigmoid, ("lru",), (("lru",),))(
        p["lam"].to(torch.float32))
    log_a = C_RGLRU * r.to(torch.float32) * log_a_base   # (..., w)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * \
        (i * u).to(torch.float32)
    return a, b


def _conv_taps(window, k, n):
    """The reference's ``sum(window[:, i : i + n] * k[i] for i in range(4))``:
    the four taps added in order."""
    out = window[:, 0:n] * k[0]
    for i in range(1, CONV_W):
        out = out + window[:, i:i + n] * k[i]
    return out


def _causal_conv(p, u, cd, carry=None):
    """Causal depthwise conv, width 4. u: (B, S, w). carry: (B, CONV_W-1, w)."""
    if carry is None:
        pad = torch.zeros(u.shape[:1] + (CONV_W - 1,) + u.shape[2:], dtype=u.dtype,
                          device=u.device)
    else:
        pad = carry.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = _conv_taps(up, p["conv"].to(cd), u.shape[1])
    new_carry = up[:, -(CONV_W - 1):]
    return out, new_carry


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    log2(S) steps, each combining element t with element t - d by the
    reference's combine ``(al * ar, ar * bl + br)``."""
    S = a.shape[1]
    d = 1
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def rglru_forward(cfg, p, x, *, sharder=None, h0=None, conv0=None, return_state=False):
    """Full-sequence block. x: (B, S, d_model) -> (B, S, d_model). With
    ``return_state``, also (h at the last position in x's dtype, the conv
    window carry)."""
    cd = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(cd), approximate="tanh")   # jax.nn.gelu's default
    u = x @ p["w_in"].to(cd)
    u = constrain(sharder, u, "batch", "seq", "lru")
    u, conv_carry = _causal_conv(p, u, cd, conv0)
    a, b = _gates(p, u, cd, sharder)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b).to(cd)
    y = (h * gate) @ p["w_out"].to(cd)
    if return_state:
        return y, (h[:, -1], conv_carry)
    return y


def rglru_decode(cfg, p, x_t, state, sharder=None):
    """One step. x_t: (B, 1, d). state: (h (B,w), conv (B,3,w)). Returns
    (y, (h float32, the new conv window in x's dtype))."""
    cd = x_t.dtype
    h_prev, conv_prev = state
    gate = F.gelu(x_t @ p["w_gate"].to(cd), approximate="tanh")
    u = x_t @ p["w_in"].to(cd)                          # (B,1,w)
    window = torch.cat([conv_prev.to(cd), u], dim=1)    # (B,4,w)
    u_c = _conv_taps(window, p["conv"].to(cd), 1)       # (B,1,w)
    a, b = _gates(p, u_c, cd, sharder)
    h = a[:, 0] * h_prev.to(torch.float32) + b[:, 0]
    y = (h[:, None].to(cd) * gate) @ p["w_out"].to(cd)
    return y, (h, window[:, 1:])
