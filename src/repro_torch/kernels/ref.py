"""Plain PyTorch versions of the kernels (the CPU path and the card's oracle).

They keep the float32 op order of the JAX package's ``_score_tile``:
``((1-u)*age)/(1+u)`` and ``garbage/max(n,1)``, each a separate op, so the
CUDA kernels (built without FMA contraction or fast math) match them bit
for bit. ``classify_ref`` evaluates the elementwise classifiers of
`core.placement.schemes`, the port's one plain version of the class maps.
``zipf_bit_sums_ref`` and ``flash_decode_ref`` are float reductions whose
kernels sum in another order; they are held within a stated tolerance.
"""

from __future__ import annotations

import math

import torch

from ..core.placement.schemes import elementwise_chain


def _scores(seg_n, seg_nvalid, seg_stime, seg_state, t, selector_id):
    """Victim scores; ``t`` and ``selector_id`` broadcast over the last axis.
    Segments that are not sealed or hold no garbage score -inf."""
    nf = seg_n.to(torch.float32)
    nvf = seg_nvalid.to(torch.float32)
    garbage = nf - nvf
    greedy = garbage / torch.clamp(nf, min=1.0)
    u = nvf / torch.clamp(nf, min=1.0)
    age = torch.clamp(t - seg_stime, min=0).to(torch.float32)
    cost_benefit = (1.0 - u) * age / (1.0 + u)
    score = torch.where(selector_id == 0, greedy, cost_benefit)
    return torch.where((seg_state == 2) & (garbage > 0), score, -math.inf)


def segment_select_batch_ref(seg_n, seg_nvalid, seg_stime, seg_state, t, selector_ids):
    """Per-volume victim argmax over (V, S) segment metadata; ties go to the
    lowest index, and idx is -1 where no segment is eligible. Returns
    ((V,) int32 idx, (V,) float32 best score)."""
    score = _scores(seg_n, seg_nvalid, seg_stime, seg_state, t[:, None], selector_ids[:, None])
    best = torch.amax(score, dim=1)
    idx = torch.argmax(score, dim=1)
    return torch.where(torch.isfinite(best), idx, -1).to(torch.int32), best


def segment_select_ref(seg_n, seg_nvalid, seg_stime, seg_state, t, selector_id):
    """The same argmax over one volume's (S,) arrays; 0-d outputs."""
    t = torch.as_tensor(t, dtype=torch.int32, device=seg_n.device).reshape(1)
    sel = torch.as_tensor(selector_id, dtype=torch.int32, device=seg_n.device).reshape(1)
    idx, best = segment_select_batch_ref(seg_n[None], seg_nvalid[None], seg_stime[None],
                                         seg_state[None], t, sel)
    return idx[0], best[0]


def classify_ref(v, g, from_c1, is_gc, ell, scheme_ids):
    """Placement class of every (V, B) element under its row's scheme id and
    ℓ: the scheme table's elementwise classifiers, with ``v`` and ``g``
    rounded to float32 as the kernel rounds them; any other id gives 0."""
    return elementwise_chain(scheme_ids[:, None], v.to(torch.float32), g.to(torch.float32),
                             from_c1, is_gc, ell[:, None])


def zipf_bit_sums_ref(probs, u0, v0, g0, r0):
    """The four sums behind the paper's Figs 8 and 10 over a pmf ``probs``,
    in float32 with (1-p)^e = exp(e * log1p(-p)): (4,) float32
    [Σp(1-(1-p)^u0)(1-(1-p)^v0), Σp(1-(1-p)^v0), Σp(1-p)^g0,
    Σp((1-p)^g0 - (1-p)^(g0+r0))]."""
    p = probs.to(torch.float32)
    lg = torch.log1p(-p)
    pow_u0 = torch.exp(u0 * lg)
    pow_v0 = torch.exp(v0 * lg)
    pow_g0 = torch.exp(g0 * lg)
    pow_gr = torch.exp((g0 + r0) * lg)
    return torch.stack([
        torch.sum(p * (1 - pow_u0) * (1 - pow_v0)),
        torch.sum(p * (1 - pow_v0)),
        torch.sum(p * pow_g0),
        torch.sum(p * (pow_g0 - pow_gr)),
    ])


def flash_decode_ref(q, k, v, kv_len):
    """Single-token GQA decode attention: q (B, Hq, D) over k, v
    (B, S, Hkv, D), positions >= ``kv_len`` (B,) masked with -1e30; float32
    scores and softmax, output in q's dtype, (B, Hq, D)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, G, D) / (D ** 0.5)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.to(torch.float32))
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]      # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.to(torch.float32))
    return out.reshape(B, Hq, D).to(q.dtype)
