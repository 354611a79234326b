"""Plain PyTorch versions of the kernels (the CPU path and the card's oracle).

They keep the float32 op order of the JAX package's ``_score_tile``:
``((1-u)*age)/(1+u)`` and ``garbage/max(n,1)``, each a separate op, so the
CUDA kernels (built without FMA contraction or fast math) match them bit
for bit. ``classify_ref`` evaluates the elementwise classifiers of
`core.placement.schemes`, the port's one plain version of the class maps.
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
