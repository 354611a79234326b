"""The corpus generator: synthetic block traces made on the device from a seed.

One general generator reads a traffic file (``traffic/<name>.json``): a
corpus of ``volumes`` traces, volume i drawn from family
``i % len(families)``. Every trace writes its working set once in LBA order
(the fill), then ``updates_per_lba * n_lbas`` updates (± ``jitter``).

The one family, ``zipf``, is the workload model of the SepBIT paper's
analysis (its §3.2-§3.3, Figs 8 and 10): each update draws a rank from
Zipf(alpha) over the volume's LBAs, p_i ∝ 1 / i^alpha, and a random
permutation maps ranks to LBAs (the model has no spatial order). ``alpha``
is a list of skews that the volumes take in turn.

Per-volume values and lengths are a fixed set, the same for every seed;
the seed draws their order over the volumes and the LBAs. So every seed
asks for the same amount of work and the same mix of skews. Draws come from
one ``torch.Generator`` on the device, in a fixed order of fixed shapes.
"""

from __future__ import annotations

import torch


def _in_turn(values: list, n: int, g, device) -> torch.Tensor:
    """(n,) float64: ``values`` taken in turn by n volumes, in an order
    drawn from ``g``."""
    vals = torch.tensor(values, dtype=torch.float64, device=device)
    vals = vals[torch.arange(n, device=device) % vals.numel()]
    return vals[torch.randperm(n, generator=g, device=device)]


def _zipf_ranks(alpha: torch.Tensor, n: int, length: int, g, device) -> torch.Tensor:
    """(V, length) int64 ranks 0..n-1 drawn by inverse CDF from Zipf(alpha)
    pmfs over ranks 1..n, one alpha per row (float64)."""
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    w = ranks[None, :] ** (-alpha[:, None])
    cdf = torch.cumsum(w / w.sum(1, keepdim=True), dim=1)
    cdf[:, -1] = 1.0
    u = torch.rand((alpha.numel(), length), generator=g, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)


def _zipf_family(fam: dict, V: int, n: int, length: int, g, device) -> torch.Tensor:
    alpha = _in_turn(fam["alpha"], V, g, device)
    perm = torch.argsort(torch.rand((V, n), generator=g, device=device), dim=1)
    out = torch.empty((V, length), dtype=torch.int32, device=device)
    # in blocks of volumes, so that the float64 draws stay a few GB
    step = max(1, (1 << 28) // max(length, 1))
    for v in range(0, V, step):
        ranks = _zipf_ranks(alpha[v:v + step], n, length, g, device)
        out[v:v + step] = torch.gather(perm[v:v + step], 1, ranks).to(torch.int32)
    return out


FAMILIES = {"zipf": _zipf_family}


def lengths(traffic: dict, n_volumes: int, n_lbas: int) -> list:
    """The per-volume update counts before their order is drawn: evenly
    spaced over n_updates ± jitter (the set every seed shares)."""
    n_upd = int(round(traffic["updates_per_lba"] * n_lbas))
    lo = max(int(n_upd * (1 - traffic["jitter"])), 1)
    hi = int(n_upd * (1 + traffic["jitter"]))
    return [lo + (i * (hi - lo)) // max(n_volumes - 1, 1) for i in range(n_volumes)]


def make_corpus(traffic: dict, n_volumes: int, n_lbas: int, seed: int,
                device="cuda") -> torch.Tensor:
    """The corpus as a (V, n_lbas + longest update count) int32 tensor on
    ``device``: each row the fill, then its updates, then -1 (a pad step)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lens_set = lengths(traffic, n_volumes, n_lbas)
    length = max(lens_set)
    lens = torch.tensor(lens_set, device=device)[
        torch.randperm(n_volumes, generator=g, device=device)]
    families = traffic["families"]
    out = torch.full((n_volumes, n_lbas + length), -1, dtype=torch.int32, device=device)
    out[:, :n_lbas] = torch.arange(n_lbas, dtype=torch.int32, device=device)
    fam_of = torch.arange(n_volumes, device=device) % len(families)
    for f, fam in enumerate(families):
        vols = torch.nonzero(fam_of == f)[:, 0]
        if vols.numel() == 0:
            continue
        upd = FAMILIES[fam["kind"]](fam, vols.numel(), n_lbas, length, g, device)
        inside = torch.arange(length, device=device)[None, :] < lens[vols][:, None]
        out[vols, n_lbas:] = torch.where(inside, upd, -1)
    return out
