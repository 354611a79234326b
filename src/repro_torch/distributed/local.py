"""Operations on each rank's local shards, where DTensor has no rule for the
operation or none that the port can use (the reference leaves all of them to
XLA's SPMD partitioner): K5, the attention core, the head projections, the
vocabulary-parallel embedding, the recurrent blocks and the in-place cache
writes. Each is the plain function under
``torch.distributed.tensor.experimental.local_map``, its placements read
from the `Sharder`'s logical axes (`shard_local`). Without a sharder, or on
a one-rank mesh, each is the plain function itself: the models have one code
path.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def shard_local(sharder, fn, out_axes, in_axes):
    """``fn`` on each rank's local shards under ``local_map``, or ``fn`` itself
    off a multi-rank mesh.

    ``in_axes`` names the logical axes of each positional argument's tensors
    (an argument may be a tree; names shorter than a tensor's dims are padded
    with None, so ``()`` gathers it whole); a plain tensor counts as
    replicated. The inputs are redistributed to those axes' placements. The
    outputs are one tensor on ``out_axes`` (names) or several, a list of
    names per tensor of the flattened output, or none (None). An output is
    ``Shard(d)`` on a mesh dim where some input is sharded along the name at
    its dim d, ``Partial`` where inputs are sharded only along names it lacks
    (a contraction split there), else ``Replicate``. An input's gradient is
    ``Partial`` on a mesh dim where it is replicated and the output is not: each
    rank's holds only its share of the sum. Keywords pass to ``fn`` as they
    are, so they must hold no tensor."""
    if sharder is None or not sharder.distributed:
        return fn
    return lambda *args, **kw: _on_shards(sharder, fn, out_axes, in_axes, args, kw)


class _Slot:
    """Where a tensor leaf sits in a flattened argument."""


def _pad(axes, n):
    return tuple(axes)[:n] + (None,) * (n - len(axes))


def _on_shards(sharder, fn, out_axes, in_axes, args, kw):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = sharder.mesh
    tensors, names, flats = [], [], []
    for arg, axes in zip(args, in_axes, strict=True):
        flat, spec = pytree.tree_flatten(arg)
        for i, x in enumerate(flat):
            if isinstance(x, torch.Tensor):
                if not isinstance(x, DTensor):
                    x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
                tensors.append(x)
                names.append(_pad(axes, x.dim()))
                flat[i] = _Slot
        flats.append((flat, spec))
    in_pl = [sharder.placements(x.shape, ax) for x, ax in zip(tensors, names)]

    outs = [] if out_axes is None else out_axes if isinstance(out_axes, list) else [out_axes]
    out_pl = []
    for ax in outs:
        pl = []
        for i in range(mesh.ndim):
            split = [n[p.dim] for n, ps in zip(names, in_pl) for p in [ps[i]]
                     if isinstance(p, Shard)]
            hit = next((tuple(ax).index(s) for s in split if s is not None and s in ax), None)
            pl.append(Shard(hit) if hit is not None else Partial() if split else Replicate())
        out_pl.append(tuple(pl))
    split_out = out_pl[0] if out_pl else (Replicate(),) * mesh.ndim
    grad_pl = [tuple(Partial() if isinstance(p, Replicate) and not isinstance(o, Replicate)
                     else p for p, o in zip(ps, split_out)) for ps in in_pl]

    result = {}

    def local(*ts):
        it = iter(ts)
        a = [pytree.tree_unflatten([next(it) if v is _Slot else v for v in flat], spec)
             for flat, spec in flats]
        oflat, result["spec"] = pytree.tree_flatten(fn(*a, **kw))
        result["flat"] = oflat
        return tuple(o for o in oflat if isinstance(o, torch.Tensor))

    dts = iter(local_map(local, out_placements=tuple(out_pl), in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                         redistribute_inputs=True)(*tensors))
    return pytree.tree_unflatten([next(dts) if isinstance(o, torch.Tensor) else o
                                  for o in result["flat"]], result["spec"])


def vocab_embed(sharder, tokens, table):
    """``F.embedding(tokens, table)``. On a multi-rank mesh, a
    vocabulary-parallel lookup on each rank's rows of the table (its embed
    dim gathered, FSDP's gather on use): tokens outside them are zeroed and
    the result is a pending sum over the mesh dims that shard the vocabulary.
    DTensor's own rule marks it with a masked partial that its backward
    cannot take."""
    import torch.nn.functional as F

    if sharder is None or not sharder.distributed:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Shard

    lo, rows = 0, table.shape[0]
    for i, p in enumerate(sharder.placements(table.shape, ("vocab", None))):
        if isinstance(p, Shard):
            rows //= sharder.mesh.size(i)
            lo += sharder.mesh.get_local_rank(i) * rows

    def lookup(ids, local):
        inside = (ids >= lo) & (ids < lo + rows)
        return F.embedding(torch.where(inside, ids - lo, 0), local) * \
            inside[..., None].to(local.dtype)
    return shard_local(sharder, lookup, ("batch", "seq", None),
                       (("batch", "seq"), ("vocab", None)))(tokens, table)


def local_write(sharder, fn, dsts, srcs, *, rows=None):
    """``fn(*dsts, *srcs)``, writing into the tensors ``dsts`` in place (given
    ``rows``, the batch rows' indices, made once per step by the caller,
    ``fn(*dsts, *srcs, rows=rows)``). On a multi-rank mesh it runs on each
    rank's local shards, since DTensor has no rule for a scatter into a
    sharded tensor: the destinations as they are placed, a source with the
    first destination's number of dims at its placements, any other (a
    per-row vector) at its batch placements only, and ``rows`` made anew for
    the rank's rows. A source shorter along dim 1 than a destination sharded
    there (a write of some positions of a cache) raises: they may lie on
    another rank."""
    kw = {} if rows is None else {"rows": rows}
    if sharder is None or not sharder.distributed:
        return fn(*dsts, *srcs, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl, nd = sharder.mesh, dsts[0].placements, dsts[0].dim()
    if Shard(1) in pl and any(x.dim() == nd and x.shape[1] != dsts[0].shape[1] for x in srcs):
        raise NotImplementedError("in-place writes of some positions of a cache sharded "
                                  "along its sequence dim")
    rows_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    srcs = [x if isinstance(x, DTensor) else
            DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
            for x in srcs]

    def local(*ts):
        if rows is not None:
            kw["rows"] = torch.arange(ts[0].shape[0], device=ts[0].device)
        fn(*ts, **kw)
        return ()
    local_map(local, out_placements=(), device_mesh=mesh, redistribute_inputs=True,
              in_placements=tuple([d.placements for d in dsts] +
                                  [pl if x.dim() == nd else rows_pl for x in srcs]))(
        *dsts, *srcs)


def assign(sharder, dst, src):
    """``dst.copy_(src)``, by `local_write`."""
    local_write(sharder, torch.Tensor.copy_, [dst], [src])
