"""Optional pipeline parallelism (GPipe schedule), the twin of the JAX
package's ``distributed/pipeline.py`` on ``torch.distributed``.

The production meshes are (data, model) only, so PP is off by default; this
module is for deployments that trade the model axis for a stage axis. The
schedule is the reference's M-microbatch GPipe loop: M + S - 1 ticks, stage
0 feeding microbatch ``min(t, M - 1)``, the last stage emitting microbatch
``t - (S - 1)``; bubble fraction (S - 1) / (M + S - 1). ``ppermute``'s open
chain (stage i sends to i + 1, stage 0 receives nothing) is one
``batch_isend_irecv`` per tick, and the last stage's outputs are all-reduced
over the stage group at the end, where the reference ``psum``s them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pipeline_apply(mesh, block_fn, stacked_params, x_microbatches, *, stage_axis: str = "stage"):
    """Run a stack of identical blocks as a pipeline over the ``stage_axis``
    dim of the DeviceMesh ``mesh``.

    stacked_params: a tensor or a dict of tensors with leading axis L =
    S * per_stage, each rank's copy of the whole stack (the rank keeps its
    stage's L / S layers) or a DTensor sharded on that axis over the stage
    dim; block_fn(params_i, h) -> h. x_microbatches: (M, mb, ...), the same
    on every rank. Returns (M, mb, ...) on every rank, equal to applying all
    L blocks in order.
    """
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves, tree_map

    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    M = x_microbatches.shape[0]
    L = tree_leaves(stacked_params)[0].shape[0]
    assert L % S == 0, (L, S)
    per = L // S

    def mine(a):
        return a.to_local() if isinstance(a, DTensor) else a[stage * per:(stage + 1) * per]

    local = tree_map(mine, stacked_params)
    layers = [tree_map(lambda a, i=i: a[i], local) for i in range(per)]

    def apply_stage(h):
        for p in layers:
            h = block_fn(p, h)
        return h

    h = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (the last one again in the drain ticks)
        h_in = x_microbatches[min(t, M - 1)] if stage == 0 else h
        h_out = apply_stage(h_in)
        out_idx = t - (S - 1)
        if stage == S - 1 and out_idx >= 0:
            outputs[out_idx] = h_out
        # hop activations to the next stage
        ops = []
        if stage < S - 1:
            ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                  dist.get_global_rank(group, stage + 1), group))
        if stage > 0:
            h = torch.empty_like(h_out)
            ops.append(dist.P2POp(dist.irecv, h, dist.get_global_rank(group, stage - 1), group))
        else:
            h = torch.zeros_like(h_out)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # only the last stage's buffer is meaningful; share it
    if stage != S - 1:
        outputs.zero_()
    dist.all_reduce(outputs, dist.ReduceOp.SUM, group=group)
    return outputs
