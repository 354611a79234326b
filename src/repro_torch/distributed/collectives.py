"""Distributed-optimization collectives, the twin of the JAX package's
``distributed/collectives.py`` on ``torch.distributed``.

Error-feedback int8 gradient reduction for the slow (pod-crossing) hop:
gradients are quantized per block to int8 with a shared float32 scale, summed
over the group, and dequantized; the quantization residual is returned for
error feedback (carried in the optimizer state so the bias vanishes over
steps, Karimireddy et al. style).

`quantize_int8` / `dequantize_int8` are bit-equal to the reference's eager
functions on either device: each division is by a tensor (on CUDA PyTorch
divides by a Python number as a product with its reciprocal), and
``torch.round`` rounds half to even as ``jnp.round`` does. As in the
reference, the all-reduce carries the dequantized payload (numerically equal
to decode-then-sum); the wire format it stands for is q plus the scales.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8 quantization. Returns (q (N, block) int8,
    scales (N, 1) float32); the flat tensor is zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / _const(127.0, blocks)
    scale = torch.maximum(scale, _const(1e-12, scale))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q, scale, shape):
    out = (q.to(torch.float32) * scale).reshape(-1)
    return out[:math.prod(shape)].reshape(shape)


def compressed_allreduce(x, residual, group=None, block: int = 256):
    """int8 all-reduce over ``group`` (None: the default group) with error
    feedback. Every rank passes its own x; returns (the mean over the group
    of the dequantized payloads, float32, the new residual ``y - sent``)."""
    y = x + residual
    q, scale = quantize_int8(y, block)
    sent = dequantize_int8(q, scale, x.shape)
    new_residual = y - sent
    summed = sent.clone()
    dist.all_reduce(summed, dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=x.dtype, device=x.device)
    dist.all_reduce(n, dist.ReduceOp.SUM, group=group)
    return summed / n, new_residual


def make_pod_grad_reducer(mesh, block: int = 256):
    """Gradient reducer over the "pod" dim of the DeviceMesh ``mesh`` (the
    pod-crossing hop): ``reduce_tree(grads, residuals) -> (grads,
    residuals)``, `compressed_allreduce` per leaf over the ranks that differ
    only in their pod. A DTensor leaf is reduced on its local shard (the
    pod ranks hold the same shard) and comes back with its placements."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    group = mesh.get_group("pod")

    def one(g, r):
        if not isinstance(g, DTensor):
            return compressed_allreduce(g, r, group, block)
        out, res = compressed_allreduce(g.to_local(), r.to_local(), group, block)
        return tuple(DTensor.from_local(t, g.device_mesh, g.placements, run_check=False,
                                        shape=g.shape, stride=g.stride()) for t in (out, res))

    def reduce_tree(grads, residuals):
        pairs = [one(g, r) for g, r in zip(pytree.tree_leaves(grads),
                                            pytree.tree_leaves(residuals))]
        new_g, new_r = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
        return (pytree.tree_map(lambda _: next(new_g), grads),
                pytree.tree_map(lambda _: next(new_r), grads))

    return reduce_tree
