"""Multi-pod dry run: every (arch × shape × mesh) cell traced per chip on the
meta device, the twin of the JAX package's ``launch/dryrun.py``.

The 256- and 512-chip production meshes are laid over a fake process group
of that many ranks (``torch.testing._internal.distributed.fake_pg``, imported
in `_fake_group` alone): this process is rank 0, every collective returns at
once, and every tensor is a meta DTensor, so nothing is allocated and no
data moves. The cell's step (train, prefill or decode, through the sharded
entry points) runs once under `_Counter`, a dispatch mode that lets DTensor
lower each operation to the rank's local operations and sees only those:

  flops             ``torch.utils.flop_counter``'s formulas on the local
                    operations: per chip, as JAX's SPMD module counts (a
                    counter over the DTensor operations would see the global
                    ones, chips times more)
  bytes_accessed    the bytes every local operation that is not a view reads
                    and writes, unfused (XLA's ``bytes accessed`` counts the
                    same way before fusion)
  collective_bytes  the output bytes of each collective DTensor dispatches,
                    under the reference's names (the reference parses the
                    output shapes of the HLO's collectives)
  memory            ``argument_bytes`` / ``output_bytes``: the chip's shares
                    of the step's arguments (parameters, optimizer state,
                    cache, batch) and results. ``temp_bytes`` and
                    ``peak_bytes`` are None: nothing here plans the buffers
                    the step would hold, as XLA's compiler does.

As in the reference, the costs come from unrolled depths k = 1 and 2 of each
repeating pattern, extrapolated linearly to the full depth (exact for
repeated layers); the memory from the full-depth config's shapes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out out.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..distributed.sharding import Sharder, ShardingOptions, abstract_params
from ..models.common import ParamSpec, tree_leaves
from ..models.transformer import cache_dtype
from ..models.zoo import build_model
from .mesh import make_production_mesh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {          # local collective op name -> the reference's name
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _fake_group(world: int):
    """The default process group as a fake one of ``world`` ranks, this
    process rank 0 (re-made when the size changes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def device_mesh(shape_mesh):
    """A CPU DeviceMesh of ``shape_mesh``'s names and sizes over a fake group
    of its size (its tensors live on the meta device)."""
    from torch.distributed.device_mesh import init_device_mesh

    _fake_group(shape_mesh.size())
    return init_device_mesh("cpu", tuple(shape_mesh.shape),
                            mesh_dim_names=tuple(shape_mesh.mesh_dim_names))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _Counter(TorchDispatchMode):
    """Counts the local operations DTensor runs on this rank (see the module
    docstring). A DTensor operation is handed back to DTensor (which lowers
    it to local ones, seen here in turn); DTensor's shape propagation on
    fake tensors runs uncounted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if types or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out          # DTensor's shape propagation (fake tensors, global shapes)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.namespace in ("_c10d_functional", "c10d_functional", "_dtensor"):
            name = _COLLECTIVE_OPS.get(packet.__name__)
            if name is not None:
                outs = out if isinstance(out, (list, tuple)) else [out]
                self.collectives[name] += sum(_nbytes(o) for o in outs)
        elif not func.is_view:
            ins = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.bytes += sum(_nbytes(a) for a in ins) + sum(_nbytes(o) for o in outs)
        return out


def _local_bytes(tree) -> int:
    """The chip's share of a tree of (meta) tensors or DTensors, in bytes."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x) for x in tree_leaves(tree))


def _cache_dtypes(cfg):
    """Positions int32; the recurrent states float32 (``init_cache``'s)."""
    return lambda key, spec: cache_dtype(key, cfg.cdtype())


def _inputs(model, shape, sharder):
    """The step's batch as meta DTensors: tokens (and labels) on ("batch",
    "seq"), the stub frontends' embeddings on ("batch", "seq", "act_embed")."""
    out = {}
    for key, x in model.input_specs(shape, abstract=True).items():
        axes = ("batch", "seq", "act_embed")[:x.dim()]
        out[key] = abstract_params(ParamSpec(tuple(x.shape), axes), sharder, x.dtype)
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               options: ShardingOptions = None, cfg_override=None, mesh=None):
    """(sharder, step function, arguments) of one dry-run cell, the
    arguments meta DTensors on the production mesh (or the `ShapeMesh`
    ``mesh``) over a fake group."""
    from ..serving.engine import make_decode_fn, make_prefill_fn
    from ..training.optimizer import AdamWConfig
    from ..training.train_loop import make_train_step

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if options is None:
        # serving deployments load weights replicated across DP (no FSDP
        # re-gather per token)
        options = ShardingOptions(fsdp=(shape.kind == "train"))
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    sharder = Sharder(device_mesh(mesh), cfg, options)
    model = build_model(cfg)
    specs = model.param_specs()
    params = abstract_params(specs, sharder, cfg.pdtype())

    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.optimizer_dtype)
        dt = getattr(torch, cfg.optimizer_dtype)
        opt = {"m": abstract_params(specs, sharder, dt), "v": abstract_params(specs, sharder, dt),
               "step": torch.zeros((), dtype=torch.int32, device="meta")}
        step = make_train_step(model, cfg, opt_cfg, sharder)
        return sharder, step, ({"params": params, "opt": opt}, _inputs(model, shape, sharder))

    B = shape.global_batch
    cache = abstract_params(model.cache_specs(B, shape.seq_len), sharder, _cache_dtypes(cfg))
    if shape.kind == "prefill":
        return sharder, make_prefill_fn(model, cfg, sharder), \
            (params, _inputs(model, shape, sharder), cache)
    # decode: one new token against a seq_len KV history
    tokens = abstract_params(ParamSpec((B, 1), ("batch", "seq")), sharder, torch.int32)
    return sharder, make_decode_fn(model, cfg, sharder), (params, tokens, cache)


def _analysis_cfg(cfg, k: int):
    """Reduced-depth config for cost extrapolation: k ∈ {1, 2} repeats of
    the block pattern (same tail, same intercept), one microbatch,
    unrolled."""
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    tail = cfg.n_layers % period
    repl = dict(n_layers=period * k + tail, microbatches=1, scan_layers=False)
    if cfg.encoder_layers:
        repl["encoder_layers"] = k
    return dataclasses.replace(cfg, **repl)


def _memory(arch, shape_name, multi_pod, options, cfg, mesh=None) -> dict:
    """The production form's per-chip argument and output bytes, from
    shapes alone: the step is not run at full depth."""
    sharder, _, args = build_cell(arch, shape_name, multi_pod, options, cfg, mesh)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        out = _local_bytes(args[0]) + 3 * 4          # new state; loss, grad_norm, lr
    else:                                            # the cache and last-position logits
        logits = sharder.local_shape((shape.global_batch, cfg.vocab), ("batch", "vocab"))
        out = _local_bytes(args[2]) + math.prod(logits) * cfg.cdtype().itemsize
        if shape.kind == "decode":
            out += logits[0] * 4                     # the next tokens, int32
    return {"argument_bytes": _local_bytes(args), "output_bytes": out,
            "temp_bytes": None, "peak_bytes": None}


def _measure(arch, shape_name, multi_pod, options, cfg, mesh=None) -> dict:
    _, fn, args = build_cell(arch, shape_name, multi_pod, options, cfg, mesh)
    counter = _Counter()
    with counter:
        fn(*args)
    return {"flops": float(counter.flops), "bytes_accessed": float(counter.bytes),
            "collectives": {**counter.collectives, "total": sum(counter.collectives.values())}}


VARIANTS = {
    "baseline": {},
    # A1: grouped MoE routing (dispatch cost linear in group size)
    "moe_g512": {"route_group": 512},
    # A2: A1 + sequence-parallel attention (kills S×S score all-reduces)
    "moe_g512_sp": {"route_group": 512,
                    "options": ShardingOptions(sp_attention=True)},
    # B1: A1 + SP + 2D weight-stationary experts (no expert all-gather)
    "moe_g512_2d": {"route_group": 512,
                    "options": ShardingOptions(moe_2d=True, sp_attention=True)},
    # A2 alone (dense archs)
    "sp_attn": {"options": ShardingOptions(sp_attention=True)},
    # C1: serving without FSDP re-gather (weights replicated over data)
    "serve_nofsdp": {"options": ShardingOptions(fsdp=False)},
    # D: pure data parallelism (small models drown in TP collectives)
    "dp_only": {"options": ShardingOptions(overrides=tuple(
        (k, None) for k in ("vocab", "ffn", "heads", "kv_heads", "head_dim",
                            "lru", "rnn_out", "rnn_state", "moe_ffn")))},
    # E: fewer grad-accumulation microbatches (fewer FSDP re-gathers)
    "mb2": {"microbatches": 2},
    "mb4": {"microbatches": 4},
}


def apply_variant(cfg, variant: str):
    spec = VARIANTS[variant]
    options = spec.get("options", ShardingOptions())
    repl = {}
    if "route_group" in spec and cfg.moe is not None:
        repl["moe"] = dataclasses.replace(cfg.moe, route_group=spec["route_group"])
    if "microbatches" in spec:
        repl["microbatches"] = spec["microbatches"]
    if repl:
        cfg = dataclasses.replace(cfg, **repl)
    return cfg, options


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             options: ShardingOptions = None, analyze: bool = True,
             variant: str = "baseline", cfg=None, mesh=None) -> dict:
    """One cell's record, with the reference's keys. ``cfg`` stands in for
    ``get_config(arch)`` and the `ShapeMesh` ``mesh`` for the production
    mesh (a smoke config on a small mesh, in the tests)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch) if cfg is None else cfg
    cfg, var_options = apply_variant(cfg, variant)
    if variant != "baseline":
        options = var_options
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "x".join(str(n) for n in mesh.shape)}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        # 1) production form: the full depth's per-chip memory
        memory = _memory(arch, shape_name, multi_pod, options, cfg, mesh)
        t1 = time.time()
        rec.update(
            status="ok",
            compile_s=round(t1 - t0, 1),
            n_chips=mesh.size(),
            model_params=cfg.n_params(),
            model_params_active=cfg.n_active_params(),
            memory=memory,
        )
        if analyze:
            # 2) costs: unrolled k = 1, 2 -> linear extrapolation to full depth
            period = len(cfg.block_pattern) if cfg.block_pattern else 1
            k_full = cfg.n_layers // period
            c1 = _measure(arch, shape_name, multi_pod, options, _analysis_cfg(cfg, 1), mesh)
            c2 = _measure(arch, shape_name, multi_pod, options, _analysis_cfg(cfg, 2), mesh)

            def extrap(a, b):
                return a + (b - a) * (k_full - 1)

            rec["flops"] = extrap(c1["flops"], c2["flops"])
            rec["bytes_accessed"] = extrap(c1["bytes_accessed"], c2["bytes_accessed"])
            rec["collective_bytes"] = {
                key: int(extrap(c1["collectives"][key], c2["collectives"][key]))
                for key in c1["collectives"]
            }
            rec["analysis_compile_s"] = round(time.time() - t1, 1)
    except Exception as e:  # noqa: BLE001 - report failures per cell
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    return rec


def model_flops_per_chip(cfg, shape, chips: int) -> float:
    """The useful FLOPs per chip: 2·N_active·T for prefill and decode, 6·N·T
    for train (8·N·T with remat), over the chips; T the step's tokens."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = (8 if cfg.remat else 6) if shape.kind == "train" else 2
    return mult * cfg.n_active_params() * tokens / chips


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                rec = run_cell(arch, shape, mp, variant=args.variant)
                print(json.dumps(rec), flush=True)
                cells.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
    n_err = sum(1 for c in cells if c["status"] == "error")
    print(f"# done: {len(cells)} cells, {n_err} errors", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
