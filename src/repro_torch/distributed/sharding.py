"""Logical-axis sharding rules (FSDP + TP + EP + SP), the twin of the JAX
package's ``distributed/sharding.py`` on ``torch.distributed``.

Every parameter / activation dimension carries a logical name; the Sharder
resolves names to mesh axes with divisibility checks (a dimension that does
not divide evenly over its candidate axis is left replicated), by the
reference's rule table:

  batch                 -> ("pod","data")   data parallel (pod extends DP)
  vocab / ffn / lru ... -> "model"          tensor parallel
  heads / kv_heads      -> "model" when BOTH divide evenly, else
                           head_dim -> "model"
  embed (params only)   -> "data"           FSDP: gather-on-use
  kv_seq                -> None baseline; "model" under SP

Models narrower than 1,024 run pure data parallel (``tp_off``); ``overrides``
apply last and can put any logical axis back on a mesh axis.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (axis names from
``mesh_dim_names``) or a `ShapeMesh`, a record of names and sizes for meshes
that exist only as plans (the 256- and 512-chip production meshes). `pspec`
gives the reference's ``PartitionSpec`` as the port's `P`; `placements`
gives DTensor's ``Shard`` / ``Replicate`` per mesh dim, where JAX builds a
``NamedSharding``; `constraint` is ``with_sharding_constraint``: a
``redistribute`` of a DTensor, the identity for a plain tensor or on a
one-rank mesh. Operations on DTensors run under `Sharder.scope`
(``implicit_replication``), so tensors the models make themselves
(positions, masks) count as replicated; those DTensor has no rule for run
on each rank's shards (``distributed/local.py``). This module imports
nothing of the models: trees of specs are walked by their fields.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


class P(tuple):
    """A partition spec: one entry per tensor dim, a mesh axis name, a tuple
    of names (sharded over their product, the first major) or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of named axes and sizes with no devices behind it (the
    reference tests' ``FakeMesh``): enough for `pspec`, `placements` and
    per-chip shapes."""
    mesh_dim_names: tuple
    shape: tuple

    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    fsdp: bool = True                 # shard params' embed dims over "data"
    seq_sharded_kv: bool = False      # SP: shard decode KV over "model" on seq
    expert_parallel: bool = False     # map experts -> "model" when divisible
    moe_2d: bool = False              # force activation-resharded expert math
    sp_attention: bool = True         # sequence-parallel attention core: for
                                      # head_dim-TP archs, reshard q/k/v to
                                      # seq-sharded full-head layout so QK^T
                                      # contracts locally (no S×S all-reduce)
    overrides: tuple = ()             # ((logical, mesh_axis-or-None), ...)


def _is_device_mesh(mesh) -> bool:
    return not isinstance(mesh, ShapeMesh)


class Sharder:
    def __init__(self, mesh, cfg, options: ShardingOptions = ShardingOptions()):
        self.mesh = mesh
        self.cfg = cfg
        self.options = options
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.axis_sizes = dict(zip(self.axis_names, (int(n) for n in mesh.shape)))
        axes = self.axis_sizes
        self.tp = axes.get("model", 1)
        self.dp = axes.get("data", 1)
        self.pod = axes.get("pod", 1)
        self.batch_axes = tuple(a for a in ("pod", "data") if a in axes)
        # arch-consistent attention TP choice
        heads_ok = (cfg.n_heads % self.tp == 0 and
                    (cfg.n_kv_heads == 0 or cfg.n_kv_heads % self.tp == 0))
        self.attn_mode = "heads" if heads_ok else "head_dim"
        self._rules = self._build_rules()

    def _build_rules(self) -> dict:
        o = self.options
        # models too narrow to amortize TP collectives run pure-DP (whisper)
        tp_off = self.cfg.d_model < 1024
        rules: dict[str, object] = {
            "batch": self.batch_axes,
            "vocab": "model",
            "ffn": "model",
            "moe_ffn": "model",
            "lru": "model",
            "lru_in": None,
            "rnn_out": "model",
            "rnn_state": "model",
            "embed": "data" if o.fsdp else None,
            "embed2": None,
            "act_embed": None,
            "seq": None,
            "kv_seq": "model" if o.seq_sharded_kv else None,
            "experts": "model" if o.expert_parallel else None,
            "layers": None,
            "heads": "model" if self.attn_mode == "heads" else None,
            "kv_heads": "model" if self.attn_mode == "heads" else None,
            "head_dim": "model" if self.attn_mode == "head_dim" else None,
            # SP-attention layout (active only in head_dim mode)
            "seq_attn": "model" if (o.sp_attention and
                                    self.attn_mode == "head_dim") else None,
            "heads_full": None,
            "head_dim_full": None,
            None: None,
        }
        if tp_off:
            for k in ("vocab", "ffn", "moe_ffn", "lru", "rnn_out", "rnn_state",
                      "heads", "kv_heads", "head_dim", "seq_attn"):
                rules[k] = None
        rules.update(dict(o.overrides))
        return rules

    # -- resolution -----------------------------------------------------------
    def _axis_size(self, mesh_axis) -> int:
        if mesh_axis is None:
            return 1
        if isinstance(mesh_axis, tuple):
            return math.prod(self._axis_size(a) for a in mesh_axis)
        return self.axis_sizes.get(mesh_axis, 1)

    def pspec(self, shape, axes) -> P:
        """Partition spec of a tensor with the given logical axes; enforces
        divisibility and one mesh axis per tensor use."""
        used = set()
        out = []
        for dim, name in zip(shape, axes):
            mesh_axis = self._rules.get(name)
            if isinstance(mesh_axis, tuple):
                mesh_axis = tuple(a for a in mesh_axis if a not in used)
                total = self._axis_size(mesh_axis)
                if mesh_axis and total > 1 and dim % total == 0:
                    out.append(mesh_axis if len(mesh_axis) > 1 else mesh_axis[0])
                    used.update(mesh_axis)
                else:
                    out.append(None)
            elif (mesh_axis is not None and mesh_axis not in used
                    and mesh_axis in self.axis_names
                    and dim % self._axis_size(mesh_axis) == 0
                    and self._axis_size(mesh_axis) > 1):
                out.append(mesh_axis)
                used.add(mesh_axis)
            else:
                out.append(None)
        return P(*out)

    def placements(self, shape, axes) -> tuple:
        """DTensor placements of `pspec`: per mesh dim ``Shard(d)`` for the
        tensor dim d it shards, else ``Replicate()``. A dim over ("pod",
        "data") is sharded on both mesh dims, pod-major as the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.axis_names)
        for d, entry in enumerate(self.pspec(shape, axes)):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    out[self.axis_names.index(name)] = Shard(d)
        return tuple(out)

    def local_shape(self, shape, axes) -> tuple:
        """Each chip's share of a tensor of ``shape`` (`pspec` divides evenly)."""
        spec = self.pspec(shape, axes)
        return tuple(dim // self._axis_size(e) for dim, e in zip(shape, spec)) + \
            tuple(shape[len(spec):])

    @property
    def distributed(self) -> bool:
        """True on a DeviceMesh of more than one rank: only then are tensors
        DTensors and constraints collectives."""
        return _is_device_mesh(self.mesh) and self.mesh.size() > 1

    def constraint(self, x, *axes):
        """``with_sharding_constraint`` by logical names: a DTensor
        redistributed to `placements`; x itself for a plain tensor or on a
        one-rank mesh (as the reference is off-mesh)."""
        from torch.distributed.tensor import DTensor

        if not self.distributed or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(x.shape, axes))

    def scope(self):
        """The context the models run DTensors in: ``implicit_replication``
        on a multi-rank mesh (a plain tensor meeting a DTensor is
        replicated), nothing otherwise. Scopes nest (`_replicating`)."""
        return _replicating() if self.distributed else contextlib.nullcontext()


_depth = [0]


@contextlib.contextmanager
def _replicating():
    """``implicit_replication`` entered by the outermost scope only: the
    context resets DTensor's flag on exit, so an inner one (``encode`` inside
    whisper's ``forward``) would end the outer one's."""
    if _depth[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _depth[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _depth[0] -= 1


def scope(sharder):
    """`Sharder.scope` of ``sharder``, or no context without one."""
    return contextlib.nullcontext() if sharder is None else sharder.scope()


def null_sharder(cfg) -> Sharder:
    """Single-device sharder (smoke tests): every constraint is a no-op. Its
    mesh is a one-rank `ShapeMesh` ("data",); it needs no process group."""
    return Sharder(ShapeMesh(("data",), (1,)), cfg)


def _is_spec(x) -> bool:
    """A ``ParamSpec`` (shape and logical axes), by its fields."""
    return hasattr(x, "shape") and hasattr(x, "axes") and not isinstance(x, torch.Tensor)


def _spec_map(fn, tree):
    """``fn`` on every spec of a tree of dicts, lists and tuples."""
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return type(tree)(_spec_map(fn, v) for v in tree)


def spec_tree_shardings(sharder: Sharder, spec_tree):
    """Map a ParamSpec tree to placements per leaf."""
    return _spec_map(lambda s: sharder.placements(s.shape, s.axes), spec_tree)


def _meta_leaf(s, sharder: Sharder, dtype):
    local = torch.empty(sharder.local_shape(s.shape, s.axes), dtype=dtype, device="meta")
    if not sharder.distributed:
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharder.mesh, sharder.placements(s.shape, s.axes),
                              run_check=False, shape=torch.Size(s.shape),
                              stride=torch.empty(s.shape, device="meta").stride())


def abstract_params(spec_tree, sharder: Sharder, dtype):
    """The dry run's stand-in arrays, no allocation: per leaf a meta tensor of
    the chip's share on a `ShapeMesh` or a one-rank mesh, a meta DTensor
    (global shape, the chip's share local) on a multi-rank DeviceMesh.
    ``dtype`` is a dtype, or a function of (leaf key, spec) giving one."""

    def walk(tree, key=None):
        if _is_spec(tree):
            dt = dtype(key, tree) if callable(dtype) else dtype
            return _meta_leaf(tree, sharder, dt)
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return type(tree)(walk(v, key) for v in tree)

    return walk(spec_tree)


def place_params(tree, sharder: Sharder, specs):
    """``jax.device_put(tree, spec_tree_shardings(sharder, specs))``: per leaf
    of ``tree`` and of its spec tree ``specs`` (``model.param_specs()``,
    ``model.cache_specs(...)``), ``distribute_tensor`` on a multi-rank mesh,
    from each rank's copy of the whole tensor (rank 0's values are
    broadcast). On a one-rank mesh the tree comes back as it is: every
    constraint is the identity there."""
    if not sharder.distributed:
        return tree
    from torch.distributed.tensor import distribute_tensor

    flat = []
    _spec_map(flat.append, specs)
    shardings = iter(sharder.placements(s.shape, s.axes) for s in flat)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return distribute_tensor(x, sharder.mesh, next(shardings))

    return put(tree)

