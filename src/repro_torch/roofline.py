"""Roofline analysis from dry-run records, the twin of the JAX package's
``roofline.py`` for the NVIDIA H100 SXM5.

Hardware model (per GPU, NVIDIA's H100 datasheet, SXM5 column):
  peak bf16 compute   989 TFLOP/s dense (1,979 with 2:4 sparsity, not used)
  HBM3 bandwidth      3.35 TB/s
  NVLink 4            900 GB/s per GPU in both directions, 450 GB/s in each;
                      the collective term takes one direction
                      (collective_bytes are per chip, the dry run counting
                      each rank's own collectives, so the term is
                      per_chip_bytes / 450e9)

A 16-wide model axis spans two 8-GPU HGX nodes, whose link between nodes
(InfiniBand or Ethernet) is several times slower than NVLink, so the
collective term is optimistic on the production meshes. That is stated, not
modelled.

Terms (seconds per step, per chip):
  compute    = flops / 989e12
  memory     = bytes_accessed / 3.35e12   (unfused: an upper bound)
  collective = collective_bytes / 450e9

MODEL_FLOPS: 6·N·D for train (N = active params for MoE, D = global tokens),
2·N·D for prefill / decode (forward only), divided over the chips; the ratio
MODEL_FLOPS / flops exposes recompute, dispatch and replicated work.
"""

from __future__ import annotations

import dataclasses
import json

PEAK_FLOPS = 989e12      # H100 SXM5, dense bf16 tensor cores (NVIDIA H100 datasheet)
HBM_BW = 3.35e12         # H100 SXM5 HBM3 (datasheet)
LINK_BW = 450e9          # NVLink 4, one direction of 900 GB/s per GPU (datasheet)


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float          # counted bytes (unfused upper bound)
    collective_s: float
    dominant: str
    model_flops_per_chip: float
    hlo_flops_per_chip: float
    useful_ratio: float
    memory_lo_s: float = 0.0  # analytic fusion-optimistic bound
    note: str = ""

    def bound(self) -> float:
        """Step-time bound using the realistic (analytic) memory term."""
        return max(self.compute_s, self.memory_lo_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the step bound that is the compute term at the
        *useful* flops — the score the perf pass pushes up."""
        if self.bound() <= 0:
            return 0.0
        return (self.model_flops_per_chip / PEAK_FLOPS) / self.bound()


def _tokens(shape_name: str, seq: int, batch: int, kind: str) -> int:
    if kind == "decode":
        return batch           # one new token per sequence
    return seq * batch


def analytic_memory_bytes(cfg, shape, chips: int, mesh_model: int = 16,
                          mesh_data: int = 16) -> float:
    """Fusion-optimistic HBM traffic per chip per step (lower bound).

    The counted bytes assume every intermediate round-trips HBM (no
    fusion). This model counts what *must* move: parameter reads per pass,
    optimizer-state update traffic, activation-checkpoint writes+reads,
    KV-cache traffic, and fp32 logits. The true memory term lies between
    this and the counted number.
    """
    P = cfg.n_params()
    p_bytes = 2  # bf16
    d = cfg.d_model
    tok_chip = _tokens(shape.name, shape.seq_len, shape.global_batch,
                       shape.kind) / mesh_data / (chips // (mesh_model * mesh_data))
    L = cfg.n_layers + cfg.encoder_layers
    act = tok_chip * d * 2  # bf16 activations at layer boundary
    vocab_shard = cfg.vocab / mesh_model
    kv_dim = max(cfg.n_kv_heads, 1) * cfg.hd

    if shape.kind == "train":
        passes = 3 if cfg.remat else 2          # fwd + (remat fwd) + bwd
        opt_b = {"float32": 16, "bfloat16": 8}[cfg.optimizer_dtype]
        param_traffic = P * p_bytes * passes / mesh_model  # gathered per chip slice-of-model
        opt_traffic = P * opt_b / chips * 2                # read+write sharded moments
        act_traffic = act * L * 3                          # write + remat read + bwd read
        logits = tok_chip * vocab_shard * 4 * 3
        return param_traffic + opt_traffic + act_traffic + logits
    if shape.kind == "prefill":
        param_traffic = P * p_bytes / mesh_model
        act_traffic = act * L * 2
        kv_write = tok_chip * kv_dim * 2 * 2 * cfg.n_layers / mesh_model
        return param_traffic + act_traffic + kv_write
    # decode: every live parameter + the KV history crosses HBM once
    param_traffic = P * p_bytes / mesh_model
    kv_hist = (shape.global_batch / mesh_data) * shape.seq_len * kv_dim * 2 * 2 \
        * cfg.n_layers / mesh_model
    if cfg.family in ("ssm",):
        kv_hist = (shape.global_batch / mesh_data) * cfg.n_heads * cfg.rnn_head_dim ** 2 \
            * 4 * cfg.n_layers / mesh_model
    if cfg.family == "hybrid":
        kv_hist = (shape.global_batch / mesh_data) * (
            min(cfg.window, shape.seq_len) * kv_dim * 2 * 2 * (cfg.n_layers // 3)
            + (cfg.lru_width or d) * 4 * cfg.n_layers) / mesh_model
    return param_traffic + kv_hist + tok_chip * d * 2 * L


def analyze_cell(rec: dict, cfg, shape) -> RooflineRow | None:
    if rec.get("status") != "ok" or "flops" not in rec:
        return None
    chips = rec["n_chips"]
    flops = rec["flops"]                    # per chip
    nbytes = rec["bytes_accessed"]
    coll = rec["collective_bytes"]["total"]
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = coll / LINK_BW
    mem_lo = analytic_memory_bytes(cfg, shape, chips) / HBM_BW
    # dominant term judged with the realistic memory bound (the counted
    # bytes assume zero fusion and would mark every cell memory-bound)
    dom = max(("compute", compute_s), ("memory", mem_lo),
              ("collective", collective_s), key=lambda kv: kv[1])[0]

    n_active = cfg.n_active_params()
    tokens = _tokens(rec["shape"], shape.seq_len, shape.global_batch, shape.kind)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens / chips
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dom,
        model_flops_per_chip=model_flops,
        hlo_flops_per_chip=flops,
        useful_ratio=model_flops / flops if flops else 0.0,
        memory_lo_s=mem_lo,
    )


NOTES = {
    "compute": "reduce recompute (remat policy) / MoE dispatch padding; "
               "raise useful-flops ratio",
    "memory": "fuse/avoid fp32 logits round-trips; microbatch to shrink "
              "activation working set; bf16 collectives",
    "collective": "reshard to cut all-gathers (FSDP prefetch), overlap "
                  "reduce-scatter with backward, compress DCN hop",
}


def build_table(dryrun_json: str, mesh: str = "16x16") -> list[RooflineRow]:
    from .configs import SHAPES, get_config

    rows = []
    with open(dryrun_json) as f:
        records = json.load(f)
    for rec in records:
        if rec.get("mesh") != mesh:
            continue
        if rec.get("status") == "skipped":
            continue
        row = analyze_cell(rec, get_config(rec["arch"]), SHAPES[rec["shape"]])
        if row is not None:
            row.note = NOTES[row.dominant]
            rows.append(row)
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'mem_hi_s':>10s} "
           f"{'mem_lo_s':>10s} {'collect_s':>10s} {'dom':>10s} {'useful':>7s} "
           f"{'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.compute_s:10.2e} {r.memory_s:10.2e} "
            f"{r.memory_lo_s:10.2e} {r.collective_s:10.2e} {r.dominant:>10s} "
            f"{r.useful_ratio:7.2f} {100*r.roofline_fraction():6.1f}%")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-json", default=".cache/dryrun_all.json")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(format_table(build_table(args.dryrun_json, args.mesh)))


if __name__ == "__main__":
    main()
