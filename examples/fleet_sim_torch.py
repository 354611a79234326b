"""Fleet-scale batched replay on the PyTorch / CUDA port.

The counterpart of ``examples/fleet_sim.py``, with the same flags and rows:
it replays a fleet of synthetic volumes and prints per-volume and aggregate
WA. It runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/fleet_sim_torch.py --volumes 16 --workload mixed \
        [--scheme sepbit] [--selector cost_benefit] [--engine replay|step] [--device cpu]

``--sweep`` replays a policy grid, every volume its own (scheme, selector,
gp_threshold) cell, grouped by scheme unless ``--ungrouped``, split across
the visible CUDA devices:

    PYTHONPATH=src python examples/fleet_sim_torch.py --sweep --volumes 72 \
        [--schemes nosep,sepgc,sepbit] [--selectors greedy,cost_benefit] \
        [--gp-grid 0.10,0.15,0.20]

``--timing`` turns on the latency model (p50 / p99 / max write latency per
volume and for the fleet); ``--gcsched`` picks the GC schedule (greedy |
rate_limited | idle_window) for the whole fleet:

    PYTHONPATH=src python examples/fleet_sim_torch.py --volumes 8 --timing \
        --gcsched rate_limited

``--engine replay`` (the default) is one launch of the replay kernel on the
card for any mix of the 14 schemes, the stateful ones (fk, dac, ml, sfs,
eti, mq, sfr, fadac, warcip) included; ``--engine step`` runs the step
engine there. On the CPU both engines are the step engine.
"""

import argparse
import time

import numpy as np

from repro_torch.core.config import GCSCHED_NAMES, SCHEME_NAMES, TorchSimConfig
from repro_torch.core.fleetshard import simulate_fleet_sweep
from repro_torch.core.torchsim import ENGINES, pad_fleet, simulate_fleet
from repro_torch.core.tracegen import FLEET_GENERATORS, make_fleet, tiled_fleet


def run_sweep(args) -> None:
    schemes = args.schemes.split(",")
    selectors = args.selectors.split(",")
    gp_grid = [float(x) for x in args.gp_grid.split(",")]
    n_cells = len(schemes) * len(selectors) * len(gp_grid)
    per_cell = max(args.volumes // n_cells, 1)
    n_updates = int(args.traffic * args.n_lbas)
    traces = tiled_fleet(args.workload, n_cells, per_cell, args.n_lbas, n_updates,
                         jitter=args.jitter, seed=args.seed)
    cfg = TorchSimConfig(n_lbas=args.n_lbas, segment_size=args.segment, timing=args.timing)
    print(f"sweep: {n_cells} policy cells × {per_cell} volumes ({len(traces)} total), "
          f"workload={args.workload}, gcsched={args.gcsched}, engine={args.engine}, "
          f"device={args.device}")

    t0 = time.perf_counter()
    res = simulate_fleet_sweep(traces, cfg, schemes=schemes, selectors=selectors,
                               gp_thresholds=gp_grid, gcsched=args.gcsched,
                               group=not args.ungrouped, engine=args.engine, device=args.device)
    dt = time.perf_counter() - t0

    lat_cols = " " + f"{'p50':>7s} {'p99':>7s}" if args.timing else ""
    print(f"\n{'scheme':>8s} {'selector':>14s} {'gp':>5s} {'vols':>5s} "
          f"{'WA':>8s} {'medianWA':>9s}{lat_cols}")
    for row in res["sweep"]:
        lat = f" {row['lat_p50']:7.2f} {row['lat_p99']:7.2f}" if args.timing else ""
        print(f"{row['scheme']:>8s} {row['selector']:>14s} {row['gp_threshold']:5.2f} "
              f"{row['n_volumes']:5d} {row['wa']:8.4f} {row['median_wa']:9.4f}{lat}")
    best = min(res["sweep"], key=lambda r: r["wa"])
    f = res["fleet"]
    print(f"\nbest cell: {best['scheme']}/{best['selector']}/gp={best['gp_threshold']:.2f} "
          f"(WA={best['wa']:.4f})")
    print(f"{f['n_volumes'] / dt:.2f} volumes/s (incl. kernel build on first use) on "
          f"{f['n_devices']} device(s), {f['n_scheme_groups']} scheme group(s), "
          f"overflow={f['overflow']}, degraded={f['degraded']}")
    if args.timing:
        lat = f["latency"]
        print(f"fleet latency: p50={lat['p50']:.2f} p99={lat['p99']:.2f} "
              f"max={lat['max']:.2f} gc_debt={lat['gc_debt']:.1f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", type=int, default=16)
    ap.add_argument("--workload", default="mixed", choices=["mixed", *FLEET_GENERATORS])
    ap.add_argument("--n-lbas", type=int, default=512)
    ap.add_argument("--traffic", type=float, default=4.0, help="updates × WSS")
    ap.add_argument("--jitter", type=float, default=0.25,
                    help="per-volume trace-length spread (0 = uniform)")
    ap.add_argument("--segment", type=int, default=32)
    ap.add_argument("--scheme", default="sepbit", choices=list(SCHEME_NAMES))
    ap.add_argument("--selector", default="cost_benefit", choices=["greedy", "cost_benefit"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing", action="store_true",
                    help="turn on the latency model and print write-latency percentiles")
    ap.add_argument("--gcsched", default="greedy", choices=list(GCSCHED_NAMES),
                    help="GC scheduling policy (fleet-wide)")
    ap.add_argument("--engine", default="replay", choices=list(ENGINES),
                    help="replay: the replay kernel on the card; step: the step engine")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--sweep", action="store_true",
                    help="heterogeneous policy-grid sweep (every volume its own "
                         "scheme/selector/gp)")
    ap.add_argument("--schemes", default=",".join(SCHEME_NAMES),
                    help="sweep: comma-separated schemes (default: every scheme)")
    ap.add_argument("--selectors", default="greedy,cost_benefit",
                    help="sweep: comma-separated selectors")
    ap.add_argument("--gp-grid", default="0.10,0.15,0.20",
                    help="sweep: comma-separated GP thresholds")
    ap.add_argument("--ungrouped", action="store_true",
                    help="sweep: one replay for the whole fleet instead of one per scheme group")
    args = ap.parse_args()

    if args.sweep:
        run_sweep(args)
        return

    traces = make_fleet(args.workload, args.volumes, args.n_lbas,
                        int(args.traffic * args.n_lbas), jitter=args.jitter, seed=args.seed)
    cfg = TorchSimConfig(n_lbas=args.n_lbas, segment_size=args.segment, scheme=args.scheme,
                         selector=args.selector, timing=args.timing, gc_sched=args.gcsched)
    padded = pad_fleet(traces)
    print(f"fleet: {args.volumes} volumes, {padded.shape[1]} padded steps, "
          f"{len({len(t) for t in traces})} distinct lengths, "
          f"scheme={args.scheme}/{args.selector}, gcsched={args.gcsched}, "
          f"engine={args.engine}, device={args.device}")

    t0 = time.perf_counter()
    res = simulate_fleet(padded, cfg, device=args.device, engine=args.engine)
    dt = time.perf_counter() - t0

    lat_cols = f" {'p99':>7s} {'maxlat':>7s}" if args.timing else ""
    print(f"\n{'vol':>4s} {'writes':>8s} {'gc_writes':>10s} {'WA':>8s}{lat_cols}")
    for i, r in enumerate(res["volumes"]):
        lat = (f" {r['latency']['p99']:7.2f} {r['latency']['max']:7.2f}"
               if args.timing else "")
        print(f"{i:4d} {r['user_writes']:8d} {r['gc_writes']:10d} {r['wa']:8.4f}{lat}")
    f = res["fleet"]
    wa = np.asarray(f["per_volume_wa"])
    print(f"\naggregate WA={f['wa']:.4f}  per-volume median={np.median(wa):.4f} "
          f"[{wa.min():.4f}, {wa.max():.4f}]")
    print(f"{f['n_volumes'] / dt:.2f} volumes/s (incl. kernel build on first use), "
          f"overflow={f['overflow']}, degraded={f['degraded']}")
    if args.timing:
        lat = f["latency"]
        print(f"fleet latency: p50={lat['p50']:.2f} p99={lat['p99']:.2f} "
              f"max={lat['max']:.2f} gc_debt={lat['gc_debt']:.1f}")


if __name__ == "__main__":
    main()
