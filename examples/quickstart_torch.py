"""Quickstart on the PyTorch / CUDA port: SepBIT against baselines on one
synthetic cloud-block volume.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--n-lbas 16384]

The counterpart of ``examples/quickstart.py``, with its six schemes, its
trace (``mixed_trace(n, 8 * n, seed=7, burst_echo_prob=0.4)``) and its knobs
(segment 128, GP 0.15, cost-benefit selection). The six schemes replay the
trace as one heterogeneous fleet, one volume each, sharing the fleet's
shapes, on the default engine: on the card one launch of the replay kernel
for all six, stateful (dac, warcip, fk) and elementwise (nosep, sepgc,
sepbit) alike. Each row names its engine. It runs on the card unless
``--device cpu`` is given; on the CPU the engine is the step engine, the
replay kernel's plain version.
"""

import argparse

from repro_torch.core import fleetshard
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.traces import mixed_trace, trace_stats

SCHEMES = ("nosep", "sepgc", "dac", "warcip", "sepbit", "fk")
ENGINE = "replay"      # torchsim's default engine


def rows(trace, n_lbas: int, device: str) -> list[dict]:
    """One summary per scheme (``torchsim``'s fields, those of
    ``jaxsim.simulate_jax``) with the engine that replayed it, in SCHEMES'
    order. The fleet's shared config (class slots and segment pool sized
    over all six) is the ``cfg`` key of each row."""
    policy = fleetshard.encode_policies(len(SCHEMES), schemes=list(SCHEMES),
                                        selectors="cost_benefit", gp_thresholds=0.15)
    cfg = fleetshard.hetero_config(TorchSimConfig(n_lbas=n_lbas, segment_size=128), policy)
    res = fleetshard.simulate_fleet_hetero([trace] * len(SCHEMES), cfg, policy, group=False,
                                           device=device)
    return [{**vol, "engine": ENGINE, "cfg": cfg} for vol in res["volumes"]]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-lbas", type=int, default=1 << 14)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # a volume matching the paper's workload observations: static + rotating
    # + zipf-hot regions with bursty rewrites (§2.3 Obs 1-3)
    trace = mixed_trace(args.n_lbas, 8 * args.n_lbas, seed=7, burst_echo_prob=0.4)
    print("volume:", trace_stats(trace))

    out = rows(trace, args.n_lbas, args.device)
    print(f"\n{'scheme':8s} {'WA':>7s} {'GC writes':>10s} {'segments reclaimed':>19s} "
          f"{'engine':>7s}")
    for r in out:
        print(f"{r['scheme']:8s} {r['wa']:7.3f} {r['gc_writes']:10d} {r['reclaimed']:19d} "
              f"{r['engine']:>7s}")
    print("\nSepBIT separates blocks by inferred invalidation time (BIT);"
          "\nFK is the future-knowledge bound (paper §2.2).")
    return out


if __name__ == "__main__":
    main()
