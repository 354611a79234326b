"""Full placement-scheme comparison on a chosen workload (the paper's Exp#1
command line) on the PyTorch / CUDA port.

    PYTHONPATH=src python examples/trace_sim_torch.py --workload mixed --alpha 1.0 \
        --selector cost_benefit [--schemes sepbit,dac,fk] [--alibaba-csv path] \
        [--engine replay|step] [--device cpu]

The counterpart of ``examples/trace_sim.py``, with its flags and its table:
each scheme replays the trace on one volume (``torchsim.simulate``), and the
row gives its WA, GC writes and wall time. ``--engine`` picks the engine of
every scheme: the replay kernel by default, which takes all 14 schemes, or
the step engine; each row names its engine. It runs on the card unless
``--device cpu`` is given; on the CPU both engines are the step engine.
``--alibaba-csv`` replays a trace in the Alibaba Cloud block-trace format
instead of a synthetic one.
"""

import argparse
import time

from repro_torch.core import torchsim
from repro_torch.core.config import SCHEME_NAMES, TorchSimConfig
from repro_torch.core.traces import GENERATORS, load_alibaba_csv, trace_stats


def rows(trace, schemes, *, segment: int, gp: float, selector: str, engine: str,
         device: str) -> list[dict]:
    """One summary per scheme (``torchsim``'s fields, those of
    ``jaxsim.simulate_jax``), with its engine and wall time in s."""
    out = []
    n_lbas = int(trace.max()) + 1
    for scheme in schemes:
        cfg = TorchSimConfig(n_lbas=n_lbas, segment_size=segment, gp_threshold=gp,
                             selector=selector, scheme=scheme)
        t0 = time.perf_counter()
        r = torchsim.simulate(trace, cfg, device=device, engine=engine)
        out.append({**r, "engine": engine, "wall_s": time.perf_counter() - t0})
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mixed", choices=list(GENERATORS))
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--n-lbas", type=int, default=1 << 14)
    ap.add_argument("--traffic", type=float, default=8.0, help="× WSS")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segment", type=int, default=128)
    ap.add_argument("--gp", type=float, default=0.15)
    ap.add_argument("--selector", default="cost_benefit", choices=["greedy", "cost_benefit"])
    ap.add_argument("--schemes", default=",".join(SCHEME_NAMES))
    ap.add_argument("--alibaba-csv", default=None,
                    help="replay a real Alibaba-format block trace instead")
    ap.add_argument("--engine", default="replay", choices=list(torchsim.ENGINES),
                    help="the engine of every scheme (default: replay, the replay kernel)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.alibaba_csv:
        trace = load_alibaba_csv(args.alibaba_csv)
    else:
        gen = GENERATORS[args.workload]
        kw = {"seed": args.seed}
        if args.workload in ("zipf", "shifting", "mixed", "bursty"):
            kw["alpha"] = args.alpha
        trace = gen(args.n_lbas, int(args.traffic * args.n_lbas), **kw)
    print("workload:", trace_stats(trace))

    out = rows(trace, args.schemes.split(","), segment=args.segment, gp=args.gp,
               selector=args.selector, engine=args.engine, device=args.device)
    print(f"\n{'scheme':8s} {'WA':>8s} {'gc_writes':>10s} {'wall_s':>7s} {'engine':>7s}")
    for r in out:
        print(f"{r['scheme']:8s} {r['wa']:8.4f} {r['gc_writes']:10d} {r['wall_s']:7.2f} "
              f"{r['engine']:>7s}")
    best = min(out, key=lambda r: r["wa"])
    print(f"\nbest: {best['scheme']} (WA={best['wa']:.4f})")
    return out


if __name__ == "__main__":
    main()
