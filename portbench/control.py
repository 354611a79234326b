"""The control of a cell's comparison: the reference computed in bfloat16,
the precision below the configuration's float32, put in the program's
place. A sound comparison has to find it wrong.

    python3 portbench/control.py --workload <cell> --seeds <n>[,<n>...]

For each seed it makes the cell's corpus as a run does, draws the run's
sample of volumes, replays each by the float32 reference and by the
control, and judges the control's answers as a run's are judged
(`check.judge`, over the sampled volumes), printing every number compared
beside its limit and whether the control came out correct. The control is
CPU work, but the corpus is made on the card, as a run makes it, so that
its volumes are a run's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell: dict, seed: int, device: str = "cuda") -> dict:
    """The control's answers on one seed's sample, judged by `check.judge`
    against the float32 reference."""
    from portbench import check, traffic
    from portbench.jobs import Job
    config, mix = cell["config"], cell["traffic"]
    seed = int(seed) % 2 ** 63
    corpus = traffic.make_corpus(mix, config["volumes"], config["n_lbas"], seed, device)
    job = Job(config, mix, corpus.cpu().numpy(), device)
    del corpus
    picks = check.sample(job, seed, mix["check"]["sample_volumes"])
    want = check.reference_outputs(job, picks)
    got = check.reference_outputs(job, picks, "bfloat16")
    checks = check.judge(job, [check.arrays([got[k] for k in picks])], 0, want, rows=picks)
    return {"seed": seed, "picks": picks, "correct": check.correct(checks), "checks": checks,
            "wa": {k: [(r["user_writes"] + r["gc_writes"]) / r["user_writes"]
                       for r in (want[k], got[k])] for k in picks}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.jobs import load_cell
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(cell, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
