"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's corpus on the card from the seed (`traffic`), brings
it to the host, where users hold their traces, and runs two whole jobs to
build and warm what the job uses. The window is a closed loop: one caller
submits the cell's job (`jobs.Job`: one call of the port's entry, which
returns per-volume summaries) after another until ``--seconds`` have
passed, the last job finishing. With ``--trace 1`` the window runs under
``torch.profiler``, and the per-layer metrics are read from it. After the
window the answers are judged (`check`), and the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines of
standard error).

Metrics are found by name: ``BENCHMARK.json`` lists the cell's metrics and
``metrics/<name>.py`` reads each. The kernels the port builds go to
``build/kernels`` in the checkout, so only a checkout's first run builds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the process may not hold once the window closes:
# JAX and the JAX package (the port, repro_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_JOBS = 2


class Run:
    """What a finished run holds for the metric readers: the cell's
    configuration, its job, the window's jobs as (start, end, user writes)
    on the host clock, each job's answers (`check.arrays`), the set-up
    seconds and, with ``--trace 1``, the `tracing.Trace`."""

    def __init__(self, config, job, jobs, outs, setup_s, trace):
        self.config, self.job, self.jobs, self.outs = config, job, jobs, outs
        self.setup_s, self.trace = setup_s, trace


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0) -> dict:
    """Set up, run the window, judge it; returns the result line's object."""
    import torch

    from portbench import check, tracing, traffic
    from portbench.jobs import Job
    from portbench.metrics import reader

    config, mix = cell["config"], cell["traffic"]
    seed = int(seed) % 2 ** 63
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels import build
        build.BUILD_DIR = ROOT / "build" / "kernels"
    corpus = traffic.make_corpus(mix, config["volumes"], config["n_lbas"], seed, device)
    host = corpus.cpu().numpy()
    del corpus
    job = Job(config, mix, host, device)
    # two warm-up jobs: the first loads the kernel and lays out the inputs;
    # the host's fresh memory is still slow in the second's copies (the
    # window's first jobs ran 15-60 % long after one)
    for _ in range(WARM_JOBS):
        job.run()
    setup_s = time.perf_counter() - t0
    log(f"[setup] {setup_s:.3f} s; {job.n_volumes} volumes, {job.total_writes} user writes a "
        f"job, {host.shape[1]} steps")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    jobs, answers, failed = [], [], 0
    with tracing.profiled(trace) as prof:
        first = time.perf_counter()
        while True:
            start = time.perf_counter()
            try:
                with tracing.job_span(trace):
                    volumes = job.run()
            except Exception as exc:        # a job that raises is counted, and ends the window
                log(f"[window] job {len(jobs)} raised {type(exc).__name__}: {exc}")
                failed += 1
                break
            end = time.perf_counter()
            jobs.append((start, end, job.total_writes))
            answers.append(volumes)
            if end - first >= seconds:
                break
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = tracing.from_profiler(prof) if prof is not None and answers else None
    del prof
    if cuda:
        torch.cuda.empty_cache()
    log(f"[window] {len(jobs)} jobs in {jobs[-1][1] - jobs[0][0]:.3f} s, each "
        f"{', '.join(f'{e - s:.3f}' for s, e, _ in jobs)} s" if jobs
        else "[window] no job completed")

    outs = [check.arrays(v) for v in answers]
    picks = check.sample(job, seed, mix["check"]["sample_volumes"])
    t_ref = time.perf_counter()
    # one process a sampled volume on the card's host; in this one on the CPU
    ref = check.reference_outputs(job, picks, workers=0 if cuda else 1)
    log(f"[check] reference on volumes {picks}: {time.perf_counter() - t_ref:.1f} s")
    checks = check.judge(job, outs, failed, ref)
    failed += checks["volumes_missing"][0]

    run = Run(config, job, jobs, outs, setup_s, traced)
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in names:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": check.correct(checks), "attempted": len(jobs) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None and traced.jobs:
        lo, hi = traced.window
        dev["busy_s"] = tracing.busy_us(traced) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = tracing.breakdown(traced)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.jobs import load_cell
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("the port (src/repro_torch) is not in this checkout")
        return 2
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"the process holds JAX or the JAX package after the window: {', '.join(found)}")
        return 3
    for name, (value, limit) in result["checks"].items():
        log(f"check {name}: {value} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
