"""The port's examples (``examples/quickstart_torch.py`` and
``examples/trace_sim_torch.py``) run with ``--device cpu`` at a small size,
each row bit-equal to ``jaxsim.simulate_jax`` on the same trace and knobs;
``examples/train_lm_torch.py`` trains, checkpoints and resumes on the CPU;
the LM examples print their JAX twins' write amplification for the MoE,
hybrid and SSM archs."""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import fleetshard as jfleetshard
from repro.core import jaxsim, traces
from repro.core.jaxsim import JaxSimConfig

ROOT = Path(__file__).resolve().parents[1]
# the LM examples' archs beyond the dense family; paligemma-3b served and trained on
# tokens alone, as the JAX examples run it (they give whisper-small no frames)
BLOCK_ARCHS = ["granite-moe-3b-a800m", "recurrentgemma-2b", "rwkv6-3b", "paligemma-3b"]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in ("engine", "cfg", "wall_s")}


def test_quickstart_rows_match_simulate_jax(capsys):
    """Six schemes in one fleet at the fleet's shared shapes: each row
    equals ``simulate_jax`` of its volume's policy at those shapes."""
    mod = _example("quickstart_torch")
    n = 128
    rows = mod.main(["--device", "cpu", "--n-lbas", str(n)])
    assert "engine" in capsys.readouterr().out
    assert [r["scheme"] for r in rows] == list(mod.SCHEMES)
    assert [r["engine"] for r in rows] == ["replay"] * len(mod.SCHEMES)
    trace = traces.mixed_trace(n, 8 * n, seed=7, burst_echo_prob=0.4)
    policy = jfleetshard.encode_policies(len(mod.SCHEMES), schemes=list(mod.SCHEMES),
                                         selectors="cost_benefit", gp_thresholds=0.15)
    jcfg = jfleetshard.hetero_config(JaxSimConfig(n_lbas=n, segment_size=128), policy)
    cfg = dataclasses.asdict(rows[0]["cfg"])
    # the port's own knobs (the numpy loop's Exp#2 and Exp#5), at JAX's behaviour
    assert {k: cfg.pop(k) for k in ("gc_batch_segments", "fifo_occupancy")} == {
        "gc_batch_segments": 1, "fifo_occupancy": False}
    assert cfg == {
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k not in ("use_kernels", "kernels_interpret")}
    for i, row in enumerate(rows):
        assert _summary(row) == jaxsim.simulate_jax(trace, jcfg, policy.volume(i)), row["scheme"]
        assert row["reclaimed"] > 0


def test_trace_sim_rows_match_simulate_jax(capsys):
    mod = _example("trace_sim_torch")
    rows = mod.main(["--device", "cpu", "--n-lbas", "256", "--traffic", "4", "--segment", "16",
                     "--selector", "greedy", "--schemes", "sepbit,fk"])
    assert "best:" in capsys.readouterr().out
    trace = traces.mixed_trace(256, 1024, seed=0, alpha=1.0)
    assert [r["engine"] for r in rows] == ["replay", "replay"]
    for row in rows:
        jcfg = JaxSimConfig(n_lbas=256, segment_size=16, selector="greedy", scheme=row["scheme"])
        assert _summary(row) == jaxsim.simulate_jax(trace, jcfg), row["scheme"]
        assert row["reclaimed"] > 0


def test_trace_sim_replays_an_alibaba_csv(tmp_path):
    """``--alibaba-csv``: a small trace in the Alibaba block-trace format,
    written here, loaded by the port's copy of the loader and replayed under
    an explicit ``--engine step``."""
    rng = np.random.default_rng(4)
    hot = rng.integers(0, 64, 900)
    lines = [f"7,W,{4096 * int(b) + 512 * (i % 3)},{4096 * (1 + i % 2)},{i}"
             for i, b in enumerate(hot)]
    lines += [f"7,R,{4096 * i},4096,{i}" for i in range(20)]
    path = tmp_path / "alibaba.csv"
    path.write_text("\n".join(lines) + "\n")
    mod = _example("trace_sim_torch")
    rows = mod.main(["--device", "cpu", "--alibaba-csv", str(path), "--segment", "8",
                     "--schemes", "nosep,dac", "--engine", "step"])
    trace = traces.load_alibaba_csv(str(path))
    assert [r["engine"] for r in rows] == ["step", "step"]
    for row in rows:
        jcfg = JaxSimConfig(n_lbas=int(trace.max()) + 1, segment_size=8, scheme=row["scheme"])
        assert _summary(row) == jaxsim.simulate_jax(trace, jcfg), row["scheme"]
        assert row["reclaimed"] > 0


@pytest.mark.parametrize("name,entry,argv", [
    ("quickstart_torch", "rows", ["--n-lbas", "64"]),
    ("trace_sim_torch", "rows", ["--n-lbas", "64"]),
    ("train_lm_torch", "train", ["--steps", "2"])])
def test_examples_run_on_the_card_by_default(name, entry, argv, monkeypatch):
    """Without ``--device`` the examples replay (or train) on
    ``device="cuda"``, which raises where CUDA is missing
    (``resolve_device``), never a quiet run on the CPU."""
    mod = _example(name)
    seen = []

    def stop(*args, **kw):
        seen.append(kw["device"] if "device" in kw else args[-1])
        raise RuntimeError("stop")

    monkeypatch.setattr(mod, entry, stop)
    with pytest.raises(RuntimeError, match="stop"):
        mod.main(argv)
    assert seen == ["cuda"]


def test_train_lm_resumes_and_reports_the_stores_wa(tmp_path, capsys):
    """``train_lm_torch.py --device cpu`` on a smoke arch: 30 steps whose
    loss falls (the last five's mean at least 0.5 under the first, the JAX
    package's test_loss_decreases margin), a checkpoint every 10 steps and
    at the end; ``--resume`` with more steps continues from the latest
    manifest (step 29) and prints the store's WA both times."""
    mod = _example("train_lm_torch")
    argv = ["--device", "cpu", "--arch", "stablelm-1.6b", "--batch", "8", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"]
    first = mod.main(argv + ["--steps", "30"])
    out = capsys.readouterr().out
    losses = first["losses"]
    assert first["start"] == 0 and len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5, losses[::6]
    assert "checkpoint-store WA=" in out and first["wa"] >= 1.0
    again = mod.main(argv + ["--steps", "34", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 29" in out and "checkpoint-store WA=" in out
    assert again["start"] == 30 and len(again["losses"]) == 4
    assert np.isfinite(again["losses"]).all()
    assert np.mean(again["losses"]) < losses[0] - 0.5


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_serve_paged_prints_the_jax_examples_wa(arch, monkeypatch, capsys):
    """``serve_paged_torch.py --device cpu --arch <arch>`` prints the page
    store's WA lines and its cut that ``examples/serve_paged.py`` prints for
    the same flags."""
    args = ["--arch", arch, "--requests", "24"]
    _example("serve_paged_torch").main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve_paged.py", *args])
    _example("serve_paged").main()
    want = capsys.readouterr().out
    lines = [re.findall(r"^(\w+ *: compaction WA=[\d.]+ gc_pages=\d+)", out, re.M)
             + re.findall(r"SepBIT cuts .* by [\d.]+%", out) for out in (got, want)]
    assert len(lines[0]) == 3 and lines[0] == lines[1], (got, want)


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_train_lm_prints_the_jax_examples_wa(arch, tmp_path, monkeypatch, capsys):
    """``train_lm_torch.py --device cpu --steps 2 --arch <arch>``: finite
    losses and the checkpoint store's WA line of ``examples/train_lm.py``
    with the same flags."""
    args = ["--arch", arch, "--steps", "2", "--seq", "32"]
    run = _example("train_lm_torch").main(args + ["--device", "cpu", "--ckpt-dir",
                                                  str(tmp_path / "port")])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir", str(tmp_path / "jax")])
    _example("train_lm").main()
    want = capsys.readouterr().out
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    wa = [re.findall(r"checkpoint-store WA=[\d.]+", out) for out in (got, want)]
    assert len(wa[0]) == 1 and wa[0] == wa[1], (got, want)
