"""The chip path holds no JAX: not by import, and not in the process after a
run (by whole top-level module names: ``repro_torch`` is the port, ``repro``
the JAX package)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as bench

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in bench.FORBIDDEN, (path, name)


def test_forbidden_modules_match_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping", "reproducer"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench.forbidden_modules() == []
    for name in ("repro.core", "jax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench.forbidden_modules() == ["jax", "repro.core"]


def test_a_tiny_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]\n"
            "from tiny import tiny_cell\n"
            "from portbench import run\n"
            "run.WARM_JOBS = 0\n"
            "res = run.run_cell(tiny_cell(), 5, 0.0, False, device='cpu')\n"
            "print(res['correct'], run.forbidden_modules())\n"
            % (str(ROOT / "src"), str(ROOT), str(HERE / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def test_benchmark_files_are_found_by_name():
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench_json["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
    for w in bench_json["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_without_a_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would run")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "corpus128m.sepbit_gp4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
