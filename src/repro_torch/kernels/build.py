"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C entry point and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root, at
first use. The hash covers the source and the flags, so an edited source
builds anew and a finished build is reused. The kernels target Hopper
(``sm_90a``) and are built with ``-fmad=false`` and without fast math: the
replay engine is an integer state machine whose float scores and class
thresholds must match the plain PyTorch versions bit for bit, and the Zipf
sums need the full-precision ``expf`` and ``log1pf``. A kernel that wants a
fused multiply-add asks for it with ``fmaf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"segsel": "segsel.cu", "classify": "classify.cu", "zipfprob": "zipfprob.cu",
           "decode_attn": "decode_attn.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                           "are built on the machine with the card")
    return path


def target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each compiler's output (register
    and shared-memory use, from ``-Xptxas=-v``); raises if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)     # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with the
    ``argtypes`` of each C entry point set from ``signatures`` and every
    ``restype`` int (the entry points return ``cudaGetLastError()``)."""
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(target(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
