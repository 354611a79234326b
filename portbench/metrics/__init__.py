"""One reader per metric, in ``<metric name>.py``: ``read(run)`` returns the
metric's value from a finished run (`portbench.run.Run`), or None where the
run holds nothing to read it from; the harness then leaves it out."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
