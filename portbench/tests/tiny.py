"""A tiny cell for the tests: a cell of ``BENCHMARK.json`` with its
configuration cut to a few small volumes (its traffic and job as they are),
so that a run goes through the port's step engine on the CPU in seconds."""

import copy

from portbench.jobs import load_cell


def tiny_cell(name: str = "corpus512m.sepbit", n_lbas: int = 256, volumes: int = 6,
              segment_size: int = 16, sample: int = 4) -> dict:
    cell = copy.deepcopy(load_cell(name))
    cell["config"].update(n_lbas=n_lbas, volumes=volumes, segment_size=segment_size)
    cell["traffic"]["check"]["sample_volumes"] = sample
    return cell
