"""The plain reference against the port's step engine on the CPU, field for
field, on a few small volumes and thresholds; its control in bfloat16
differs."""

import numpy as np
import pytest
import torch

from portbench import reference, traffic
from repro_torch.core import fleetshard, torchsim
from repro_torch.core.config import TorchSimConfig
from repro_torch.core.placement.schemes import SCHEME_NAMES

MIX = {"families": [{"kind": "zipf", "alpha": [0.6, 1.0, 1.4]},
                    {"kind": "zipf", "alpha": [0.0, 0.5]}],
       "updates_per_lba": 3, "jitter": 0.25}
FIELDS = ("user_writes", "gc_writes", "reclaimed", "overflow", "class_user_writes",
          "class_gc_writes", "ell")


@pytest.mark.parametrize("gp,segment", [(0.10, 8), (0.25, 16)])
def test_reference_equals_the_step_engine(gp, segment):
    n = 384
    corpus = traffic.make_corpus(MIX, 3, n, 7, "cpu").numpy()
    cfg = TorchSimConfig(n_lbas=n, segment_size=segment, gp_threshold=gp, class_slots=6)
    got = torchsim.simulate_fleet(corpus, cfg, device="cpu")["volumes"]
    rows = reference.pool_rows(n, segment, gp, 6)
    assert rows == cfg.s_max
    for trace, vol in zip(corpus, got):
        want = reference.replay(trace, n_lbas=n, segment_size=segment, gp_threshold=gp,
                                n_segments=rows)
        assert want["reclaimed"] > 0
        assert {f: vol[f] for f in FIELDS} == want
        ctl = reference.replay(trace, n_lbas=n, segment_size=segment, gp_threshold=gp,
                               n_segments=rows, precision="bfloat16")
        assert ctl != want


def test_every_scheme_equals_the_step_engine():
    """One volume under each of the 14 schemes, in one fleet."""
    n, segment = 256, 8
    corpus = traffic.make_corpus(MIX, 1, n, 11, "cpu").numpy()
    fleet = np.repeat(corpus, len(SCHEME_NAMES), axis=0)
    policy = fleetshard.encode_policies(len(SCHEME_NAMES), schemes=list(SCHEME_NAMES))
    cfg = TorchSimConfig(n_lbas=n, segment_size=segment, sfs_resample=256)
    got = fleetshard.simulate_fleet_hetero(fleet, cfg, policy, group=False,
                                           device="cpu")["volumes"]
    rows = reference.pool_rows(n, segment, 0.15, 6)
    for scheme, vol in zip(SCHEME_NAMES, got):
        want = reference.replay(corpus[0], n_lbas=n, segment_size=segment, gp_threshold=0.15,
                                n_segments=rows, scheme=scheme, sfs_resample=256)
        assert {f: vol[f] for f in FIELDS} == want, scheme


def test_bf16_rounds_as_torch_does():
    # ties (1 + 2^-8, 1 + 3 * 2^-8) go to the even neighbour
    x = np.array([1.0, 1.00390625, 1.01171875, 3.0e-3, -2.5, 12345.678, np.inf], np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert reference._bf16(x).tolist() == want.tolist()
    assert reference._bf16(np.float32(1.01171875)) == np.float32(1.015625)
