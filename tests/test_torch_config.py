"""The port's configuration, id tables, initial state, trace generators and
state conversion, held against the JAX package (CPU only)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import jaxsim, tracegen, traces
from repro.core.jaxsim import JaxSimConfig
from repro.core.placement.jax_schemes import NOBIT
from repro_torch import convert, resolve_device
from repro_torch.core import config as tconfig
from repro_torch.core import tracegen as ttracegen
from repro_torch.core import traces as ttraces
from repro_torch.core.placement import schemes as tschemes

JAX_ONLY = {"use_kernels", "kernels_interpret"}

CONFIGS = {
    "sepbit": dict(n_lbas=256, segment_size=16),
    "nosep": dict(n_lbas=256, segment_size=16, scheme="nosep"),
    "sepgc": dict(n_lbas=300, segment_size=32, scheme="sepgc", selector="greedy"),
    "uw": dict(n_lbas=512, segment_size=8, scheme="uw", gp_threshold=0.22),
    "gw": dict(n_lbas=128, segment_size=8, scheme="gw", n_segments=40),
    "sepbit_slots6": dict(n_lbas=256, segment_size=16, class_slots=6, gc_watermark=5),
}


# the numpy simulator's knobs that the JAX config lacks (GC operations of k
# victims, SepBIT's FIFO samples), last, at defaults that keep JAX's engine
PORT_ONLY = [("gc_batch_segments", 1), ("fifo_occupancy", False)]


def test_config_fields_and_defaults_match_jax():
    want = [(f.name, f.default) for f in dataclasses.fields(JaxSimConfig)
            if f.name not in JAX_ONLY]
    got = [(f.name, f.default) for f in dataclasses.fields(tconfig.TorchSimConfig)]
    assert got == want + PORT_ONLY


@pytest.mark.parametrize("name", list(CONFIGS))
def test_derived_properties_match_jax(name):
    jcfg = JaxSimConfig(**CONFIGS[name])
    tcfg = tconfig.TorchSimConfig(**CONFIGS[name])
    for prop in ("n_classes", "n_class_slots", "s_max", "watermark_rows", "pad_row",
                 "n_rows"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop


def test_id_tables_match_jax():
    assert tconfig.SCHEME_IDS == jaxsim.SCHEME_IDS
    assert tconfig.SCHEME_NAMES == jaxsim.SCHEME_NAMES
    assert tschemes.SCHEME_CLASSES == jaxsim.SCHEME_CLASSES
    assert tschemes.SCHEME_REQUIRES_FUTURE == jaxsim.SCHEME_REQUIRES_FUTURE
    assert tconfig.SELECTOR_IDS == jaxsim.SELECTOR_IDS
    assert tconfig.GCSCHED_IDS == jaxsim.GCSCHED_IDS
    assert tschemes.NOBIT == NOBIT
    assert tconfig.BIG == int(jaxsim.BIG)


def _policy_cases():
    cases = [(name, None) for name in CONFIGS]
    # a uw volume (3 classes) inside a 6-slot fleet: three slots stay free
    uw = {"p_scheme": 7, "p_selector": 0, "p_gp": 0.12, "p_ncw": 8, "p_classes": 3,
          "p_gcsched": 0}
    cases.append(("sepbit_slots6", uw))
    return cases


@pytest.mark.parametrize("name,policy", _policy_cases(),
                         ids=[f"{n}-{'policy' if p else 'default'}" for n, p in _policy_cases()])
def test_init_state_matches_jax(name, policy):
    jcfg = JaxSimConfig(**CONFIGS[name])
    tcfg = tconfig.TorchSimConfig(**CONFIGS[name])
    jpol = None if policy is None else {
        k: np.asarray(v, np.float32 if k == "p_gp" else np.int32) for k, v in policy.items()}
    ref = {k: np.asarray(v) for k, v in jaxsim.init_state(jcfg, jpol).items()}
    got = convert.state_to_numpy(tconfig.init_state(tcfg, policy, device="cpu"))
    assert set(got) == set(ref)
    spec = tconfig.state_spec(tcfg)
    for key, want in ref.items():
        assert got[key].shape == (1,) + want.shape, key
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key][0], want, err_msg=key)
        assert spec[key][0] == want.shape, key


def test_init_state_batches_policy_arrays():
    tcfg = tconfig.TorchSimConfig(n_lbas=128, segment_size=8, class_slots=6)
    pol = {"p_scheme": [2, 0, 7], "p_selector": [1, 0, 1], "p_gp": [0.1, 0.2, 0.15],
           "p_ncw": [16, 8, 16], "p_classes": [6, 1, 3], "p_gcsched": [0, 0, 0]}
    st = tconfig.init_state(tcfg, pol, device="cpu")
    assert st["seg_lba"].shape == (3, tcfg.n_rows, 8)
    assert st["p_gp"].dtype == torch.float32
    np.testing.assert_array_equal(st["seg_state"][:, :6].numpy(),
                                  [[1] * 6, [1, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0]])


@pytest.mark.parametrize("kind", list(traces.GENERATORS))
@pytest.mark.parametrize("seed", [0, 11])
def test_trace_generators_match_jax_package(kind, seed):
    want = traces.GENERATORS[kind](300, 700, seed=seed)
    got = ttraces.GENERATORS[kind](300, 700, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_requests", [None, 40])
@pytest.mark.parametrize("block_bytes", [4096, 512])
def test_alibaba_csv_loader_matches_jax_package(tmp_path, block_bytes, max_requests):
    """A small CSV in the Alibaba block-trace format, written here: writes
    by each opcode spelling, reads and short lines skipped, unaligned
    offsets, zero and multi-block lengths, a sparse address space."""
    rng = np.random.default_rng(9)
    lines = ["device_id,opcode,offset,length,timestamp", "3,W,12"]
    for i in range(60):
        op = ("W", "w", "1", "R", "r")[i % 5]
        offset = int(rng.integers(0, 1 << 34)) if i % 7 == 0 else int(rng.integers(0, 1 << 20))
        length = int(rng.choice([0, 1, 4096, 4097, 65536, 1000]))
        lines.append(f"3,{op},{offset},{length},{1000 + i}")
    path = tmp_path / "trace.csv"
    path.write_text("\n".join(lines) + "\n")
    want = traces.load_alibaba_csv(str(path), block_bytes, max_requests)
    got = ttraces.load_alibaba_csv(str(path), block_bytes, max_requests)
    assert got.dtype == want.dtype and len(want) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["mixed", "zipf_mixture", "shifting_hotspot", "msr_burst"])
def test_fleet_generators_match_jax_package(kind):
    want = tracegen.make_fleet(kind, 5, 256, 400, jitter=0.25, seed=3)
    got = ttracegen.make_fleet(kind, 5, 256, 400, jitter=0.25, seed=3)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tiled = ttracegen.tiled_fleet(kind, 2, 3, 128, 200, jitter=0.1, seed=4)
    want = tracegen.tiled_fleet(kind, 2, 3, 128, 200, jitter=0.1, seed=4)
    for a, b in zip(tiled, want):
        np.testing.assert_array_equal(a, b)


def test_config_and_state_convert_both_ways():
    jcfg = JaxSimConfig(n_lbas=128, segment_size=8, use_kernels=True, class_slots=6)
    tcfg = convert.config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg == tconfig.TorchSimConfig(n_lbas=128, segment_size=8, class_slots=6)
    jst = {k: np.asarray(v) for k, v in jaxsim.init_state(jcfg).items()}
    st = convert.state_from_numpy(jst, "cpu")
    assert sum(k.startswith("sch_") for k in st) == 22 and set(st) == set(jst)
    assert st["t"].shape == (1,) and st["seg_lba"].shape == (1, jcfg.n_rows, 8)
    back = convert.state_to_numpy(st)
    for key, x in back.items():
        np.testing.assert_array_equal(x[0], jst[key])
    fleet = convert.state_from_numpy({k: np.stack([v, v]) for k, v in jst.items()}, "cpu")
    assert fleet["t"].shape == (2,)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
