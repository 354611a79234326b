"""The port's checkpoint slice against the JAX package on the CPU: the copied
SepBIT blob store equal to the reference's field for field, checkpoints
written by either package restored by the other with byte-identical blobs,
the twins of ``tests/test_checkpoint.py``, and a resumed training run equal
to an uninterrupted one bit for bit."""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import logstore as jlogstore
from repro.distributed import null_sharder
from repro.models import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import configs, convert
from repro_torch.checkpoint import CheckpointManager, LogBlobStore, LogStoreConfig, logstore
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.training import AdamWConfig, DataConfig, SyntheticLM, make_train_step
from repro_torch.training import init_train_state


def _store_state(store) -> dict:
    """Every field of a store that the reference keeps, and its index file's
    bytes."""
    with open(store._index_path(), "rb") as f:
        index = f.read()
    return {"t": store.t, "next_sid": store._next_sid, "ell": store.ell, "nc": store._nc,
            "ell_tot": store._ell_tot, "user_bytes": store.user_bytes,
            "gc_bytes": store.gc_bytes, "wa": store.write_amplification,
            "live": {k: dataclasses.asdict(m) for k, m in store.live.items()},
            "seg_meta": store.seg_meta, "open": store.open, "index": index}


def _dir_bytes(root) -> dict:
    return {name: open(os.path.join(root, name), "rb").read() for name in sorted(os.listdir(root))}


def _churn_and_archive(store, rng):
    """tests/test_checkpoint.py::test_store_gc_wa's mix."""
    for i in range(400):
        store.put(f"hot/{i % 8}", rng.bytes(1024))
        if i % 4 == 0:
            store.put(f"cold/{i}", rng.bytes(1024))


def _random_mix(store, rng):
    """Puts of seeded sizes over 40 keys, a fifth of the operations deletes."""
    for _ in range(1500):
        key = f"k/{int(rng.integers(0, 40))}"
        if rng.random() < 0.2:
            store.delete(key)
        else:
            store.put(key, rng.bytes(int(rng.integers(64, 3000))))


@pytest.mark.parametrize("mix", [_churn_and_archive, _random_mix])
@pytest.mark.parametrize("policy", ["nosep", "sepbit"])
def test_logstore_equals_the_reference(tmp_path, policy, mix):
    """The same puts and deletes through both stores: user and GC bytes, WA,
    ell, every BlobMeta, every segment's metadata, the index file and every
    segment file equal; and each store reopened from its index equal to the
    other reopened (the index keeps no ell window counts, in both)."""
    kw = dict(segment_bytes=1 << 14, gp_threshold=0.12, policy=policy)
    ours = LogBlobStore(str(tmp_path / "port"), LogStoreConfig(**kw))
    ref = jlogstore.LogBlobStore(str(tmp_path / "ref"), jlogstore.LogStoreConfig(**kw))
    mix(ours, np.random.default_rng(0))
    mix(ref, np.random.default_rng(0))
    ours.sync()
    ref.sync()
    assert ref.gc_bytes > 0
    assert _store_state(ours) == _store_state(ref)
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")
    again = LogBlobStore(str(tmp_path / "port"), LogStoreConfig(**kw))
    ref_again = jlogstore.LogBlobStore(str(tmp_path / "ref"), jlogstore.LogStoreConfig(**kw))
    assert _store_state(again) == _store_state(ref_again)
    assert dataclasses.asdict(LogStoreConfig()) == dataclasses.asdict(jlogstore.LogStoreConfig())
    assert logstore.BlobMeta.__dataclass_fields__.keys() == \
        jlogstore.BlobMeta.__dataclass_fields__.keys()


def _jax_train_state(param_dtype: str):
    """A smoke train state of the JAX package after one step (moments not
    zero), with its model config."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("starcoder2-3b"), param_dtype=param_dtype)
    model = jbuild_model(jcfg)
    jc = jopt.AdamWConfig()
    state = jloop.init_train_state(model, jcfg, jc, jax.random.PRNGKey(1))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    step = jax.jit(jloop.make_train_step(model, jcfg, null_sharder(jcfg), jc))
    state, _ = step(state, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    cfg = dataclasses.replace(configs.smoke_config("starcoder2-3b"), param_dtype=param_dtype)
    return state, cfg


def _same_leaves(port_tree, jax_tree) -> None:
    """Every leaf of a port tree equal to the JAX (numpy) tree's, in the
    reference's order; bfloat16 (and a raw '|V2' array) through its bits."""
    for (key, got), want in zip(_flatten(port_tree), jax.tree.leaves(jax_tree)):
        want = np.asarray(want)
        if got.dtype == torch.bfloat16:
            assert want.dtype.itemsize == 2, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype), key
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, monkeypatch, param_dtype):
    """The same train state saved by each package (the clock patched): every
    file of the two stores byte-identical, so blobs, digests and manifests
    equal; each package restores the other's checkpoint into its own tree,
    every leaf equal (the reference hands back a bfloat16 leaf as a raw
    '|V2' array, the port through the manifest's dtype)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    jstate, cfg = _jax_train_state(param_dtype)
    host = jax.device_get(jstate)
    state = convert.train_state_from_numpy(cfg, AdamWConfig(), host, "cpu")
    jcm, cm = JCheckpointManager(str(tmp_path / "jax"), keep=2), \
        CheckpointManager(str(tmp_path / "port"), keep=2)
    for step in (3, 5):
        jcm.save(step, jstate)
        cm.save(step, state)
    assert _dir_bytes(tmp_path / "jax") == _dir_bytes(tmp_path / "port")
    m_port = json.loads(cm.store.get("manifest/000000000005"))
    m_jax = json.loads(jcm.store.get("manifest/000000000005"))
    assert m_port == m_jax and m_port["prev"] == 3
    wq = "['params']['blocks']['p0_attn']['attn']['wq']"
    assert m_port["entries"][wq]["dtype"] == param_dtype
    assert m_port["entries"]["['opt']['step']"] == {**m_jax["entries"]["['opt']['step']"],
                                                     "shape": [], "dtype": "int32"}

    got, manifest = CheckpointManager(str(tmp_path / "jax")).restore(state)
    assert manifest["step"] == 5
    _same_leaves(got, host)
    assert got["params"]["embed"].dtype == cfg.pdtype()
    want, _ = JCheckpointManager(str(tmp_path / "port")).restore(jstate)
    _same_leaves(state, want)
    if param_dtype == "bfloat16":
        assert want["params"]["embed"].dtype.str == "|V2"      # the reference's quirk


def _tree(step):
    return {"w": torch.full((4, 4), float(step)),
            "opt": {"m": torch.full((8,), step * 2.0),
                    "step": torch.tensor(step, dtype=torch.int32)}}


def test_roundtrip_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        cm.save(s, _tree(s), async_save=True)
    cm.wait()
    assert cm.manifests() == [3, 4]
    restored, manifest = cm.restore(_tree(0))
    assert manifest["step"] == 4
    assert torch.equal(restored["w"], torch.full((4, 4), 4.0))
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 4


def test_async_save_snapshots_before_the_tree_changes(tmp_path):
    """A CPU leaf updated in place right after an async save is saved as it
    was at the call."""
    tree = _tree(1)
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, tree, async_save=True)
    tree["w"].add_(100.0)
    restored, _ = cm.restore(_tree(0))
    assert torch.equal(restored["w"], torch.full((4, 4), 1.0))


def test_restart_restores(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(7, _tree(7))
    cm2 = CheckpointManager(str(tmp_path), keep=3)   # fresh process
    restored, m = cm2.restore(_tree(0))
    assert m["step"] == 7
    assert torch.equal(restored["opt"]["m"], torch.full((8,), 14.0))


def test_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, _tree(1))
    segs = [f for f in os.listdir(tmp_path) if f.startswith("seg_")]
    victim = os.path.join(tmp_path, sorted(segs)[0])
    data = bytearray(open(victim, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(data))
    with pytest.raises(IOError):
        cm.restore(_tree(0))


def test_shape_mismatch_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, _tree(1))
    bad = {"w": torch.zeros((2, 2)), "opt": {"m": torch.zeros((8,)),
                                              "step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        cm.restore(bad)


def test_store_gc_wa(tmp_path):
    """Churned keys trigger compaction; SepBIT separation keeps WA lower
    than NoSep on a churn+archive mix."""
    results = {}
    for policy in ("nosep", "sepbit"):
        store = LogBlobStore(str(tmp_path / policy), LogStoreConfig(
            segment_bytes=1 << 14, gp_threshold=0.12, policy=policy))
        _churn_and_archive(store, np.random.default_rng(0))
        results[policy] = store.write_amplification
    assert results["sepbit"] <= results["nosep"]
    assert results["nosep"] > 1.0


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """k steps, a save, a restore by a fresh manager into a fresh state, m
    more steps: every leaf equal bit for bit to k + m steps run straight
    through, and the same losses."""
    cfg = configs.smoke_config("qwen3-32b")
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))

    def run(state, steps):
        step_fn = make_train_step(model, cfg, opt_cfg)
        losses = []
        for i in steps:
            toks, labels = pipe.batch(i)
            state, m = step_fn(state, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
            losses.append(float(m["loss"]))
        return state, losses

    def fresh():
        return init_train_state(model, cfg, opt_cfg, torch.Generator().manual_seed(0))

    straight, want = run(fresh(), range(6))
    state, first = run(fresh(), range(4))
    CheckpointManager(str(tmp_path), keep=1).save(3, state)
    restored, manifest = CheckpointManager(str(tmp_path)).restore(fresh())
    assert manifest["step"] == 3
    resumed, rest = run(restored, range(4, 6))
    assert first + rest == want
    assert int(resumed["opt"]["step"]) == 6
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert a.dtype == b.dtype and torch.equal(a, b)
