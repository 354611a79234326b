"""The port's serving slice against the JAX package on the CPU: the copied
SepBIT KV page store and scheduler field for field, the step functions'
greedy decode, the paged-serving loop's page accounting, and the example
twin's printed write amplification."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.distributed import null_sharder
from repro.models import build_model as jbuild_model
from repro.serving import engine as jengine
from repro.serving import logkv as jlogkv
from repro.serving import scheduler as jscheduler
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import engine, logkv, scheduler

ROOT = Path(__file__).resolve().parents[1]


def _tables(store):
    return ({fid: [None if p is None else vars(p) for p in fr.pages]
             for fid, fr in store.frames.items()}, store.seq_pages, store.free)


def _drive(store_mod, cfg_kwargs, ops_list):
    store = store_mod.LogKVStore(store_mod.LogKVConfig(**cfg_kwargs))
    out = [getattr(store, op)(seq) for op, seq in ops_list]
    return store, out


def _churn_ops():
    """test_serving.py's GC churn: one-page sequences with a survivor."""
    seq = []
    for i in range(40):
        seq.append(("append_page", 1000 + i))
        if i % 2 == 0:
            seq.append(("append_page", 7))
        if i >= 2:
            seq.append(("finish_sequence", 1000 + i - 2))
    seq += [("release_sequence", 7), ("append_page", 3), ("finish_sequence", 3)]
    return seq


@pytest.mark.parametrize("policy", ["sepbit", "sepgc", "nosep"])
@pytest.mark.parametrize("selector", ["greedy", "cost_benefit"])
def test_store_equals_the_reference(policy, selector):
    kw = dict(n_frames=12, pages_per_frame=4, gp_threshold=0.10, policy=policy,
              selector=selector, nc_window=4)
    store, got = _drive(logkv, kw, _churn_ops())
    jstore, want = _drive(jlogkv, kw, _churn_ops())
    assert got == want
    assert store.stats() == jstore.stats()
    assert _tables(store) == _tables(jstore)
    assert store.frames_reclaimed > 0


def test_compare_policies_equals_the_reference():
    w = dict(n_requests=400, max_batch=16, seed=5)
    got = scheduler.compare_policies(scheduler.WorkloadConfig(**w), n_frames=40,
                                     pages_per_frame=32)
    want = jscheduler.compare_policies(jscheduler.WorkloadConfig(**w), n_frames=40,
                                       pages_per_frame=32)
    assert got == want
    assert got["sepbit"]["wa"] < got["nosep"]["wa"]


def test_run_serving_sim_with_preemption_equals_the_reference():
    w = dict(n_requests=100, max_batch=64, long_frac=0.9, long_mean=48.0, max_pages=64, seed=1)
    got = scheduler.run_serving_sim(logkv.LogKVConfig(n_frames=18, pages_per_frame=16),
                                    scheduler.WorkloadConfig(**w))
    want = jscheduler.run_serving_sim(jlogkv.LogKVConfig(n_frames=18, pages_per_frame=16),
                                      jscheduler.WorkloadConfig(**w))
    assert got == want
    np.testing.assert_array_equal(
        scheduler.sample_lengths(scheduler.WorkloadConfig(**w), np.random.default_rng(4)),
        jscheduler.sample_lengths(jscheduler.WorkloadConfig(**w), np.random.default_rng(4)))


def test_greedy_decode_equals_the_reference_engine():
    """The port's step functions on JAX's parameters give JAX's engine's
    greedy tokens, which are the teacher-forced argmax of the growing
    sequence (the pattern of tests/test_serving.py's engine test)."""
    jcfg = jsmoke_config("stablelm-1.6b")
    jmodel = jbuild_model(jcfg)
    sharder = null_sharder(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
    Bt, Pt = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (Bt, Pt)).astype(np.int32)

    def generate(prefill, decode, params, cache, toks, argmax, cat):
        logits, cache = prefill(params, {"tokens": toks}, cache)
        cur = argmax(logits)[:, None]
        outs = [cur]
        for _ in range(5):
            cur, logits, cache = decode(params, cur, cache)
            cur = cur[:, None]
            outs.append(cur)
        return np.asarray(cat(outs))

    want = generate(jengine.make_prefill_fn(jmodel, jcfg, sharder),
                    jengine.make_decode_fn(jmodel, jcfg, sharder), jparams,
                    jmodel.init_cache(Bt, Pt + 6), jnp.asarray(toks),
                    lambda lg: jnp.argmax(lg, -1).astype(jnp.int32),
                    lambda xs: jnp.concatenate(xs, axis=1))
    got_t = generate(engine.make_prefill_fn(model, cfg), engine.make_decode_fn(model, cfg),
                     params, model.init_cache(Bt, Pt + 6, device="cpu"), torch.from_numpy(toks),
                     lambda lg: torch.argmax(lg, -1).to(torch.int32),
                     lambda xs: torch.cat(xs, dim=1))
    assert got_t.dtype == np.int32
    np.testing.assert_array_equal(got_t, want)
    seq = torch.from_numpy(toks)           # the port's forward equals JAX's (test_torch_models)
    for _ in range(6):
        full, _ = model.forward(params, {"tokens": seq})
        seq = torch.cat([seq, torch.argmax(full[:, -1], -1).to(torch.int32)[:, None]], dim=1)
    np.testing.assert_array_equal(got_t, seq[:, Pt:].numpy())


def _reference_accounting(lengths, B, P, page_tokens, policy):
    """examples/serve_paged.py's page accounting alone, on the reference's
    store: (stats, decode steps, prefills)."""
    store = jlogkv.LogKVStore(jlogkv.LogKVConfig(n_frames=48, pages_per_frame=16, policy=policy))
    queue = list(range(len(lengths)))
    slots, remaining = [None] * B, np.zeros(B, dtype=np.int64)
    steps = prefills = 0
    while queue or any(s is not None for s in slots):
        for b in range(B):
            if slots[b] is None and queue:
                req = queue.pop()
                slots[b], remaining[b] = req, lengths[req]
                prefills += 1
                for _ in range(P // page_tokens):
                    store.append_page(req)
        live = [b for b in range(B) if slots[b] is not None]
        steps += 1
        for b in live:
            remaining[b] -= 1
            if remaining[b] % page_tokens == 0:
                store.append_page(slots[b])
            if remaining[b] <= 0:
                store.finish_sequence(slots[b])
                slots[b] = None
    return store.stats(), steps, prefills


def test_serve_paged_keeps_the_reference_examples_accounting():
    """The example's traffic (48 requests, batch 8, prompt 16, page 8, max
    new 96) through `serve_paged` on a smoke model: the store's stats equal
    the reference accounting's, 140 decode steps and 48 prefills per policy,
    WA nosep 3.990 and sepbit 2.193, no alloc failure, no kernel launch."""
    cfg = smoke_config("qwen3-32b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    lengths, prompts = engine.request_traffic(48, 96, 16, cfg.vocab)
    rng = np.random.default_rng(0)          # examples/serve_paged.py's draws
    np.testing.assert_array_equal(lengths, np.where(rng.random(48) < 0.25,
                                                    rng.geometric(1 / 48.0, 48),
                                                    rng.geometric(1 / 8.0, 48)).clip(1, 96))
    np.testing.assert_array_equal(prompts, rng.integers(0, cfg.vocab, (48, 16)))
    ops.reset_launch_counts()
    for policy, wa in (("nosep", 3.990), ("sepbit", 2.193)):
        cache = model.init_cache(8, 16 + 96 + 8, device="cpu")
        got = engine.serve_paged(engine.make_prefill_fn(model, cfg),
                                 engine.make_decode_fn(model, cfg), params, cache, prompts,
                                 lengths, policy=policy, page_tokens=8)
        want, steps, prefills = _reference_accounting(lengths, 8, 16, 8, policy)
        assert {k: got[k] for k in want} == want
        assert (got["decode_steps"], got["prefills"]) == (steps, prefills) == (140, 48)
        assert round(got["wa"], 3) == wa and got["alloc_failures"] == 0
        assert got["tokens"] == int(lengths.sum())
    assert ops.launch_counts()["flash_decode"] == 0


def _wa_lines(out: str) -> list[str]:
    return re.findall(r"^(\w+ *: compaction WA=[\d.]+ gc_pages=\d+)", out, re.M)


def test_example_prints_the_reference_examples_wa():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    args = ["--arch", "qwen3-32b", "--requests", "24"]
    got = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_paged_torch.py"), *args,
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         check=True, timeout=300).stdout
    want = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_paged.py"), *args],
                          env=env, capture_output=True, text=True, check=True,
                          timeout=300).stdout
    assert len(_wa_lines(got)) == 2 and _wa_lines(got) == _wa_lines(want), (got, want)
    assert re.search(r"SepBIT cuts .* by [\d.]+%", got).group(0) == \
        re.search(r"SepBIT cuts .* by [\d.]+%", want).group(0)
