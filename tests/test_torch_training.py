"""The port's training slice against the JAX package on the CPU: the copied
data pipeline, AdamW and its schedules, the cross entropy, the loss's
gradients and the train step at the smoke configs of the four dense archs
and of the MoE, hybrid and SSM ones, with JAX's parameters carried across by
``convert``; remat and microbatches; the train state carried both ways."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import null_sharder
from repro.models import build_model as jbuild_model
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import configs, convert
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.training import data, optimizer, train_loop

DENSE = ["qwen3-32b", "stablelm-1.6b", "starcoder2-3b", "phi3-mini-3.8b"]
BLOCKS = ["granite-moe-3b-a800m", "grok-1-314b", "recurrentgemma-2b", "rwkv6-3b"]
B, S = 4, 16
GRAD_TOL = 1e-4      # every gradient leaf, absolute, of the leaf's largest |grad|
LOSS_TOL = 1e-5      # one step's loss, relative
STEPS_TOL = 1e-4     # five steps' losses, relative
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in float32 ulps of the larger magnitude."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    spacing = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float(np.max(np.abs(got.astype(np.float64) - want) / spacing)) if got.size else 0.0


def _bf16_bits(x) -> np.ndarray:
    """A bfloat16 array or tensor's bits as int32 (so that a difference
    counts ulps of one binade)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair(arch, **replace):
    """The JAX smoke model, its sharder and PRNGKey(0) params, and the
    port's model and config."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **replace)
    cfg = dataclasses.replace(configs.smoke_config(arch), **replace)
    jmodel = jbuild_model(jcfg)
    return jcfg, jmodel, null_sharder(jcfg), jmodel.init_params(jax.random.PRNGKey(0)), cfg, \
        build_model(cfg)


def _batch(cfg, seed=1, batch=B, seq=S):
    """Tokens and next-token labels, the last column and a few more ignored."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    labels[rng.random(labels.shape) < 0.1] = -1
    return toks, labels


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}


def _jax_batch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_equal_the_reference(seed):
    dc = dict(vocab=512, seq_len=24, global_batch=8, seed=seed)
    ours, ref = data.SyntheticLM(data.DataConfig(**dc)), jdata.SyntheticLM(jdata.DataConfig(**dc))
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    for name in ("probs", "cdf", "successor"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    for step in (0, 1, 7, 1000):
        for n_shards in (1, 2, 4):
            for shard in range(n_shards):
                got, want = ours.batch(step, shard, n_shards), ref.batch(step, shard, n_shards)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == (8 // n_shards, 24)
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(5, 30), (100, 10000), (0, 7)])
def test_lr_at_matches_jax(schedule, warmup, total):
    """Every step from 0 to total + 10 within 1 float32 ulp of JAX (equal in
    practice: the cosine's cos is glibc's cosf, as in JAX's CPU program)."""
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total, schedule=schedule)
    steps = np.arange(total + 11, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jopt.AdamWConfig(**kw), s))(
        jnp.asarray(steps)))
    got = optimizer.lr_at(optimizer.AdamWConfig(**kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= 1.0


def test_cosf_is_the_reference_cos():
    """The schedule's cos equals JAX's float32 cos on the CPU over [0, pi]
    and at the reduction's edges."""
    x = np.concatenate([np.random.default_rng(1).random(100_000) * np.pi,
                        np.pi * np.arange(1001) / 1000,
                        [0.0, 1e-5, 2.0 ** -12, 0.7499, 0.75, np.pi / 4, 2.3562, 3.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(optimizer._cosf(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.cos)(jnp.asarray(x))))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 2] = -1
    got = train_loop.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jloop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    none = np.full_like(labels, -1)
    assert float(train_loop.cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))) \
        == float(jloop.cross_entropy(jnp.asarray(logits), jnp.asarray(none))) == 0.0


def _opt_tree(rng, dtype):
    shapes = {"a": (6, 8), "blocks": {"p0_attn": {"w": (2, 5, 3)}}, "tail": [(7,)]}

    def make(scale, positive=False):
        def leaf(shape):
            x = scale * rng.standard_normal(shape)
            return np.abs(x).astype(dtype) if positive else x.astype(dtype)
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))
    return make


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(param_dtype, state_dtype, clip):
    """One update from identical params, grads and state at step 3: float32
    outputs within 2 float32 ulps of JAX's, bfloat16 ones equal or one
    bfloat16 ulp apart; grad_norm within 1e-6 relative, lr equal. JAX's
    function runs op by op, as written: under jit XLA contracts ``b1 * m +
    (1 - b1) * g`` into a fused multiply-add, which moves a moment that
    nearly cancels by up to 114 ulps from the function's own eager result
    (measured at float32, clip on, the (6, 8) leaf), and the port computes
    what is written."""
    rng = np.random.default_rng(11)
    pdt, sdt = jnp.dtype(param_dtype), jnp.dtype(state_dtype)
    params = _opt_tree(rng, pdt)(0.5)
    grads = _opt_tree(rng, pdt)(0.3 if clip else 0.05)
    m, v = _opt_tree(rng, sdt)(0.01), _opt_tree(rng, sdt)(1e-4, positive=True)
    jc = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip,
                          state_dtype=state_dtype)
    c = optimizer.AdamWConfig(**dataclasses.asdict(jc))
    jstate = {"m": m, "v": v, "step": jnp.int32(3)}
    want_p, want_o, want_m = jopt.adamw_update(jc, *jax.tree.map(jnp.asarray,
                                                                (params, grads, jstate)))

    def to_torch(tree):
        return jax.tree.map(lambda x: convert._tensor(np.asarray(x), "cpu"), tree)
    tp, tg = to_torch(params), to_torch(grads)
    topt = {"m": to_torch(m), "v": to_torch(v), "step": torch.tensor(3, dtype=torch.int32)}
    got_p, got_o, got_m = optimizer.adamw_update(c, tp, tg, topt)
    assert got_p is tp and int(got_o["step"]) == 4 and got_o["step"].dtype == torch.int32
    assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=1e-6)
    assert float(got_m["lr"]) == float(want_m["lr"])
    if clip:
        assert float(want_m["grad_norm"]) > clip          # the clip acts
    for got, want in ((got_p, want_p), (got_o["m"], want_o["m"]), (got_o["v"], want_o["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            if g.dtype == torch.bfloat16:
                assert np.abs(_bf16_bits(g) - _bf16_bits(w)).max() <= 1
            else:
                assert _ulps(g.numpy(), np.asarray(w)) <= 2.0


def _jax_grads(jmodel, jcfg, sharder, jparams, jbatch):
    loss_fn = jloop.make_loss_fn(jmodel, jcfg, sharder)
    return jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(jparams, jbatch)


def _grad_err(cfg, grads, jgrads) -> float:
    """Largest |grad - JAX's grad| over a leaf's largest |JAX grad|, over
    every leaf (JAX's carried into the port's tree)."""
    want = convert.lm_params_from_numpy(cfg, jax.device_get(jgrads), "cpu")
    worst = 0.0
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.shape == w.shape
        worst = max(worst, float((g.float() - w.float()).abs().max()
                                 / w.float().abs().max().clamp(min=1e-30)))
    return worst


def _check_step(arch, **replace):
    """One train step of the port against JAX's: the loss within LOSS_TOL,
    the gradients within GRAD_TOL, the step and lr equal. Returns the
    observed loss and gradient errors."""
    jcfg, jmodel, sharder, jparams, cfg, model = _pair(arch, **replace)
    jc = jopt.AdamWConfig(**OPT)
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jc, jparams)}
    state = convert.train_state_from_numpy(cfg, optimizer.AdamWConfig(**OPT),
                                           jax.device_get(jstate), "cpu")
    toks, labels = _batch(cfg)
    jgrads = _jax_grads(jmodel, jcfg, sharder, jparams, _jax_batch(toks, labels))
    if jcfg.microbatches > 1:     # the reference's accumulation: a float32 sum, over M
        M = jcfg.microbatches
        parts = [_jax_grads(jmodel, jcfg, sharder, jparams,
                            _jax_batch(toks.reshape(M, -1, S)[i], labels.reshape(M, -1, S)[i]))
                 for i in range(M)]
        jgrads = jax.tree.map(lambda *g: sum(x.astype(jnp.float32) for x in g) / M, *parts)
    loss, grads = train_loop.loss_and_grads(train_loop.make_loss_fn(model, cfg),
                                            state["params"], _torch_batch(toks, labels),
                                            cfg.microbatches)
    assert all(p.grad is None for p in tree_leaves(state["params"]))
    g_err = _grad_err(cfg, grads, jgrads)
    jstep = jax.jit(jloop.make_train_step(jmodel, jcfg, sharder, jc))
    _, jm = jstep(jstate, _jax_batch(toks, labels))
    step = train_loop.make_train_step(model, cfg, optimizer.AdamWConfig(**OPT))
    state, m = step(state, _torch_batch(toks, labels))
    l_err = abs(float(m["loss"]) - float(jm["loss"])) / abs(float(jm["loss"]))
    assert float(loss) == float(m["loss"])
    assert int(state["opt"]["step"]) == 1 and float(m["lr"]) == float(jm["lr"])
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert l_err <= LOSS_TOL and g_err <= GRAD_TOL, (l_err, g_err)
    return l_err, g_err


@pytest.mark.parametrize("arch", DENSE + BLOCKS)
def test_train_step_matches_jax(arch):
    _check_step(arch)


def test_microbatches_match_jax():
    """microbatches=2: the float32 sum of the two halves' gradients over 2
    and the mean loss, as JAX's lax.scan accumulates them."""
    _check_step("phi3-mini-3.8b", microbatches=2)


def test_five_steps_match_jax():
    """Five steps on the synthetic pipeline: each loss within STEPS_TOL of
    JAX's, the step count and the lr equal."""
    jcfg, jmodel, sharder, jparams, cfg, model = _pair("stablelm-1.6b")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jc = jopt.AdamWConfig(**kw)
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jc, jparams)}
    state = convert.train_state_from_numpy(cfg, optimizer.AdamWConfig(**kw),
                                           jax.device_get(jstate), "cpu")
    jstep = jax.jit(jloop.make_train_step(jmodel, jcfg, sharder, jc))
    step = train_loop.make_train_step(model, cfg, optimizer.AdamWConfig(**kw))
    pipe = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    for i in range(5):
        toks, labels = pipe.batch(i)
        jstate, jm = jstep(jstate, _jax_batch(toks, labels))
        state, m = step(state, _torch_batch(toks, labels))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEPS_TOL)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 5


def test_remat_is_bit_equal():
    """remat=True recomputes each layer in the backward pass: the loss and
    every gradient equal remat=False's bit for bit."""
    out = {}
    for remat in (False, True):
        _, _, _, jparams, cfg, model = _pair("qwen3-32b", remat=remat)
        params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
        toks, labels = _batch(cfg, seed=4)
        out[remat] = train_loop.loss_and_grads(train_loop.make_loss_fn(model, cfg), params,
                                               _torch_batch(toks, labels))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


def test_bfloat16_grads_stay_in_the_param_dtype():
    """With M = 1 the gradients keep the params' dtype (bfloat16), as
    jax.value_and_grad's do; with M = 2 they are the float32 accumulation."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    _, _, _, jparams, cfg, model = _pair("starcoder2-3b", **bf16)
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
    toks, labels = _batch(cfg, seed=6)
    loss_fn = train_loop.make_loss_fn(model, cfg)
    for M, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        loss, grads = train_loop.loss_and_grads(loss_fn, params, _torch_batch(toks, labels), M)
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
        assert {g.dtype for g in tree_leaves(grads)} == {dtype}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_train_state_carries_both_ways(param_dtype):
    """A JAX train state into the port and back: every leaf equal bit for
    bit, bfloat16 as its bits; a moment of another dtype than the
    optimizer's state dtype is refused."""
    jcfg, jmodel, _, _, cfg, _ = _pair("phi3-mini-3.8b", param_dtype=param_dtype)
    jc = jopt.AdamWConfig(state_dtype=param_dtype)
    jstate = jax.device_get(jloop.init_train_state(jmodel, jcfg, jc, jax.random.PRNGKey(2)))
    jstate["opt"]["m"] = jax.tree.map(lambda p: (p * 3).astype(p.dtype), jstate["params"])
    state = convert.train_state_from_numpy(cfg, optimizer.AdamWConfig(state_dtype=param_dtype),
                                           jstate, "cpu")
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == ()
    back = convert.train_state_to_numpy(state)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    again = convert.train_state_from_numpy(cfg, optimizer.AdamWConfig(state_dtype=param_dtype),
                                           back, "cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = "float32" if param_dtype == "bfloat16" else "bfloat16"
    with pytest.raises(ValueError, match="dtype"):
        convert.train_state_from_numpy(cfg, optimizer.AdamWConfig(state_dtype=other), jstate,
                                       "cpu")
