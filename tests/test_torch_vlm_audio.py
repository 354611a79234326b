"""The port's vlm prefix (paligemma-3b) and whisper (whisper-small) against the
JAX package on the CPU, at their smoke configs (paligemma: 8 query heads'
smoke twin over 1 KV head, 8 image-prefix embeddings; whisper: 2 encoder and
2 decoder layers, 8 frames): forward, prefill with every cache leaf, chains
of decode steps past the self cache's end, decode against forward, the
prefix-LM mask, the loss and gradients, the parameter converter and the
input specs. Inputs are made with numpy from a seed and JAX's parameters
come across with ``convert.lm_params_from_numpy``; where a test says
"perturbed", every zero- or one-initialised leaf (biases, norm scales) is
moved off its constant, so that the biases take part. Tolerances: float32
2e-4 absolute (``tests/test_models.py``'s), bfloat16 2e-2 of the largest
|logit|, each gradient leaf 1e-4 of its largest |grad|."""

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
from repro.models import common as jcommon
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import build_model, common
from repro_torch.models.common import tree_leaves
from repro_torch.training import AdamWConfig, init_train_state, make_train_step, train_loop

ARCHS = ["paligemma-3b", "whisper-small"]
TOL, BF16_TOL, GRAD_TOL = 2e-4, 2e-2, 1e-4
B, S, P = 2, 12, 8       # tests/test_models.py's decode pattern: prompt P, then S - P steps
BIASES = ("bq", "bk", "bv", "bo", "bi", "scale", "bias")   # the constant-initialised leaves


def _configs(arch, **replace):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **replace),
            dataclasses.replace(configs.smoke_config(arch), **replace))


class _Jitted:
    """The JAX model's forward, prefill and decode step on batch dicts, each
    under ``jax.jit``."""

    def __init__(self, jmodel, sharder):
        self.forward = jax.jit(lambda p, b: jmodel.forward(p, b, sharder))
        self.prefill = jax.jit(lambda p, b, c: jmodel.prefill(p, b, c, sharder))
        self.decode_step = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c, sharder))


@functools.lru_cache(maxsize=None)
def _pair(arch, perturb=False, **replace):
    """The JAX smoke model with its PRNGKey(0) params (``perturb``: every
    bias and norm leaf plus 0.3 of a normal draw from seed 7), its jitted
    steps, and the port's model with the same params."""
    jcfg, cfg = _configs(arch, **replace)
    jmodel = jbuild_model(jcfg)
    tree = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    if perturb:
        rng = np.random.default_rng(7)

        def move(path, x):
            if jax.tree_util.keystr(path[-1:]).strip("[]'") in BIASES:
                noise = 0.3 * rng.standard_normal(x.shape)
                return (np.asarray(x, np.float32) + noise).astype(x.dtype)
            return x
        tree = jax.tree_util.tree_map_with_path(move, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = convert.lm_params_from_numpy(cfg, tree, "cpu")
    return (jcfg, jmodel, _Jitted(jmodel, null_sharder(jcfg)), jparams, cfg, build_model(cfg),
            params)


def _key(cfg):
    return "prefix" if cfg.family == "vlm" else "frames"


def _inputs(cfg, seed=1, n_tokens=S):
    """Tokens (B, n_tokens) and the stub frontend's embeddings (B, P or T, D)
    from numpy's generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n_tokens)).astype(np.int32)
    emb = rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return toks, emb


def _batches(cfg, toks, emb, dtype=torch.float32):
    """The same batch for JAX and for the port, the embeddings in ``dtype``."""
    jdt = getattr(jnp, str(dtype)[6:])
    return ({"tokens": jnp.asarray(toks), _key(cfg): jnp.asarray(emb, jdt)},
            {"tokens": torch.from_numpy(toks), _key(cfg): torch.from_numpy(emb).to(dtype)})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _check_cache(cache, jcache, tol=TOL):
    """Every leaf of the port's cache against JAX's: paths, shapes, dtypes
    and values."""
    got = jax.tree_util.tree_flatten_with_path(cache)[0]
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jcache))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        key = jax.tree_util.keystr(path)
        assert tuple(g.shape) == w.shape and str(g.dtype) == "torch." + str(w.dtype), key
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=tol,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(arch, dtype):
    """The teacher-forced logits over the stream (vlm: prefix and text) in
    float32 within 2e-4, in bfloat16 within 2e-2 of the largest |logit|."""
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg, _, jm, jparams, cfg, model, params = _pair(arch, perturb=True, **dt)
    toks, emb = _inputs(cfg)
    jb, tb = _batches(cfg, toks, emb, getattr(torch, dtype))
    want, _ = jm.forward(jparams, jb)
    got, aux = model.forward(params, tb)
    stream = S + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    assert got.shape == (B, stream, cfg.vocab) and got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    want = np.asarray(want, np.float32)
    tol = TOL if dtype == "float32" else BF16_TOL * np.abs(want).max()
    _close(got, want, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_on_every_cache_leaf(arch):
    """Perturbed params: a prefill of all S tokens, then a prefill of the
    first P into the same cache, on both sides; the last-position logits and
    every cache leaf equal JAX's. JAX's whisper prefill replaces the whole
    self cache, zeros past the prompt, so the port leaves no stale row
    there; its LM prefill updates the first positions only, as the port's."""
    _, jmodel, jm, jparams, cfg, model, params = _pair(arch, perturb=True)
    toks, emb = _inputs(cfg, seed=2)
    jcache, cache = jmodel.init_cache(B, S + 4), model.init_cache(B, S + 4, device="cpu")
    for n in (S, P):
        jb, tb = _batches(cfg, toks[:, :n], emb)
        jlg, jcache = jm.prefill(jparams, jb, jcache)
        lg, cache = model.prefill(params, tb, cache)
        assert lg.shape == (B, cfg.vocab)
        _close(lg, jlg)
    _check_cache(cache, jcache)
    if cfg.family == "audio":
        assert not cache["self_k"][:, :, P:].any() and not cache["self_v"][:, :, P:].any()
        assert cache["self_k"][:, :, :P].abs().min() > 0
    stream = P + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    assert cache["pos"].tolist() == [stream] * B


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_jax_past_the_cache_end(arch):
    """Perturbed params, a cache of 10 text positions (the vlm stream's
    prefix on top): prefill of P = 8, then 4 decode steps, the last two at
    or past the self cache's end, where JAX's scatter drops the write and
    the attention covers the whole cache; after each step the logits and
    every cache leaf equal JAX's. No kernel on the CPU."""
    _, jmodel, jm, jparams, cfg, model, params = _pair(arch, perturb=True)
    toks, emb = _inputs(cfg, seed=3)
    jcache, cache = jmodel.init_cache(B, 10), model.init_cache(B, 10, device="cpu")
    jb, tb = _batches(cfg, toks[:, :P], emb)
    jm_lg, jcache = jm.prefill(jparams, jb, jcache)
    lg, cache = model.prefill(params, tb, cache)
    ops.reset_launch_counts()
    for t in range(P, S):
        jlg, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), cache)
        _close(lg, jlg)
        _check_cache(cache, jcache)
    end = 10 + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    assert cache["pos"].tolist() == [end + 2] * B
    assert ops.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_prefill_and_decode_follow_jax(arch):
    """bfloat16: prefill and 4 decode steps within 2e-2 of the largest
    |logit| of JAX's, every cache leaf of JAX's dtype."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    _, jmodel, jm, jparams, cfg, model, params = _pair(arch, perturb=True, **bf16)
    toks, emb = _inputs(cfg, seed=4)
    jcache, cache = jmodel.init_cache(B, S), model.init_cache(B, S, device="cpu")
    jb, tb = _batches(cfg, toks[:, :P], emb, torch.bfloat16)
    pairs = [(*model.prefill(params, tb, cache), *jm.prefill(jparams, jb, jcache))]
    for t in range(P, S):
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), pairs[-1][1])
        jlg, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), pairs[-1][3])
        pairs.append((lg, cache, jlg, jcache))
    for lg, _, jlg, _ in pairs:
        want = np.asarray(jlg, np.float32)
        assert lg.dtype == torch.bfloat16
        assert np.abs(lg.float().numpy() - want).max() <= BF16_TOL * np.abs(want).max()
    _check_cache(pairs[-1][1], pairs[-1][3], tol=BF16_TOL * 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's prefill plus stepwise decode against its own teacher-forced
    forward (JAX's test_decode_matches_forward for these two archs: B 2,
    S 12, P 8, zero biases, the vlm logits offset by the prefix), within
    2e-4; and the forward equal to JAX's."""
    _, _, jm, jparams, cfg, model, params = _pair(arch)
    toks, emb = _inputs(cfg, seed=5)
    jb, tb = _batches(cfg, toks, emb)
    full, _ = model.forward(params, tb)
    _close(full, jm.forward(jparams, jb)[0])
    cache = model.init_cache(B, S + 4, device="cpu")
    lg, cache = model.prefill(params, dict(tb, tokens=tb["tokens"][:, :P]), cache)
    offset = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    errs = [float((lg - full[:, offset + P - 1]).abs().max())]
    for t in range(P, S):
        lg, cache = model.decode_step(params, tb["tokens"][:, t:t + 1], cache)
        errs.append(float((lg - full[:, offset + t]).abs().max()))
    assert max(errs) < TOL, errs


# (query positions, key positions, prefix lengths per row): every case has a row
# whose prefix ends inside the queries' span, so the mask's two branches meet
PREFIX_CASES = {
    "offset_queries": (np.arange(5, 12), np.arange(12), [7, 9]),
    "ragged": (np.arange(12), np.arange(12), [1, 11]),
    "empty_and_whole": (np.arange(4, 12), np.arange(12), [0, 12]),
}


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_prefix_mask_across_the_causal_diagonal_matches_jax(case):
    """``gqa_attend``'s prefix-LM branch (bidirectional inside the prefix,
    causal elsewhere) against JAX's, whose ``jnp.maximum(scores, -1e29)``
    and recomputed raw scores give the same weights; float32 within 2e-6,
    bfloat16 within 2e-2."""
    q_pos, k_pos, plen = PREFIX_CASES[case]
    rng = np.random.default_rng(len(q_pos))
    q = rng.standard_normal((2, len(q_pos), 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, len(k_pos), 1, 16)).astype(np.float32) for _ in range(2))
    qp, kp = (np.tile(x.astype(np.int32), (2, 1)) for x in (q_pos, k_pos))
    plen = np.asarray(plen, np.int32)
    for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        got = common.gqa_attend(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                mode="causal", q_pos=torch.from_numpy(qp),
                                k_pos=torch.from_numpy(kp), prefix_len=torch.from_numpy(plen))
        jdt = getattr(jnp, str(dtype)[6:])
        want = jcommon.gqa_attend(*(jnp.asarray(x, jdt) for x in (q, k, v)), mode="causal",
                                  q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp),
                                  prefix_len=jnp.asarray(plen))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_and_a_train_step_runs(arch):
    """Perturbed params, remat on: the loss (the last ``labels.shape[1]``
    logits, as the reference's loss keeps them) within 1e-5 relative of
    JAX's, every gradient leaf within 1e-4 of its largest |grad| (the key
    bias's, zero in exact arithmetic, of the tree's largest), and a
    parameter the batch leaves unused with a zero gradient; then one AdamW
    train step of two microbatches on the port, its loss and grad norm
    finite and its step counted."""
    jcfg, jmodel, _, jparams, cfg, model, params = _pair(arch, perturb=True, remat=True)
    toks, emb = _inputs(cfg, seed=6, n_tokens=16)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[np.random.default_rng(6).random(labels.shape) < 0.1] = -1
    jb, tb = _batches(cfg, toks, emb)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    jloss_fn = jloop.make_loss_fn(jmodel, jcfg, null_sharder(jcfg))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jparams, jb)
    loss, grads = train_loop.loss_and_grads(train_loop.make_loss_fn(model, cfg), params, tb)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = convert.lm_params_from_numpy(cfg, jax.device_get(jgrads), "cpu")
    top = max(float(w.abs().max()) for w in tree_leaves(want))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for g, (path, w) in zip(jax.tree.leaves(grads), flat):
        assert g.shape == w.shape
        # bk's gradient is 0 in exact arithmetic (a query's scores all shift by q . bk):
        # held to the tree's largest |grad|, every other leaf to its own
        scale = top if jax.tree_util.keystr(path).endswith("['bk']") else float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, jax.tree_util.keystr(path)
    if cfg.family == "vlm":     # a text-only batch: vision_proj unused, its gradient zero
        text = {"tokens": tb["tokens"], "labels": tb["labels"]}
        _, grads = train_loop.loss_and_grads(train_loop.make_loss_fn(model, cfg), params, text)
        assert not grads["vision_proj"].any()
    cfg2 = dataclasses.replace(cfg, microbatches=2)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, cfg2, opt_cfg, torch.Generator().manual_seed(0))
    state, metrics = make_train_step(model, cfg2, opt_cfg)(state, tb)
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
    assert int(state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_and_refuses_a_wrong_tree(arch):
    """The port's params to numpy and back, bit for bit (bfloat16 as its
    uint16 bits), shaped as JAX's ``param_specs``; JAX's train state across;
    a tree without its family's own leaf (``vision_proj``, ``enc_in``), with
    another family's, or with a leaf of the wrong shape raises."""
    _, jmodel, _, _, cfg, model, _ = _pair(arch)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = build_model(cfg16).init_params(torch.Generator().manual_seed(0))
    tree = convert.train_state_to_numpy(params)
    back = convert.lm_params_from_numpy(cfg16, tree, "cpu", torch.bfloat16)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(tree_leaves(back), tree_leaves(params)))
    shapes = jax.tree.map(lambda s: s.shape, jmodel.param_specs(),
                          is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    assert common.tree_map(lambda t: tuple(t.shape), back) == shapes
    jstate = jloop.init_train_state(jmodel, jconfigs.smoke_config(arch), jopt.AdamWConfig(),
                                    jax.random.PRNGKey(1))
    state = convert.train_state_from_numpy(cfg, AdamWConfig(), jax.device_get(jstate), "cpu")
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = "vision_proj" if cfg.family == "vlm" else "enc_in"
    wrong = [{k: v for k, v in tree.items() if k != own},
             dict(tree, **{("enc_in" if own == "vision_proj" else "vision_proj"): tree[own]}),
             dict(tree, embed=tree["embed"][:-1])]
    for bad in wrong:
        with pytest.raises(ValueError):
            convert.lm_params_from_numpy(cfg16, bad, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(arch, shape):
    """Abstract inputs at the full config: ``meta`` tensors with JAX's keys,
    shapes and dtypes; concrete inputs at the smoke config from a
    ``torch.Generator``: the same shapes and dtypes as JAX's, tokens inside
    the vocabulary, the same values from the same seed."""
    jmodel = jbuild_model(jconfigs.get_config(arch))
    model = build_model(configs.get_config(arch))
    want = jmodel.input_specs(jconfigs.SHAPES[shape], abstract=True)
    got = model.input_specs(configs.SHAPES[shape], abstract=True)
    assert list(got) == list(want)
    for key, w in want.items():
        assert got[key].device.type == "meta"
        assert (tuple(got[key].shape), str(got[key].dtype)) == (w.shape, "torch." + str(w.dtype))
    small = dataclasses.replace(configs.SHAPES[shape], seq_len=24, global_batch=2)
    jcfg = jconfigs.smoke_config(arch)
    jsmall = dataclasses.replace(jconfigs.SHAPES[shape], seq_len=24, global_batch=2)
    want = jbuild_model(jcfg).input_specs(jsmall, abstract=False)
    model = build_model(configs.smoke_config(arch))
    got = model.input_specs(small, abstract=False, generator=torch.Generator().manual_seed(3))
    again = model.input_specs(small, abstract=False, generator=torch.Generator().manual_seed(3))
    assert list(got) == list(want)
    for key, w in want.items():
        assert (tuple(got[key].shape), str(got[key].dtype)) == (w.shape, "torch." + str(w.dtype))
        assert torch.equal(got[key], again[key])
        if got[key].dtype == torch.int32:
            assert 0 <= int(got[key].min()) and int(got[key].max()) < jcfg.vocab
    with pytest.raises(ValueError, match="generator"):
        model.input_specs(small, abstract=False)
