"""The port's LM slice against the JAX package on the CPU: the copied configs,
the pieces of ``models/common.py``, and the dense transformer's forward,
prefill and stepwise decode at the smoke configs of the four dense archs,
with JAX's parameters carried across by ``convert.lm_params_from_numpy``
(the other block kinds: ``tests/test_torch_blocks.py``)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import null_sharder
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch import configs, convert
from repro_torch.kernels import decode_attn, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, common

DENSE = ["qwen3-32b", "stablelm-1.6b", "starcoder2-3b", "phi3-mini-3.8b"]
STUBS = ["paligemma-3b", "whisper-small"]   # the stub frontends: tests/test_torch_vlm_audio.py
BLOCKS = ["granite-moe-3b-a800m", "grok-1-314b", "recurrentgemma-2b", "rwkv6-3b"]
TOL = 2e-4          # tests/test_models.py's decode-vs-forward tolerance, float32
B, S, P = 2, 12, 8  # tests/test_models.py's decode pattern: prompt P, then S - P steps


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The JAX smoke model with its PRNGKey(0) params, and the port's model
    with the same params."""
    jcfg = jconfigs.smoke_config(arch)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = configs.smoke_config(arch)
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.pattern == jcfg.pattern and cfg.hd == jcfg.hd
        assert (cfg.n_params(), cfg.n_active_params()) == (jcfg.n_params(),
                                                           jcfg.n_active_params())
        assert cfg.pdtype() == getattr(torch, jcfg.pdtype().name)
        assert cfg.cdtype() == getattr(torch, jcfg.cdtype().name)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(configs.SHAPES[name]) == dataclasses.asdict(shape)
        assert (configs.shape_applicable(configs.get_config(arch), configs.SHAPES[name])
                == jconfigs.shape_applicable(jconfigs.get_config(arch), shape))


def test_qwen3_32b_full_width():
    cfg = configs.get_config("qwen3-32b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab) == (64, 5120, 64, 8, 128, 25600, 151936)
    assert cfg.n_params() == 32_761_446_400
    assert cfg.pdtype() == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    toks = _tokens(cfg)
    want, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, null_sharder(jcfg))
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    """The port's prefill plus stepwise decode against JAX's prefill and
    decode and against JAX's teacher-forced forward, each within TOL; the
    port's cache equal to JAX's; no kernel launch on the CPU."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    sharder = null_sharder(jcfg)
    toks = _tokens(cfg, seed=2)
    full = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, sharder)[0])
    jcache = jmodel.init_cache(B, S + 4)
    cache = model.init_cache(B, S + 4, device="cpu")
    ops.reset_launch_counts()
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])}, jcache, sharder)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])}, cache)
    pairs = [(lg, jlg, full[:, P - 1])]
    for t in range(P, S):
        jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, sharder)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), cache)
        pairs.append((lg, jlg, full[:, t]))
    for got, want, teacher in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), teacher, atol=TOL, rtol=0)
    assert cache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["blocks"]["p0_attn"][key].numpy(),
                                   np.asarray(jcache["blocks"]["p0_attn"][key]), atol=1e-5)
    assert ops.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("arch", DENSE)
def test_decode_past_the_cache_end_drops_the_write_as_jax_does(arch):
    """A prompt that fills the cache (max_seq 4), then one decode step at
    pos 4: JAX's scatter drops the write and its mask covers every row; the
    port leaves the cache as it was (no IndexError, no device assert) and
    its logits follow JAX's within TOL; pos becomes 5 in both."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    sharder = null_sharder(jcfg)
    prompt = np.array([[5, 7, 9, 11]], np.int32)
    jcache = jmodel.init_cache(1, 4)
    cache = model.init_cache(1, 4, device="cpu")
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache, sharder)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)}, cache)
    before = {k: v.clone() for k, v in cache["blocks"]["p0_attn"].items()}
    tok = np.array([[3]], np.int32)
    jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, sharder)
    lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL, rtol=0)
    for key in ("k", "v"):
        assert torch.equal(cache["blocks"]["p0_attn"][key], before[key])
        np.testing.assert_allclose(cache["blocks"]["p0_attn"][key].numpy(),
                                   np.asarray(jcache["blocks"]["p0_attn"][key]), atol=1e-5)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [5]


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_follows_jax_within_its_rounding(arch):
    """In bfloat16 (the card's dtype) the port casts where JAX casts: forward,
    prefill and decode logits within 2e-2 of the largest |logit| (measured:
    at most 7.4e-3, one or two bfloat16 ulps of a logit in [2, 8); the
    softmax weights meet V in float32 in K5's plain version, in bfloat16 in
    JAX's decode_attend)."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **bf16)
    jmodel, sharder = jbuild_model(jcfg), null_sharder(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(configs.smoke_config(arch), **bf16)
    model = build_model(cfg)
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
    toks = _tokens(cfg, seed=3)
    full = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, sharder)[0],
                      np.float32)
    pairs = [(model.forward(params, {"tokens": torch.from_numpy(toks)})[0], full)]
    jcache, cache = jmodel.init_cache(B, S), model.init_cache(B, S, device="cpu")
    jlg, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])}, jcache, sharder)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])}, cache)
    pairs.append((lg, jlg))
    for t in range(P, S):
        jlg, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, sharder)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), cache)
        pairs.append((lg, jlg))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_bfloat16_params_carry_across_bit_for_bit():
    jcfg = dataclasses.replace(jconfigs.smoke_config("starcoder2-3b"), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jparams = jax.device_get(jbuild_model(jcfg).init_params(jax.random.PRNGKey(3)))
    cfg = dataclasses.replace(configs.smoke_config("starcoder2-3b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = convert.lm_params_from_numpy(cfg, jparams, "cpu")
    wq = params["blocks"]["p0_attn"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 4, 16)
    want = np.asarray(jparams["blocks"]["p0_attn"]["attn"]["wq"]).view(np.uint16)
    np.testing.assert_array_equal(wq.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("case", ["missing key", "extra key", "shape", "tail length"])
def test_lm_params_from_numpy_rejects_another_tree(case):
    _, _, jparams, cfg, _, _ = _pair("qwen3-32b")
    tree = jax.device_get(jparams)
    tree = dict(tree, blocks={"p0_attn": dict(tree["blocks"]["p0_attn"])})
    if case == "missing key":
        del tree["lm_head"]
    elif case == "extra key":
        tree["vision_proj"] = np.zeros((64, 64), np.float32)
    elif case == "shape":
        tree["blocks"]["p0_attn"]["ln1"] = {"scale": np.zeros((3, 64), np.float32)}
    else:
        tree["tail"] = [tree["final_norm"]]
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(cfg, tree, "cpu")


@pytest.mark.parametrize("arch", STUBS)
def test_what_is_not_ported_raises_naming_its_roadmap_item(arch):
    """The two archs that raised until item 9.3 now build at full and smoke
    size, and their parameter trees are JAX's: keys, nesting and shapes
    (``vision_proj`` for the vlm prefix; whisper's encoder and decoder)."""
    for get in ("get_config", "smoke_config"):
        model = build_model(getattr(configs, get)(arch))
        shapes = jax.tree.map(lambda s: s.shape,
                              jbuild_model(getattr(jconfigs, get)(arch)).param_specs(),
                              is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
        assert common.tree_map(lambda s: s.shape, model.param_specs()) == shapes
    assert ("vision_proj" in shapes) == (arch == "paligemma-3b")
    assert ("encoder" in shapes) == (arch == "whisper-small")


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("piece", ["rmsnorm", "layernorm", "rope", "rope_quarter",
                                   "sinusoidal", "mlp_swiglu", "mlp_gelu_bias"])
def test_common_pieces_match_jax(piece):
    x = _np(2, 5, 4, 16)
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    if piece == "rmsnorm":
        s = _np(16, seed=1)
        got = common.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
        want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    elif piece == "layernorm":
        s, b = _np(16, seed=1), _np(16, seed=2)
        got = common.layernorm(*map(torch.from_numpy, (x, s, b)))
        want = jcommon.layernorm(*map(jnp.asarray, (x, s, b)))
    elif piece in ("rope", "rope_quarter"):
        frac = 1.0 if piece == "rope" else 0.25
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), fraction=frac,
                                theta=1e6)
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction=frac, theta=1e6)
    elif piece == "sinusoidal":
        got = common.sinusoidal_pos(torch.from_numpy(pos), 24)
        want = jcommon.sinusoidal_pos(jnp.asarray(pos), 24)
    else:
        arch = "qwen3-32b" if piece == "mlp_swiglu" else "starcoder2-3b"
        cfg, jcfg = configs.smoke_config(arch), jconfigs.smoke_config(arch)
        p = {k: _np(*s.shape, seed=i + 3) for i, (k, s) in enumerate(common.mlp_specs(cfg).items())}
        h = _np(2, 5, 64)
        got = common.mlp(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(h))
        want = jcommon.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h),
                           null_sharder(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode,window,prefix", [("causal", 0, False), ("window", 3, False),
                                                ("full", 0, False), ("causal", 0, True)])
def test_gqa_attend_matches_jax(mode, window, prefix):
    q, k, v = _np(2, 7, 4, 16), _np(2, 7, 2, 16, seed=1), _np(2, 7, 2, 16, seed=2)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    plen = np.array([3, 5], np.int32) if prefix else None
    got = common.gqa_attend(*map(torch.from_numpy, (q, k, v)), mode=mode,
                            q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
                            prefix_len=None if plen is None else torch.from_numpy(plen),
                            window=window)
    want = jcommon.gqa_attend(*map(jnp.asarray, (q, k, v)), mode=mode, q_pos=jnp.asarray(pos),
                              k_pos=jnp.asarray(pos),
                              prefix_len=None if plen is None else jnp.asarray(plen),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("G", [1, 2, 128])
def test_decode_attend_any_head_dim_goes_to_the_plain_version_on_the_cpu(G):
    """D 16 (the smoke configs') and G 128 are not shapes the kernel takes;
    on the CPU both wrappers run the plain version, as JAX's decode_attend
    computes it, and launch nothing."""
    q, k, v = _np(2, 1, 2 * G, 16), _np(2, 9, 2, 16, seed=1), _np(2, 9, 2, 16, seed=2)
    kl = np.array([4, 9], np.int32)
    ops.reset_launch_counts()
    got = common.decode_attend(*map(torch.from_numpy, (q, k, v, kl)))
    want = jcommon.decode_attend(*map(jnp.asarray, (q, k, v, kl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    args = (torch.from_numpy(q[:, 0]), *map(torch.from_numpy, (k, v, kl)))
    for fn in (decode_attn.flash_decode, decode_attn.flash_decode_unread):
        assert torch.equal(fn(*args), tref.flash_decode_ref(*args))
    assert ops.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("spec,std", [
    (common.ParamSpec((64, 512), ("a", "b")), 1 / 8),
    (common.ParamSpec((4, 64, 8, 16), ("l", "a", "b", "c")), 1 / math.sqrt(4 * 64 * 8)),
    (common.ParamSpec((512, 64), ("a", "b"), "embed", 0.5), 0.5),
])
def test_make_param_follows_the_reference_rule(spec, std):
    """A stacked tensor's fan-in counts its layers axis, as the reference's
    make_param does (the scale the chip's random weights keep); the draw is
    the generator's, the same on a repeat, its spread the rule's."""
    got = common.make_param(spec, torch.Generator().manual_seed(0), torch.float32)
    again = common.make_param(spec, torch.Generator().manual_seed(0), torch.float32)
    want = jcommon.make_param(jcommon.ParamSpec(spec.shape, spec.axes, spec.init, spec.scale),
                              jax.random.PRNGKey(0), jnp.float32)
    assert got.shape == spec.shape and torch.equal(got, again)
    assert float(got.std()) == pytest.approx(std, rel=0.05)
    assert float(np.std(np.asarray(want))) == pytest.approx(std, rel=0.05)
    ones = common.make_param(common.ParamSpec((3,), ("a",), "ones", 2.0),
                             torch.Generator(), torch.bfloat16)
    assert ones.dtype == torch.bfloat16 and torch.equal(ones, torch.full((3,), 2.0,
                                                                          dtype=torch.bfloat16))


@pytest.mark.parametrize("arch", ["qwen3-32b"] + BLOCKS + STUBS)
def test_init_params_shapes_and_cache_layout(arch):
    """The port's parameter tree has JAX's shapes; its cache has JAX's
    leaves, shapes and dtypes (but RG-LRU's ``h``, float32 in the port:
    `transformer.cache_dtype`), zeros but the rings' position maps, -1."""
    cfg = configs.smoke_config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    jmodel = jbuild_model(jconfigs.smoke_config(arch))
    shapes = jax.tree.map(lambda s: s.shape, jmodel.param_specs(),
                          is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    assert common.tree_map(lambda t: tuple(t.shape), params) == shapes
    cache = model.init_cache(3, 20, device="cpu")
    jcache = jax.device_get(jmodel.init_cache(3, 20))
    got = jax.tree_util.tree_flatten_with_path(cache)[0]
    want = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        key = jax.tree_util.keystr(path)
        assert tuple(g.shape) == w.shape, key
        dtype = "float32" if key.endswith("['h']") else str(w.dtype)
        assert str(g.dtype) == "torch." + dtype, key
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32), err_msg=key)
    if arch == "qwen3-32b":
        assert cache["blocks"]["p0_attn"]["k"].shape == (2, 3, 20, 2, 16)
        assert cache["pos"].dtype == torch.int32 and cache["tail"] == []
    if arch == "recurrentgemma-2b":
        assert cache["blocks"]["p2_attn_local"]["pos"].shape == (1, 3, 16)
        assert (cache["blocks"]["p2_attn_local"]["pos"] == -1).all()
