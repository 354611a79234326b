"""The port's MoE block, local attention and recurrent blocks (RG-LRU,
RWKV-6) against the JAX package on the CPU: each block function on inputs
made with numpy from a seed, then forward, prefill plus stepwise decode, the
bfloat16 path and one loss-and-gradient pass at the smoke configs of
granite-moe-3b-a800m, grok-1-314b, recurrentgemma-2b and rwkv6-3b, with
JAX's parameters carried across by ``convert.lm_params_from_numpy``.
Tolerances: float32 2e-4 absolute (``tests/test_models.py``'s), bfloat16 2e-2
of the largest |logit|, each gradient leaf 1e-4 of its largest |grad|."""

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
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.training import train_loop as jloop
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import build_model, common, rglru, rwkv6, transformer
from repro_torch.models.common import tree_leaves
from repro_torch.training import train_loop

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b", "recurrentgemma-2b", "rwkv6-3b"]
# recurrentgemma at 5 layers: one period of (rglru, rglru, attn_local) and a tail of two rglru
MODELS = ARCHS + ["recurrentgemma-2b@5"]
TOL = 2e-4
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
B, S, P = 2, 40, 24      # a prompt and a stream longer than the smoke window (16): both rings wrap


def _configs(case, **replace):
    """The JAX and the port's smoke config of ``case`` (``arch`` or
    ``arch@n_layers``), each with ``replace``."""
    arch, _, layers = case.partition("@")
    if layers:
        replace = dict(replace, n_layers=int(layers))
    return (dataclasses.replace(jconfigs.smoke_config(arch), **replace),
            dataclasses.replace(configs.smoke_config(arch), **replace))


class _Jitted:
    """The JAX model's forward, prefill and decode step, each under
    ``jax.jit`` (compiled once per test, not once per step)."""

    def __init__(self, jmodel, sharder):
        self.forward = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, sharder))
        self.prefill = jax.jit(lambda p, t, c: jmodel.prefill(p, {"tokens": t}, c, sharder))
        self.decode_step = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c, sharder))
        self.init_cache = jmodel.init_cache


@functools.lru_cache(maxsize=None)
def _pair(case, **replace):
    """The JAX smoke model with its PRNGKey(0) params, and the port's model
    with the same params."""
    jcfg, cfg = _configs(case, **replace)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(cfg, jax.device_get(jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _block_params(specs, seed):
    """Random values for a block's ParamSpec dict: a normal draw by the
    spec's fan-in rule, and the constant leaves (norm scales, gate biases,
    mixes, decays) moved off their constants so that every channel differs."""
    out = {}
    for i, (name, s) in enumerate(sorted(specs.items())):
        x = _np(*s.shape, seed=seed + i)
        if s.init in ("zeros", "ones"):
            out[name] = (s.scale if s.init == "ones" else 0.0) + 0.3 * x
        else:
            out[name] = x * s.scale / math.sqrt(max(s.shape[0], 1))
    return out


def _both(tree):
    """A numpy tree as (JAX arrays, CPU tensors)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


# -- the MoE block ------------------------------------------------------------------------

# S, route_group, capacity factor
MOE_CASES = {"whole": (24, 0, 1.25), "grouped": (24, 8, 1.25),
             "group_not_dividing": (24, 7, 1.25), "group_not_below_S": (8, 8, 1.25),
             "decode": (1, 512, 1.25), "overflow": (37, 0, 0.5)}


def _moe(route_group, seed=5, zero_router=False):
    jcfg, cfg = _configs("granite-moe-3b-a800m")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, route_group=route_group))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, route_group=route_group))
    p = _block_params(jcommon.moe_specs(jcfg), seed)
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return jcfg, cfg, p


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_jax(case):
    """The output within TOL and the aux within 1e-5 relative, with and
    without routing groups (the recursion taken only where 0 < G < S and
    S % G == 0), at decode (S 1, capacity 1), and where tokens overflow an
    expert's capacity (checked here from JAX's own routing)."""
    S_, G, cf = MOE_CASES[case]
    jcfg, cfg, p = _moe(G)
    jp, tp = _both(p)
    x = _np(2, S_, cfg.d_model, seed=9)
    want, want_aux = jcommon.moe_block(jcfg, jp, jnp.asarray(x), null_sharder(jcfg),
                                       capacity_factor=cf)
    got, aux = common.moe_block(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    assert got.shape == x.shape and aux.dtype == torch.float32 and aux.shape == ()
    _close(got.numpy(), want)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    if case == "overflow":
        E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
        probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
        idx = np.asarray(jax.lax.top_k(probs, K)[1])
        counts = (idx.reshape(2, -1)[..., None] == np.arange(E)).sum(1)
        assert counts.max() > max(int(cf * K * S_ / E), 1)


def test_moe_zero_router_ties_pick_the_lowest_experts_and_drop_by_position():
    """A zero router ties every token across all experts: JAX picks experts
    0..K-1 (lax.top_k's order) and keeps the first C tokens of each by
    position; the port does too. So tokens 0..C-1 get half of each of
    experts 0 and 1, the rest nothing; the aux is E * (2 / E) * coef."""
    S_ = 16
    jcfg, cfg, p = _moe(0, zero_router=True)
    jp, tp = _both(p)
    x = _np(2, S_, cfg.d_model, seed=3)
    want, want_aux = jcommon.moe_block(jcfg, jp, jnp.asarray(x), null_sharder(jcfg))
    got, aux = common.moe_block(cfg, tp, torch.from_numpy(x))
    _close(got.numpy(), want)
    C = int(1.25 * 2 * S_ / 4)

    def expert(e, h):
        return (jax.nn.silu(h @ p["wg"][e]) * (h @ p["wi"][e])) @ p["wo"][e]
    hand = np.asarray(0.5 * expert(0, x[:, :C]) + 0.5 * expert(1, x[:, :C]))
    np.testing.assert_allclose(got[:, :C].numpy(), hand, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[:, C:], torch.zeros_like(got[:, C:]))
    assert float(aux) == pytest.approx(4 * 0.5 * 0.01, rel=1e-6) == pytest.approx(float(want_aux))


def test_top_k_breaks_ties_as_lax_top_k():
    """Values with many ties (small integers): the same values and indices
    as ``lax.top_k``, ties toward the lower index."""
    x = np.random.default_rng(2).integers(0, 4, (64, 40)).astype(np.float32)
    vals, idx = common.top_k(torch.from_numpy(x), 8)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_dispatch_equals_the_references_five_axis_product():
    """The port builds dispatch (B, S, E, C) directly; the reference's
    (B, S, K, E, C) product summed over K gives the same 0 / 1 values."""
    _, cfg, p = _moe(0)
    x = torch.from_numpy(_np(2, 37, cfg.d_model, seed=4))
    E, K, C = 4, 2, int(0.5 * 2 * 37 / 4)
    probs = torch.softmax(x @ torch.from_numpy(p["router"]), -1)
    _, idx = common.top_k(probs, K)
    onehot = (idx[..., None] == torch.arange(E)).float()
    pos = (torch.cumsum(onehot.reshape(2, -1, E), 1).reshape(onehot.shape) - 1.0) * onehot
    five = (((pos < C) & (onehot > 0))[..., None]
            * (pos.long()[..., None] == torch.arange(C)).float()).sum(2)
    pe = pos.sum(2)
    direct = (((pe < C) & (onehot.sum(2) > 0))[..., None] & (pe[..., None] == torch.arange(C)))
    assert torch.equal(five, direct.float()) and five.sum() < 2 * 37 * K


# -- local attention at decode ------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 3, 8])
def test_windowed_decode_attend_matches_jax(window):
    q, k, v = _np(2, 1, 4, 16), _np(2, 9, 2, 16, seed=1), _np(2, 9, 2, 16, seed=2)
    kl = np.array([4, 9], np.int32)
    ops.reset_launch_counts()
    got = common.decode_attend(*map(torch.from_numpy, (q, k, v, kl)), window=window)
    want = jcommon.decode_attend(*map(jnp.asarray, (q, k, v, kl)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    assert ops.launch_counts()["flash_decode"] == 0


# -- RG-LRU -------------------------------------------------------------------------------

def _rglru():
    jcfg, cfg = _configs("recurrentgemma-2b")
    return jcfg, cfg, _block_params(jrglru.rglru_specs(jcfg), 11)


@pytest.mark.parametrize("n", [1, 2, 5, 37, 64, 130])
def test_linear_scan_equals_the_sequential_recurrence(n):
    a = torch.from_numpy(np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 8)).astype(np.float32))
    b = torch.from_numpy(_np(2, n, 8, seed=n))
    h, want = torch.zeros(2, 8, dtype=torch.float64), []
    for t in range(n):
        h = a[:, t].double() * h + b[:, t].double()
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b).double(), torch.stack(want, 1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("n", [1, 37, 64, 130])
def test_rglru_forward_matches_jax(n, carried):
    """The output and the returned state (h in x's dtype, the conv carry)
    within TOL, from a zero state or from a carried h0 and conv window."""
    jcfg, cfg, p = _rglru()
    jp, tp = _both(p)
    x = _np(2, n, cfg.d_model, seed=n)
    h0 = _np(2, 64, seed=21) if carried else None
    conv0 = _np(2, 3, 64, seed=22) if carried else None
    jkw = dict(h0=None if h0 is None else jnp.asarray(h0),
               conv0=None if conv0 is None else jnp.asarray(conv0))
    tkw = dict(h0=None if h0 is None else torch.from_numpy(h0),
               conv0=None if conv0 is None else torch.from_numpy(conv0))
    want, (wh, wconv) = jrglru.rglru_forward(jcfg, jp, jnp.asarray(x), null_sharder(jcfg),
                                             return_state=True, **jkw)
    got, (gh, gconv) = rglru.rglru_forward(cfg, tp, torch.from_numpy(x), return_state=True,
                                           **tkw)
    for g, w in ((got, want), (gh, wh), (gconv, wconv)):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)
    assert torch.equal(rglru.rglru_forward(cfg, tp, torch.from_numpy(x), **tkw), got)


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_decode_steps_follow_the_sequence(carried):
    """37 decode steps of the port against JAX's steps and against the
    port's full-sequence pass from the same state, each within TOL."""
    jcfg, cfg, p = _rglru()
    jp, tp = _both(p)
    x = _np(2, 37, cfg.d_model, seed=7)
    h0 = _np(2, 64, seed=8) if carried else np.zeros((2, 64), np.float32)
    conv0 = _np(2, 3, 64, seed=9) if carried else np.zeros((2, 3, 64), np.float32)
    full = rglru.rglru_forward(cfg, tp, torch.from_numpy(x), h0=torch.from_numpy(h0),
                               conv0=torch.from_numpy(conv0))
    jstate = (jnp.asarray(h0), jnp.asarray(conv0))
    state = (torch.from_numpy(h0), torch.from_numpy(conv0))
    for t in range(x.shape[1]):
        wy, jstate = jrglru.rglru_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, state = rglru.rglru_decode(cfg, tp, torch.from_numpy(x[:, t:t + 1]), state)
        assert state[0].dtype == torch.float32
        _close(y.numpy(), wy)
        _close(y.numpy(), full[:, t:t + 1].numpy())
        _close(state[0].numpy(), jstate[0])
        _close(state[1].numpy(), jstate[1])


# -- RWKV-6 -------------------------------------------------------------------------------

def _rwkv():
    jcfg, cfg = _configs("rwkv6-3b")
    return jcfg, cfg, _block_params(jrwkv6.rwkv_specs(jcfg), 31)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("n", [1, 37, 64, 130])
def test_rwkv_time_mix_and_channel_mix_match_jax(n, carried):
    """The time mix (chunked, padded to a multiple of 64, the state carried
    across chunks) and the channel mix, with and without a carried state
    and token shift: outputs and returned states within TOL."""
    jcfg, cfg, p = _rwkv()
    jp, tp = _both(p)
    H, N = cfg.n_heads, cfg.rnn_head_dim
    x = _np(2, n, cfg.d_model, seed=n)
    st = _np(2, H, N, N, seed=41, scale=0.3) if carried else None
    prev = _np(2, 1, cfg.d_model, seed=42) if carried else None
    j = {"state": None if st is None else jnp.asarray(st),
         "shift_prev": None if prev is None else jnp.asarray(prev)}
    t = {"state": None if st is None else torch.from_numpy(st),
         "shift_prev": None if prev is None else torch.from_numpy(prev)}
    want, (wst, wtm) = jrwkv6.rwkv_time_mix(jcfg, jp, jnp.asarray(x), null_sharder(jcfg),
                                            return_state=True, **j)
    got, (gst, gtm) = rwkv6.rwkv_time_mix(cfg, tp, torch.from_numpy(x), return_state=True, **t)
    for g, w in ((got, want), (gst, wst), (gtm, wtm)):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)
    assert gst.dtype == torch.float32
    want, wcm = jrwkv6.rwkv_channel_mix(jcfg, jp, jnp.asarray(x), j["shift_prev"],
                                        return_state=True)
    got, gcm = rwkv6.rwkv_channel_mix(cfg, tp, torch.from_numpy(x), t["shift_prev"],
                                      return_state=True)
    _close(got.numpy(), want)
    _close(gcm.numpy(), wcm)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_decode_steps_follow_the_sequence(carried):
    """70 decode steps (past a chunk edge) of the port against JAX's steps
    and against the port's chunked pass from the same state, within TOL."""
    jcfg, cfg, p = _rwkv()
    jp, tp = _both(p)
    H, N, D = cfg.n_heads, cfg.rnn_head_dim, cfg.d_model
    x = _np(2, 70, D, seed=17)
    st = _np(2, H, N, N, seed=18, scale=0.3) if carried else np.zeros((2, H, N, N), np.float32)
    prev = _np(2, 1, D, seed=19) if carried else np.zeros((2, 1, D), np.float32)
    full = rwkv6.rwkv_time_mix(cfg, tp, torch.from_numpy(x), state=torch.from_numpy(st),
                               shift_prev=torch.from_numpy(prev))
    jstate = (jnp.asarray(st), jnp.asarray(prev), None)
    state = (torch.from_numpy(st), torch.from_numpy(prev), None)
    for t in range(x.shape[1]):
        wy, (wst, wtm) = jrwkv6.rwkv_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, (gst, gtm) = rwkv6.rwkv_decode(cfg, tp, torch.from_numpy(x[:, t:t + 1]), state)
        _close(y.numpy(), wy)
        _close(y.numpy(), full[:, t:t + 1].numpy())
        _close(gst.numpy(), wst)
        jstate, state = (wst, wtm, None), (gst, gtm, None)


# -- whole models -------------------------------------------------------------------------

def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict / list cache, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _check_cache(cache, jcache, tol=1e-5):
    """Every leaf of the port's cache against JAX's: the same paths and
    shapes, the dtype JAX's leaf has after a step, the position maps
    equal, the values within ``tol`` of the leaf's largest magnitude."""
    got, want = _leaves(cache), _leaves(jax.device_get(jcache))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)
        if key.endswith("pos"):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            w32 = w.astype(np.float32)
            assert np.abs(g.float().numpy() - w32).max() <= tol * max(np.abs(w32).max(), 1.0)


@pytest.mark.parametrize("case", MODELS)
def test_forward_matches_jax(case):
    """The logits within TOL and the aux (the MoE blocks' summed load-balance
    loss, 0 elsewhere) within 1e-5 relative."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(case)
    toks = _tokens(cfg)
    want, jaux = _Jitted(jmodel, null_sharder(jcfg)).forward(jparams, jnp.asarray(toks))
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close(got.numpy(), want)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("case", MODELS)
def test_prefill_and_decode_match_jax(case):
    """Prefill of P = 24 tokens, then 16 decode steps (both rings of W = 16
    wrap): every step's logits within TOL of JAX's, and, without MoE, of
    JAX's teacher-forced forward (MoE's capacity differs between the two
    shapes by construction); every cache leaf, the ring position maps
    included, against JAX's after prefill and at the end; no kernel launch
    on the CPU."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(case)
    jm = _Jitted(jmodel, null_sharder(jcfg))
    toks = _tokens(cfg, seed=2)
    full = np.asarray(jm.forward(jparams, jnp.asarray(toks))[0])
    jcache, cache = jmodel.init_cache(B, S), model.init_cache(B, S, device="cpu")
    ops.reset_launch_counts()
    jlg, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :P]), jcache)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])}, cache)
    _check_cache(cache, jcache)
    pairs = [(lg, jlg, full[:, P - 1])]
    for t in range(P, S):
        jlg, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), cache)
        pairs.append((lg, jlg, full[:, t]))
    for got, want, teacher in pairs:
        _close(got.numpy(), want)
        if cfg.moe is None:
            _close(got.numpy(), teacher)
    _check_cache(cache, jcache)
    assert cache["pos"].tolist() == [S] * B
    assert ops.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("case", MODELS)
def test_bfloat16_follows_jax_within_its_rounding(case):
    """In bfloat16 (the card's dtype): forward, prefill and decode logits
    within BF16_TOL of the largest |logit|; after prefill every cache leaf
    has JAX's dtype after prefill. JAX's ``init_cache`` makes RG-LRU's ``h``
    bfloat16 and its first step replaces it by a float32 array; the port's
    ``h`` is float32 from the start (``transformer.cache_dtype``)."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, jmodel, jparams, cfg, model, params = _pair(case, **bf16)
    jm = _Jitted(jmodel, null_sharder(jcfg))
    toks = _tokens(cfg, seed=3)
    full = jm.forward(jparams, jnp.asarray(toks))[0]
    pairs = [(model.forward(params, {"tokens": torch.from_numpy(toks)})[0], full)]
    jcache, cache = jmodel.init_cache(B, S), model.init_cache(B, S, device="cpu")
    h_dtypes = {str(np.asarray(w).dtype) for k, w in _leaves(jax.device_get(jcache))
                if k.endswith("/h")}
    assert h_dtypes <= {"bfloat16"} and bool(h_dtypes) == ("rglru" in cfg.pattern)
    jlg, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :P]), jcache)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])}, cache)
    _check_cache(cache, jcache, tol=BF16_TOL)
    pairs.append((lg, jlg))
    for t in range(P, S):
        jlg, jcache = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        lg, cache = model.decode_step(params, torch.from_numpy(toks[:, t:t + 1]), cache)
        pairs.append((lg, jlg))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_jax(arch):
    """One loss-and-gradient pass with remat on (each layer under
    ``torch.utils.checkpoint``, the aux carried through it) against
    ``jax.grad`` of JAX's loss: the loss and the cross entropy within 1e-5
    relative, the aux within 1e-5 relative, every gradient leaf within
    GRAD_TOL of its largest |grad|."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, remat=True)
    sharder = null_sharder(jcfg)
    rng = np.random.default_rng(6)
    toks = _tokens(cfg, seed=6, shape=(4, 16))
    labels = np.concatenate([toks[:, 1:], np.full((4, 1), -1, np.int32)], axis=1)
    labels[rng.random(labels.shape) < 0.1] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss_fn = jloop.make_loss_fn(jmodel, jcfg, sharder)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jparams, jbatch)
    loss_fn = train_loop.make_loss_fn(model, cfg)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    _, parts = loss_fn(params, batch)
    loss, grads = train_loop.loss_and_grads(loss_fn, params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for key in ("ce", "aux"):
        assert float(parts[key]) == pytest.approx(float(jparts[key]), rel=1e-5)
    assert (float(parts["aux"]) > 0) == (cfg.moe is not None)
    want = convert.lm_params_from_numpy(cfg, jax.device_get(jgrads), "cpu")
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), 1e-30)


def test_check_supported_names_item_9_3_only_for_the_stubs():
    """Since item 9.3 every one of the ten configs passes ``check_supported``
    and builds, the two stubs included; a family the port has no model of
    raises."""
    for arch in jconfigs.ARCH_IDS:
        cfg = configs.smoke_config(arch)
        transformer.check_supported(cfg)
        assert build_model(cfg).cfg is cfg
    with pytest.raises(ValueError, match="no model of family"):
        build_model(dataclasses.replace(configs.smoke_config("qwen3-32b"), family="diffusion"))
