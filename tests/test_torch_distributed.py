"""The port's distribution layer, dry run and roofline against the JAX
package on the CPU: the sharding plan of all ten archs over four meshes and
every dry-run variant, int8 block quantization bit for bit, the elastic
planner, the H100 roofline's terms; then, in one pair of spawned ranks on a
gloo group, the compressed all-reduce, the pipeline and the models on
DTensors (forward in heads and head_dim / sequence-parallel mode, decode,
a train step) against the unsharded port and JAX, and the dry run on fake
process groups (rank 0, after the gloo group is gone)."""

import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, convert, roofline
from repro_torch.distributed import Sharder, ShardingOptions, ShapeMesh, collectives, elastic
from repro_torch.launch import dryrun, make_production_mesh
from repro_torch.models import build_model, common

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 2), ("data", "model")), ((2, 1), ("data", "model"))]
# the smoke configs are narrower than tp_off's 1,024: overrides put TP back on
HEADS = (("heads", "model"), ("kv_heads", "model"), ("ffn", "model"), ("vocab", "model"))
HEAD_DIM = (("head_dim", "model"), ("seq_attn", "model"), ("ffn", "model"), ("vocab", "model"))
OPTIONS = {name: spec.get("options", ShardingOptions()) for name, spec in dryrun.VARIANTS.items()}
OPTIONS.update(overrides_heads=ShardingOptions(overrides=HEADS), seq_kv_ep=ShardingOptions(
    seq_sharded_kv=True, expert_parallel=True, moe_2d=True, sp_attention=False, fsdp=False))
TOL = 2e-4          # tests/test_models.py's float32 tolerance
TRAIN_LR = 1e-2     # the train step's constant learning rate
B, S = 2, 8


class FakeMesh:
    """The reference tests' shape-only mesh for the JAX Sharder."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)
        self.empty = False
        self.size = int(np.prod(shape))


def _leaves(tree):
    out = []
    common.tree_map(out.append, tree)
    return out


def _sites(cfg):
    """(shape, logical axes) of the tensors at the reference's constraint
    sites (``models/common.py`` mha / mlp / moe_block, ``rglru.py``,
    ``whisper.py``, ``transformer.py``), at one batch and sequence."""
    Bq, Sq, D, H, Hk, hd = 64, 4096, cfg.d_model, cfg.n_heads, max(cfg.n_kv_heads, 1), cfg.hd
    E = cfg.moe.n_experts if cfg.moe else 8
    return [((Bq, Sq, H, hd), ("batch", "seq_attn", "heads_full", "head_dim_full")),
            ((Bq, Sq, Hk, hd), ("batch", None, "heads_full", "head_dim_full")),
            ((Bq, Sq, H, hd), ("batch", "seq", "heads", "head_dim")),
            ((Bq, Sq, Hk, hd), ("batch", "seq", "kv_heads", "head_dim")),
            ((Bq, Sq, cfg.d_ff), ("batch", "seq", "ffn")),
            ((E, Bq, 16, D), ("experts", None, None, "embed")),
            ((E, Bq, 16, cfg.d_ff), ("experts", "batch", None, "ffn")),
            ((Bq, Sq, cfg.lru_width or D), ("batch", "seq", "lru")),
            ((Bq, Sq, D), ("batch", "seq", "act_embed")),
            ((Bq, Sq, cfg.vocab), ("batch", "seq", "vocab")),
            ((Bq, 1, D), ("batch", "seq", "act_embed"))]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_sharding_plan_matches_jax(arch):
    """Every param and cache leaf and every constraint site's activation gets
    JAX's PartitionSpec, on four meshes under every variant's options."""
    from repro import configs as jconfigs
    from repro.distributed import Sharder as JSharder

    for shape, names in MESHES:
        for opts in OPTIONS.values():
            for get in (configs.get_config, configs.smoke_config):
                cfg = get(arch)
                jcfg = getattr(jconfigs, get.__name__)(arch)
                sh = Sharder(ShapeMesh(names, shape), cfg, opts)
                jsh = JSharder(FakeMesh(shape, names), jcfg, opts)
                model = build_model(cfg)
                leaves = _leaves(model.param_specs()) + _leaves(model.cache_specs(128, 4096))
                pairs = [(s.shape, s.axes) for s in leaves] + _sites(cfg)
                for shp, axes in pairs:
                    want = tuple(jsh.pspec(shp, axes))
                    assert tuple(sh.pspec(shp, axes)) == want, (shape, opts, shp, axes)
                    local = sh.local_shape(shp, axes)
                    assert math.prod(local) * sh.mesh.size() >= math.prod(shp)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_attn_mode_matches_jax(arch, mesh):
    from repro import configs as jconfigs
    from repro.distributed import Sharder as JSharder

    shape, names = MESHES[mesh]
    sh = Sharder(ShapeMesh(names, shape), configs.get_config(arch))
    assert sh.attn_mode == JSharder(FakeMesh(shape, names), jconfigs.get_config(arch)).attn_mode
    assert sh.batch_axes == tuple(a for a in ("pod", "data") if a in names)


def test_placements_follow_the_pspec():
    from torch.distributed.tensor import Replicate, Shard

    sh = Sharder(make_production_mesh(multi_pod=True), configs.get_config("qwen3-32b"))
    assert sh.pspec((256, 4096), ("batch", "seq")) == (("pod", "data"), None)
    assert sh.placements((256, 4096), ("batch", "seq")) == (Shard(0), Shard(0), Replicate())
    assert sh.placements((5120, 25600), ("embed", "ffn")) == (Replicate(), Shard(0), Shard(1))
    assert sh.local_shape((5120, 25600), ("embed", "ffn")) == (320, 1600)


def test_null_sharder_is_the_identity():
    from repro_torch.distributed import null_sharder

    cfg = configs.smoke_config("stablelm-1.6b")
    sh = null_sharder(cfg)
    x = torch.randn(2, 3, 4)
    assert sh.constraint(x, "batch", "seq", "act_embed") is x and not sh.distributed
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    from repro_torch.distributed import place_params
    assert place_params(params, sh, build_model(cfg).param_specs()) is params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 256, 513, 77, 2048])
def test_quantize_int8_bit_equal_to_jax(dtype, n):
    import jax.numpy as jnp
    from repro.distributed.collectives import dequantize_int8, quantize_int8

    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 300.0], n)).astype(np.float32)
    if n == 2048:
        x[256:512] = 0.0                     # an all-zero block: the 1e-12 floor
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q, scale = collectives.quantize_int8(tx)
    jq, jscale = quantize_int8(jx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(collectives.dequantize_int8(q, scale, (n,)).numpy(),
                                  np.asarray(dequantize_int8(jq, jscale, (n,))))


def test_elastic_matches_jax():
    from repro.distributed import elastic as jelastic

    for n in (1, 7, 16, 200, 255, 256, 257, 300, 504, 512, 1024, 1030):
        for mp in (1, 4, 16):
            for per_pod in (64, 256):
                got = elastic.plan_mesh(n, model_parallel=mp, devices_per_pod=per_pod)
                want = jelastic.plan_mesh(n, model_parallel=mp, devices_per_pod=per_pod)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
                assert got.n_devices == want.n_devices
                p0 = elastic.plan_mesh(512, model_parallel=mp, devices_per_pod=per_pod)
                j0 = jelastic.plan_mesh(512, model_parallel=mp, devices_per_pod=per_pod)
                assert elastic.reshard_plan(p0, got) == jelastic.reshard_plan(j0, want)
    det, jdet = elastic.StragglerDetector(8), jelastic.StragglerDetector(8)
    rng = np.random.default_rng(0)
    for step in range(12):
        t = 1.0 + 0.1 * rng.random(8)
        t[3] *= 5 if step >= 2 else 1
        t[6] *= 3 if step % 2 else 1
        assert det.observe(t) == jdet.observe(t)
        assert np.array_equal(det.strikes, jdet.strikes) and det.flagged == jdet.flagged
    assert det.reassign_shards(20) == jdet.reassign_shards(20)


def test_roofline_matches_jax_with_h100_constants():
    from repro import configs as jconfigs
    from repro import roofline as jroofline

    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            for chips in (256, 512):
                got = roofline.analytic_memory_bytes(configs.get_config(arch), shape, chips)
                want = jroofline.analytic_memory_bytes(jconfigs.get_config(arch),
                                                       jconfigs.SHAPES[name], chips)
                assert got == want
    rec = {"status": "ok", "arch": "qwen3-32b", "shape": "train_4k", "mesh": "16x16",
           "n_chips": 256, "flops": 3.1e15, "bytes_accessed": 7.7e14,
           "collective_bytes": {"total": 2.0e11}}
    row = roofline.analyze_cell(rec, configs.get_config("qwen3-32b"), configs.SHAPES["train_4k"])
    jrow = jroofline.analyze_cell(rec, jconfigs.get_config("qwen3-32b"),
                                  jconfigs.SHAPES["train_4k"])
    assert row.compute_s / jrow.compute_s == pytest.approx(197 / 989, rel=1e-12)
    assert row.memory_s / jrow.memory_s == pytest.approx(819 / 3350, rel=1e-12)
    assert row.collective_s / jrow.collective_s == pytest.approx(50 / 450, rel=1e-12)
    assert row.model_flops_per_chip == jrow.model_flops_per_chip


def test_fake_process_group_module_is_where_the_dry_run_imports_it():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    import inspect
    assert "torch.testing._internal.distributed.fake_pg import FakeStore" in \
        inspect.getsource(dryrun._fake_group)
    assert issubclass(FakeStore, torch.distributed.Store)


def test_make_host_mesh_needs_a_process_group():
    from repro_torch.launch import make_host_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh()


# -- two ranks on a gloo group --------------------------------------------------

DRY = dict(arch="stablelm-1.6b", shape="decode_32k")
DRY_OPTS = ShardingOptions(fsdp=False, overrides=HEADS)


@functools.lru_cache(maxsize=None)
def _jax_case(arch):
    """A smoke model's JAX params (PRNGKey 0) as numpy, its inputs and JAX's
    forward logits."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.distributed import null_sharder
    from repro.models import build_model as jbuild

    jcfg = jconfigs.smoke_config(arch)
    jmodel = jbuild(jcfg)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["prefix"] = rng.standard_normal((B, jcfg.n_prefix_tokens, jcfg.d_model)).astype(
            np.float32)
    logits, _ = jmodel.forward(params, {k: jnp.asarray(v) for k, v in batch.items()},
                               null_sharder(jcfg))
    return {"params": params, "batch": batch, "jax": np.asarray(logits)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run `_worker` on two ranks of a gloo group (two processes, once for the
    file); rank 0's results."""
    tmp = tmp_path_factory.mktemp("dist")
    inp, out = tmp / "in.pt", tmp / "out.pt"
    torch.save({"heads": _jax_case("stablelm-1.6b"), "head_dim": _jax_case("paligemma-3b"),
                "tmp": str(tmp)}, inp)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), str(inp),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs[0][-4000:] + logs[1][-4000:]
    return torch.load(out, weights_only=False)


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _worker(rank, world, port, inp, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import pipeline, place_params
    from repro_torch.launch import make_host_mesh
    from repro_torch.serving.engine import make_decode_fn, make_prefill_fn
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (
        init_train_state,
        loss_and_grads,
        make_loss_fn,
        make_train_step,
    )

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    data = torch.load(inp, weights_only=False)
    res = {}

    # the int8 error-feedback all-reduce, three rounds with the residual carried
    g = torch.Generator().manual_seed(rank)
    xs = [torch.randn(1000, generator=g) * (1 + rank) for _ in range(3)]
    resid = torch.zeros(1000)
    res["allreduce"] = []
    for x in xs:
        mean, new = collectives.compressed_allreduce(x, resid, block=256)
        everyone = [torch.empty(1000) for _ in range(world)]
        dist.all_gather(everyone, x + resid)
        res["allreduce"].append((x, resid, mean, new, torch.stack(everyone)))
        resid = new

    # the int8 reducer over the "pod" dim of a (pod, data) mesh
    pod_mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("pod", "data"))
    tree = {"a": torch.randn(300, generator=g), "b": [torch.randn(7, 5, generator=g)]}
    zero = common.tree_map(torch.zeros_like, tree)
    got, new = collectives.make_pod_grad_reducer(pod_mesh, 64)(tree, zero)
    res["pod"] = (got, new, [collectives.compressed_allreduce(x, torch.zeros_like(x), block=64)
                             for x in _leaves(tree)])

    # the S = 2 GPipe pipeline, the reference test's shapes
    stage_mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("stage",))
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((4, 8, 8)) * 0.3).to(torch.float32)
    x = torch.from_numpy(rng.standard_normal((4, 3, 8))).to(torch.float32)
    res["pipeline"] = (pipeline.pipeline_apply(stage_mesh, lambda w, h: torch.tanh(h @ w), W, x),
                       W, x)

    # the models on DTensors at model 2
    mesh = make_host_mesh(model_axis=2)
    for mode, overrides in (("heads", HEADS), ("head_dim", HEAD_DIM)):
        case = data[mode]
        arch = "stablelm-1.6b" if mode == "heads" else "paligemma-3b"
        cfg = configs.smoke_config(arch)
        sh = Sharder(mesh, cfg, ShardingOptions(overrides=overrides))
        model = build_model(cfg)
        params = convert.lm_params_from_numpy(cfg, case["params"], "cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        ref, _ = model.forward(params, batch)
        specs = model.param_specs()
        logits, _ = model.forward(place_params(params, sh, specs), batch, sh)
        res[f"forward_{mode}"] = (sh.attn_mode, logits.placements, _full(logits), ref)
        if mode != "heads":
            continue
        # prefill and two greedy decode steps
        pf, df = make_prefill_fn(model, cfg), make_decode_fn(model, cfg)
        spf, sdf = make_prefill_fn(model, cfg, sh), make_decode_fn(model, cfg, sh)
        cache = model.init_cache(B, 16, device="cpu")
        scache = place_params(model.init_cache(B, 16, device="cpu"), sh, model.cache_specs(B, 16))
        sparams = place_params(params, sh, specs)
        steps = []
        l1, cache = pf(params, batch, cache)
        l2, scache = spf(sparams, batch, scache)
        steps.append((_full(l2), l1))
        tok = torch.argmax(l1, -1).to(torch.int32)[:, None]
        for _ in range(2):
            n1, g1, cache = df(params, tok, cache)
            n2, g2, scache = sdf(sparams, tok, scache)
            steps.append((_full(g2), g1, _full(n2), n1))
            tok = n1[:, None]
        res["decode"] = (steps, scache["blocks"]["p0_attn"]["k"].placements,
                         _full(scache["blocks"]["p0_attn"]["k"]), cache["blocks"]["p0_attn"]["k"])
        # the gradients, then one train step that moves every parameter: no
        # warmup, a constant learning rate of 1e-2
        tb = {"tokens": batch["tokens"], "labels": batch["tokens"]}
        _, grads = loss_and_grads(make_loss_fn(model, cfg), params, tb)
        with sh.scope():          # the backward pass meets plain tensors too
            _, sgrads = loss_and_grads(make_loss_fn(model, cfg, sh),
                                       place_params(params, sh, specs), tb)
        res["grads"] = [(_full(a), b) for a, b in zip(_leaves(sgrads), _leaves(grads))]
        oc = AdamWConfig(lr=TRAIN_LR, warmup_steps=0, schedule="constant")
        state = init_train_state(model, cfg, oc, torch.Generator().manual_seed(3))
        before = common.tree_map(torch.clone, state["params"])
        sstate = {"params": place_params(common.tree_map(torch.clone, state["params"]), sh,
                                         specs),
                  "opt": {"m": place_params(common.tree_map(torch.clone, state["opt"]["m"]), sh,
                                            specs),
                          "v": place_params(common.tree_map(torch.clone, state["opt"]["v"]), sh,
                                            specs),
                          "step": state["opt"]["step"].clone()}}
        state, m = make_train_step(model, cfg, oc)(state, tb)
        sstate, sm = make_train_step(model, cfg, oc, sh)(sstate, tb)

        def pairs(key):
            got = sstate["params"] if key == "params" else sstate["opt"][key]
            want = state["params"] if key == "params" else state["opt"][key]
            return [(_full(a).detach(), b.detach()) for a, b in zip(_leaves(got), _leaves(want))]
        res["train"] = {"loss": (float(_full(sm["loss"])), float(m["loss"])),
                        "before": _leaves(before), "params": pairs("params"),
                        "m": pairs("m"), "v": pairs("v")}
    dist.destroy_process_group()

    if rank == 0:
        # the dry run on fake groups: a smoke cell at (2, 2) with TP and at
        # (1, 1), then the command line at qwen3-32b's decode_32k
        cfg = configs.smoke_config(DRY["arch"])
        res["dry"] = {m: dryrun.run_cell(DRY["arch"], DRY["shape"], False, DRY_OPTS, cfg=cfg,
                                         mesh=ShapeMesh(("data", "model"), m))
                      for m in ((2, 2), (1, 1))}
        path = os.path.join(data["tmp"], "qwen3.json")
        try:
            dryrun.main(["--arch", "qwen3-32b", "--shape", "decode_32k", "--out", path])
        except SystemExit as e:
            res["cli_exit"] = e.code
        with open(path) as f:
            res["cli"] = json.load(f)
        res["cli_path"] = path
        torch.save(res, out)


def test_compressed_allreduce_with_error_feedback(ranks):
    for x, resid, mean, new, everyone in ranks["allreduce"]:
        y = x + resid
        q, scale = collectives.quantize_int8(y, 256)
        sent = collectives.dequantize_int8(q, scale, y.shape)
        assert torch.equal(new, y - sent) and torch.equal(sent + new, y)
        exact = everyone.mean(0)
        quantum = everyone.abs().amax() / 127.0
        assert (mean - exact).abs().max() <= quantum


def test_pod_grad_reducer_reduces_each_leaf(ranks):
    got, new, want = ranks["pod"]
    for g, r, (wg, wr) in zip(_leaves(got), _leaves(new), want):
        assert torch.equal(g, wg) and torch.equal(r, wr)


def test_pipeline_matches_sequential(ranks):
    got, W, x = ranks["pipeline"]
    want = x
    for i in range(W.shape[0]):
        want = torch.tanh(want @ W[i])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["heads", "head_dim"])
def test_dtensor_forward_matches_unsharded_and_jax(ranks, mode, tmp_path):
    from torch.distributed.tensor import Shard

    attn_mode, placements, got, ref = ranks[f"forward_{mode}"]
    assert attn_mode == mode
    assert Shard(2) in placements               # logits sharded on the vocabulary
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)
    jax_logits = _jax_case("stablelm-1.6b" if mode == "heads" else "paligemma-3b")["jax"]
    np.testing.assert_allclose(got.numpy(), jax_logits, atol=TOL, rtol=0)


def test_dtensor_prefill_and_decode_match_unsharded(ranks):
    from torch.distributed.tensor import Shard

    steps, placements, k_sharded, k_plain = ranks["decode"]
    assert Shard(3) in placements               # the (layers, B, S, Hk, hd) cache on its heads
    np.testing.assert_allclose(steps[0][0].numpy(), steps[0][1].numpy(), atol=TOL, rtol=0)
    for got, want, tok, want_tok in steps[1:]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
        assert torch.equal(tok, want_tok)
    np.testing.assert_allclose(k_sharded.numpy(), k_plain.numpy(), atol=1e-6, rtol=0)


def test_dtensor_gradients_match_unsharded(ranks):
    for got, ref in ranks["grads"]:
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=1e-5, rtol=0)


def _update_mismatch(before, pairs, v):
    """The largest difference between the sharded and the unsharded step's
    update of any parameter, over the largest unsharded update, where the
    gradient is at least 1e3 times AdamW's eps (1e-8). Below that the first
    step g / (|g| + eps) turns a gradient's rounding into any step up to the
    learning rate; there the moments are compared instead. Returns it and
    the share of the values compared."""
    worst = biggest = 0.0
    n = total = 0
    for b, (got, want), (_, vw) in zip(before, pairs, v, strict=True):
        well = (vw / 0.05).sqrt() >= 1e-5       # |g| from v = (1 - b2) g² after one step
        worst = max(worst, float((((got - b) - (want - b)) * well).abs().max()))
        biggest = max(biggest, float((want - b).abs().max()))
        n, total = n + int(well.sum()), total + well.numel()
    return worst / biggest, n / total


def test_dtensor_train_step_matches_unsharded(ranks):
    """One AdamW step at a constant learning rate of 1e-2, no warmup: the
    loss, the update of the parameters (within 1e-3 of the largest update,
    `_update_mismatch`) and the moments m and v (within 1e-4 of their
    largest value) equal to the unsharded step's; a step that left the
    parameters as they were would fail."""
    train = ranks["train"]
    loss, want = train["loss"]
    assert abs(loss - want) <= 1e-5
    before, params = train["before"], train["params"]
    assert max(float((w - b).abs().max()) for b, (_, w) in zip(before, params)) >= \
        0.5 * TRAIN_LR
    mismatch, share = _update_mismatch(before, params, train["v"])
    assert mismatch <= 1e-3 and share >= 0.5, (mismatch, share)
    noop, _ = _update_mismatch(before, [(b, w) for b, (_, w) in zip(before, params)], train["v"])
    assert noop == 1.0
    for key in ("m", "v"):
        for got, ref in train[key]:
            scale = float(ref.abs().max())
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4 * scale, rtol=0)


def _jax_bytes(cfg, opts, mesh, shape):
    """The chip's share of a decode cell's arguments by the JAX Sharder's
    pspec: params, cache and tokens."""
    from repro import configs as jconfigs
    from repro.distributed import Sharder as JSharder

    jsh = JSharder(FakeMesh(mesh, ("data", "model")), jconfigs.smoke_config(DRY["arch"]), opts)
    model = build_model(cfg)
    B_ = shape.global_batch

    def share(shp, axes):
        n = 1
        for dim, e in zip(shp, tuple(jsh.pspec(shp, axes))):
            names = e if isinstance(e, tuple) else (e,)
            n *= dim // math.prod(dict(zip(("data", "model"), mesh)).get(a, 1) for a in names)
        return n

    from repro_torch.models.transformer import cache_dtype
    total = sum(share(s.shape, s.axes) * cfg.pdtype().itemsize
                for s in _leaves(model.param_specs()))

    def cache(tree, key=None):
        if isinstance(tree, common.ParamSpec):
            return share(tree.shape, tree.axes) * cache_dtype(key, cfg.cdtype()).itemsize
        if isinstance(tree, dict):
            return sum(cache(v, k) for k, v in tree.items())
        return sum(cache(v, key) for v in tree)

    total += cache(model.cache_specs(B_, shape.seq_len))
    return total + share((B_, 1), ("batch", "seq")) * 4


def test_dry_run_cell_on_a_fake_mesh(ranks):
    cfg = configs.smoke_config(DRY["arch"])
    shape = configs.SHAPES[DRY["shape"]]
    keys = {"arch", "shape", "variant", "mesh", "status", "compile_s", "n_chips", "model_params",
            "model_params_active", "memory", "flops", "bytes_accessed", "collective_bytes",
            "analysis_compile_s"}
    for mesh, rec in ranks["dry"].items():
        assert rec["status"] == "ok", rec
        assert set(rec) == keys and rec["mesh"] == "x".join(map(str, mesh))
        assert rec["n_chips"] == math.prod(mesh)
        assert set(rec["collective_bytes"]) == set(dryrun.COLLECTIVES) | {"total"}
        assert rec["memory"]["argument_bytes"] == _jax_bytes(cfg, DRY_OPTS, mesh, shape)
        assert rec["memory"]["temp_bytes"] is None and rec["memory"]["peak_bytes"] is None
        assert rec["flops"] >= dryrun.model_flops_per_chip(cfg, shape, rec["n_chips"])
    assert ranks["dry"][(1, 1)]["collective_bytes"]["total"] == 0
    assert ranks["dry"][(2, 2)]["collective_bytes"]["total"] > 0
    assert ranks["dry"][(2, 2)]["memory"]["argument_bytes"] < \
        ranks["dry"][(1, 1)]["memory"]["argument_bytes"]


def test_dry_run_command_line_at_qwen3_decode(ranks):
    """One record with run_cell's keys; per-chip FLOPs 2·N_active·T / chips
    plus K5's products, which run on whole heads on every rank of the model
    axis in head_dim mode (4·(B / data)·H·S·hd per layer), within 1 %
    under (N counts the embedding table, which a lookup does not multiply)
    and 10 % over."""
    assert ranks.get("cli_exit") == 0
    (rec,) = ranks["cli"]
    assert rec["status"] == "ok" and rec["arch"] == "qwen3-32b" and rec["mesh"] == "16x16"
    cfg, shape = configs.get_config("qwen3-32b"), configs.SHAPES["decode_32k"]
    useful = dryrun.model_flops_per_chip(cfg, shape, 256)
    assert useful == 2 * cfg.n_active_params() * shape.global_batch / 256
    attention = 4 * (shape.global_batch // 16) * cfg.n_heads * shape.seq_len * cfg.hd * \
        cfg.n_layers
    assert 0.99 <= rec["flops"] / (useful + attention) <= 1.1
    rows = roofline.build_table(ranks["cli_path"])
    assert len(rows) == 1 and rows[0].compute_s == rec["flops"] / 989e12


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
