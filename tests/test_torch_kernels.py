"""The port's kernels: plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) and its jnp oracles, the wrappers' CPU routing and
checks, and the port's import hygiene. The CUDA kernels themselves are held
against their plain versions in test_torch_cuda.py, on a card."""

import ast
import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.placement import jax_schemes
from repro.kernels import classify as jclassify
from repro.kernels import ref as jref
from repro.kernels import segsel as jsegsel
from repro_torch.core import torchsim
from repro_torch.core.config import TorchSimConfig, init_state
from repro_torch.core.placement import schemes as tschemes
from repro_torch.kernels import build
from repro_torch.kernels import classify as tclassify
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import replay as treplay
from repro_torch.kernels import segsel as tsegsel

ROOT = Path(__file__).resolve().parents[1]


def _segsel_inputs(seed, V, S, seg=128):
    """Reachable segment metadata (nv <= n <= seg, stime < t), forced ties
    (segment 3 copied onto S-2), an all-ineligible volume, mixed selectors."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, seg + 1, (V, S))
    nv = np.minimum(rng.integers(0, seg + 1, (V, S)), n)
    t = rng.integers(1, 30_000, V)
    stime = rng.integers(0, 30_000, (V, S)) % t[:, None]
    state = rng.integers(0, 4, (V, S))
    for a in (n, nv, stime, state):
        a[:, S - 2] = a[:, 3]
    state[V - 1] = np.where(state[V - 1] == 2, 0, state[V - 1])
    sel = np.arange(V) % 2
    return [np.ascontiguousarray(x, np.int32) for x in (n, nv, stime, state, t, sel)]


@pytest.mark.parametrize("V,S", [(5, 640), (3, 1500), (4, 17)])
def test_segment_select_batch_ref_matches_pallas_and_jnp(V, S):
    args = _segsel_inputs(V * S, V, S)
    idx, score = tref.segment_select_batch_ref(*map(torch.from_numpy, args))
    jidx, jscore = jsegsel.segment_select_batch(*map(jnp.asarray, args[:5]),
                                                selector_ids=jnp.asarray(args[5]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))   # bit-equal, -inf too
    assert idx.dtype == torch.int32 and score.dtype == torch.float32
    assert int(idx[V - 1]) == -1
    for v in range(V):
        ridx, rscore = jref.segment_select_ref(*(jnp.asarray(a[v]) for a in args[:5]),
                                               selector_id=int(args[5][v]))
        assert int(idx[v]) == int(ridx)
        assert score[v].item() == float(rscore) or np.isneginf(float(rscore))


def test_segment_select_ties_go_to_the_lowest_index():
    n = torch.full((8,), 10, dtype=torch.int32)
    nv = torch.tensor([9, 4, 9, 4, 4, 9, 9, 9], dtype=torch.int32)
    state = torch.full((8,), 2, dtype=torch.int32)
    stime = torch.zeros(8, dtype=torch.int32)
    idx, score = tref.segment_select_ref(n, nv, stime, state, 5, 0)
    assert int(idx) == 1 and score.item() == np.float32(0.6)


@pytest.mark.parametrize("S", [17, 1500])
@pytest.mark.parametrize("selector", [0, 1])
def test_segment_select_ref_matches_pallas_1d(S, selector):
    n, nv, stime, state, t, _ = (a[0] for a in _segsel_inputs(S + selector, 1, S))
    idx, score = tsegsel.segment_select(*map(torch.from_numpy, (n, nv, stime, state)),
                                        int(t), selector)
    jidx, jscore = jsegsel.segment_select(*map(jnp.asarray, (n, nv, stime, state)),
                                          jnp.int32(t), selector_id=jnp.int32(selector))
    assert idx.shape == () and int(idx) == int(jidx)
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))


def test_segment_select_no_eligible_segment():
    z = torch.zeros(64, dtype=torch.int32)
    idx, score = tsegsel.segment_select(z, z, z, z, 5, 1)
    assert int(idx) == -1 and score.item() == -np.inf


def _classify_inputs(seed, B):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, (14, B)).astype(np.int32)
            for hi in (10_000, 100_000, 2, 2)]


@pytest.mark.parametrize("ell", [np.inf, 1234.5, 1.0, 0.0])
def test_classify_ref_matches_pallas_for_every_scheme_id(ell):
    v, g, c1, gc = _classify_inputs(int(ell) if np.isfinite(ell) else 99, 300)
    sids = np.arange(14, dtype=np.int32)
    ells = np.full(14, ell, np.float32)
    got = tref.classify_ref(*map(torch.from_numpy, (v, g, c1, gc, ells, sids))).numpy()
    for sid in range(14):
        args = tuple(jnp.asarray(a[sid]) for a in (v, g, c1, gc))
        want = jclassify.classify(*args, jnp.float32(ell), scheme_id=jnp.int32(sid))
        np.testing.assert_array_equal(got[sid], np.asarray(want), err_msg=f"scheme {sid}")
        oracle = jref.classify_ref(*args, jnp.float32(ell), scheme_id=sid)
        np.testing.assert_array_equal(got[sid], np.asarray(oracle), err_msg=f"scheme {sid}")
        if sid not in tschemes.ELEMENTWISE_IDS:
            assert not got[sid].any()


def _user_write_lifespans(seed, V):
    """(V, 1) int32 lifespans of user writes, by row in turn: t + 2^30 (a
    fresh LBA), 2^30 + 65..127 (rounds up to 2^30 + 128 in float32) and the
    short lifespan of a rewritten LBA."""
    rng = np.random.default_rng(seed)
    kinds = np.stack([rng.integers(0, 60_000, V) + (1 << 30),
                      rng.integers(65, 128, V) + (1 << 30),
                      rng.integers(1, 60_000, V)])
    return kinds[np.arange(V) % 3, np.arange(V)][:, None].astype(np.int32)


@pytest.mark.parametrize("ell", [np.inf, 2.0 ** 30 + 128, 20_000.5])
def test_classify_ref_matches_pallas_on_user_write_lifespans(ell):
    """The user write's (V, 1) batch, is_gc = 0, where v = t + 2^30 for a
    fresh LBA and float32 rounding decides the class near ℓ."""
    v = _user_write_lifespans(11, 42)
    z = np.zeros_like(v)
    sids = (np.arange(42) // 3).astype(np.int32)
    ells = np.full(42, ell, np.float32)
    got = tref.classify_ref(*map(torch.from_numpy, (v, z, z, z, ells, sids))).numpy()
    for row in range(42):
        args = (jnp.asarray(v[row]),) + (jnp.asarray(z[row]),) * 3
        want = jclassify.classify(*args, jnp.float32(ell), scheme_id=jnp.int32(sids[row]))
        np.testing.assert_array_equal(got[row], np.asarray(want), err_msg=f"row {row}")
    if ell == 2.0 ** 30 + 128:
        assert got[7, 0] == 1       # sepbit: v < ℓ as integers, not once rounded


@pytest.mark.parametrize("sid", range(14))
def test_elementwise_chain_matches_jax(sid):
    v, g, c1, gc = (a[0] for a in _classify_inputs(sid, 257))
    for ell in (np.float32(np.inf), np.float32(777.5)):
        got = tschemes.elementwise_chain(
            torch.tensor(sid, dtype=torch.int32), torch.from_numpy(v).float(),
            torch.from_numpy(g).float(), torch.from_numpy(c1), torch.from_numpy(gc),
            torch.tensor(ell))
        want = jax_schemes.elementwise_chain(
            jnp.int32(sid), jnp.asarray(v, jnp.float32), jnp.asarray(g, jnp.float32),
            jnp.asarray(c1), jnp.asarray(gc), jnp.float32(ell))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    ops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _segsel_inputs(1, 4, 100)]
    idx, score = ops.segment_select_batch(*args)
    ridx, rscore = tref.segment_select_batch_ref(*args)
    assert torch.equal(idx, ridx) and torch.equal(score, rscore)
    v, g, c1, gc = (torch.from_numpy(a) for a in _classify_inputs(2, 64))
    ell = torch.full((14,), 50.0)
    sids = torch.arange(14, dtype=torch.int32)
    assert torch.equal(ops.classify(v, g, c1, gc, ell, sids),
                       tref.classify_ref(v, g, c1, gc, ell, sids))
    assert torch.equal(ops.classify(v, g, c1, gc, ell, sids, site="user"),
                       tref.classify_ref(v, g, c1, gc, ell, sids))
    assert ops.launch_counts() == {"segment_select_batch": 0, "segment_select": 0,
                                   "classify_gc": 0, "classify_user": 0,
                                   "zipf_bit_sums": 0, "flash_decode": 0, "replay": 0,
                                   "replay_timing": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    args = [torch.from_numpy(a) for a in _segsel_inputs(3, 4, 100)]
    with pytest.raises(TypeError, match="int32"):
        tsegsel.segment_select_batch(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        tsegsel.segment_select_batch(args[0][:2], *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tsegsel.segment_select_batch(args[0].t().contiguous().t(), *args[1:])
    v = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        tclassify.classify(v, v, v, v, torch.zeros(2, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="site"):
        tclassify.classify(v, v, v, v, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                           site="fill")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", *sorted((ROOT / "examples").glob("*_torch.py"))]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
    assert len(_port_sources()) > 10
    assert ROOT / "src" / "repro_torch" / "kernels" / "replay.py" in _port_sources()
    assert ROOT / "src" / "repro_torch" / "core" / "fleetshard.py" in _port_sources()
    assert ROOT / "src" / "repro_torch" / "models" / "whisper.py" in _port_sources()
    assert all(path.exists() for path in _port_sources())
    assert not bad, bad


def _replay_inputs(V=2, T=12, n=64):
    cfg = TorchSimConfig(n_lbas=n, segment_size=8)
    st = torchsim.own_state(init_state(cfg, torchsim.broadcast_policies(cfg, V), "cpu"))
    trace = torch.from_numpy(np.random.default_rng(3).integers(0, n, (V, T)).astype(np.int32))
    return cfg, st, trace


@pytest.mark.parametrize("bad,err,match", [
    (lambda cfg, st, tr: (dict(st, seg_n=st["seg_n"].long()), tr), TypeError, "int32"),
    (lambda cfg, st, tr: (dict(st, ell=st["ell"].double()), tr), TypeError, "float32"),
    (lambda cfg, st, tr: (dict(st, seg_lba=st["seg_lba"].transpose(1, 2).contiguous()
                               .transpose(1, 2)), tr), ValueError, "contiguous"),
    (lambda cfg, st, tr: (st, tr[:1]), ValueError, "shape"),
    (lambda cfg, st, tr: (st, tr[0]), TypeError, r"\(V, T\)"),
    (lambda cfg, st, tr: (st, tr.long()), TypeError, "int32"),
    (lambda cfg, st, tr: (st, tr.t().contiguous().t()), ValueError, "contiguous"),
    (lambda cfg, st, tr: (st, torch.full_like(tr, -2)), ValueError, "-1"),
    (lambda cfg, st, tr: (st, tr + cfg.n_lbas), ValueError, "LBAs"),
    (lambda cfg, st, tr: (dict(st, p_scheme=torch.full_like(st["p_scheme"], 3)), tr),
     ValueError, "CUDA"),
    (lambda cfg, st, tr: ({k: v for k, v in st.items() if k != "last_uw"}, tr), TypeError,
     "last_uw"),
    (lambda cfg, st, tr: (st, tr), ValueError, "CUDA"),
])
def test_replay_wrapper_rejects_what_the_kernel_does_not_take(bad, err, match):
    """Checked before any launch; the wrapper takes only CUDA tensors, and a
    well-formed state on the CPU is refused last, whatever its schemes (an
    fk fleet with its next-write stream)."""
    cfg, st, trace = _replay_inputs()
    st, trace = bad(cfg, st, trace)
    before = {k: v.clone() for k, v in st.items()}
    ops.reset_launch_counts()
    with pytest.raises(err, match=match):
        treplay.replay(cfg, st, trace, nxt=torch.zeros(trace.shape, dtype=torch.int32))
    assert ops.launch_counts()["replay"] == 0
    assert all(torch.equal(before[k], st[k]) for k in st)


def _fk_replay_inputs():
    cfg, st, trace = _replay_inputs()
    st["p_scheme"].fill_(tschemes.SCHEME_IDS["fk"])
    return cfg, st, trace


@pytest.mark.parametrize("make,err,match", [
    (lambda tr: torch.zeros(tr.shape, dtype=torch.int64), TypeError, "int32"),
    (lambda tr: torch.zeros((tr.shape[0], tr.shape[1] + 1), dtype=torch.int32), ValueError,
     "shape"),
    (lambda tr: torch.zeros((tr.shape[1], tr.shape[0]), dtype=torch.int32).t(), ValueError,
     "contiguous"),
    (lambda tr: torch.zeros(tr.shape, dtype=torch.int32, device="meta"), ValueError, "meta"),
    (lambda tr: None, ValueError, "fk"),
])
def test_replay_wrapper_checks_the_next_write_stream(make, err, match):
    """fk's next-write stream, which the kernel reads beside the trace: an
    int32 tensor of the trace's shape, contiguous, on its device, and
    present when some volume runs fk; checked before the device, so before
    any launch."""
    cfg, st, trace = _fk_replay_inputs()
    ops.reset_launch_counts()
    with pytest.raises(err, match=match):
        treplay.replay(cfg, st, trace, nxt=make(trace))
    assert ops.launch_counts()["replay"] == 0
    with pytest.raises(ValueError, match="CUDA"):      # a well-formed stream passes
        treplay.check_inputs(cfg, st, trace, torch.zeros(trace.shape, dtype=torch.int32))


def test_replay_args_match_the_kernel_struct():
    """`ReplayArgs` lists csrc/replay.cu's struct field for field, in order
    and by type, and its sch_* pointers are the stateful schemes' keys in
    `stateful.state_spec`'s order, each pointer of its key's dtype."""
    import re

    from repro_torch.core.placement import stateful
    src = (build.CSRC / "replay.cu").read_text()
    body = src[src.index("struct ReplayArgs {"):]
    body = body[:body.index("};")]
    decls = re.findall(r"^\s*(?:const )?(unsigned char\*|int\*|float\*|unsigned\*|int|float) "
                       r"(\w+);", body, re.M)
    assert [name for _, name in decls] == [name for name, _ in treplay.ReplayArgs._fields_]
    kinds = {ctypes.c_void_p: ("unsigned char*", "int*", "float*", "unsigned*"),
             ctypes.c_int: ("int",), ctypes.c_float: ("float",)}
    for (ctype, name), (_, pytype) in zip(decls, treplay.ReplayArgs._fields_):
        assert ctype in kinds[pytype], name
    cfg = TorchSimConfig(n_lbas=300, segment_size=8)
    spec = stateful.state_spec(cfg)
    assert treplay.SCHEME_FIELDS == tuple(spec)
    pointee = {"int*": torch.int32, "float*": torch.float32, "unsigned char*": torch.bool}
    declared = dict((name, ctype) for ctype, name in decls)
    for key, (_, dtype, _) in spec.items():
        assert pointee[declared[key]] == dtype, key


def test_next_writes_are_made_only_for_an_fk_volume():
    """`torchsim._next_writes`, the stream both engines read: None for a
    fleet without fk (a stream given is not read), the given stream or the
    annotations of the trace (`annotate.fleet_annotations`) with one, as a
    contiguous int32 tensor on the trace's device."""
    from repro_torch.core import annotate
    cfg, st, trace = _replay_inputs(V=3, T=40)
    given = torch.arange(120, dtype=torch.int32).reshape(3, 40)
    assert torchsim._next_writes(st, trace) is None
    assert torchsim._next_writes(st, trace, given) is None
    st["p_scheme"][1] = tschemes.SCHEME_IDS["fk"]
    made = torchsim._next_writes(st, trace)
    want = annotate.fleet_annotations(trace.numpy(), st["p_scheme"].numpy())
    assert made.dtype == torch.int32 and made.is_contiguous()
    assert np.array_equal(made.numpy(), want)
    assert (made[[0, 2]] == tschemes.NOBIT).all() and (made[1] < tschemes.NOBIT).any()
    assert torch.equal(torchsim._next_writes(st, trace, given.t().contiguous().t()), given)


def test_replay_wrapper_routes_cpu_tensors_to_the_step_engine(monkeypatch):
    """`torchsim`'s replay wrapper (`_replay`) sends a state on the CPU under
    ``engine="replay"`` to the kernel's plain version, the step engine, and
    never to the kernel's wrapper, which refuses CPU tensors."""
    cfg, st, trace = _replay_inputs(T=200)
    trace[1, 150:] = -1
    want = torchsim.own_state(st)
    stats, want_stats = torchsim.ReplayStats(), torchsim.ReplayStats()
    ran = []
    step = torchsim.step_replay
    monkeypatch.setattr(torchsim, "step_replay", lambda *a, **kw: ran.append(1) or step(*a, **kw))
    ops.reset_launch_counts()
    torchsim._replay(cfg, st, trace, stats, "replay", None)
    assert ran == [1] and ops.launch_counts()["replay"] == 0
    step(cfg, want, trace, want_stats)
    assert int(st["reclaimed"].min()) > 0
    assert all(torch.equal(want[k], st[k]) for k in st)
    assert stats == want_stats and stats.steps == 200


def test_kernel_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) names a new library, so a
    stale build is never reused."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.target(name) for name in build.SOURCES}
    header = tmp_path / "engine_ops.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.target(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in ("segsel", "classify", "replay"))
    assert "replay" in build.SOURCES
    for name in ("segsel", "classify", "replay"):
        assert '#include "engine_ops.cuh"' in (tmp_path / build.SOURCES[name]).read_text()


def _main_run_config(**kw):
    """The smoke's main-run volume: 64 MiB at 4 KiB blocks, segment 128."""
    return TorchSimConfig(n_lbas=16384, segment_size=128, **kw)


@pytest.mark.parametrize("V,warps", [(1, 1), (131, 1), (132, 1), (133, 2), (264, 2), (265, 3),
                                     (528, 4), (744, 4), (5580, 4)])
def test_replay_geometry_spreads_small_fleets_over_the_sms(V, warps):
    """Up to MAX_WARPS volumes a block; a fleet smaller than the card takes
    one volume an SM, so no SM holds two while another idles; the blocks
    cover every volume, the last one partly when V is not a multiple of the
    block's warps."""
    geo = treplay.geometry(_main_run_config(), V)
    assert geo.warps == warps <= treplay.MAX_WARPS
    assert geo.blocks == -(-V // warps)
    assert (geo.blocks - 1) * geo.warps < V <= geo.blocks * geo.warps
    assert geo.block_bytes == geo.warps * geo.warp_bytes


def test_replay_geometry_shared_bytes_follow_the_kernel_layout():
    """A warp's bytes: 96 of a stateful scheme's and the timing model's
    scalars, C ints of free rows, the victim's LBAs and times (and classes,
    stateful, with its compacted victim scan's 256-row list) as ints and
    its valid flags as bytes, each rounded to 16; with the metadata, 10
    bytes a row in four arrays and the pad row's two ints. [sweep]'s volumes
    (355 rows, C 6) take 4,880 bytes, so 11 blocks of four fit the SM's 228
    KB (1 KB reserved each)."""
    cfg = TorchSimConfig(n_lbas=16384, segment_size=128, class_slots=6, n_segments=354)
    R = cfg.n_rows
    plain = 96 + 32 + 2 * 512 + 128
    assert treplay.warp_bytes(cfg, False, False) == plain
    assert treplay.warp_bytes(cfg, True, False) == plain + 512 + 256
    meta = 2 * (-(-4 * R // 16) * 16) + 2 * (-(-R // 16) * 16) + 16
    assert treplay.warp_bytes(cfg, False, True) == plain + meta == 4880
    geo = treplay.geometry(cfg, 5580)
    assert geo.shared_meta and geo.block_bytes == 4 * 4880
    assert (228 * 1024) // (geo.block_bytes + 1024) == 11
    odd = TorchSimConfig(n_lbas=100, segment_size=9, class_slots=3)
    assert treplay.warp_bytes(odd, False, False) == 96 + 16 + 2 * 48 + 16


def test_replay_geometry_keeps_metadata_in_global_memory_where_it_does_not_fit():
    """The metadata goes to shared memory when a block of MAX_WARPS volumes
    fits MAX_BLOCK_SMEM with it and the state's counts fit their narrow
    fields; otherwise it stays in global memory, whatever V. The pad row's
    counts are 32-bit, so neither a large class-slot count nor a large
    segment (every (C + 1) s, 32 x 4,096 included) sends it there by itself:
    only the rows' number does."""
    for cfg in (_main_run_config(), _main_run_config(class_slots=32),
                TorchSimConfig(n_lbas=16384, segment_size=4096, class_slots=32)):
        assert (cfg.n_class_slots + 1) * cfg.segment_size < 65536 or cfg.segment_size == 4096
        for stateful in (False, True):
            geo = treplay.geometry(cfg, 744, stateful)
            assert geo.shared_meta
            assert geo.block_bytes <= treplay.MAX_BLOCK_SMEM
    assert not treplay.geometry(_main_run_config(), 744, narrow=False).shared_meta
    big = TorchSimConfig(n_lbas=512, segment_size=8, n_segments=6000)
    for V in (1, 7, 744):
        geo = treplay.geometry(big, V)
        assert not geo.shared_meta
        assert geo.warp_bytes == treplay.warp_bytes(big, False, False)
        assert treplay.MAX_WARPS * treplay.warp_bytes(big, False, True) > treplay.MAX_BLOCK_SMEM
    scale = TorchSimConfig(n_lbas=262144, segment_size=128, gp_threshold=0.22)   # [scale]
    fits = treplay.MAX_WARPS * treplay.warp_bytes(scale, False, True) <= treplay.MAX_BLOCK_SMEM
    assert treplay.geometry(scale, 32).shared_meta == fits


def test_replay_geometry_constants_match_the_kernel_source():
    """MAX_WARPS, VARS_BYTES, SCAN_CHUNK and the segment-size limit are
    csrc/replay.cu's."""
    import re
    src = (build.CSRC / "replay.cu").read_text()
    assert int(re.search(r"constexpr int kScanChunk = (\d+);", src)[1]) == treplay.SCAN_CHUNK
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);", src)[1]) == treplay.MAX_WARPS
    assert int(re.search(r"sizeof\(Vars\)\)\) == (\d+)", src)[1]) == treplay.VARS_BYTES
    max_seg = int(re.search(r"constexpr int kMaxSegSize = (\d+);", src)[1])
    assert max_seg * 4 * 3 * treplay.MAX_WARPS < treplay.MAX_BLOCK_SMEM


@pytest.mark.parametrize("corrupt,narrow", [
    (lambda st, s: None, True),
    (lambda st, s: st["seg_nvalid"][:, -1].fill_(70_000), True),     # the pad row is 32-bit
    (lambda st, s: st["seg_n"][:, -1].fill_(5 * s), True),
    (lambda st, s: st["seg_n"][:, 0].fill_(s + 1), False),
    (lambda st, s: st["seg_nvalid"][1, 1].fill_(-1), False),
    (lambda st, s: st["seg_state"][:, 2].fill_(256), False),
    (lambda st, s: st["seg_cls"][0, 2].fill_(-1), False),
])
def test_replay_metadata_fits_its_narrow_fields(corrupt, narrow):
    """The metadata may live in shared memory only where every row but the
    pad row has its counts in [0, s] and every state and class is in
    [0, 255], as a state from `init_state` or a replay has them; the pad
    row's counts are 32-bit there, so they may be anything."""
    cfg, st, _ = _replay_inputs()
    corrupt(st, cfg.segment_size)
    assert treplay.narrow_metadata(cfg, st) == narrow
    assert treplay.geometry(cfg, 2, narrow=narrow).shared_meta == narrow
