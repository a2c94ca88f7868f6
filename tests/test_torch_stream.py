"""The port's streaming regime and 3-stage bank against the JAX package.

Scenes past VMEM_RESIDENT_MAX_TRIS = 2^17 padded triangles stream: the JAX
package bakes them with ``_stream_tile`` tiles (256·2^k) and traces them
with its HBM-streaming kernel (``_make_trace_kernel_t_hbm``), which walks
the group heap (16 groups or more) or visits the groups nearest first in
distance bins (``_front_to_back_groups``, fewer groups).  Banks with no
resident form (more than ONEHOT_MAX_TEXELS texels and a tiled capacity
past PAGED_MAX_TEXELS) take its 3-stage shade: prep kernel, XLA gather of
u16×2-packed texels, shade kernel.  Here, on the CPU:

* the bake of a real streaming scene (``large_scene(side=260)``, 135,210
  triangles) equals the JAX package's, array for array, at its own tile
  and at a doubled one (STREAM_MAX_TILES lowered in both packages);
* the port's trace twin equals the JAX streaming kernel in interpret mode
  (forced by lowering its VMEM_RESIDENT_MAX_TRIS) on a bank of 31 tiles, in
  4 groups (the distance-bin branch) and in 16 groups of 2 (the group-tree
  branch), with records and previous hits;
* the port's shade equals the JAX 3-stage ``shade_fused`` in interpret mode
  (forced by lowering ONEHOT_MAX_TEXELS and PAGED_MAX_TEXELS to 0);
* the regime and the bank's shade equal the JAX package's on both sides of
  every edge;
* a small streaming frame equals the JAX package's frame bit for bit.

Tolerances are those of tests/test_torch_per_bounce.py.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bake import jax_scene_arrays
from test_torch_trace import _two_nearest

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.ops import mxu_intersect as jmi
from zig_raytracing_contest_tpu.ops import rng as jrng
from zig_raytracing_contest_tpu.render import wavefront as jwave
from zig_raytracing_contest_tpu.render.fused import shade_fused as jax_shade
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu.render.pipeline import render_scene as jax_render
from zig_raytracing_contest_tpu.scene import types as jtypes
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jgeo
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.grid.builder import scene_bbox
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.render import fused, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene import types as ttypes
from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.materials import load_materials
from zig_raytracing_contest_tpu_torch.scene.types import (
    TorchScene,
    build_torch_scene,
    from_jax_scene,
)

REPO = Path(__file__).resolve().parent.parent
R = 512


@pytest.fixture(scope="module")
def terrain_260(tmp_path_factory):
    """``large_scene(side=260)``: 135,210 triangles, past 2^17, as each
    package loads it."""
    path = tproc.large_scene(tmp_path_factory.mktemp("t260") / "l.gltf", side=260)
    jg, tg = jgltf(str(path)), load_gltf(str(path))
    return jgeo(jg), jmat(jg), load_geometry(tg), load_materials(tg)


@pytest.mark.parametrize("max_tiles, tile", [(8192, 256), (512, 512)])
def test_streaming_bake_equals_jax(terrain_260, max_tiles, tile, monkeypatch):
    jgeom, jm, tgeom, tm = terrain_260
    assert tgeom.num_triangles == 135_210 > tmi.VMEM_RESIDENT_MAX_TRIS
    monkeypatch.setattr(jtypes, "STREAM_MAX_TILES", max_tiles)
    monkeypatch.setattr(ttypes, "STREAM_MAX_TILES", max_tiles)
    js = build_device_scene(jgeom, build_grid(jgeom.positions, (4, 4, 4)), jm,
                            backend="mxu")
    ts = build_torch_scene(tgeom, tm, scene_bbox(tgeom.positions), device="cpu")
    assert ts.tile == js.mxu.tile == tile
    nt = -(-135_210 // tile)
    assert ts.tile_bbox.shape[1] == nt and ts.group_bbox.shape[1] == -(-nt // 8)
    for f in ("tri_data", "tile_bbox", "group_bbox", "tree_bbox", "group_tree_bbox"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js.mxu, f)), f)
    np.testing.assert_array_equal(ts.perm.numpy(), np.asarray(js.mxu.perm))
    np.testing.assert_array_equal(ts.rec_table.numpy(), np.asarray(js.shade_table_t))
    assert ts.group_tiles == js.mxu.group_tiles
    # 67 texels: the one-hot bank, a resident one
    assert ts.bank_resident and js.color_u16f_t is not None
    fj = from_jax_scene(jax_scene_arrays(js), device="cpu")
    for f in ("tri_data", "group_tree_bbox", "rec_table", "bank"):
        assert torch.equal(getattr(fj, f), getattr(ts, f)), f
    assert tmi.streams_bank(ts)
    assert wavefront.regime(ts) == "streaming, sorted"


def _bench_scenes(tmp_path, monkeypatch):
    """A bench-style scene baked by the JAX package without a resident bank
    (its 3-stage shade), and the port's matching TorchScene bank."""
    g = jgltf(str(tproc.bench_scene(tmp_path / "b.gltf", num_objects=20)))
    geo = jgeo(g)
    monkeypatch.setattr(jtypes, "ONEHOT_MAX_TEXELS", 0)
    monkeypatch.setattr(jtypes, "PAGED_MAX_TEXELS", 0)
    js = build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)), jmat(g),
                            backend="mxu")
    monkeypatch.undo()
    assert js.color_u16f_t is None and js.color_paged_t is None
    assert js.tiled_layout is None
    return js, geo.num_triangles


@pytest.fixture(scope="module", params=[8, 2], ids=["4-groups", "16-groups"])
def streamed(request, tmp_path_factory):
    """One bounce-1 wave traced by the port's twin and by the JAX streaming
    kernel: a 3900-triangle bank of 31 tiles of 128 (the last group short
    of tiles), in groups of 8 (4 groups: JAX's distance-bin branch) or 2
    (16 groups: its group-tree branch); 512 rays, 90% alive, half of them
    excluding a previous hit; records of a 3-stage bench-style scene."""
    group_tiles = request.param
    with pytest.MonkeyPatch.context() as mp:
        js, num_tris = _bench_scenes(tmp_path_factory.mktemp("stream"), mp)
    r = np.random.default_rng(5)
    T = 3900
    v0 = r.uniform(-5, 5, (T, 3)).astype(np.float32)
    e1 = r.normal(0, 0.5, (T, 3)).astype(np.float32)
    e2 = r.normal(0, 0.5, (T, 3)).astype(np.float32)
    tris = tmi.bake_triangles(v0, e1, e2, tile=128, group_tiles=group_tiles)
    jtris = jmi.bake_triangles(v0, e1, e2, tile=128, group_tiles=group_tiles)
    nt, ng = tris.tile_bbox.shape[1], tris.group_bbox.shape[1]
    assert nt == 31 and ng == -(-31 // group_tiles)
    assert (ng >= jmi.TREE_MIN_TILES) == (group_tiles == 2)
    tp = tris.tri_data.shape[1]
    rs = np.random.default_rng(2025)
    table = np.asarray(js.shade_table_t)[:, rs.integers(0, num_tris, tp)]
    ts = TorchScene(
        tri_data=torch.from_numpy(tris.tri_data),
        tile_bbox=torch.from_numpy(tris.tile_bbox),
        tree_bbox=torch.from_numpy(tris.tree_bbox),
        group_bbox=torch.from_numpy(tris.group_bbox),
        group_tree_bbox=torch.from_numpy(tris.group_tree_bbox),
        perm=torch.from_numpy(tris.perm.astype(np.int64)),
        rec_table=torch.from_numpy(np.ascontiguousarray(table)),
        bank=from_jax_scene(jax_scene_arrays(js), device="cpu").bank,
        bbox_min=torch.zeros(3),
        bbox_max=torch.ones(3),
        tile=tris.tile,
        emissive_dummy=js.emissive_all_dummy is not None,
        group_tiles=group_tiles,
        bank_resident=False,
    )

    orig = rs.uniform(-4, 4, (R, 3)).astype(np.float32)
    dirs = rs.standard_normal((R, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    alive = rs.uniform(size=R) < 0.9
    streams = np.asarray(jrng.ray_streams(jnp.uint32(13), jnp.arange(R, dtype=jnp.int32)))
    state = np.zeros((16, R), np.float32)
    state[0:3], state[3:6] = orig.T, dirs.T
    state[6:9] = rs.uniform(0.2, 1.0, (3, R))
    state[9:12] = rs.uniform(0.0, 0.3, (3, R))
    state[12] = alive
    state[13] = streams.view(np.float32)
    state[14] = 1.0
    first = tmi.trace_emit_aux_ref(ts, torch.from_numpy(state))
    hit0 = np.isfinite(first[0][2].numpy())
    prev = np.where(hit0 & (rs.uniform(size=R) < 0.5), first[1].numpy(), -1)
    prev = prev.astype(np.int32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmi, "VMEM_RESIDENT_MAX_TRIS", 0)
        assert wavefront.regime(ts) == "streaming"
        port = tmi.trace_emit_aux(ts, torch.from_numpy(state), rec_table=ts.rec_table,
                                  prev=torch.from_numpy(prev))
        mp.setattr(jmi, "VMEM_RESIDENT_MAX_TRIS", 0)  # the streaming kernel
        jmi.trace_emit_aux._clear_cache()
        try:
            jax_out = jmi.trace_emit_aux(
                jtris, jnp.asarray(state), rec_table=jnp.asarray(table), interpret=True,
                prev=jnp.asarray(prev),
            )
        finally:
            jmi.trace_emit_aux._clear_cache()
    return SimpleNamespace(js=js, ts=ts, tris=tris, state=state, alive=alive,
                           prev=prev, orig=orig, dirs=dirs,
                           port=port, jax=tuple(np.array(a) for a in jax_out))


def test_trace_twin_matches_jax_streaming_kernel(streamed):
    """aux rows 3-4 on every lane; on live lanes t (to the tolerance of
    tests/test_torch_per_bounce.py), u/v, the winner where no second hit
    lies within 1e-6·t, and the record wherever the winners agree."""
    aux, idx, rec = (a.numpy() for a in streamed.port)
    jaux, jidx, jrec = streamed.jax
    live = streamed.alive
    np.testing.assert_array_equal(aux[3:5].view(np.uint32), jaux[3:5].view(np.uint32))
    t, tj = aux[2][live], jaux[2][live]
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() > R // 5, "fixture rays must hit the bank"
    m = streamed.tris.tri_data[:, jidx[live][hit]]
    o, d = streamed.orig[live][hit].T, streamed.dirs[live][hit].T
    dw = np.abs(m[6] * d[0] + m[7] * d[1] + m[8] * d[2])
    terms = (np.abs(m[6] * o[0]) + np.abs(m[7] * o[1]) + np.abs(m[8] * o[2])
             + np.abs(m[11]) + tj[hit] * (np.abs(m[6] * d[0]) + np.abs(m[7] * d[1])
                                         + np.abs(m[8] * d[2])))
    tol = 1e-6 + 1e-6 * tj[hit] + 4 * np.finfo(np.float32).eps * terms / dw
    assert (np.abs(t[hit] - tj[hit]) <= tol).all()
    assert (np.abs(t[hit] - tj[hit]) <= 1e-6 + 1e-6 * tj[hit]).mean() > 0.99
    np.testing.assert_allclose(aux[0:2][:, live][:, hit], jaux[0:2][:, live][:, hit],
                               atol=1e-5)
    t1, t2 = _two_nearest(SimpleNamespace(mxu=streamed.tris), streamed.orig,
                          streamed.dirs, streamed.prev)
    with np.errstate(invalid="ignore"):
        clear = (np.isfinite(t1) & ~(np.abs(t2 - t1) <= 1e-6 * t1))[live] & hit
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(idx[live][clear], jidx[live][clear])
    excl = live & (streamed.prev >= 0) & np.isfinite(aux[2])
    assert excl.sum() > 0 and (idx[excl] != streamed.prev[excl]).all()
    same = live & (idx == jidx)
    np.testing.assert_array_equal(rec[:, same], jrec[:, same])
    np.testing.assert_array_equal(rec[:, ~np.isfinite(aux[2])], 0.0)
    # the padded tiles of the last group are never swept: the winners are real
    T = 3900
    assert (idx[np.isfinite(aux[2])] < T).all()


def test_shade_twin_matches_jax_three_stage_shade(streamed):
    """Both packages shade the JAX streaming trace's outputs (bounce 1) with
    a bank that has no resident form: the JAX package in three steps, the
    port in one."""
    jaux, jidx, jrec = streamed.jax
    want = np.asarray(jax_shade(
        streamed.js, jnp.asarray(streamed.state), jnp.asarray(jaux), jnp.asarray(jidx),
        1, interpret=True, block_skip=True, rec=jnp.asarray(jrec),
    ))
    assert wavefront.shade_bank(streamed.ts) == "3-stage bank"
    got = fused.shade_fused(streamed.ts, torch.from_numpy(streamed.state),
                            torch.from_numpy(jaux), torch.from_numpy(jidx), 1,
                            rec=torch.from_numpy(jrec)).numpy()
    np.testing.assert_array_equal(got[12:16].view(np.uint32), want[12:16].view(np.uint32))
    np.testing.assert_allclose(got[0:3], want[0:3], rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(got[3:6], want[3:6], atol=1e-5)
    np.testing.assert_allclose(got[6:12], want[6:12], rtol=3e-6, atol=1e-6)
    live_hit = streamed.alive & np.isfinite(jaux[2])
    assert live_hit.sum() > R // 5
    through = live_hit & (got[3:6] == streamed.state[3:6]).all(axis=0)
    assert through.sum() > 0, "alpha pass-through unexercised"
    np.testing.assert_array_equal(got[:, ~streamed.alive],
                                  streamed.state[:, ~streamed.alive])


def _jax_mock(tp: int, resident: bool):
    """The parts of a JAX DeviceScene that its whole_path_regime reads."""
    bank = np.zeros((4, 128), np.float32)
    return SimpleNamespace(
        mxu=SimpleNamespace(tri_data=np.empty((16, tp), np.float32)),
        color_u16f_t=bank if resident else None, color_paged_t=None,
        shade_table_t=np.zeros((24, 1), np.float32),
    )


def _port_mock(tp: int, resident: bool) -> TorchScene:
    z = torch.zeros(6, 1)
    return TorchScene(
        tri_data=torch.empty((16, tp)), tile_bbox=z, tree_bbox=z, group_bbox=z,
        group_tree_bbox=z, perm=torch.zeros(1, dtype=torch.int64), rec_table=z,
        bank=torch.zeros(1, 4), bbox_min=torch.zeros(3), bbox_max=torch.ones(3),
        tile=128, emissive_dummy=True, group_tiles=8, bank_resident=resident,
    )


def _desc(*textures):
    """color_desc rows [offset, w, h, ...] of textures (w, h) laid end to
    end after three 1×1 factor entries."""
    rows, off = [], 0
    for w, h in ((1, 1),) * 3 + textures:
        rows.append([off, w, h, 0, w - 1, 0, h - 1])
        off += w * h
    return np.asarray(rows, np.int64), off


@pytest.mark.parametrize("textures", [
    (), ((32, 31),), ((33, 31),), ((1024, 992),), ((1024, 1024),),
    ((2048, 1024),), ((512, 512), (1024, 736)), ((512, 512), (1024, 768)),
])
def test_regime_and_bank_match_jax(textures):
    """The bank's resident form (one-hot up to 1024 texels, else a tiled
    capacity within 2^20) and the regime at every triangle edge (2^15,
    2^16, 2^17 padded), against the JAX package's rules on the same inputs:
    its paged-bank decision in build_device_scene and its whole_path_regime
    with use_fused."""
    desc, P = _desc(*textures)
    j_resident = (P <= jtypes.ONEHOT_MAX_TEXELS
                  or jtypes._tiled_texel_map(P, desc)[2] <= jtypes.PAGED_MAX_TEXELS)
    resident = ttypes.bank_is_resident(P, desc)
    assert resident == j_resident
    for got, want in zip(ttypes.tiled_texel_map(P, desc), jtypes._tiled_texel_map(P, desc)):
        np.testing.assert_array_equal(got, want)
    for tp in (1 << 15, (1 << 15) + 1024, 1 << 16, (1 << 16) + 1024, 1 << 17,
               (1 << 17) + 1024):
        port = _port_mock(tp, resident)
        whole = jwave.whole_path_regime(_jax_mock(tp, j_resident), use_fused=True)
        assert wavefront.whole_path_regime(port) == whole
        assert tmi.streams_bank(port) == (tp > jmi.VMEM_RESIDENT_MAX_TRIS)
        assert wavefront.sorts_every_bounce(port) == (tp > jwave.SORT_MIN_TRIS)
        want = ("whole path" if whole else
                ("streaming" if tp > jmi.VMEM_RESIDENT_MAX_TRIS else "per-bounce")
                + (", sorted" if tp > jwave.SORT_MIN_TRIS else ""))
        assert wavefront.regime(port) == want
        assert wavefront.shade_bank(port) == ("resident bank" if j_resident
                                              else "3-stage bank")


@pytest.mark.parametrize("num_tris", [
    (1 << 17), (1 << 17) + 1, 256 * 8192, 256 * 8192 + 1, 512 * 8192 + 1,
])
def test_bake_tile_matches_jax(num_tris):
    """The tile rule on the raw count: 128 up to VMEM_RESIDENT_MAX_TRIS,
    then 256 doubled until at most STREAM_MAX_TILES tiles
    (build_device_scene)."""
    want = (jtypes.TRI_TILE_SMALL if num_tris <= jtypes.VMEM_RESIDENT_MAX_TRIS
            else jtypes._stream_tile(num_tris))
    assert ttypes.bake_tile(num_tris) == want


@pytest.fixture(scope="module")
def terrain_48(tmp_path_factory):
    path = tproc.large_scene(tmp_path_factory.mktemp("t48") / "l.gltf", side=48)
    cam_kw = dict(camera_name="Camera 1", width=64, height=36)
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=5)
    js, jcam, _ = jax_prepare(str(path), jcfg, **cam_kw)
    jimg, jst = jax_render(js, jcam, jcfg, use_fused=False)
    return path, cam_kw, jimg, jst


@pytest.mark.parametrize("bank", ["resident", "3-stage"])
def test_streaming_frame_matches_jax(terrain_48, bank, monkeypatch):
    """The port's streaming frame (every threshold lowered below the
    terrain's 5120 padded triangles; the bank's resident bounds too for
    the 3-stage bank) against the JAX package's XLA frame, bit for bit."""
    path, cam_kw, jimg, jst = terrain_48
    if bank == "3-stage":
        monkeypatch.setattr(ttypes, "ONEHOT_MAX_TEXELS", 0)
        monkeypatch.setattr(ttypes, "PAGED_MAX_TEXELS", 0)
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=1 << 12)
    scene, cam, _ = pipeline.prepare_scene(str(path), cfg, device="cpu", **cam_kw)
    for mod, name in ((tmi, "REC_EMIT_MAX_TRIS"), (tmi, "VMEM_RESIDENT_MAX_TRIS"),
                      (wavefront, "SORT_MIN_TRIS")):
        monkeypatch.setattr(mod, name, 4096)
    assert wavefront.regime(scene) == "streaming, sorted"
    assert wavefront.shade_bank(scene) == f"{bank} bank"
    img, st = pipeline.render_scene(scene, cam, cfg)
    assert st.segments == jst.segments
    np.testing.assert_array_equal(img, jimg)


def test_streaming_frame_imports_no_jax(tmp_path):
    """A streaming frame with a 3-stage bank, rendered on the CPU in a fresh
    process, imports neither JAX, Pillow nor the JAX package, and logs its
    regime."""
    code = (
        "import logging, sys\n"
        "logging.basicConfig(level=logging.INFO)\n"
        "from zig_raytracing_contest_tpu_torch.config import Config\n"
        "from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi\n"
        "from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront\n"
        "from zig_raytracing_contest_tpu_torch.scene import types\n"
        "from zig_raytracing_contest_tpu_torch.scene.procedural import large_scene\n"
        "mi.REC_EMIT_MAX_TRIS = mi.VMEM_RESIDENT_MAX_TRIS = 1024\n"
        "wavefront.SORT_MIN_TRIS = 1024\n"
        "types.PAGED_MAX_TEXELS = types.ONEHOT_MAX_TEXELS = 0\n"
        f"p = large_scene({str(tmp_path / 'l.gltf')!r}, side=24)\n"
        "cfg = Config(num_samples=1, max_bounce=2)\n"
        "s, cam, _ = pipeline.prepare_scene(str(p), cfg, camera_name='Camera 1',\n"
        "                                   width=16, height=8, device='cpu')\n"
        "print(pipeline.render_scene(s, cam, cfg)[1].segments)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL'"
        ", 'zig_raytracing_contest_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Intersection backend: streaming, sorted on cpu (3-stage bank)" in res.stderr
