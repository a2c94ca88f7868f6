"""The whole path on a Duck-class scene: the JAX kernels' tile-heap walk, a
paged bank, and the two probes of this path, against the JAX package.

The fixture is the port's Duck-class GLB (scene/duck.py) at reduced detail
(``detail=0.5``, a 64×64 body texture): 2622 triangles in 21 tiles, so the
JAX whole-path kernels walk their tile heap (TREE_MIN_TILES = 16) where the
port's take the flat tile loop, and 69,637 texels, so the JAX package
bakes a paged bank in the tiled page layout.
Inputs come from NumPy seeds; each test states its tolerance.  Run on the
CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_whole_tree.py``.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from PIL import Image

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.ops import mxu_intersect as jmi
from zig_raytracing_contest_tpu.render import fused as jfused
from zig_raytracing_contest_tpu.render.pipeline import (
    prepare_scene as jax_prepare,
    render_scene as jax_render,
)
from zig_raytracing_contest_tpu.scene import types as jtypes
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import INT32_MAX, INT32_MIN
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.grid.builder import scene_bbox
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.probes import check_fetch, sort_key
from zig_raytracing_contest_tpu_torch.render import fused
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par, trace_walk
from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb
from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.materials import load_materials
from zig_raytracing_contest_tpu_torch.scene.types import build_torch_scene, from_jax_scene

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "tests" / "assets"
DETAIL, TEX = 0.5, 64  # the reduced fixture
W, H = 64, 36


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test: beside other pytest workers a
    full thread pool per process oversubscribes the cores, and the twins'
    many small ops then wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_arrays(js, color_desc) -> dict:
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_bake import jax_scene_arrays

    return jax_scene_arrays(js, color_desc)


@pytest.fixture(scope="module")
def duck(tmp_path_factory):
    """(path, JAX scene, JAX camera, JAX materials' descriptors, port scene
    from the JAX arrays, port camera) of the reduced Duck-class GLB."""
    path = write_duck_glb(tmp_path_factory.mktemp("duck") / "duck.glb", tex_size=TEX,
                          detail=DETAIL)
    js, jcam, _ = jax_prepare(str(path), JConfig(grid_resolution=(8, 8, 8)), height=H)
    desc = jmat(jgltf(str(path))).color_desc
    ts = from_jax_scene(_jax_arrays(js, desc), device="cpu")
    _, cam, _ = prepare_scene(str(path), Config(), height=H, device="cpu")
    assert (cam.width, jcam.width) == (W, W)  # the camera's 16:9 aspect ratio
    return path, js, jcam, desc, ts, cam


def test_fixture_walks_the_tree_with_a_paged_bank(duck):
    _, js, _, _, ts, _ = duck
    assert ts.tile_bbox.shape[1] >= jmi.TREE_MIN_TILES
    assert ts.bank.shape[0] > jtypes.ONEHOT_MAX_TEXELS
    assert js.color_paged_t is not None and js.tiled_layout is not None
    assert trace_walk(ts) == "flat" and ts.bank_resident


@pytest.mark.parametrize("kw", [dict(detail=DETAIL, tex_size=TEX), dict()],
                         ids=["reduced", "full"])
def test_duck_writer_matches_duck_builder(kw, tmp_path):
    """(a) The port's writer against scripts/duck_builder.py: decoded
    texels, positions, normals, uvs, materials and indices equal (the PNG
    bytes come from another encoder)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from duck_builder import write_duck_glb as write_orig

    a = load_gltf(str(write_orig(tmp_path / "a.glb", **kw)))
    b = load_gltf(str(write_duck_glb(tmp_path / "b.glb", **kw)))
    assert len(a.images) == len(b.images) == 2
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x.pixels, y.pixels)
    ga, gb = load_geometry(a), load_geometry(b)
    for f in ("positions", "normals", "texcoords", "material_idx"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    for ma, mb in zip(a.doc["meshes"], b.doc["meshes"]):
        prim_a, prim_b = ma["primitives"][0], mb["primitives"][0]
        np.testing.assert_array_equal(a.accessor_array(prim_a["indices"]),
                                      b.accessor_array(prim_b["indices"]))
    assert a.doc["materials"] == b.doc["materials"] and a.doc["nodes"] == b.doc["nodes"]


def test_from_jax_scene_paged_duck(duck):
    """(b) from_jax_scene of the JAX package's paged bake equals the port's
    own bake array for array (records and bank row-major), and the bank is
    resident."""
    path, _, _, _, ts, _ = duck
    g = load_gltf(str(path))
    geo, mats = load_geometry(g), load_materials(g)
    own = build_torch_scene(geo, mats, scene_bbox(geo.positions), device="cpu")
    for f in ("tri_data", "tile_bbox", "tree_bbox", "group_bbox", "group_tree_bbox",
              "perm", "rec_table", "bank", "bbox_min", "bbox_max"):
        # (degenerate triangles bake NaN transforms: equal NaN for NaN)
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(own, f).numpy(), f)
    for f in ("tile", "emissive_dummy", "group_tiles", "bank_resident"):
        assert getattr(ts, f) == getattr(own, f), f
    assert own.bank_resident


def test_path_trace_fused_tree_and_paged_bank_match_twin(duck):
    """(c) One bounce of the JAX whole-path kernel (interpret mode: its
    tile-heap walk and paged texel fetch) against the port's twin on the
    same 512-lane state: rows 12-15 exactly; where the winners agree the
    winner index exactly and rows 0-11 to PR 1's tolerances (origins to 4
    f32 ULPs at the camera's scale, as interpret mode contracts multiply-
    adds into FMAs; directions to 1e-5, the libm ULPs of the scatter; the
    rest to f32 rounding).  Where they differ, both winners are hit at the
    same t (a tie, which the walk and the flat loop break by visit order)."""
    _, js, jcam, _, ts, cam = duck
    par = build_gen_par(ts, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(1, W, W, H, tiles_x=2)
    R = 512
    meta = (1024, 0, 0, 5, 1, 0, 0, 0)
    # bounce 0 by the twin; bounce 1 (diffuse rays) through both packages
    st, idx0 = fused.path_trace_gen_ref(ts, par, meta, R, 1, gen, emit_idx=True)
    jstate, jidx = jfused.path_trace_fused(
        js.mxu, jnp.asarray(st.numpy()), js.shade_table_t, jfused.resident_bank(js), 1,
        js.emissive_all_dummy is not None, interpret=True, lane_block=R, bounce0=1,
        prev=jnp.asarray(idx0.numpy()), emit_idx=True)
    state, idx = fused.path_trace_fused_ref(ts, st, 1, bounce0=1, prev=idx0,
                                            emit_idx=True)
    a, b = state.numpy(), np.asarray(jstate)
    np.testing.assert_array_equal(a[12:16].view(np.uint32), b[12:16].view(np.uint32))
    alive = st[12].numpy() > 0
    assert alive.sum() > R // 4
    ji = np.asarray(jidx)[0]
    same = (idx.numpy() == ji) | ~alive
    tied = np.nonzero(~same)[0]
    assert tied.size <= 2
    if tied.size:
        lane = torch.from_numpy(tied)
        o, d = st[0:3, lane], st[3:6, lane]
        hk, tk, _, _ = tmi.triangle_hit_ref(ts.tri_data, o, d, torch.from_numpy(ji[tied]))
        ht, tt, _, _ = tmi.triangle_hit_ref(ts.tri_data, o, d, idx[lane])
        assert bool(hk.all() and ht.all()) and torch.equal(tk, tt)
    for rows, tol in ((slice(0, 3), dict(rtol=3e-6, atol=4e-6)),
                      (slice(3, 6), dict(atol=1e-5)),
                      (slice(6, 12), dict(rtol=3e-6, atol=1e-6))):
        np.testing.assert_allclose(a[rows][:, same], b[rows][:, same], **tol)


def test_twin_frame_matches_jax_render(duck):
    """(d) A twin frame of the fixture against the JAX package's XLA path:
    segments within 0.5% and the opaque golden gate (|diff| > 3 on under
    0.5% of channels, mean under 1.0)."""
    path, js, jcam, _, _, _ = duck
    cfg = Config(num_samples=2, max_bounce=3, seed=4)
    scene, cam, _ = prepare_scene(str(path), cfg, height=H, device="cpu")
    img, st = render_scene(scene, cam, cfg)
    jimg, jst = jax_render(js, jcam, JConfig(grid_resolution=(8, 8, 8), num_samples=2,
                                             max_bounce=3, seed=4), use_fused=False)
    assert abs(st.segments - jst.segments) <= 0.005 * jst.segments
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert (diff > 3).mean() < 0.005 and diff.mean() < 1.0


def test_duck_glb_matches_golden(tmp_path):
    """(e) The port renders the full Duck-class GLB (9586 triangles in 75
    tiles, a 327,685-texel bank) at tests/test_golden.py's settings within
    its opaque gate of golden_duck.png."""
    glb = write_duck_glb(tmp_path / "duck.glb")
    cfg = Config(grid_resolution=(32, 32, 32), num_samples=4, max_bounce=3, seed=12345)
    scene, cam, _ = prepare_scene(str(glb), cfg, height=90, device="cpu")
    assert cam.width == 160 and scene.tile_bbox.shape[1] == 75
    assert trace_walk(scene) == "flat" and scene.bank_resident
    img, _ = render_scene(scene, cam, cfg)
    golden = np.asarray(Image.open(ASSETS / "golden_duck.png"))
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert (diff > 3).mean() < 0.005 and diff.mean() < 1.0


def _wall(num_tiles: int):
    """num_tiles·128 right triangles tiling the square [0, 1]² of the z = 0
    plane, facing +z."""
    n = num_tiles * 128
    k = int(np.ceil(np.sqrt(n / 2)))
    s = 1.0 / k
    cells = np.stack(np.meshgrid(np.arange(k), np.arange(k), indexing="ij"), -1)
    cells = cells.reshape(-1, 2)[: -(-n // 2)] * s
    v0 = np.concatenate([np.c_[cells, np.zeros(len(cells))],
                         np.c_[cells + s, np.zeros(len(cells))]])[:n]
    e1 = np.tile([s, 0.0, 0.0], (n, 1))
    e2 = np.tile([0.0, s, 0.0], (n, 1))
    e1[len(cells):], e2[len(cells):] = -e1[len(cells):], -e2[len(cells):]
    return v0, e1, e2


@pytest.mark.parametrize("num_tiles", [15, 16, 17])
def test_walk_rule_matches_jax(num_tiles):
    """(f) The port's walk rule against the JAX kernel's: the JAX whole-path
    kernel (interpret mode) on a wall of ``num_tiles`` tiles, with its tile
    heap replaced by always-miss boxes, hits the wall only when it takes
    the flat loop, below TREE_MIN_TILES = 16 tiles.  The port's whole-path
    kernels take the flat loop at every tile count (on the H100 it beat the
    walk from 21 to 249 tiles), so the port's trace, which never reads the
    heap, hits every lane of the wall on either side of 16."""
    v0, e1, e2 = _wall(num_tiles)
    tris = jmi.bake_triangles(v0, e1, e2, tile=128)
    assert tris.tile_bbox.shape[1] == num_tiles
    blind = dataclasses.replace(tris, tree_bbox=jnp.full(tris.tree_bbox.shape, jnp.inf))
    R = 512
    rng = np.random.default_rng(num_tiles)
    state = np.zeros((16, R), np.float32)
    state[0:2] = rng.uniform(0.05, 0.95, (2, R))
    state[2], state[5], state[12] = 1.0, -1.0, 1.0
    out = jfused.path_trace_fused(
        blind, jnp.asarray(state), jnp.zeros((24, tris.tri_data.shape[1]), jnp.float32),
        jnp.zeros((4, 128), jnp.float32), 1, True, interpret=True, lane_block=R)
    jax_tree = not bool((np.asarray(out)[12] > 0).any())
    assert jax_tree == (num_tiles >= jmi.TREE_MIN_TILES == 16)
    port = tmi.bake_triangles(v0, e1, e2, tile=128)
    scene = SimpleNamespace(tri_data=torch.from_numpy(port.tri_data), bank_resident=True)
    assert trace_walk(scene) == "flat"
    t = tmi.nearest_hit_ref(scene.tri_data, torch.from_numpy(port.tile_bbox), 128,
                            torch.from_numpy(state[0:3]), torch.from_numpy(state[3:6]),
                            torch.ones(R, dtype=torch.bool))[0]
    torch.testing.assert_close(t, torch.ones(R), rtol=0, atol=1e-6)


def _jax_corners(bank_u16, desc, base, demand):
    """JAX's paged fetch of the base texels ``base`` (row-major) through a
    pallas_call in interpret mode, as scripts/check_paged_tpu.py drives it,
    with _paged_corners' clamp reconciliation: (16, B) rows 4·corner +
    channel."""
    P = bank_u16.shape[0]
    q = jtypes._tiled_texel_map(P, desc)[0]
    corners = jtypes._paged_corner_maps(P, desc)  # row-major (4, P)
    bank = jnp.asarray(jtypes._pack_paged_bank(bank_u16, desc))
    B = base.shape[0]

    def kernel(bank_ref, idx_ref, demand_ref, out_ref):
        res = jfused._fetch_paged(bank_ref, [idx_ref[0, :]], demand_ref[0, :] != 0)[0]
        c = jfused._paged_corners(res, idx_ref[0, :], idx_ref[1, :], idx_ref[2, :])
        for corner in range(4):
            for ch in range(4):
                out_ref[4 * corner + ch, :] = c[corner][ch]

    idx = np.stack([q[corners[k][base]] for k in range(3)]).astype(np.int32)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((16, B), jnp.float32),
                         interpret=True)(bank, jnp.asarray(idx),
                                         jnp.asarray(demand.reshape(1, B).astype(np.int32)))
    return np.asarray(out)


_FETCH_CASES = [(n, name) for n in check_fetch.BANK_TEXELS
                for name in ("sequential", "random", "page-straddle")]


@pytest.mark.parametrize("n_texels,pattern", _FETCH_CASES + [(5 * 2048, "clamp edges")])
def test_texel_fetch_matches_jax_paged_fetch(n_texels, pattern):
    """(g) The texel-fetch twin against JAX's _fetch_paged + _paged_corners
    on scripts/check_paged_tpu.py's banks and index patterns, every 7th lane
    not demanded; the clamp case reads a clamp-clamp texture at its last
    column and row, where the corners collapse.  Bit-exact: both return
    u16 values."""
    bank, texture = check_fetch.make_bank(n_texels)
    off, w, h, _, _ = texture
    if pattern == "clamp edges":
        texture = (off, w, h, 0, 0)
        base = check_fetch.clamp_edge_case(texture)
    else:
        base = check_fetch.index_cases(bank.shape[0])[pattern]
    demand = check_fetch.demand_mask()
    u_min, u_max = (INT32_MIN, INT32_MAX) if texture[3] else (0, w - 1)
    desc = np.array([[off, w, h, u_min, u_max, 0, h - 1]], np.int64)
    want = _jax_corners(bank.astype(np.uint16), desc, base, demand)
    got = check_fetch.texel_fetch(torch.from_numpy(bank), texture, torch.from_numpy(base),
                                  torch.from_numpy(demand))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_key_matches_jax_emit_sort_key():
    """(h) sort_key_ref against JAX's _emit_sort_key through the
    tests/test_fused.py harness in interpret mode, bit-exact, on 256 lanes
    with lanes 5-8 dead; the probe's entry point on the CPU agrees."""
    state, (bmin, bmax) = sort_key.probe_state()
    par = sort_key.gen_par(bmin, bmax)

    def kernel(state_ref, par_ref, out_ref):
        out_ref[:, :] = state_ref[:, :]
        jfused._emit_sort_key(out_ref, par_ref)

    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((16, sort_key.LANES),
                                                                jnp.float32),
                         interpret=True)(jnp.asarray(state.numpy()),
                                         jnp.asarray(par.numpy()))
    want = np.asarray(jax.lax.bitcast_convert_type(out[15], jnp.int32))
    np.testing.assert_array_equal(fused.sort_key_ref(state, par).numpy(), want)
    assert (want >> 30 == 1).sum() == 4
    assert sort_key.run_checks("cpu") == [(f"{sort_key.LANES} lanes, lanes 5-8 dead",
                                           sort_key.LANES, 0, 0)]
