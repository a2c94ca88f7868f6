"""The port's per-bounce pipeline against the JAX package.

Scenes past REC_EMIT_MAX_TRIS padded triangles render per bounce: one
``trace_emit_aux`` and one ``shade_fused`` call each, with a beam sort
before every bounce past SORT_MIN_TRIS.  Here the port's twins (the CPU
bodies of those wrappers) are held against the JAX package on the CPU:

* ``trace_emit_aux`` against the JAX function in interpret mode on a
  32-tile bank, with REC_EMIT_MAX_TRIS lowered to 0 so the JAX kernel takes
  the HBM-table path with deferred winner extraction and the tile-tree walk
  (the ``--large`` frame's kernel);
* ``shade_fused`` against the JAX function in interpret mode with
  ``block_skip`` on the JAX trace's outputs, with a one-hot bank;
* whole frames of a small ``--large`` terrain, unsorted and sorted, against
  the JAX package's ``render_scene`` on the CPU (its XLA path);
* the regime boundaries and the device defaults of the entry points.

Tolerances are those of tests/test_torch_trace.py and tests/test_torch_shade.py:
XLA:CPU contracts the transform's multiply-adds into FMAs and PyTorch does
not, so t is held to rtol 1e-6 plus atol 1e-6 (one f32 ULP at the scene's
coordinate scale; on grazing hits also to the transform's own rounding),
u/v to 1e-5 and the winner exactly wherever the nearest
and second-nearest hit are more than 1e-6·t apart; shading keeps rows
12-15 exact, value rows to rtol 3e-6 / atol 1e-6 (f32 reassociation of the
blends) and direction rows to 1e-5 (libm log/cos/sin/rsqrt ULPs).  The
terrain's frames equal the JAX package's bit for bit, as the single-sided
scenes of tests/test_torch_render.py do.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trace import _two_nearest

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.ops import mxu_intersect as jmi
from zig_raytracing_contest_tpu.ops import rng as jrng
from zig_raytracing_contest_tpu.render.fused import shade_fused as jax_shade
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu.render.pipeline import render_scene as jax_render
from zig_raytracing_contest_tpu.render.wavefront import wave_pixel_coords as jax_pixels
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jgeo
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.grid.builder import scene_bbox
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.ops.rng import ray_streams, uniform2_soa
from zig_raytracing_contest_tpu_torch.render import fused, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.materials import load_materials
from zig_raytracing_contest_tpu_torch.scene.types import (
    TorchScene,
    build_torch_scene,
    from_jax_scene,
)

REPO = Path(__file__).resolve().parent.parent
R = 1024


def _random_banks(seed, T=4000):
    """tests/test_tree.py's ≥ 16-tile random bank (32 tiles of 128), baked
    by each package (the bakes are equal: tests/test_torch_bake.py)."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-5, 5, (T, 3)).astype(np.float32)
    e1 = r.normal(0, 0.5, (T, 3)).astype(np.float32)
    e2 = r.normal(0, 0.5, (T, 3)).astype(np.float32)
    return (tmi.bake_triangles(v0, e1, e2, tile=128),
            jmi.bake_triangles(v0, e1, e2, tile=128))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One bounce-1 wave traced by both packages: 1024 rays, 90% alive,
    half of them excluding a previous hit.  The records come from a
    bench-style scene's table (so shading reads real texel descriptors),
    one real record per triangle of the random bank."""
    d = tmp_path_factory.mktemp("per_bounce")
    g = jgltf(str(tproc.bench_scene(d / "b.gltf", num_objects=20)))
    geo = jgeo(g)
    js = build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)), jmat(g),
                            backend="mxu")
    assert js.color_u16f_t is not None  # the one-hot bank
    tris, jtris = _random_banks(3)
    tp = tris.tri_data.shape[1]
    rs = np.random.default_rng(2024)
    table = np.asarray(js.shade_table_t)[:, rs.integers(0, geo.num_triangles, tp)]
    P = js.color_data.shape[0]
    ts = TorchScene(
        tri_data=torch.from_numpy(tris.tri_data),
        tile_bbox=torch.from_numpy(tris.tile_bbox),
        tree_bbox=torch.from_numpy(tris.tree_bbox),
        group_bbox=torch.from_numpy(tris.group_bbox),
        group_tree_bbox=torch.from_numpy(tris.group_tree_bbox),
        perm=torch.from_numpy(tris.perm.astype(np.int64)),
        rec_table=torch.from_numpy(np.ascontiguousarray(table)),
        bank=torch.from_numpy(np.asarray(js.color_u16f_t)[:, :P].T.copy()),
        bbox_min=torch.zeros(3),
        bbox_max=torch.ones(3),
        tile=tris.tile,
        emissive_dummy=js.emissive_all_dummy is not None,
        group_tiles=tris.group_tiles,
        bank_resident=True,
    )
    assert tris.tile_bbox.shape[1] >= jmi.TREE_MIN_TILES

    orig = rs.uniform(-4, 4, (R, 3)).astype(np.float32)
    dirs = rs.standard_normal((R, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    alive = rs.uniform(size=R) < 0.9
    streams = np.asarray(jrng.ray_streams(jnp.uint32(11), jnp.arange(R, dtype=jnp.int32)))
    state = np.zeros((16, R), np.float32)
    state[0:3], state[3:6] = orig.T, dirs.T
    state[6:9] = rs.uniform(0.2, 1.0, (3, R))
    state[9:12] = rs.uniform(0.0, 0.3, (3, R))
    state[12] = alive
    state[13] = streams.view(np.float32)
    state[14] = 1.0
    # previous hits: each ray's own nearest triangle on half the lanes
    first = tmi.trace_emit_aux_ref(ts, torch.from_numpy(state))
    hit0 = np.isfinite(first[0][2].numpy())
    prev = np.where(hit0 & (rs.uniform(size=R) < 0.5), first[1].numpy(), -1)
    prev = prev.astype(np.int32)

    port = tmi.trace_emit_aux(ts, torch.from_numpy(state), rec_table=ts.rec_table,
                              prev=torch.from_numpy(prev))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmi, "REC_EMIT_MAX_TRIS", 0)  # the HBM table, deferred records
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


def test_trace_emit_aux_matches_jax(traced):
    """aux rows 0-4, the winner and its record, on live lanes (the JAX
    kernel sweeps whole lane blocks, so its dead lanes hold hits the
    pipeline never reads); rows 3-4 on every lane."""
    aux, idx, rec = (a.numpy() for a in traced.port)
    jaux, jidx, jrec = traced.jax
    live = traced.alive
    np.testing.assert_array_equal(aux[3:5].view(np.uint32), jaux[3:5].view(np.uint32))
    t, tj = aux[2][live], jaux[2][live]
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() > R // 5, "fixture rays must hit the bank"
    # test_torch_trace.py's rtol/atol, widened on grazing hits by the rounding of the
    # transform itself: one f32 ULP of o'_w's and t·d'_w's terms over |d'_w|
    # per operation the two frameworks round differently (4 of them).
    m = traced.tris.tri_data[:, jidx[live][hit]]
    o, d = traced.orig[live][hit].T, traced.dirs[live][hit].T
    dw = np.abs(m[6] * d[0] + m[7] * d[1] + m[8] * d[2])
    terms = (np.abs(m[6] * o[0]) + np.abs(m[7] * o[1]) + np.abs(m[8] * o[2])
             + np.abs(m[11]) + tj[hit] * (np.abs(m[6] * d[0]) + np.abs(m[7] * d[1])
                                         + np.abs(m[8] * d[2])))
    tol = 1e-6 + 1e-6 * tj[hit] + 4 * np.finfo(np.float32).eps * terms / dw
    assert (np.abs(t[hit] - tj[hit]) <= tol).all()
    assert (np.abs(t[hit] - tj[hit]) <= 1e-6 + 1e-6 * tj[hit]).mean() > 0.99
    np.testing.assert_allclose(aux[0:2][:, live][:, hit], jaux[0:2][:, live][:, hit],
                               atol=1e-5)
    prev_m = np.where(traced.prev >= 0, traced.prev, -1)
    t1, t2 = _two_nearest(SimpleNamespace(mxu=traced.tris), traced.orig, traced.dirs,
                          prev_m)
    with np.errstate(invalid="ignore"):
        clear = (np.isfinite(t1) & ~(np.abs(t2 - t1) <= 1e-6 * t1))[live] & hit
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(idx[live][clear], jidx[live][clear])
    # the excluded triangle is never the winner
    excl = live & (traced.prev >= 0) & np.isfinite(aux[2])
    assert excl.sum() > 0 and (idx[excl] != traced.prev[excl]).all()
    # the record is the winner's column; a miss or a dead lane reads zeros
    same = live & (idx == jidx)
    np.testing.assert_array_equal(rec[:, same], jrec[:, same])
    np.testing.assert_array_equal(rec[:, ~np.isfinite(aux[2])], 0.0)
    # per-ray diagnostics: tiles swept, tile boxes tested (every real tile)
    nt = traced.tris.tile_bbox.shape[1]
    assert (aux[5] <= nt).all() and (aux[5][live & np.isfinite(aux[2])] >= 1).all()
    np.testing.assert_array_equal(aux[6], nt * traced.alive.astype(np.float32))
    np.testing.assert_array_equal(aux[7], 0.0)
    # without a record table: the same hits and no records
    aux_n, idx_n, rec_n = tmi.trace_emit_aux(traced.ts, torch.from_numpy(traced.state),
                                             prev=torch.from_numpy(traced.prev))
    assert rec_n is None
    # (row 3 holds RNG streams as f32 bit patterns, some of them NaN)
    assert torch.equal(aux_n.view(torch.int32), traced.port[0].view(torch.int32))
    assert torch.equal(idx_n, traced.port[1])


def test_triangle_hit_ref_reproduces_the_winner(traced):
    """The check of a tied lane recomputes the winner's hit alone; on the
    twin's own winners it gives back t, u and v bit for bit, and a triangle
    the ray misses reads as no hit."""
    aux, idx, _ = traced.port
    hit = torch.isfinite(aux[2])
    st = torch.from_numpy(traced.state)
    ok, t, u, v = tmi.triangle_hit_ref(traced.ts.tri_data, st[0:3, hit], st[3:6, hit],
                                       idx[hit])
    assert bool(ok.all())
    for got, want in ((t, aux[2]), (u, aux[0]), (v, aux[1])):
        assert torch.equal(got, want[hit])
    other = (idx[hit] + 1) % traced.tris.tri_data.shape[1]
    ok2, t2, _, _ = tmi.triangle_hit_ref(traced.ts.tri_data, st[0:3, hit], st[3:6, hit],
                                         other)
    assert not bool((ok2 & (t2 == aux[2][hit])).any())


def test_shade_fused_matches_jax(traced):
    """Both packages shade the JAX trace's outputs (bounce 1)."""
    jaux, jidx, jrec = traced.jax
    want = np.asarray(jax_shade(
        traced.js, jnp.asarray(traced.state), jnp.asarray(jaux), jnp.asarray(jidx), 1,
        interpret=True, block_skip=True, rec=jnp.asarray(jrec),
    ))
    got = fused.shade_fused(traced.ts, torch.from_numpy(traced.state),
                            torch.from_numpy(jaux), torch.from_numpy(jidx), 1,
                            rec=torch.from_numpy(jrec)).numpy()
    np.testing.assert_array_equal(got[12:16].view(np.uint32), want[12:16].view(np.uint32))
    np.testing.assert_allclose(got[0:3], want[0:3], rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(got[3:6], want[3:6], atol=1e-5)
    np.testing.assert_allclose(got[6:12], want[6:12], rtol=3e-6, atol=1e-6)
    live_hit = traced.alive & np.isfinite(jaux[2])
    through = live_hit & (got[3:6] == traced.state[3:6]).all(axis=0)
    assert through.sum() > 0, "alpha pass-through unexercised"
    dead = ~traced.alive
    np.testing.assert_array_equal(got[:, dead], traced.state[:, dead])
    # without records the wrapper gathers them from the scene's table
    gathered = fused.shade_fused(traced.ts, torch.from_numpy(traced.state),
                                 torch.from_numpy(jaux), torch.from_numpy(jidx), 1).numpy()
    np.testing.assert_array_equal(gathered.view(np.uint32), got.view(np.uint32))


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """A small ``--large`` terrain (side 48: 4618 triangles in 37 tiles)
    and the JAX package's frame of it on the CPU."""
    path = tproc.large_scene(tmp_path_factory.mktemp("terrain") / "l.gltf", side=48)
    cam_kw = dict(camera_name="Camera 1", width=64, height=36)
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=5)
    js, jcam, _ = jax_prepare(str(path), jcfg, **cam_kw)
    jimg, jst = jax_render(js, jcam, jcfg, use_fused=False)
    return path, cam_kw, jimg, jst


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_per_bounce_frame_matches_jax(terrain, sort, monkeypatch):
    """The port's per-bounce frame (thresholds lowered below the terrain's
    5120 padded triangles) against the JAX package's XLA frame, which has
    no regimes, bit for bit: a fault in the sort, the unsort or the carried
    previous hit shows as a changed pixel.  Waves of 2^12 rays, so the last
    wave runs past the image."""
    path, cam_kw, jimg, jst = terrain
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=1 << 12)
    scene, cam, _ = pipeline.prepare_scene(str(path), cfg, device="cpu", **cam_kw)
    assert tuple(scene.tri_data.shape) == (16, 5120)
    assert tuple(scene.tree_bbox.shape) == (6, 128) and scene.tile_bbox.shape[1] == 37
    monkeypatch.setattr(tmi, "REC_EMIT_MAX_TRIS", 4096)
    if sort:
        monkeypatch.setattr(wavefront, "SORT_MIN_TRIS", 4096)
    assert wavefront.regime(scene) == ("per-bounce, sorted" if sort else "per-bounce")
    img, st = pipeline.render_scene(scene, cam, cfg)
    assert st.segments == jst.segments
    np.testing.assert_array_equal(img, jimg)


def _scene_of(num_padded_tris: int, bank_resident: bool = True) -> TorchScene:
    z = torch.zeros(6, 1)
    return TorchScene(
        tri_data=torch.empty((16, num_padded_tris)), tile_bbox=z, tree_bbox=z,
        group_bbox=z, group_tree_bbox=z, perm=torch.zeros(1, dtype=torch.int64),
        rec_table=z, bank=torch.zeros(1, 4), bbox_min=torch.zeros(3),
        bbox_max=torch.ones(3), tile=128, emissive_dummy=True, group_tiles=8,
        bank_resident=bank_resident,
    )


@pytest.mark.parametrize("tris, want", [
    (1 << 15, "whole path"),
    ((1 << 15) + 1024, "per-bounce"),
    (1 << 16, "per-bounce"),
    ((1 << 16) + 1024, "per-bounce, sorted"),
    (1 << 17, "per-bounce, sorted"),
    ((1 << 17) + 1, "streaming, sorted"),
])
def test_regime_boundaries(tris, want):
    """REC_EMIT_MAX_TRIS = 2^15, SORT_MIN_TRIS = 2^16 and the resident
    bound VMEM_RESIDENT_MAX_TRIS = 2^17, past which the trace streams; a
    bank without a resident form leaves the whole path for the per-bounce
    pipeline (tests/test_torch_stream.py holds these edges against the JAX
    package)."""
    scene = _scene_of(tris)
    assert wavefront.regime(scene) == want
    assert wavefront.shade_bank(scene) == "resident bank"
    whole = want == "whole path"
    assert wavefront.whole_path_regime(scene) == whole
    assert pipeline.slot_geometry(48, 40, whole) == ((2 * 2 * 1024, 2) if whole
                                                     else (48 * 40, 0))
    paged_past = _scene_of(tris, bank_resident=False)
    assert wavefront.shade_bank(paged_past) == "3-stage bank"
    assert not wavefront.whole_path_regime(paged_past)
    assert wavefront.regime(paged_past) == ("per-bounce" if whole else want)


def test_wave_pixel_coords_and_jitter_match_jax():
    """Raster pixel ids and coordinates from the wave's first pixel, and
    the pixel jitter draws, equal the JAX package's bit for bit."""
    local = np.arange(6000, dtype=np.int32)
    for spp, width, base in ((2, 64, 0), (3, 1280, 917_000), (1, 7, 123)):
        jp, jx, jy = (np.asarray(a) for a in jax_pixels(jnp.asarray(local), spp, width,
                                                      base))
        p, x, y = wavefront.wave_pixel_coords(torch.from_numpy(local).to(torch.int64),
                                              spp, width, base)
        np.testing.assert_array_equal(p.numpy(), jp)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)
    g = np.arange(0, 1 << 20, 97, dtype=np.int64)
    ja, jb = jrng.uniform2_soa(jrng.ray_streams(jnp.uint32(9), jnp.asarray(g, jnp.int32)), 0)
    a, b = uniform2_soa(ray_streams(9, torch.from_numpy(g)), 0)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_large_scene_matches_bench_py(tmp_path):
    """The port's copy of bench.py::build_large_scene builds the same scene
    (PNG bytes differ between encoders; the decoded texels do not)."""
    import bench

    a = load_gltf(str(bench.build_large_scene(tmp_path / "j.gltf", side=48)))
    b = load_gltf(str(tproc.large_scene(tmp_path / "t.gltf", side=48)))
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x.pixels, y.pixels)
    ga, gb = load_geometry(a), load_geometry(b)
    assert gb.num_triangles == 2 * 48 * 48 + 10
    for f in ("positions", "normals", "texcoords", "material_idx"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    np.testing.assert_array_equal(load_materials(a).color_u16, load_materials(b).color_u16)


def test_entry_points_default_to_the_card(tmp_path, terrain):
    """Called without a device, every entry point asks for the card, which
    a host without one refuses: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is for CUDA-less hosts")
    path, cam_kw, _, _ = terrain
    cfg = Config(num_samples=1, max_bounce=1)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.prepare_scene(str(path), cfg, **cam_kw)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.render_file(str(path), str(tmp_path / "o.png"), cfg, **cam_kw)
    g = load_gltf(str(path))
    geo, mats = load_geometry(g), load_materials(g)
    with pytest.raises(RuntimeError, match="cuda"):
        build_torch_scene(geo, mats, scene_bbox(geo.positions))
    cpu = build_torch_scene(geo, mats, scene_bbox(geo.positions), device="cpu")
    arrays = {
        "mxu.tri_data": cpu.tri_data.numpy(), "mxu.tile_bbox": cpu.tile_bbox.numpy(),
        "mxu.tree_bbox": cpu.tree_bbox.numpy(), "mxu.group_bbox": cpu.group_bbox.numpy(),
        "mxu.group_tree_bbox": cpu.group_tree_bbox.numpy(), "mxu.perm": cpu.perm.numpy(),
        "mxu.tile": cpu.tile, "mxu.group_tiles": cpu.group_tiles,
        "shade_table_t": cpu.rec_table.numpy(), "color_u16f_t": cpu.bank.numpy().T,
        "grid.bbox_min": cpu.bbox_min.numpy(), "grid.bbox_max": cpu.bbox_max.numpy(),
        "emissive_all_dummy": cpu.emissive_dummy,
    }
    assert torch.equal(from_jax_scene(arrays, device="cpu").tree_bbox, cpu.tree_bbox)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_scene(arrays)


def test_cli_without_a_card_fails_unless_asked_for_the_cpu(tmp_path, terrain):
    path, _, _, _ = terrain
    (tmp_path / "config.json").write_text(
        '{"grid_resolution": [4, 4, 4], "num_threads": null, "num_samples": 1, '
        '"max_bounce": 2}')
    out = tmp_path / "o.png"

    def cli(*extra):
        return subprocess.run(
            [sys.executable, "-m", "zig_raytracing_contest_tpu_torch", "--in", str(path),
             "--out", str(out), "--camera", "Camera 1", "--width", "16", "--height", "8",
             "--config", str(tmp_path / "config.json"), *extra],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )

    if not torch.cuda.is_available():
        res = cli()
        assert res.returncode != 0 and "--device cpu" in res.stderr
        assert not out.exists()
    res = cli("--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "Intersection backend: whole path on cpu" in res.stderr
    assert out.stat().st_size > 0
