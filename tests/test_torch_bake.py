"""The port's own scene bake equals the JAX package's, array for array.

Both packages load the same glTF; the port's NumPy host layer (loader,
materials, geometry, triangle bake, packed records) must produce arrays
equal to ``build_device_scene``'s, and ``from_jax_scene`` must rebuild the
same TorchScene from the JAX DeviceScene's arrays.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.scene import procedural as jproc
from zig_raytracing_contest_tpu.scene.camera import load_camera as jcam
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jgeo
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu.scene.types import (
    build_device_scene,
    build_packed_record as jpacked,
)
from zig_raytracing_contest_tpu_torch.grid.builder import scene_bbox
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.camera import load_camera
from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.materials import load_materials
from zig_raytracing_contest_tpu_torch.scene.types import (
    bake_scene_triangles,
    build_shade_table,
    build_torch_scene,
    from_jax_scene,
)

ASSETS = Path(__file__).parent / "assets"


def jax_scene_arrays(scene) -> dict:
    """A JAX DeviceScene's whole-path arrays as NumPy (from_jax_scene keys)."""
    P = scene.color_data.shape[0]
    return {
        "mxu.tri_data": np.asarray(scene.mxu.tri_data),
        "mxu.tile_bbox": np.asarray(scene.mxu.tile_bbox),
        "mxu.group_bbox": np.asarray(scene.mxu.group_bbox),
        "mxu.tree_bbox": np.asarray(scene.mxu.tree_bbox),
        "mxu.perm": np.asarray(scene.mxu.perm),
        "mxu.tile": scene.mxu.tile,
        "shade_table_t": np.asarray(scene.shade_table_t),
        "color_u16f_t": np.asarray(scene.color_u16f_t)[:, :P],
        "grid.bbox_min": np.asarray(scene.grid.bbox_min),
        "grid.bbox_max": np.asarray(scene.grid.bbox_max),
        "emissive_all_dummy": scene.emissive_all_dummy is not None,
    }


def _scene_file(name, tmp_path):
    if name == "cornell":
        return jproc.cornell_like_box(tmp_path / "box.gltf"), ("Camera 1", 32, 32)
    if name == "bench20":
        return tproc.bench_scene(tmp_path / "b.gltf", num_objects=20), ("Camera 1", 48, 32)
    return ASSETS / f"{name}.gltf", (None, None, 96)


@pytest.mark.parametrize("name", ["cornell", "bench20", "duckish", "alpha_modes"])
def test_port_bake_equals_jax_bake(name, tmp_path):
    path, (cam_name, w, h) = _scene_file(name, tmp_path)
    kw = dict(width=w, height=h) if w else dict(height=h)
    if name == "alpha_modes":
        kw = dict(width=128, height=96)
    jg, tg = jgltf(str(path)), load_gltf(str(path))
    jgeom, tgeom = jgeo(jg), load_geometry(tg)
    jm, tm = jmat(jg), load_materials(tg)
    # host layer: geometry, materials, camera
    for f in ("positions", "normals", "texcoords", "material_idx"):
        np.testing.assert_array_equal(getattr(tgeom, f), getattr(jgeom, f))
    for f in ("color_data", "color_desc", "mat_base", "mat_emissive", "color_u16",
              "color_scale"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    jc, tc = jcam(jg, cam_name, **kw), load_camera(tg, cam_name, **kw)
    for f in ("origin", "lower_left_corner", "right", "up"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))

    js = build_device_scene(jgeom, build_grid(jgeom.positions, (8, 8, 8)), jm,
                            backend="mxu")
    mxu = bake_scene_triangles(tgeom)
    for f in ("tri_data", "tile_bbox", "perm", "group_bbox", "tree_bbox",
              "group_tree_bbox"):
        np.testing.assert_array_equal(getattr(mxu, f), np.asarray(getattr(js.mxu, f)), f)
    assert mxu.tile == js.mxu.tile
    shade = build_shade_table(tgeom, tm)
    np.testing.assert_array_equal(shade, np.asarray(js.shade_table))

    ts = build_torch_scene(tgeom, tm, scene_bbox(tgeom.positions))
    np.testing.assert_array_equal(ts.bbox_min.numpy(), np.asarray(js.grid.bbox_min))
    np.testing.assert_array_equal(ts.bbox_max.numpy(), np.asarray(js.grid.bbox_max))
    np.testing.assert_array_equal(ts.tri_data.numpy(), mxu.tri_data)
    assert ts.emissive_dummy == (js.emissive_all_dummy is not None)
    # records: row-major texel offsets (JAX bakes tiled offsets only for a
    # paged bank, which the port does not use)
    want_rec = jpacked(np.asarray(js.shade_table))[np.asarray(js.mxu.perm)].T
    np.testing.assert_array_equal(ts.rec_table.numpy(), want_rec)
    np.testing.assert_array_equal(ts.bank.numpy(), jm.color_u16.astype(np.float32))
    if js.color_u16f_t is not None:
        np.testing.assert_array_equal(ts.rec_table.numpy(), np.asarray(js.shade_table_t))
        P = jm.color_u16.shape[0]
        np.testing.assert_array_equal(ts.bank.numpy().T, np.asarray(js.color_u16f_t)[:, :P])

        # from_jax_scene round trip: the same TorchScene, tensor for tensor
        fj = from_jax_scene(jax_scene_arrays(js))
        for f in ("tri_data", "tile_bbox", "perm", "rec_table", "bank",
                  "bbox_min", "bbox_max"):
            assert torch.equal(getattr(fj, f), getattr(ts, f)), f
        assert (fj.tile, fj.emissive_dummy) == (ts.tile, ts.emissive_dummy)


def test_bench_scene_matches_bench_py(tmp_path):
    """The port's copy of bench.py::build_bench_scene builds the same scene
    (PNG bytes differ between encoders; decoded content may not)."""
    import bench

    a = load_gltf(str(bench.build_bench_scene(tmp_path / "j.gltf", num_objects=12)))
    b = load_gltf(str(tproc.bench_scene(tmp_path / "t.gltf", num_objects=12)))
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x.pixels, y.pixels)
    ga, gb = load_geometry(a), load_geometry(b)
    for f in ("positions", "normals", "texcoords", "material_idx"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    np.testing.assert_array_equal(load_materials(a).color_u16, load_materials(b).color_u16)


def test_out_of_slice_scenes_raise(tmp_path):
    path = jproc.cornell_like_box(tmp_path / "box.gltf")
    g = load_gltf(str(path))
    geo, mats = load_geometry(g), load_materials(g)
    with pytest.raises(NotImplementedError, match="item 11"):
        build_torch_scene(geo, mats, scene_bbox(geo.positions), backend="grid")
    with pytest.raises(NotImplementedError, match="REC_EMIT_MAX_TRIS"):
        from zig_raytracing_contest_tpu_torch.scene.types import check_whole_path

        check_whole_path((1 << 15) + 1024, 10)
    with pytest.raises(NotImplementedError, match="PAGED_MAX_TEXELS"):
        check_whole_path(1024, (1 << 20) + 1)
