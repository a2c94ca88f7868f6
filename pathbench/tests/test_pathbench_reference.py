"""The reference renderer: a frame whose every pixel is known, its own
reading of the scenes beside the port's, its grid (which only prunes),
agreement with the port's plain twins at a tiny frame of each cell's
scene and traffic, and its control (bfloat16), which the cells' limits
must fail; ``plain`` through the entry point a cell names renders as the
harness's own reference object did."""

import dataclasses

import numpy as np
import pytest
import torch

from pathbench import compare, spec
from pathbench.reference import render as rr
from pathbench.reference import scene as rs
from pathbench.scenes import scene_file
from pathbench.scenes.procedural import SceneBuilder, quad

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def encode(c):
    return np.minimum(np.float32(c) ** np.float32(1 / 2.2), 0.999999) * 256


def test_a_frame_known_pixel_by_pixel(tmp_path):
    """An emissive quad filling the middle of the view: one bounce, so a
    pixel is its emission where the ray hits it and the sky elsewhere."""
    b = SceneBuilder()
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(0.5, 0.25, 0.125))
    p, i, n, t = quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
    b.add_mesh_node(p, i, light, normals=n, texcoords=t)
    b.add_camera_node((0, 0, 3), (0, 0, 0), yfov=1.2, name="Camera 1")
    path = b.write_gltf(tmp_path / "quad.gltf")
    scene, cam = rs.read_scene(path, "Camera 1", 40, 30)
    image, segments = rr.render(rr.upload(scene, "cpu"), cam, 4, 1, seed=9)
    assert segments == 40 * 30 * 4
    centre = image[12:18, 17:23].reshape(-1, 3)
    assert (centre == encode([0.5, 0.25, 0.125]).astype(np.uint8)).all()
    # a corner pixel's four samples all miss: the sky of their directions
    corner = image[0, 0].astype(float)
    d = cam.lower_left + cam.right * 0.5 + cam.up * 0.5
    d = d / np.linalg.norm(d)
    s = 0.5 * (d[1] + 1)
    sky = encode(np.array([1 - 0.5 * s, 1 - 0.3 * s, 1.0]))
    assert np.abs(corner - sky).max() <= 2


def test_the_scene_reading_matches_the_ports(tmp_path, tiny_contest):
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.scene.camera import load_camera
    from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf

    for cfg, size in ((tiny_contest, (64, 36)), (spec.load_config("sponza_interior"), (None, 36))):
        path = scene_file(cfg, tmp_path)
        scene, cam = rs.read_scene(path, cfg["camera"], *size)
        gltf = load_gltf(str(path), num_threads=Config().host_threads)
        geo = load_geometry(gltf)
        pcam = load_camera(gltf, cfg["camera"], *size)
        assert np.array_equal(scene.positions, geo.positions)
        assert np.array_equal(scene.normals, geo.normals)
        assert np.array_equal(scene.texcoords, geo.texcoords)
        assert (cam.width, cam.height) == (pcam.width, pcam.height)
        for a, b in ((cam.origin, pcam.origin), (cam.lower_left, pcam.lower_left_corner),
                     (cam.right, pcam.right), (cam.up, pcam.up)):
            assert np.array_equal(a, b)
        for image in gltf.images:
            assert image.pixels.dtype == np.float32
        pngs = [t for t in scene.textures if t.width * t.height > 1]
        assert len(pngs) >= len(gltf.images)


@pytest.mark.parametrize("form", ["mt", "transform"])
def test_the_grid_only_prunes(tmp_path, form, tiny_contest):
    cfg = tiny_contest
    scene, cam = rs.read_scene(scene_file(cfg, tmp_path), cfg["camera"], 48, 27)
    ds = rr.upload(scene, "cpu", form)
    frames = []
    for res in (None, (1, 1, 1), (40, 3, 17)):
        ds.grid = rr.build_grid(torch.as_tensor(scene.positions), res)
        frames.append(rr.render(ds, cam, 2, 4, seed=3))
    for image, segments in frames[1:]:
        assert segments == frames[0][1] and np.array_equal(image, frames[0][0])


def tiny(cell):
    wl = spec.load_workload(cell)
    traffic = dataclasses.replace(wl.traffic, width=None if wl.traffic.width is None else 64,
                                  height=36, grid_resolution=(16, 16, 16))
    return dataclasses.replace(wl, traffic=traffic)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cell", ["sponza-720p", "sponza-720p-grid"])
def test_the_plain_entry_point_renders_as_before(tmp_path, cell, dtype):
    """At a tiny frame of each cell, ``plain`` as the harness obtains it
    renders what the harness's own reference object rendered before the
    reference became a cell's choice: the same bytes and segments, in
    float32 and in bfloat16, and the same grid and triangle count."""
    wl = tiny(cell)
    tr = wl.traffic
    path = scene_file(wl.config, tmp_path)
    ref = spec.load_reference(wl.reference).prepare(wl, path, "cpu")
    image, segments = ref.render(2**31 + 13, None if dtype == torch.float32 else dtype)
    scene, cam = rs.read_scene(path, wl.config["camera"], tr.width, tr.height)
    ds = rr.upload(scene, "cpu", tr.triangle_test)
    before, before_segments = rr.render(ds, cam, tr.spp, tr.bounces, 2**31 + 13, dtype)
    assert segments == before_segments and image.tobytes() == before.tobytes()
    cells, refs = ref.grid_size()
    if tr.backend == "grid":
        grid = rr.build_grid(torch.as_tensor(scene.positions), tr.grid_resolution)
        assert (cells, refs) == (16 ** 3, grid.num_refs)
    else:
        assert (cells, refs) == (0, 0)
    assert ref.triangles == scene.num_triangles == 261966


@pytest.mark.parametrize("cell", CELLS)
def test_the_twins_pass_and_the_control_fails(tmp_path, cell):
    """At a tiny frame of the cell's scene and traffic, the port's plain
    twins are within the cell's limits of the cell's reference, and that
    reference computed in bfloat16 is outside one of them."""
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene

    from pathbench import harness

    wl = tiny(cell)
    tr = wl.traffic
    path = scene_file(wl.config, tmp_path)
    cfg = harness.program_config(tr, 2**31 + 11)
    scene, cam, _ = prepare_scene(str(path), cfg, wl.config["camera"], tr.width, tr.height,
                                  device="cpu")
    image, stats = render_scene(scene, cam, cfg)
    reference = spec.load_reference(wl.reference).prepare(wl, path, "cpu")
    ref, segments = reference.render(cfg.seed)
    ok, failed, checks = compare.judge([(0, image, stats.segments)], ref, segments, None, wl)
    assert ok, checks
    low, low_segments = reference.render(cfg.seed, torch.bfloat16)
    ok, failed, checks = compare.judge([(0, low, low_segments)], ref, segments, None, wl)
    assert not ok and failed == 1, checks
