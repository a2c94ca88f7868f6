"""The port's host C++ libraries: the CPU tracer and the OpenMP grid builder.

* each ``.cpp`` in the port byte-equal to its JAX source;
* ``build_grid_native`` equal to the port's NumPy builder and to the JAX
  package's NumPy builder on tests/test_native_grid.py's cases and on
  triangles that lie on cell faces: every array, the stats and the log
  lines;
* ``prepare_scene``'s fallback to the NumPy builder, with a warning;
* the port's ``render_cpu`` against the JAX package's on
  tests/test_native_tracer.py's textured box (seed 11, 4 spp, 4 bounces),
  bit for bit; against the port's grid ``render_scene`` on the CPU under
  that file's gates (diff > 2 on under 2% of channels, mean under 1.0,
  segments within max(8, 0.1%)); independent of the thread count; the
  build without OpenMP gives the same bits.

Skipped without ``g++``, as tests/test_native_tracer.py is.
"""

import ctypes
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest

from zig_raytracing_contest_tpu.grid.builder import build_grid as jax_build_grid
from zig_raytracing_contest_tpu.scene import procedural as jproc
from zig_raytracing_contest_tpu_torch import native
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.grid.builder import build_grid
from zig_raytracing_contest_tpu_torch.grid.native import build_grid_native, native_available
from zig_raytracing_contest_tpu_torch.render import native_cpu, pipeline

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")


@pytest.mark.parametrize("name", ["cpu_tracer", "grid_builder"])
def test_sources_are_copies_of_the_jax_package(name):
    jax_src = REPO / "zig_raytracing_contest_tpu" / "native" / f"{name}.cpp"
    assert native.SOURCES[name].read_bytes() == jax_src.read_bytes()


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, size=(n, 1, 3))
    offsets = rng.uniform(-0.5, 0.5, size=(n, 3, 3))
    return (centers + offsets).astype(np.float32)


def _degenerate():
    positions = _soup(10, 3)
    positions[4] = positions[4, 0]  # collapse to a point
    positions[7, 1] = positions[7, 0]  # collapse an edge
    return positions


def _cornell_faces(tmp_path):
    """The Cornell box's 12 triangles, whose walls lie on the faces of an
    8³ grid's cells: an FMA in the SAT test moves 20 of its 512 cells."""
    from zig_raytracing_contest_tpu.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu.scene.gltf import load_gltf

    return load_geometry(load_gltf(str(jproc.cornell_like_box(tmp_path / "b.gltf")))).positions


CASES = {
    "50": (lambda _: _soup(50, 50), (6, 6, 6)),
    "400": (lambda _: _soup(400, 400), (16, 16, 16)),
    "1": (lambda _: _soup(1, 1), (4, 4, 4)),
    "degenerate": (lambda _: _degenerate(), (5, 5, 5)),
    "cell_faces": (_cornell_faces, (8, 8, 8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_grid_native_equals_numpy_and_jax(case, tmp_path):
    make, res = CASES[case]
    positions = make(tmp_path)
    logs = {k: [] for k in ("native", "numpy", "jax")}
    got = build_grid_native(positions, res, log_fn=logs["native"].append)
    for key, want in (("numpy", build_grid(positions, res, log=logs["numpy"].append)),
                      ("jax", jax_build_grid(positions, res, log=logs["jax"].append))):
        for f in ("bbox_min", "bbox_max", "resolution", "cell_size", "cell_begin",
                  "cell_end", "dup_to_tri"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, (key, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {f}")
        assert got.stats == want.stats, key
        assert logs["native"] == logs[key], key


def test_prepare_scene_falls_back_to_numpy(tmp_path, monkeypatch, caplog):
    assert native_available()
    path = str(jproc.cornell_like_box(tmp_path / "box.gltf"))
    cfg = Config(grid_resolution=(8, 8, 8), backend="grid", num_samples=1, max_bounce=1)
    native_scene, _, _ = pipeline.prepare_scene(path, cfg, width=8, height=8, device="cpu")

    def no_compiler(*args, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(pipeline, "build_grid_native", no_compiler)
    with caplog.at_level(logging.WARNING, logger="zig_raytracing_contest_tpu_torch"):
        numpy_scene, _, _ = pipeline.prepare_scene(path, cfg, width=8, height=8, device="cpu")
    assert "native grid builder unavailable" in caplog.text
    for f in ("cell_begin", "cell_end", "tri_v0", "tri_e1", "tri_e2", "dup_to_tri"):
        assert getattr(native_scene.grid, f).equal(getattr(numpy_scene.grid, f)), f


@pytest.fixture(scope="module")
def textured_box(tmp_path_factory):
    """tests/test_native_tracer.py's scene: the Cornell box with a
    checker texture and a BLEND quad; 48×48, an 8³ grid."""
    d = tmp_path_factory.mktemp("scenes")
    b = jproc.SceneBuilder()
    white = b.add_material(base_color_factor=(0.73, 0.73, 0.73, 1))
    red = b.add_material(base_color_factor=(0.65, 0.05, 0.05, 1))
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(5, 5, 5))
    checker = np.zeros((4, 4, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [220, 220, 220, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [40, 40, 40, 255]
    tex = b.add_material(base_color_texture=b.add_texture(b.add_image_png(checker)))
    holes = np.full((1, 1, 4), 255, np.uint8)
    holes[0, 0, 3] = 120
    glass = b.add_material(base_color_texture=b.add_texture(b.add_image_png(holes)),
                           alpha_mode="BLEND")
    s = 1.0
    walls = [
        ((0, -s, 0), (s, 0, 0), (0, 0, -s), tex),
        ((0, s, 0), (s, 0, 0), (0, 0, s), light),
        ((0, 0, -s), (s, 0, 0), (0, s, 0), white),
        ((-s, 0, 0), (0, 0, s), (0, s, 0), red),
        ((0, 0, 0.3), (0.5, 0, 0), (0, 0.5, 0), glass),
    ]
    for center, uax, vax, mat in walls:
        p, i, n, t = jproc.quad(center, uax, vax)
        b.add_mesh_node(p, i, mat, normals=n, texcoords=t * 2)
    b.add_camera_node((0, 0, 3.2), (0, 0, 0), yfov=0.9, name="c")
    path = str(b.write_gltf(d / "t.gltf"))
    cfg = Config(grid_resolution=(8, 8, 8), backend="grid", num_samples=4, max_bounce=4,
                 seed=11)
    scene, cam, _ = pipeline.prepare_scene(path, cfg, width=48, height=48, device="cpu")
    return path, cfg, scene, cam


def test_render_cpu_matches_jax_render_cpu(textured_box):
    from zig_raytracing_contest_tpu.grid.builder import build_grid as jbuild
    from zig_raytracing_contest_tpu.render.native_cpu import render_cpu as jax_render_cpu
    from zig_raytracing_contest_tpu.scene.camera import load_camera
    from zig_raytracing_contest_tpu.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu.scene.gltf import load_gltf
    from zig_raytracing_contest_tpu.scene.materials import load_materials
    from zig_raytracing_contest_tpu.scene.types import build_device_scene

    path, _, scene, cam = textured_box
    gltf = load_gltf(path)
    geo = load_geometry(gltf)
    js = build_device_scene(geo, jbuild(geo.positions, (8, 8, 8)), load_materials(gltf),
                            backend="grid")
    want, want_segs, _ = jax_render_cpu(js, load_camera(gltf, width=48, height=48), spp=4,
                                        max_bounce=4, seed=11)
    got, segs, _ = native_cpu.render_cpu(scene, cam, spp=4, max_bounce=4, seed=11)
    assert got.dtype == np.uint8 and got.shape == (48, 48, 3)
    np.testing.assert_array_equal(got, want)
    assert segs == want_segs


def test_render_cpu_matches_port_grid_render(textured_box):
    _, cfg, scene, cam = textured_box
    img, stats = pipeline.render_scene(scene, cam, cfg)
    got, segments, _ = native_cpu.render_cpu(scene, cam, spp=4, max_bounce=4, seed=11)
    assert abs(segments - stats.segments) <= max(8, stats.segments // 1000)
    diff = np.abs(img.astype(int) - got.astype(int))
    assert (diff > 2).mean() < 0.02, f"{(diff > 2).mean():.2%} channels diverge"
    assert diff.mean() < 1.0


def test_render_cpu_thread_count_invariant(textured_box):
    _, _, scene, cam = textured_box
    a, sa, _ = native_cpu.render_cpu(scene, cam, spp=2, max_bounce=3, seed=3, num_threads=1)
    b, sb, _ = native_cpu.render_cpu(scene, cam, spp=2, max_bounce=3, seed=3, num_threads=8)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_build_without_openmp_gives_the_same_bits(textured_box):
    """The fallback build (no -fopenmp: one thread) renders what the OpenMP
    build renders."""
    _, _, scene, cam = textured_box
    assert native_cpu.load_library().openmp
    plain = native_cpu.bind(ctypes.CDLL(str(native.build("cpu_tracer", openmp=False))))
    a, sa, _ = native_cpu.render_cpu(scene, cam, spp=2, max_bounce=3, seed=3)
    b, sb, _ = native_cpu.render_cpu(scene, cam, spp=2, max_bounce=3, seed=3, lib=plain)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_render_cpu_needs_a_grid(textured_box):
    path, _, _, _ = textured_box
    cfg = Config(num_samples=1, max_bounce=1)
    scene, cam, _ = pipeline.prepare_scene(path, cfg, width=8, height=8, device="cpu")
    assert scene.grid is None
    with pytest.raises(ValueError, match="grid"):
        native_cpu.render_cpu(scene, cam, spp=1, max_bounce=1)
