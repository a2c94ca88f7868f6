"""The port's extensions (``nee``, ``russian_roulette``, ``pbr``) against
the benchmark's extensions reference (``pathbench/reference/ext.py``), and
the pieces of the ``sponza-720p-ext`` cell.

* on a small seeded scene with an emissive panel, metals and dielectrics,
  ``render_scene`` on the CPU and the reference render the same frame
  within the cell's limits, for each extension and for all three, over
  the bake and over the grid; the reference in bfloat16, and the
  program's frame without NEE, fail them;
* the reference's light table is the port's ``build_light_set``;
* ``sponza_pbr.write`` writes the Sponza writer's triangles with their
  fronts on their normals' side, the roof's opening as the one light and
  a metallic factor on every material, which the port and the reference
  read back;
* the cell loads with the ``ext`` reference, and its traffic under
  ``plain`` is refused;
* the work counters of NEE's shadow rays and of the specular bounces
  count what the reference counts, and 0 on a plain frame; the cell's
  readers of them divide them, read 0 where nothing was done and nothing
  where nothing is counted.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from pathbench import compare, spec
from pathbench.reference import ext as ref_ext
from pathbench.reference import scene as ref_scene
from pathbench.scenes import load_writer
from pathbench.scenes.sponza_pbr import METALS, SCONCE, SKY, SKYLIGHT
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.render import pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.materials import load_materials
from zig_raytracing_contest_tpu_torch.scene.procedural import SceneBuilder, quad

CELL = "sponza-720p-ext"
W, H, SPP, BOUNCES = 64, 32, 2, 4  # 4096 rays: two full waves of 2048, no lane past the image
WAVE = 2048
SEED = 2**31 + 2301
ALL = ("nee", "russian_roulette", "pbr")
CASES = [("nee",), ("russian_roulette",), ("pbr",), ALL]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("ext") / "ext.gltf")


def write_scene(path, light: bool = True):
    """A floor, an emissive panel above it (``light``; else the panel does
    not emit) and 30 seeded one-sided quads of five materials: two metals,
    one half metal, two dielectrics (one with glTF's default factors, 1 and
    1, so a metal too)."""
    rng = np.random.default_rng(23)
    b = SceneBuilder()
    checker = np.zeros((8, 8, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [220, 220, 220, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [60, 60, 60, 255]
    tex = b.add_texture(b.add_image_png(checker), b.add_sampler())
    floor = b.add_material(base_color_texture=tex, metallic=0.0, roughness=0.5)
    light = b.add_material(base_color_factor=(0, 0, 0, 1),
                           emissive_factor=(6, 6, 6) if light else (0, 0, 0),
                           metallic=0.0, roughness=1.0)
    mats = [b.add_material(base_color_factor=(0.9, 0.7, 0.3, 1), metallic=1.0, roughness=0.2),
            b.add_material(base_color_factor=(0.7, 0.7, 0.75, 1), metallic=1.0, roughness=0.6),
            b.add_material(base_color_factor=(0.6, 0.3, 0.3, 1), metallic=0.5, roughness=0.4),
            b.add_material(base_color_factor=(0.3, 0.6, 0.3, 1), metallic=0.0, roughness=0.9),
            b.add_material(base_color_factor=(0.3, 0.3, 0.7, 1))]
    p, i, n, t = quad((0, -2, 0), (10, 0, 0), (0, 0, -10))
    b.add_mesh_node(p, i, floor, normals=n, texcoords=t * 4)
    p, i, n, t = quad((0, 6, 0), (3, 0, 0), (0, 0, 3))
    b.add_mesh_node(p, i, light, normals=n, texcoords=t)
    for k in range(30):
        c = rng.uniform([-6, -1.5, -6], [6, 3, 6])
        size = rng.uniform(0.4, 1.0)
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        v = rng.standard_normal(3)
        v -= u * (v @ u)
        v /= np.linalg.norm(v)
        p, i, n, t = quad(c, u * size, v * size)
        b.add_mesh_node(p, i, mats[k % len(mats)], normals=n, texcoords=t)
    b.add_camera_node((0, 2.5, 12), (0, 0.5, 0), yfov=0.8, name="Camera 1")
    return b.write_gltf(path)


def workload(extensions, backend="auto"):
    """The cell at a tiny frame of the small scene, with ``extensions``."""
    wl = spec.load_workload(CELL)
    traffic = dataclasses.replace(wl.traffic, width=W, height=H, spp=SPP, bounces=BOUNCES,
                                  wave=WAVE, backend=backend, grid_resolution=(8, 8, 8),
                                  extensions=tuple(extensions))
    return dataclasses.replace(wl, traffic=traffic)


def program(path, extensions, backend="auto"):
    """(image, RenderStats) of the port's frame on the CPU."""
    cfg = Config(num_samples=SPP, max_bounce=BOUNCES, wave_size=WAVE, seed=SEED,
                 backend=backend, grid_resolution=(8, 8, 8), **{e: True for e in extensions})
    scene, cam, _ = pipeline.prepare_scene(str(path), cfg, camera_name="Camera 1", width=W,
                                           height=H, device="cpu")
    return pipeline.render_scene(scene, cam, cfg)


@pytest.mark.parametrize("backend", ["auto", "grid"])
@pytest.mark.parametrize("extensions", CASES, ids="+".join)
def test_the_port_renders_the_references_frame(scene_path, extensions, backend):
    wl = workload(extensions, backend)
    image, stats = program(scene_path, extensions, backend)
    ref = ref_ext.prepare(wl, scene_path, "cpu")
    ref_image, ref_segments = ref.render(SEED)
    ok, failed, checks = compare.judge([(0, image, stats.segments)], ref_image, ref_segments,
                                       None, wl)
    assert ok and stats.segments == ref_segments, checks
    assert checks["image_mad"]["value"] < wl.limits["image_mad"]


@pytest.mark.parametrize("extensions", CASES, ids="+".join)
def test_the_reference_in_bfloat16_fails_the_limits(scene_path, extensions):
    wl = workload(extensions)
    ref = ref_ext.prepare(wl, scene_path, "cpu")
    ref_image, ref_segments = ref.render(SEED)
    low, low_segments = ref.render(SEED, torch.bfloat16)
    ok, failed, checks = compare.judge([(0, low, low_segments)], ref_image, ref_segments,
                                       None, wl)
    assert not ok and failed == 1, checks


def test_a_frame_without_nee_fails_against_the_reference_with_it(scene_path):
    wl = workload(ALL)
    ref_image, ref_segments = ref_ext.prepare(wl, scene_path, "cpu").render(SEED)
    image, stats = program(scene_path, ("russian_roulette", "pbr"))
    ok, failed, checks = compare.judge([(0, image, stats.segments)], ref_image, ref_segments,
                                       None, wl)
    assert not ok and checks["image_mad"]["value"] > wl.limits["image_mad"], checks


def test_the_light_table_is_the_ports(scene_path):
    cfg = Config(num_samples=1, max_bounce=1, nee=True)
    scene, _, _ = pipeline.prepare_scene(str(scene_path), cfg, camera_name="Camera 1",
                                         width=8, height=8, device="cpu")
    port = scene.lights
    table = ref_ext.light_table(ref_scene.read_scene(scene_path, "Camera 1", 8, 8)[0])
    assert table.tri.tolist() == port.tri.tolist() == [2, 3]  # the panel's two triangles
    for name in ("v0", "e1", "e2", "normal", "cdf"):
        assert np.array_equal(getattr(table, name), getattr(port, name).numpy()), name
    assert np.float32(table.total_area) == port.total_area.numpy()[0]
    assert np.allclose(table.area.sum(), table.total_area)
    assert np.allclose(np.cumsum(table.area) / table.total_area, table.cdf)


def test_sponza_pbr_writes_the_factors_of_its_table(tmp_path):
    """The Sponza writer's triangles, each front on its normals' side; the
    skylight stretched to the roof as the one light, facing the hall;
    metallic 1 on the two metals and 0 elsewhere, roughness glTF's
    default: as the port and the reference read the file."""
    args = {"detail": 0.3, "tex": 32}  # the writer's shapes at a fraction of its size
    plain = load_writer("sponza")(tmp_path / "sponza.glb", **args)
    pbr = load_writer("sponza_pbr")(tmp_path / "sponza_pbr.glb", **args)
    doc = ref_scene.Document(pbr).doc
    assert len(doc["materials"]) == 25
    assert [m["pbrMetallicRoughness"]["metallicFactor"] for m in doc["materials"]] == [
        float(i in METALS) for i in range(25)]
    assert not any("roughnessFactor" in m["pbrMetallicRoughness"] for m in doc["materials"])
    assert [i for i, m in enumerate(doc["materials"]) if "emissiveFactor" in m] == [SKYLIGHT]
    assert doc["materials"][SKYLIGHT]["emissiveFactor"] == list(SKY)

    new, old = (ref_scene.read_scene(p, "Camera 1", 8, 8)[0] for p in (pbr, plain))
    assert np.array_equal(new.material, old.material)
    assert np.array_equal(new.mat_base, old.mat_base)

    def fronts(scene):  # each triangle's front against its vertex normals, where it has one
        p = scene.positions.astype(np.float64)
        cross = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        side = (cross * scene.normals.sum(axis=1)).sum(axis=1)
        return np.where(np.linalg.norm(cross, axis=1) > 1e-9, side, 0.0)

    assert (fronts(new) >= 0).all()
    floor = old.material == 0
    assert (fronts(old)[floor] < 0).all()  # culled from inside the hall
    sky = new.material == SKYLIGHT
    same = (new.positions == old.positions).all(axis=(1, 2))
    flipped = (new.positions == old.positions[:, ::-1]).all(axis=(1, 2))
    assert (same | flipped)[~sky].all() and flipped[floor].all()
    normals = np.where(flipped[:, None, None], old.normals[:, ::-1], old.normals)
    assert np.array_equal(new.normals, normals)
    roof = new.positions[sky]
    assert np.allclose(roof[..., 1], 9.98)
    assert np.allclose(np.abs(roof[..., [0, 2]]).max(axis=(0, 1)), [15.0, 6.0])

    table = ref_ext.light_table(new)
    assert np.array_equal(table.tri, np.nonzero(sky)[0])
    assert table.total_area == pytest.approx(360.0, rel=1e-5)
    assert np.allclose(table.normal, [0.0, -1.0, 0.0])  # facing the hall

    materials = load_materials(load_gltf(str(pbr)))
    want = np.asarray([float(i in METALS) for i in range(25)], np.float32)
    assert np.array_equal(materials.mat_metallic, want)
    assert np.array_equal(materials.mat_roughness, np.ones(25, np.float32))
    metallic, roughness = ref_ext.material_factors(pbr)
    assert np.array_equal(metallic, want) and np.array_equal(roughness, np.ones(25, np.float32))


def test_the_cell_loads_with_the_ext_reference():
    wl = spec.load_workload(CELL)
    assert wl.reference == "ext" and wl.config["name"] == "sponza_interior_pbr"
    assert wl.traffic.extensions == ALL and wl.traffic.backend == "auto"
    assert (wl.traffic.height, wl.traffic.spp, wl.traffic.bounces) == (720, 2, 4)
    assert wl.kernels == wl.trace_kernels == ("trace_stream",)
    assert spec.load_reference(wl.reference).EXTENSIONS == ALL
    entry = next(w for w in spec.benchmark()["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1 and entry["config"] == wl.config["name"]
    metrics = {m["name"] for m in spec.per_layer_metrics(CELL, spec.benchmark())}
    assert {"shadow_rays_per_segment", "shadow_boxes_per_ray", "specular_per_segment"} <= metrics


def test_the_cells_traffic_under_plain_is_refused(tmp_path):
    root = tmp_path / "pathbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                                   "tests"))
    raw = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    del raw["reference"]
    (root / "workloads" / "ext-plain.json").write_text(json.dumps(raw))
    with pytest.raises(ValueError, match=r"ext-plain.*\bnee\b.*reference plain"):
        spec.load_workload("ext-plain", root)


@pytest.mark.parametrize("backend", ["auto", "grid"])
def test_the_shadow_and_specular_counters(scene_path, backend):
    """With every extension on, the frame's shadow rays and specular bounces
    are the reference's; the bake's traces count their tiles and boxes
    (the twin's flat loop tests every tile's box of a live ray), the grid
    none; a plain frame counts none of the four."""
    wl = workload(ALL, backend)
    _, stats = program(scene_path, ALL, backend)
    ref = ref_ext.prepare(wl, scene_path, "cpu")
    ref.render(SEED)
    c = stats.counters
    assert set(c) == {"segments", "lanes", *wavefront.WORK_COUNTERS}
    assert wavefront.WORK_COUNTERS[:4] == ("alive", "tiles", "boxes", "walk_iterations")
    assert 0 < c["shadow_rays"] == ref.shadow_rays < c["segments"]
    assert 0 < c["specular"] == ref.specular < c["segments"]
    assert c["alive"] == c["segments"]  # the nearest hits' counts stay where they were
    if backend == "auto":
        tiles = pipeline.prepare_scene(str(scene_path), Config(nee=True), camera_name="Camera 1",
                                       width=8, height=8, device="cpu")[0].tile_bbox.shape[1]
        assert c["shadow_boxes"] == c["shadow_rays"] * tiles
        assert 0 < c["shadow_tiles"] <= c["shadow_boxes"]
    else:
        assert c["shadow_tiles"] == c["shadow_boxes"] == 0
    _, plain = program(scene_path, (), backend)
    assert all(plain.counters[k] == 0
               for k in ("shadow_rays", "shadow_tiles", "shadow_boxes", "specular"))


def test_the_shadow_readers_divide_the_counters(monkeypatch):
    from pathbench import devtrace
    from pathbench.reading import Reading
    from zig_raytracing_contest_tpu_torch import kernels

    trace = devtrace.DeviceTrace([(0.0, 10.0, "trace_stream_kernel")], [], 0.0, 20.0, 2)
    reading = Reading(spec.load_workload(CELL), 2, {}, trace, 1843200, 2857164, 261966, 0, 0)
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}

    def read(name):
        module = spec.load_metric(name)
        assert module.UNIT == entries[name]["unit"]
        assert entries[name]["source"] == "program_counter"
        assert entries[name]["workloads"] == [CELL]
        return module.read(reading)

    readers = ("shadow_rays_per_segment", "shadow_boxes_per_ray", "specular_per_segment")
    monkeypatch.setattr(kernels, "COUNTERS", {"frames": 2, "segments": 1000, "shadow_rays": 40,
                                              "shadow_tiles": 90, "shadow_boxes": 3200,
                                              "specular": 25})
    assert [read(name) for name in readers] == pytest.approx([0.04, 80.0, 0.025])
    monkeypatch.setattr(kernels, "COUNTERS", {"frames": 2, "segments": 1000, "shadow_rays": 0,
                                              "shadow_boxes": 0, "specular": 0})  # no extension
    assert [read(name) for name in readers] == [0, 0, 0]
    monkeypatch.setattr(kernels, "COUNTERS", {"frames": 2, "segments": 1000})  # an older program
    assert [read(name) for name in readers] == [None, None, None]
