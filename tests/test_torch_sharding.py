"""The port's multi-device pixel tiling (parallel/sharding.py) on CPU tiles.

* ``render_scene_sharded`` against the port's ``render_scene`` bit for bit,
  with equal segments: the 16×16 Cornell box through the whole path (tiled
  slot order, 1024-slot tile boundaries) over 1, 2, 3 and 8 tiles; the
  grid backend over 3 uneven tiles (raster order, 86/86/84 slots); NEE,
  Russian roulette and PBR on the grid and on the MXU bake over 4 tiles;
* the port's sharded frame against the JAX package's ``render_scene_sharded``
  on the 8 virtual CPU devices of tests/conftest.py, under the opaque golden
  gate of tests/test_golden.py (diff > 3 on under 0.5% of channels, mean
  under 1.0) with equal segments;
* ``make_mesh``'s errors, the CLI's ``--devices``, and the launch counter
  under concurrent host threads;
* the device programs: ``tile_geometry`` / ``frame_plan``'s tiles against
  hand-computed values (the official 1080p frame over 1, 3, 4 and 8 tiles,
  raster splits, the 2^23 cap), a tiled sharded frame with the NumPy slot
  map unavailable, the plans' keys, and the graph route through a stub
  capture over a mesh of two distinct devices (``cpu`` and ``cpu:1``,
  which stands in for a second card: a replica, its own FrameGraph, the
  framebuffers finished on the first device): bit for bit, equal
  segments and launch counts, replicas and graphs kept across frames.
"""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.parallel import sharding as jsharding
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.cli import main as cli_main
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.parallel import sharding
from zig_raytracing_contest_tpu_torch.parallel.sharding import make_mesh, render_scene_sharded
from zig_raytracing_contest_tpu_torch.render import fused, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu_torch.scene.procedural import cornell_like_box
from zig_raytracing_contest_tpu_torch.utils.image_io import decode_image


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return str(cornell_like_box(tmp_path_factory.mktemp("box") / "box.gltf"))


def _single_and_sharded(path, cfg, n, size=16):
    scene, cam, _ = prepare_scene(path, cfg, width=size, height=size, device="cpu")
    single, st_s = render_scene(scene, cam, cfg)
    sharded, st_m = render_scene_sharded(scene, cam, cfg, make_mesh(n, "cpu"))
    return scene, single, st_s, sharded, st_m


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_whole_path_matches_single_device(box, n):
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=2048)
    scene, single, st_s, sharded, st_m = _single_and_sharded(box, cfg, n)
    assert wavefront.whole_path_regime(scene)  # tiled order, 1024-slot tiles
    np.testing.assert_array_equal(single, sharded)
    assert st_s.segments == st_m.segments > 0


def test_grid_backend_uneven_tiles(box):
    """16×16 = 256 raster slots over 3 tiles (86/86/84): masking at the cap."""
    cfg = Config(grid_resolution=(8, 8, 8), num_samples=1, max_bounce=2, seed=2,
                 backend="grid")
    scene, single, st_s, sharded, st_m = _single_and_sharded(box, cfg, 3)
    assert wavefront.regime(scene) == "XLA shading, grid"
    np.testing.assert_array_equal(single, sharded)
    assert st_s.segments == st_m.segments


@pytest.mark.parametrize("backend", ["grid", "mxu"])
def test_extensions_sharded(box, backend):
    """NEE + Russian roulette + PBR through the XLA shading path over 4
    tiles, 24×24 in waves of 2^11 rays (two waves a tile)."""
    cfg = Config(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=9,
                 wave_size=2048, backend=backend, nee=True, russian_roulette=True,
                 pbr=True)
    scene, single, st_s, sharded, st_m = _single_and_sharded(box, cfg, 4, size=24)
    assert scene.lights is not None
    assert wavefront.regime(scene, cfg.ext_flags).startswith("XLA shading")
    np.testing.assert_array_equal(single, sharded)
    assert st_s.segments == st_m.segments


def test_sharded_matches_jax_sharded(box):
    """The port over 8 CPU tiles against the JAX package over its 8 virtual
    CPU devices: the opaque golden gate, equal segments."""
    kw = dict(grid_resolution=(8, 8, 8), num_samples=2, max_bounce=3, seed=5,
              wave_size=2048)
    jcfg = JConfig(**kw)
    js, jcam, _ = jax_prepare(box, jcfg, width=16, height=16)
    want, jst = jsharding.render_scene_sharded(js, jcam, jcfg, jsharding.make_mesh(8))
    cfg = Config(**kw)
    scene, cam, _ = prepare_scene(box, cfg, width=16, height=16, device="cpu")
    got, st = render_scene_sharded(scene, cam, cfg, make_mesh(8, "cpu"))
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert got.shape == want.shape == (16, 16, 3)
    assert (diff > 3).mean() < 0.005, f"{(diff > 3).mean():.4%} channels off"
    assert diff.mean() < 1.0
    assert st.segments == jst.segments


def test_make_mesh():
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="requested -1"):
        make_mesh(-1, "cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_mesh(2, "meta")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_mesh() == tuple(torch.device("cuda", i) for i in range(n))
        with pytest.raises(ValueError, match=f"only {n} visible"):
            make_mesh(n + 1)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(2, "cuda")


def test_cli_devices_flag(tmp_path):
    """``--device cpu --devices 2`` renders through the sharded path: a
    16×16 PNG, read back with the port's own codec."""
    from zig_raytracing_contest_tpu_torch.scene.procedural import cornell_like_box as box_glb

    scene_path = box_glb(tmp_path / "s.glb", glb=True)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"grid_resolution": [8, 8, 8], "num_threads": None,
                               "num_samples": 1, "max_bounce": 2}))
    out = tmp_path / "out.png"
    rc = cli_main(["--in", str(scene_path), "--out", str(out), "--camera", "Camera 1",
                   "--width", "16", "--height", "16", "--config", str(cfg),
                   "--device", "cpu", "--devices", "2"])
    assert rc == 0
    img = decode_image(out.read_bytes())
    assert (img.width, img.height) == (16, 16)


def test_launch_counter_under_threads():
    """kernels._count from more threads than cores, with a short switch
    interval: no lost update."""
    threads, per = 32, 2000
    kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [kernels._count("shade") for _ in range(per)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert kernels.LAUNCHES["shade"] == threads * per
    kernels.reset_launches()


# ------------------------------------------------------ the device programs

OFFICIAL_SLOTS = 60 * 34 * 1024  # 1920×1080 in 32×32 tiles: 2,088,960 slots


@pytest.mark.parametrize("w, h, spp, n, whole, wave_cfg, want", [
    # the official frame (3 spp, waves of 2^19 rays: 170 × 3072 = 522,240)
    (1920, 1080, 3, 1, True, 1 << 19, (OFFICIAL_SLOTS, 522240, 12)),
    (1920, 1080, 3, 3, True, 1 << 19, (696320, 522240, 4)),
    (1920, 1080, 3, 4, True, 1 << 19, (522240, 522240, 3)),
    (1920, 1080, 3, 8, True, 1 << 19, (261120, 522240, 2)),
    # tiled: 100×50 is 4×2 tiles; 8192 / 3 rounded up to whole 1024-slot tiles
    (100, 50, 2, 3, True, 1 << 12, (3072, 4096, 2)),
    # raster splits anywhere: 256 slots as 86 / 86 / 84
    (16, 16, 1, 3, False, 1 << 20, (86, 1024, 1)),
    # raster 1080p over 3: a wave no larger than the tile's 1,382,400 rays
    (1920, 1080, 2, 3, False, 1 << 21, (691200, 1382400, 1)),
    # the 2^23-ray cap on a wave
    (4096, 4096, 1, 1, False, 1 << 24, (1 << 24, 1 << 23, 2)),
], ids=["official-1", "official-3", "official-4", "official-8", "tiled-uneven",
        "raster-uneven", "raster-1080p-3", "cap-2^23"])
def test_tile_geometry(monkeypatch, w, h, spp, n, whole, wave_cfg, want):
    """Slots a tile, rays a wave, waves a tile and each tile's slot range,
    from the one function that render_scene's and the sharded plans share
    (the JAX package's sharded geometry), against hand-computed values."""
    monkeypatch.setattr(pipeline, "whole_path_regime", lambda scene, ext=None: whole)
    num_slots, tiles_x = pipeline.slot_geometry(w, h, whole)
    assert pipeline.tile_geometry(num_slots, tiles_x, spp, wave_cfg, n) == want
    cam = SimpleNamespace(width=w, height=h)
    cfg = Config(num_samples=spp, max_bounce=4, wave_size=wave_cfg)
    plan = pipeline.frame_plan(None, cam, cfg, n)
    tile_slots, wave, waves = want
    assert (plan.tile_slots, plan.wave_size, plan.num_waves) == want
    assert plan.tiles == tuple((t * tile_slots, min((t + 1) * tile_slots, num_slots))
                               for t in range(n))
    assert plan.tiles[-1][1] == num_slots and plan.encode
    assert plan.tile_cols == waves * wave // spp >= tile_slots
    mid = pipeline.frame_plan(None, cam, cfg, n, [n - 1])
    assert mid.tiles == plan.tiles[-1:] and mid.encode == (n == 1)


def test_plan_keys_tell_tile_splits_apart(box):
    """Meshes of 3 and 4 tiles take two graphs; a one-tile sharded plan is
    render_scene's plan (the same work, one graph); a device's share of a
    split is not the whole split."""
    cfg = Config(num_samples=2, max_bounce=3, wave_size=2048)
    scene, cam, _ = prepare_scene(box, cfg, width=64, height=64, device="cpu")
    cpu = torch.device("cpu")
    three = sharding.device_plans(scene, cam, cfg, (cpu,) * 3)[cpu]
    four = sharding.device_plans(scene, cam, cfg, (cpu,) * 4)[cpu]
    one = sharding.device_plans(scene, cam, cfg, (cpu,))[cpu]
    assert three.key != four.key
    assert one == pipeline.frame_plan(scene, cam, cfg)
    halves = sharding.device_plans(scene, cam, cfg, (cpu, torch.device("cpu", 1)) * 2)
    assert [p.tiles for p in halves.values()] == [((0, 1024), (2048, 3072)),
                                                  ((1024, 2048), (3072, 4096))]
    assert not any(p.encode for p in halves.values())
    assert len({p.key for p in halves.values()} | {four.key}) == 3


TWO_DEVICES = (torch.device("cpu"), torch.device("cpu", 1))


@pytest.mark.parametrize("mesh", [(torch.device("cpu"),) * 4, TWO_DEVICES * 2],
                         ids=["4 tiles", "2 devices"])
def test_sharded_frame_needs_no_numpy_slot_map(box, monkeypatch, mesh):
    """A tiled sharded frame maps its slots with the device slot map: with
    ``slot_of_pixel`` raising, it still equals render_scene bit for bit."""
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=2048)
    scene, cam, _ = prepare_scene(box, cfg, width=40, height=40, device="cpu")
    single, st_s = render_scene(scene, cam, cfg)

    def no_numpy_map(*a):
        raise AssertionError("the NumPy slot map was built")

    monkeypatch.setattr(pipeline, "slot_of_pixel", no_numpy_map)
    sharded, st_m = render_scene_sharded(scene, cam, cfg, mesh)
    assert wavefront.whole_path_regime(scene)
    np.testing.assert_array_equal(single, sharded)
    assert st_s.segments == st_m.segments > 0


def stub_capture(fn, device):
    """Stands in for capture_cuda_graph (as in tests/test_torch_frame.py):
    a replay runs ``fn`` again into the captured outputs, with the Python
    launch counts left as they were; a plan that does not encode has no
    image output."""
    out = fn()

    def replay():
        before = dict(kernels.LAUNCHES)
        for dst, src in zip(out, fn()):
            if dst is not None:
                dst.copy_(src)
        kernels.add_launches({k: before[k] - n for k, n in kernels.LAUNCHES.items()})

    return replay, out, 0


def test_graph_frames_keep_replicas_and_graphs(box, monkeypatch):
    """Sharded frames through the graph route (a stub capture on the CPU)
    over two distinct devices: the second device's replica and each
    device's FrameGraph are made once and kept in the scene's frame cache,
    one capture a device; every frame (warm-up, capture, replays, and a
    second camera through the same graphs) equals render_scene bit for bit
    with equal segments; two graph frames count the launches of two eager
    ones."""
    captures = []
    monkeypatch.setattr(pipeline, "graph_route", lambda *a, **k: True)
    monkeypatch.setattr(pipeline, "capture_cuda_graph",
                        lambda fn, device: captures.append(device) or stub_capture(fn, device))
    real = fused.path_trace_gen

    def counted(*a, **k):
        kernels.add_launches({"path_trace_gen": 1})
        return real(*a, **k)

    monkeypatch.setattr(fused, "path_trace_gen", counted)
    cfg = Config(num_samples=2, max_bounce=3, seed=5, wave_size=2048)
    scene, cam, _ = prepare_scene(box, cfg, width=40, height=40, device="cpu")
    cam2 = SimpleNamespace(width=cam.width, height=cam.height,
                           origin=np.asarray(cam.origin) + np.float32([0.3, -0.1, 0.2]),
                           lower_left_corner=cam.lower_left_corner, right=cam.right, up=cam.up)
    mesh = TWO_DEVICES * 2
    want = {id(c): render_scene(scene, c, cfg, graph=False) for c in (cam, cam2)}
    assert not np.array_equal(want[id(cam)][0], want[id(cam2)][0])
    counts = {}
    for graph in (False, True):
        kernels.reset_launches()
        for _ in range(2):
            render_scene_sharded(scene, cam, cfg, mesh, graph=graph)
        counts[graph] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert counts[True] == counts[False] and counts[True]["path_trace_gen"] > 0
    other = sharding.replica(scene, TWO_DEVICES[1])
    assert other is not scene and sharding.replica(scene, TWO_DEVICES[1]) is other
    plans = sharding.device_plans(scene, cam, cfg, mesh)
    graphs = [pipeline.frame_graph(sharding.replica(scene, d), p) for d, p in plans.items()]
    for c in (cam, cam2, cam):
        img, st = render_scene_sharded(scene, c, cfg, mesh)
        np.testing.assert_array_equal(img, want[id(c)][0])
        assert st.segments == want[id(c)][1].segments
    assert len(captures) == 2  # one a device, both devices' tensors on the CPU
    assert [pipeline.frame_graph(sharding.replica(scene, d), p)
            for d, p in plans.items()] == graphs
    assert [g.frames for g in graphs] == [5, 5] and all(g.replay for g in graphs)
    assert other.frame_cache()[plans[TWO_DEVICES[1]].key] is graphs[1]
    kernels.reset_launches()
