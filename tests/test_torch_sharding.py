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
  under concurrent host threads.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.parallel import sharding as jsharding
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu_torch import kernels
from zig_raytracing_contest_tpu_torch.cli import main as cli_main
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.parallel.sharding import make_mesh, render_scene_sharded
from zig_raytracing_contest_tpu_torch.render import wavefront
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
