"""Entry points: a one-wave render step and a multi-device dry run.

The twin of the JAX package's top-level ``__graft_entry__.py``.

``entry()`` returns a render step over the port's main path
(``render/wavefront.render_wave_rows``) plus example args on a tiny
Cornell box.

``dryrun_multichip(n)`` renders one sharded frame over n pixel tiles
(``parallel/sharding.py``): the framebuffer split by pixel tile and the
scene replicated.  The renderer has no parameters or experts, so pixel
tiling is its only multi-device configuration.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from .config import Config
from .parallel.sharding import make_mesh, render_scene_sharded
from .render.pipeline import prepare_scene, slot_geometry
from .render.wavefront import build_gen_par, render_wave_rows, whole_path_regime
from .scene.procedural import cornell_like_box


def _tiny_scene(width=16, height=16, device="cuda"):
    """The Cornell box (config: an 8³ grid, the auto backend) on
    ``device`` → (TorchScene, Camera)."""
    with tempfile.TemporaryDirectory() as d:
        path = cornell_like_box(Path(d) / "box.gltf")
        scene, camera, _ = prepare_scene(str(path), Config(grid_resolution=(8, 8, 8)),
                                         width=width, height=height, device=device)
    return scene, camera


def entry(device="cuda"):
    """(step, example_args): one wave of 32×32×1 rays at 2 bounces.

    ``step(scene, cam_origin, cam_llc, cam_right, cam_up, slot_base, seed)``
    → (rows3 (3, R) radiance in slot order, segments as a 0-d int64
    tensor); the counterpart of the JAX ``render_wave``."""
    width = height = 32  # 1024 rays: one 32×32 pixel tile, one full wave
    spp = 1
    wave_size = width * height * spp
    scene, camera = _tiny_scene(width, height, device)

    def step(scene, cam_origin, cam_llc, cam_right, cam_up, slot_base, seed):
        num_slots, tiles_x = slot_geometry(width, height, whole_path_regime(scene))
        par = build_gen_par(scene, cam_origin, cam_llc, cam_right, cam_up)
        return render_wave_rows(scene, par, width, height, spp, 2, slot_base, num_slots,
                                wave_size, seed, tiles_x)

    example_args = (scene, camera.origin, camera.lower_left_corner, camera.right,
                    camera.up, 0, 0)
    return step, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Render one sharded 16×16 frame (1 spp, 2 bounces, waves of 1024
    rays) over ``n_devices`` tiles: the visible cards, repeated when
    ``n_devices`` exceeds them (a dry run), or CPU tiles."""
    if n_devices < 1:
        raise ValueError(f"requested {n_devices} devices")
    if torch.device(device).type == "cuda":
        cards = make_mesh(None, device)
        mesh = tuple(cards[i % len(cards)] for i in range(n_devices))
    else:
        mesh = make_mesh(n_devices, device)
    scene, camera = _tiny_scene(16, 16, mesh[0])
    config = Config(num_samples=1, max_bounce=2, wave_size=1024)
    img, stats = render_scene_sharded(scene, camera, config, mesh)
    if not (img.shape == (16, 16, 3) and img.dtype == "uint8"):
        raise AssertionError(f"dry run image {img.shape} {img.dtype}")
    if not stats.segments > 0:
        raise AssertionError("dry run traced no segment")
