"""End-to-end render pipeline: scene file → PNG, with phase timing.

The port of ``zig_raytracing_contest_tpu/render/pipeline.py`` for the
whole-path regime: load → preprocess → compile (scene bake) → render →
save, each phase timed and logged like the reference's main()
(src/main.zig:73-143).  Frames render in waves of pixel slots in 32×32
tiled order; each wave's radiance is summed per slot into a field-major
framebuffer, which is mapped back to raster order, averaged and
gamma-encoded at the end.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..grid.builder import scene_bbox
from ..ops import linalg
from ..scene.camera import Camera, load_camera
from ..scene.geometry import load_geometry
from ..scene.gltf import load_gltf
from ..scene.materials import load_materials
from ..scene.types import TorchScene, build_torch_scene
from ..utils.image_io import write_png
from ..utils.timing import PhaseTimers
from .wavefront import build_gen_par, render_wave_rows, whole_path_regime

log = logging.getLogger("zig_raytracing_contest_tpu_torch")


def slot_geometry(width: int, height: int) -> tuple[int, int]:
    """(num_slots, tiles_x) of the frame's 32×32-tiled pixel-slot space:
    each 1024-slot tile is a compact pixel square."""
    tiles_x = -(-width // 32)
    tiles_y = -(-height // 32)
    return tiles_x * tiles_y * 1024, tiles_x


def slot_of_pixel(width: int, height: int, tiles_x: int) -> np.ndarray:
    """(num_pixels,) int64: raster pixel id → tiled slot id."""
    p = np.arange(width * height, dtype=np.int64)
    x = p % width
    y = p // width
    tile = (y // 32) * tiles_x + (x // 32)
    return tile * 1024 + (y % 32) * 32 + (x % 32)


def finalize_image_rows(fb: torch.Tensor, num_pixels: int, spp: int,
                        slot_perm: torch.Tensor) -> torch.Tensor:
    """Map slots back to raster pixels, average samples, gamma-encode →
    (num_pixels * 3,) uint8."""
    fb = fb[:, slot_perm]  # (3, num_pixels) raster order
    return linalg.vec3_to_rgb(fb.T / spp).reshape(-1)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_bounce: int
    segments: int  # traced path segments (= rays for Mrays/s)
    phases: dict


def prepare_scene(in_path: str, config: Config, camera_name=None, width=None,
                  height=None, device="cpu"):
    """Host pipeline: parse, extract, bake, upload.  Returns
    (TorchScene, Camera, timers)."""
    timers = PhaseTimers()

    with timers.phase("load", "Loaded"):
        gltf = load_gltf(in_path, num_threads=config.host_threads)

    with timers.phase("preprocess", "Preprocessed"):
        camera = load_camera(gltf, camera_name, width, height)
        log.info("Pixels count: %d", camera.width * camera.height)
        materials = load_materials(gltf)
        log.info("Materials count: %d", materials.num_materials)
        geometry = load_geometry(gltf)
        if config.debug_checks and geometry.num_triangles:
            for name in ("positions", "normals", "texcoords"):
                arr = getattr(geometry, name)
                bad = int(np.sum(~np.isfinite(arr)))
                if bad:
                    raise FloatingPointError(
                        f"debug_checks: {bad} non-finite {name} values in "
                        f"loaded geometry"
                    )

    with timers.phase("compile", "Compiled"):
        scene = build_torch_scene(
            geometry, materials, scene_bbox(geometry.positions), device,
            backend=config.backend,
        )
        log.info("Intersection backend: flat tile loop on %s", scene.device)

    return scene, camera, timers


def render_scene(
    scene: TorchScene,
    camera: Camera,
    config: Config,
    timers: PhaseTimers | None = None,
    progressive_path: str | None = None,
    device=None,
    plain: bool = False,
) -> tuple[np.ndarray, RenderStats]:
    """Render to an (h, w, 3) uint8 array.

    ``device``: where to render (default: the scene's device).  A CUDA
    device renders with the CUDA kernels and a CPU device with their plain
    twins; ``plain=True`` runs the twins on any device (the kernels'
    reference on the card)."""
    if device is not None:
        scene = scene.to(device)
    timers = timers or PhaseTimers()
    w, h, spp = camera.width, camera.height, config.num_samples
    if not whole_path_regime(scene, config.ext_flags):
        raise NotImplementedError(
            "the rendering extensions (nee, russian_roulette, pbr) are "
            "ROADMAP queue 1 item 12"
        )
    num_pixels = w * h
    num_slots, tiles_x = slot_geometry(w, h)
    total_rays = num_slots * spp
    if total_rays >= 1 << 31:
        raise ValueError(
            f"{num_slots} slots × {spp} spp = {total_rays} rays exceeds "
            f"the int32 ray-id space (2^31); reduce resolution or spp."
        )
    # Waves are whole multiples of spp·1024 rays: whole pixel slots, whole
    # 32×32 tiles.  Slot math is exact below 2^23 rays per wave.
    quantum = spp * 1024
    wave_size = max(
        quantum, min(config.wave_size, total_rays + quantum - 1) // quantum * quantum
    )
    wave_size = min(wave_size, (1 << 23) // quantum * quantum)
    num_waves = -(-total_rays // wave_size)
    wave_pixels = wave_size // spp
    log.info(
        "Num samples: %d, max bounce %d", config.num_samples, config.max_bounce
    )

    dev = scene.device
    par = build_gen_par(scene, camera.origin, camera.lower_left_corner,
                        camera.right, camera.up)
    fb = torch.zeros((3, num_waves * wave_pixels), dtype=torch.float32, device=dev)
    slot_perm = torch.from_numpy(slot_of_pixel(w, h, tiles_x)).to(dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)

    with timers.phase("render", "Rendered"):
        for wave in range(num_waves):
            slot_base = wave * wave_pixels
            rows3, segs = render_wave_rows(
                scene, par, w, h, spp, config.max_bounce, slot_base,
                num_slots, wave_size, config.seed, tiles_x, plain=plain,
            )
            fb[:, slot_base : slot_base + wave_pixels] += rows3.reshape(
                3, wave_pixels, spp
            ).sum(dim=2)
            segments += segs
            if (
                progressive_path
                and config.progressive_every
                and (wave + 1) % config.progressive_every == 0
                and wave + 1 < num_waves
            ):
                # Progressive dump: slots not yet reached stay dark.
                partial = finalize_image_rows(fb, num_pixels, spp, slot_perm)
                write_png(progressive_path, partial.cpu().numpy().reshape(h, w, 3))
        if config.debug_checks:
            bad = int((~torch.isfinite(fb)).sum())
            if bad:
                raise FloatingPointError(
                    f"debug_checks: {bad} non-finite framebuffer channel "
                    f"values before PNG encode"
                )
        img = finalize_image_rows(fb, num_pixels, spp, slot_perm)
        img = img.cpu().numpy().reshape(h, w, 3)
        segments = int(segments)

    stats = RenderStats(
        width=w,
        height=h,
        spp=spp,
        max_bounce=config.max_bounce,
        segments=segments,
        phases=timers.phases,
    )
    return img, stats


def render_file(
    in_path: str,
    out_path: str,
    config: Config,
    camera_name=None,
    width=None,
    height=None,
    device="cpu",
) -> RenderStats:
    """Full reference-equivalent run: scene file in, PNG out."""
    scene, camera, timers = prepare_scene(
        in_path, config, camera_name, width, height, device
    )
    progressive = out_path if config.progressive_every else None
    img, stats = render_scene(scene, camera, config, timers, progressive)
    with timers.phase("save", "Saved"):
        write_png(out_path, img)
    timers.done()
    stats.phases = timers.phases
    return stats
