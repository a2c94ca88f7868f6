"""End-to-end render pipeline: scene file → PNG, with phase timing.

The port of ``zig_raytracing_contest_tpu/render/pipeline.py``: load →
preprocess → compile (the grid when the backend needs one, the scene bake)
→ render → save, each phase timed and logged like the reference's main()
(src/main.zig:73-143).  Frames render in waves of pixel slots, in 32×32
tiled order for whole-path scenes and in raster order for per-bounce and
XLA-path waves (grid scenes, the extensions); each wave's radiance is
summed per slot into a field-major framebuffer, which is mapped back to
raster order, averaged and gamma-encoded at the end.

Every entry point renders on the CUDA card unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import logging
import subprocess
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..grid.builder import GridBuild, build_grid, scene_bbox
from ..grid.native import build_grid_native
from ..ops import linalg
from ..scene.camera import Camera, load_camera
from ..scene.geometry import load_geometry
from ..scene.gltf import load_gltf
from ..scene.materials import load_materials
from ..scene.types import TorchScene, build_torch_scene, scene_backend
from ..utils.image_io import write_png
from ..utils.timing import PhaseTimers
from .wavefront import (
    build_gen_par,
    regime,
    render_wave_rows,
    shade_bank,
    trace_walk,
    whole_path_regime,
)

log = logging.getLogger("zig_raytracing_contest_tpu_torch")


def slot_geometry(width: int, height: int, whole_path: bool) -> tuple[int, int]:
    """(num_slots, tiles_x) of the frame's pixel-slot space.  Whole-path
    frames use 32×32-tiled order (each 1024-slot tile a compact pixel
    square); the per-bounce pipeline keeps raster order (slot == pixel id,
    tiles_x = 0)."""
    if not whole_path:
        return width * height, 0
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
                        slot_perm: torch.Tensor | None) -> torch.Tensor:
    """Map slots back to raster pixels (``slot_perm``; None for raster
    order), average samples, gamma-encode → (num_pixels * 3,) uint8."""
    fb = fb[:, :num_pixels] if slot_perm is None else fb[:, slot_perm]
    return linalg.vec3_to_rgb(fb.T / spp).reshape(-1)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_bounce: int
    segments: int  # traced path segments (= rays for Mrays/s)
    phases: dict


def build_scene_grid(positions: np.ndarray, resolution) -> GridBuild:
    """The scene's grid, from the native OpenMP builder, or from the NumPy
    builder (the same GridBuild) with a warning when no compiler can build
    the native one."""
    try:
        return build_grid_native(positions, resolution, log_fn=log.info)
    except (OSError, subprocess.CalledProcessError) as exc:
        log.warning("native grid builder unavailable (%s); using NumPy", exc)
        return build_grid(positions, resolution, log=log.info)


def backend_line(scene: TorchScene, ext=None) -> str:
    """How a frame of ``scene`` renders, in words: the regime, the device,
    the bank's shade and the walk, e.g. ``streaming, sorted on cuda:0
    (resident bank); walk: group heap``.  The CPU twins take the flat tile
    loop for every baked scene: ``walk: flat (plain twins)``."""
    walk = (trace_walk(scene, ext) if scene.device.type == "cuda" or scene.tri_data is None
            else "flat (plain twins)")
    return f"{regime(scene, ext)} on {scene.device} ({shade_bank(scene, ext)}); walk: {walk}"


def prepare_scene(in_path: str, config: Config, camera_name=None, width=None,
                  height=None, device="cuda"):
    """Host pipeline: parse, extract, build the grid when the backend needs
    one (``build_scene_grid``), bake, upload to ``device``.  Returns
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
        backend = scene_backend(geometry.num_triangles, config.backend)
        log.info("Backend: %s (config: %s, %d triangles)", backend, config.backend,
                 geometry.num_triangles)
        grid = build_scene_grid(geometry.positions, config.grid_resolution) if (
            backend == "grid") else None
        scene = build_torch_scene(
            geometry, materials, scene_bbox(geometry.positions), device,
            backend=config.backend, grid=grid,
        )
        log.info("Intersection backend: %s", backend_line(scene, config.ext_flags))

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
    reference on the card).  A grid scene, or an extension in ``config``,
    renders through the XLA shading path."""
    if device is not None:
        scene = scene.to(device)
    timers = timers or PhaseTimers()
    w, h, spp = camera.width, camera.height, config.num_samples
    ext = config.ext_flags
    num_pixels = w * h
    num_slots, tiles_x = slot_geometry(w, h, whole_path_regime(scene, ext))
    total_rays = num_slots * spp
    if total_rays >= 1 << 31:
        raise ValueError(
            f"{num_slots} slots × {spp} spp = {total_rays} rays exceeds "
            f"the int32 ray-id space (2^31); reduce resolution or spp."
        )
    # Waves are whole multiples of spp·1024 rays: whole pixel slots (and
    # whole 32×32 tiles in tiled order).  Slot math is exact below 2^23
    # rays per wave.
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
    slot_perm = (torch.from_numpy(slot_of_pixel(w, h, tiles_x)).to(dev)
                 if tiles_x else None)
    segments = torch.zeros((), dtype=torch.int64, device=dev)

    with timers.phase("render", "Rendered"):
        for wave in range(num_waves):
            slot_base = wave * wave_pixels
            rows3, segs = render_wave_rows(
                scene, par, w, h, spp, config.max_bounce, slot_base,
                num_slots, wave_size, config.seed, tiles_x, plain=plain, ext=ext,
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
    device="cuda",
) -> RenderStats:
    """Full reference-equivalent run: scene file in, PNG out, rendered on
    ``device``."""
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
