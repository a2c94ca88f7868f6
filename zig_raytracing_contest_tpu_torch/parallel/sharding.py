"""Multi-device rendering: pixel-tile data parallelism over a mesh of devices.

The port of ``zig_raytracing_contest_tpu/parallel/sharding.py``.  The
reference's only render parallelism is fork-join OS threads over contiguous
pixel blocks with no communication (src/stage3.zig:222-256).  Here a mesh
is an ordered tuple of ``torch.device``s, one per pixel tile; the scene
(read-only) is replicated once per distinct device, each tile renders
exactly the global ray ids of its own slots, and one gather to the first
device ends the frame.  The per-ray counter RNG keys on the global ray id,
so the tiled image is bit-identical to ``render/pipeline.render_scene``'s.

A device may appear more than once: its tiles then render in turn.  That
is how N tiles run on one card, or on the CPU.  Each distinct device's
tiles are issued from a host thread of their own, so several cards work
at once.  The frame is finished on the first device by the same
``finalize_image_rows`` that ``render_scene`` uses.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..render.pipeline import (
    RenderStats,
    finalize_image_rows,
    prepare_scene,
    slot_geometry,
    slot_of_pixel,
)
from ..render.wavefront import build_gen_par, render_wave_rows, whole_path_regime
from ..scene.camera import Camera
from ..scene.types import TorchScene
from ..utils.image_io import write_png
from ..utils.timing import PhaseTimers

log = logging.getLogger("zig_raytracing_contest_tpu_torch")

Mesh = tuple  # of torch.device, one per pixel tile; a device may repeat


def make_mesh(num_devices: int | None = None, device="cuda") -> Mesh:
    """``num_devices`` tiles (default: one per visible card): with
    ``"cuda"`` the first n visible cards, with ``"cpu"`` n CPU tiles
    (default 1)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is "
                           "False; render on device='cpu' explicitly")
    visible = torch.cuda.device_count() if kind == "cuda" else None
    n = num_devices or visible or 1
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if kind == "cpu":
        return (torch.device("cpu"),) * n
    if n > visible:
        raise ValueError(f"requested {n} devices, only {visible} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def _tile_fb(scene: TorchScene, camera: Camera, config: Config, tile: int, *,
             slots_per_dev: int, num_slots: int, wave_size: int, waves_per_dev: int,
             tiles_x: int):
    """One tile's framebuffer (3, waves_per_dev · wave pixels), field-major,
    and its segments (0-d int64), rendered on the scene's device."""
    spp = config.num_samples
    wave_pixels = wave_size // spp
    slot0 = tile * slots_per_dev
    # rows past this tile or the real slot space are zeroed by
    # render_wave_rows, so a final wave may spill into the padded columns
    slot_cap = min(slot0 + slots_per_dev, num_slots)
    dev = scene.device
    par = build_gen_par(scene, camera.origin, camera.lower_left_corner, camera.right,
                        camera.up)
    fb = torch.zeros((3, waves_per_dev * wave_pixels), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for w in range(waves_per_dev):
        slot_base = slot0 + w * wave_pixels
        if slot_base >= slot_cap:
            break  # a wave with no real slot adds exact zeros
        rows3, segs = render_wave_rows(
            scene, par, camera.width, camera.height, spp, config.max_bounce, slot_base,
            slot_cap, wave_size, config.seed, tiles_x, ext=config.ext_flags,
        )
        lp0 = w * wave_pixels
        fb[:, lp0: lp0 + wave_pixels] += rows3.reshape(3, wave_pixels, spp).sum(dim=2)
        segments += segs
    return fb, segments


def render_scene_sharded(
    scene: TorchScene,
    camera: Camera,
    config: Config,
    mesh: Mesh | None = None,
    timers: PhaseTimers | None = None,
) -> tuple[np.ndarray, RenderStats]:
    """Render over the tiles of ``mesh`` (default ``make_mesh()``: every
    visible card) to an (h, w, 3) uint8 array; bit-identical to
    ``render_scene`` with equal segments."""
    timers = timers or PhaseTimers()
    mesh = tuple(torch.device(d) for d in (make_mesh() if mesh is None else mesh))
    n = len(mesh)
    if n < 1:
        raise ValueError("the mesh has no device")
    w, h, spp = camera.width, camera.height, config.num_samples
    num_pixels = w * h
    if num_pixels * spp >= 1 << 31:
        raise ValueError(
            f"{num_pixels} pixels × {spp} spp = {num_pixels * spp} rays "
            f"exceeds the int32 ray-id space (2^31); reduce resolution or spp."
        )
    num_slots, tiles_x = slot_geometry(w, h, whole_path_regime(scene, config.ext_flags))
    if num_slots * spp >= 1 << 31:
        raise ValueError("slot count × spp exceeds int32 ray-id space")
    # Tiled slot order needs tile-aligned (1024-slot) device boundaries so
    # the kernels' slot decode stays tile-exact; raster order keeps the
    # reference-like arbitrary contiguous split.
    if tiles_x:
        slots_per_dev = -(-(-(-num_slots // n)) // 1024) * 1024
    else:
        slots_per_dev = -(-num_slots // n)
    rays_per_dev = slots_per_dev * spp
    # Wave quantum: spp (whole pixel slots) × 1024 (32×32 pixel tiles);
    # slot math is exact below 2^23 rays per wave.
    quantum = spp * 1024
    wave_size = max(
        quantum,
        min(config.wave_size, rays_per_dev + quantum - 1) // quantum * quantum,
    )
    wave_size = min(wave_size, (1 << 23) // quantum * quantum)
    waves_per_dev = -(-rays_per_dev // wave_size)
    log.info("Num samples: %d, max bounce %d", config.num_samples, config.max_bounce)
    log.info("Mesh: %d tile(s) on %s, %d slots/tile, %d wave(s) of %d rays",
             n, ", ".join(sorted({str(d) for d in mesh})), slots_per_dev, waves_per_dev,
             wave_size)

    # the scene once per distinct device
    replicas = {}
    for d in mesh:
        if d not in replicas:
            replicas[d] = scene if scene.device == d else scene.to(d)
    geometry = dict(slots_per_dev=slots_per_dev, num_slots=num_slots, wave_size=wave_size,
                    waves_per_dev=waves_per_dev, tiles_x=tiles_x)

    def render_device(d):
        """Every tile of device ``d``, in turn: {tile: (fb, segments)}."""
        ctx = torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()
        with ctx:
            return {tile: _tile_fb(replicas[d], camera, config, tile, **geometry)
                    for tile, m in enumerate(mesh) if m == d}

    with timers.phase("render", "Rendered"):
        tiles = {}
        with ThreadPoolExecutor(len(replicas)) as pool:
            for got in pool.map(render_device, replicas):
                tiles.update(got)
        # strip the per-tile padding, gather to the first device, and finish
        # there as render_scene does: tiled slots map back to raster pixels
        fb = torch.cat([tiles[t][0][:, :slots_per_dev].to(mesh[0]) for t in range(n)],
                       dim=1)
        slot_perm = (torch.from_numpy(slot_of_pixel(w, h, tiles_x)).to(mesh[0])
                     if tiles_x else None)
        img = finalize_image_rows(fb, num_pixels, spp, slot_perm)
        img = img.cpu().numpy().reshape(h, w, 3)
        segments = sum(int(tiles[t][1]) for t in range(n))

    stats = RenderStats(
        width=w, height=h, spp=spp, max_bounce=config.max_bounce,
        segments=segments, phases=timers.phases,
    )
    return img, stats


def render_file_sharded(
    in_path: str,
    out_path: str,
    config: Config,
    camera_name=None,
    width=None,
    height=None,
    num_devices: int | None = None,
    device="cuda",
) -> RenderStats:
    """Scene file in, PNG out, rendered over ``make_mesh(num_devices,
    device)``."""
    mesh = make_mesh(num_devices, device)
    scene, camera, timers = prepare_scene(in_path, config, camera_name, width, height,
                                          mesh[0])
    img, stats = render_scene_sharded(scene, camera, config, mesh, timers)
    with timers.phase("save", "Saved"):
        write_png(out_path, img)
    timers.done()
    stats.phases = timers.phases
    return stats
