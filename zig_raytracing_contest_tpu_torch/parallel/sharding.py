"""Multi-device rendering: pixel-tile data parallelism over a mesh of devices.

The port of ``zig_raytracing_contest_tpu/parallel/sharding.py``.  The
reference's only render parallelism is fork-join OS threads over contiguous
pixel blocks with no communication (src/stage3.zig:222-256).  Here a mesh
is an ordered tuple of ``torch.device``s, one per pixel tile; the scene
(read-only) is replicated once per distinct device, each tile renders
exactly the global ray ids of its own slots, and one gather to the first
device ends the frame.  The per-ray counter RNG keys on the global ray id,
so the tiled image is bit-identical to ``render/pipeline.render_scene``'s.

A device may appear more than once: its tiles then render in turn, in one
device program.  That is how N tiles run on one card, or on the CPU.  As
the JAX package's frame is one ``shard_map`` program with a ``fori_loop``
of waves a device, each distinct device here renders its tiles as one
``FramePlan`` of ``render/pipeline.py``: on a card one CUDA graph replay a
frame, issued from a host thread a card, on a replica of the scene kept
across frames.  With one distinct device the encode is in that program;
with several, the framebuffers are copied to the first device and
finished there by the same ``finalize_image_rows`` that ``render_scene``
uses, through the device slot map.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..render import pipeline
from ..render.pipeline import (
    FramePlan,
    RenderStats,
    _render_frame_waves,
    device_slot_map,
    finalize_image_rows,
    frame_graph,
    frame_plan,
    image_to_host,
    prepare_scene,
    render_frame_graph,
)
from ..render.wavefront import build_gen_par
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


def replica(scene: TorchScene, device: torch.device) -> TorchScene:
    """``scene`` on ``device``: the scene itself where it lies, else its
    copy, made once and kept in the scene's frame cache, so the copy's
    CUDA graphs (which bake its tensors' addresses) live across frames."""
    if scene.device == device:
        return scene
    cache = scene.frame_cache()
    key = ("replica", device)
    if key not in cache:
        cache[key] = scene.to(device)
    return cache[key]


def device_plans(scene: TorchScene, camera: Camera, config: Config,
                 mesh: Mesh) -> dict:
    """{device: its FramePlan}, one per distinct device of ``mesh`` in mesh
    order: the tiles of ``mesh`` that lie on it.  With one distinct device
    its plan renders every tile and ends with the encode."""
    devices = dict.fromkeys(mesh)
    tiles = {d: [t for t, m in enumerate(mesh) if m == d] for d in devices}
    return {d: frame_plan(scene, camera, config, len(mesh),
                          None if len(devices) == 1 else tiles[d]) for d in devices}


def _device_frames(replicas: dict, plans: dict, camera: Camera, as_graph: bool) -> dict:
    """{device: ``_render_frame_waves``' outputs} of one frame: through each
    device's FrameGraph (``as_graph``), else eagerly.  Warm-ups and
    captures run one device at a time from this thread: a CUDA call from
    another thread can invalidate a capture, and a capture counts the
    launches of the whole process.  Replays and eager frames are issued
    from a host thread a device, so several cards work at once."""

    def run(d):
        ctx = torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()
        with ctx:
            scene, plan = replicas[d], plans[d]
            if as_graph:
                return render_frame_graph(scene, plan, camera)
            par = build_gen_par(scene, camera.origin, camera.lower_left_corner,
                                camera.right, camera.up)
            slot_perm = (device_slot_map(scene, plan.width, plan.height, plan.tiles_x)
                         if plan.encode else None)
            return _render_frame_waves(scene, plan, par, slot_perm, ext=plan.ext)

    out = {}
    if as_graph:
        for d in plans:
            if frame_graph(replicas[d], plans[d]).replay is None:
                out[d] = run(d)
    rest = [d for d in plans if d not in out]
    if len(rest) > 1:
        with ThreadPoolExecutor(len(rest)) as pool:
            out.update(zip(rest, pool.map(run, rest)))
    else:
        out.update((d, run(d)) for d in rest)
    return out


def finish_frame(outs: dict, mesh: Mesh, plan: FramePlan,
                 slot_perm: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(img (num_pixels·3,) u8, segments 0-d int64) on ``mesh[0]`` from
    the devices' framebuffers and segments (``outs``: {device: (fb, _,
    segments)}, each fb its tiles' ``plan.tile_cols`` columns in turn):
    each tile's slots copied to the first device without blocking the
    host, in tile order, then mapped back to raster pixels and encoded
    there as ``render_scene`` does."""
    first = mesh[0]
    seen = dict.fromkeys(outs, 0)
    cols = []
    for d in mesh:
        c0 = seen[d] * plan.tile_cols
        seen[d] += 1
        cols.append(outs[d][0][:, c0 : c0 + plan.tile_slots].to(first, non_blocking=True))
    segments = torch.stack([o[2].to(first, non_blocking=True) for o in outs.values()]).sum()
    return finalize_image_rows(torch.cat(cols, dim=1), plan.num_pixels, plan.spp,
                               slot_perm), segments


def render_scene_sharded(
    scene: TorchScene,
    camera: Camera,
    config: Config,
    mesh: Mesh | None = None,
    timers: PhaseTimers | None = None,
    graph: bool = True,
) -> tuple[np.ndarray, RenderStats]:
    """Render over the tiles of ``mesh`` (default ``make_mesh()``: every
    visible card) to an (h, w, 3) uint8 array; bit-identical to
    ``render_scene`` with equal segments.

    Each distinct device renders its tiles as one device program
    (``device_plans``), on its replica of the scene (``replica``): on a
    card, one CUDA graph replay of every wave of its tiles from the third
    frame of a frame key on (the first runs eagerly, the second captures),
    as ``render_scene``'s frames do; ``graph=False`` and CPU meshes run
    the same waves eagerly.  With one distinct device the program ends
    with the encode, so the frame is one replay and one synchronisation;
    with several, ``finish_frame`` ends it on the first device."""
    timers = timers or PhaseTimers()
    mesh = tuple(torch.device(d) for d in (make_mesh() if mesh is None else mesh))
    if not mesh:
        raise ValueError("the mesh has no device")
    plans = device_plans(scene, camera, config, mesh)
    plan = plans[mesh[0]]
    replicas = {d: replica(scene, d) for d in plans}
    as_graph = graph and all(pipeline.graph_route(replicas[d], plan.ext) for d in plans)
    log.info("Num samples: %d, max bounce %d", config.num_samples, config.max_bounce)
    log.info("Mesh: %d tile(s) on %s, %d slots/tile, %d wave(s) of %d rays, %s", len(mesh),
             ", ".join(str(d) for d in plans), plan.tile_slots, plan.num_waves,
             plan.wave_size, "one CUDA graph a device" if as_graph else "wave by wave")

    with timers.phase("render", "Rendered"):
        outs = _device_frames(replicas, plans, camera, as_graph)
        if plan.encode:
            _, img, segments = outs[mesh[0]]
        else:
            first = replicas[mesh[0]]
            img, segments = finish_frame(
                outs, mesh, plan, device_slot_map(first, plan.width, plan.height,
                                                  plan.tiles_x))
        img, segments = image_to_host(img, segments, plan)

    stats = RenderStats(
        width=plan.width, height=plan.height, spp=plan.spp, max_bounce=config.max_bounce,
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
