"""The port's benchmark harness: one JSON line per frame.

The counterpart of the repository's ``bench.py`` (the JAX package's
harness) and of ``scripts/large_sweep.py``'s rows.  Each row of ``ROWS`` is
one frame: a scene from the port's own writers, the frame's size, samples
per pixel, bounces and wave, the backend and the extensions.  ``measure``
writes and loads the scene, renders one warmup frame (which also takes the
nvcc build out of the timing) and, where the frame replays a CUDA graph
(``render.pipeline.graph_route``), a second one that captures it, then
``reps`` timed frames, each ended by ``torch.cuda.synchronize()``, and one
more under ``torch.profiler``.  Its
JSON object holds the median Mrays/s (traced segments / wall) with the
best, the spread and every rep; the kernels' launches over the warmup and
the timed frames; the device's busy time in the profiled frame (CUDA
kernels and copies) and its idle share against the median unprofiled wall,
and ``graph``: whether the timed frames replayed a CUDA graph.
The ``cpu`` row is ``bench.py --cpu``: the host C++ tracer
(render/native_cpu.py) on all host cores, over the bench scene's grid.

Run: ``python -m zig_raytracing_contest_tpu_torch.bench [--row NAME]...``
(default ``official``; ``--row all`` runs every row in the order of
``ROWS``).  Frames render on the CUDA card and the bench exits non-zero
without one; ``--device cpu`` renders with the kernels' plain twins on the
CPU, for tests at a small ``--width`` / ``--height`` / ``--reps``, and its
lines say ``"device": "cpu"``.  A value overridden from the row's is listed
under ``overridden``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from . import kernels
from .config import Config
from .render.native_cpu import load_library, render_cpu
from .render.pipeline import (
    backend_line,
    frame_graph,
    frame_plan,
    graph_route,
    prepare_scene,
    render_scene,
)
from .scene.duck import write_duck_glb
from .scene.procedural import bench_scene, big_texture_scene, large_scene
from .scene.sponza import write_sponza_glb

REPS = 5  # timed frames of a row; the line's value is their median
GRID = (128, 128, 128)  # bench.py's grid resolution, every row's
TOP_OPS = 8  # device ops listed from the profiled frame


def texture_terrain(path, side: int = 224, seed: int = 0, tex_width: int = 2048,
                    tex_height: int = 1024) -> Path:
    """The ``--large`` terrain with its texture replaced by a
    ``tex_width`` x ``tex_height`` noise image (at 2048 x 1024 a bank with
    no resident form: the 3-stage shade)."""
    return big_texture_scene(large_scene(path, side=side), seed, tex_width, tex_height)


@dataclass(frozen=True)
class Row:
    """One frame of the bench.  ``writer(path, **dict(scene_kw))`` writes
    the scene, whose one camera renders the frame; ``width`` None takes the
    width from the camera's aspect ratio at ``height``.  ``kernels``: the CUDA kernels (keys of
    ``kernels.LAUNCHES``) the frame launches on the card, no more and no
    fewer.  ``host``: the frame is the host C++ tracer's (the cpu row)."""

    name: str
    metric: str
    writer: Callable
    file: str
    scene_kw: tuple = ()
    width: int | None = 1920
    height: int = 1080
    spp: int = 3
    bounces: int = 4
    wave: int | None = 1 << 19
    backend: str = "auto"
    extensions: tuple = ()
    kernels: tuple = ()
    host: bool = False


_WHOLE = ("path_trace_gen", "path_trace", "ray_sort_key")
_LARGE = dict(width=1280, height=720, spp=2, bounces=3, wave=1 << 21)
ROWS = (
    # bench.py main(): the official frame
    Row("official", "Mrays/s", bench_scene, "bench.gltf", kernels=_WHOLE),
    # bench.py run_large()
    Row("large", "large_Mrays/s", large_scene, "large.gltf", (("side", 224),), **_LARGE,
        kernels=("trace_emit", "shade", "ray_sort_key")),
    # bench.py --cpu: a warmup at 1 spp and 1 bounce, then the official frame
    Row("cpu", "cpu_Mrays/s", bench_scene, "bench.gltf", wave=None, backend="grid",
        host=True),
    # scripts/large_sweep.py --side=500 (the wave as --large's)
    Row("500k", "500k_Mrays/s", large_scene, "large500.gltf", (("side", 500),), **_LARGE,
        kernels=("trace_stream", "shade", "ray_sort_key")),
    # scripts/large_sweep.py --side=1000 (its "huge" branch)
    Row("2m", "2m_Mrays/s", large_scene, "large2m.gltf", (("side", 1000),), width=640,
        height=360, spp=1, bounces=2, wave=1 << 21,
        kernels=("trace_stream", "shade", "ray_sort_key")),
    # scripts/large_sweep.py --sponza
    Row("sponza", "sponza_Mrays/s", write_sponza_glb, "sponza.glb", (("detail", 1.25),),
        width=None, height=720, spp=2, bounces=3, wave=1 << 21,
        kernels=("trace_stream", "shade", "ray_sort_key")),
    # the Duck-class GLB at the official settings
    Row("duck", "duck_Mrays/s", write_duck_glb, "duck.glb", width=None, kernels=_WHOLE),
    # the --large terrain with a 2-Mtexel texture
    Row("2mtexel", "2mtexel_Mrays/s", texture_terrain, "bank.gltf", **_LARGE,
        kernels=("trace_emit", "shade", "ray_sort_key")),
    # the --large frame through the grid: the XLA shading path, the walk
    # grid_walk_kernel
    Row("grid_large", "grid_large_Mrays/s", large_scene, "large.gltf", (("side", 224),),
        **_LARGE, backend="grid", kernels=("grid_walk",)),
    # the --large frame with every extension: the XLA shading path over the
    # bake, trace_emit_kernel for nearest hits and shadow rays
    Row("large_ext", "large_ext_Mrays/s", large_scene, "large.gltf", (("side", 224),),
        **_LARGE, extensions=("nee", "russian_roulette", "pbr"), kernels=("trace_emit",)),
)
ROW = {row.name: row for row in ROWS}


class BenchError(RuntimeError):
    """A row's frame is not what the row says (image, segments, launches)."""


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def stats(rates) -> tuple:
    """(median, best, spread %) of a rate list, rounded as bench.py's
    ``_stats``."""
    s = sorted(rates)
    med = s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])
    best = s[-1]
    spread = 100.0 * (s[-1] - s[0]) / med if med else 0.0
    return round(med, 3), round(best, 3), round(spread, 1)


def config_of(row: Row) -> Config:
    """The row's render config (the Config default seed)."""
    cfg = Config(grid_resolution=GRID, num_samples=row.spp, max_bounce=row.bounces,
                 backend=row.backend, **{name: True for name in row.extensions})
    if row.wave is not None:
        cfg.wave_size = row.wave
    return cfg


def write_scene(row: Row, directory: Path) -> tuple[Path, float]:
    """Write the row's scene into ``directory``: (path, seconds)."""
    t0 = time.perf_counter()
    path = row.writer(Path(directory) / row.file, **dict(row.scene_kw))
    return Path(path), time.perf_counter() - t0


@dataclass
class Prepared:
    """A row's scene on its device, with its camera, config and the seconds
    of ``prepare_scene``'s phases."""

    scene: object
    camera: object
    config: Config
    phases: dict


def prepare(row: Row, device, path: Path, width=None, height=None) -> Prepared:
    """Load and bake the scene at ``path`` for ``row`` on ``device`` (the
    cpu row on the host CPU, whose tracer reads the grid there), at the
    row's frame or at ``width`` / ``height`` in its place."""
    cfg = config_of(row)
    w = None if row.width is None else (width or row.width)
    h = height or row.height
    scene, cam, timers = prepare_scene(str(path), cfg, width=w, height=h,
                                       device="cpu" if row.host else device)
    return Prepared(scene, cam, cfg, dict(timers.phases))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_render(p: Prepared) -> tuple[float, list]:
    """One frame under torch.profiler: (its wall ms, [(device ms, count,
    name)] of every CUDA kernel and copy, largest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(p.scene.device)
        t0 = time.perf_counter()
        render_scene(p.scene, p.camera, p.config)
        _sync(p.scene.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [(e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    return wall_ms, sorted(ops, reverse=True)


def _base_line(row: Row, p: Prepared, reps: int, device) -> dict:
    cam, cfg = p.camera, p.config
    overridden = [k for k, want in (("width", row.width), ("height", row.height))
                  if want is not None and getattr(cam, k) != want]
    if reps != REPS:
        overridden.append("reps")
    return {
        "row": row.name, "metric": row.metric, "unit": "Mrays/s",
        "triangles": int(p.scene.shade_table.shape[0]), "width": cam.width,
        "height": cam.height, "spp": cfg.num_samples, "bounces": cfg.max_bounce,
        "wave": row.wave, "load_s": p.phases["load"], "bake_s": p.phases["compile"],
        "device": str(p.scene.device),
        "card": card_line() if torch.device(device).type == "cuda" else None,
        "overridden": overridden,
    }


def _measure_host(row: Row, p: Prepared, reps: int, device) -> dict:
    """The cpu row: a warmup at 1 spp and 1 bounce (the library's build and
    the pages), then ``reps`` frames of the C++ tracer on all host cores."""
    nl = load_library()
    cam, cfg = p.camera, p.config
    render_cpu(p.scene, cam, spp=1, max_bounce=1, seed=cfg.seed, lib=nl.lib)
    rates, seconds, segments = [], [], set()
    for _ in range(reps):
        img, segs, s = render_cpu(p.scene, cam, spp=cfg.num_samples,
                                  max_bounce=cfg.max_bounce, seed=cfg.seed, lib=nl.lib)
        rates.append(segs / s / 1e6)
        seconds.append(s)
        segments.add(segs)
        print(f"{row.name} rep: {rates[-1]:.3f} Mrays/s", file=sys.stderr)
    _check_frame(row, img, segments, cam)
    med, best, spread = stats(rates)
    return {**_base_line(row, p, reps, device), "value": med, "best": best,
            "spread_pct": spread, "reps": rates, "segments": segments.pop(),
            "regime": f"host C++ tracer, grid {GRID}", "graph": False, "launches": {},
            "device_busy_ms": None, "idle_share": None, "profiled_wall_ms": None,
            "top_ops": None, "threads": os.cpu_count(), "openmp": nl.openmp,
            "seconds": statistics.median(seconds)}


def _check_frame(row: Row, img, segments: set, cam) -> None:
    if img.shape != (cam.height, cam.width, 3) or not 0 < float(img.mean()) < 255:
        raise BenchError(f"{row.name}: frame of shape {img.shape}, mean {float(img.mean())}")
    if len(segments) != 1 or not min(segments) > 0:
        raise BenchError(f"{row.name}: segments differ between reps: {sorted(segments)}")


def _measure_frame(row: Row, p: Prepared, reps: int, device) -> dict:
    scene, cam, cfg = p.scene, p.camera, p.config
    dev = scene.device
    built = set(kernels.BUILD_INFO)
    kernels.reset_launches()
    graph = graph_route(scene, cfg.ext_flags)
    t0 = time.perf_counter()
    render_scene(scene, cam, cfg)  # warmup: the nvcc build and the first launches
    _sync(dev)
    warm_s = time.perf_counter() - t0
    if graph:
        render_scene(scene, cam, cfg)  # the capture of the frame's CUDA graph
    nvcc = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in kernels.BUILD_INFO.items()
                     if k not in built)
    print(f"{row.name}: warmup {warm_s:.2f} s (nvcc: {nvcc or 'none'})", file=sys.stderr)
    walls, rates, segments = [], [], set()
    for _ in range(reps):
        t0 = time.perf_counter()
        img, st = render_scene(scene, cam, cfg)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        rates.append(st.segments / walls[-1] / 1e6)
        segments.add(st.segments)
        print(f"{row.name} rep: {rates[-1]:.3f} Mrays/s", file=sys.stderr)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    _check_frame(row, img, segments, cam)
    if graph and frame_graph(scene, frame_plan(scene, cam, cfg)).replay is None:
        raise BenchError(f"{row.name}: the frame's CUDA graph was not captured")
    if dev.type == "cuda" and set(launches) != set(row.kernels):
        raise BenchError(f"{row.name}: launched {launches}; the row's frame launches "
                         f"{list(row.kernels) or 'no kernel'}")
    wall_ms = statistics.median(walls) * 1e3
    busy = idle = pwall = top = None
    if dev.type == "cuda":
        pwall, ops = profile_render(p)
        if ops:
            busy = sum(op[0] for op in ops)
            idle = 1.0 - busy / wall_ms
            top = [{"name": name[:120], "ms": ms, "count": n} for ms, n, name in ops[:TOP_OPS]]
        else:
            print(f"{row.name}: the profiler saw no device time: busy not measured",
                  file=sys.stderr)
    med, best, spread = stats(rates)
    return {**_base_line(row, p, reps, device), "value": med, "best": best,
            "spread_pct": spread, "reps": rates, "segments": segments.pop(),
            "regime": backend_line(scene, cfg.ext_flags), "graph": graph,
            "launches": launches,
            "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "profiled_wall_ms": pwall, "top_ops": top}


def measure(row: Row, device="cuda", reps: int = REPS, width=None, height=None,
            prepared: Prepared | None = None) -> dict:
    """The row's JSON object (see the module docstring), measured on
    ``device``; the scene written into a temporary directory, loaded and
    freed again, unless ``prepared`` (``prepare``'s) is given."""
    if reps < 1:
        raise ValueError("reps must be at least 1")
    run = _measure_host if row.host else _measure_frame
    if prepared is not None:
        return run(row, prepared, reps, device)
    with tempfile.TemporaryDirectory() as d:
        path, write_s = write_scene(row, Path(d))
        print(f"{row.name}: scene written in {write_s:.2f} s", file=sys.stderr)
        p = prepare(row, device, path, width, height)
    try:
        return run(row, p, reps, device)
    finally:
        del p
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m zig_raytracing_contest_tpu_torch.bench",
        description="the port's bench: one JSON line per row",
    )
    p.add_argument("--row", action="append", choices=[*ROW, "all"],
                   help="a row to run (repeatable; default official; all: every row)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the CUDA card (default) or the CPU (plain twins, for tests)")
    p.add_argument("--reps", type=int, default=REPS, help="timed frames per row")
    p.add_argument("--width", type=int, default=None, help="a smaller frame (tests)")
    p.add_argument("--height", type=int, default=None, help="a smaller frame (tests)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: PyTorch sees no CUDA card (torch.cuda.is_available() "
                     "is False); pass --device cpu to run the plain twins on the CPU")
    names = args.row or ["official"]
    rows = ROWS if "all" in names else [ROW[name] for name in names]
    for row in rows:
        line = measure(row, args.device, args.reps, args.width, args.height)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
