"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Set-up, in order: the configuration's scene file (written once into the
checkout's cache), ``prepare_scene`` (load, bake and, on the grid
backend, the grid), one warm-up frame (the nvcc build of the kernels into
the checkout, lazy loads) and one frame that captures the frame's CUDA
graph.  ``setup_s`` runs from the process's start to the end of that
frame; its parts go to the standard error.

The window is a closed loop of one client, the user waiting for each
image: frames ``render_scene(scene, camera, config)``, each returning the
image on the host, start until ``seconds`` have passed.  Nothing builds
or captures in it.  ``mrays_s`` is the traced segments of every frame of
the window over its wall seconds; ``frame_ms_p95`` the 95th percentile
of every frame's wall ms, from the call to the image on the host.  With
``trace`` the window runs under ``torch.profiler`` and the per-layer
metrics are read instead.

Once the window has closed, the memory peak is read, the program's state
is freed, and the cell's reference (``spec.load_reference``) renders the
frame of the same scene file, camera and seed: every checked frame
(CHECKED drawn from the seed, and the last) is compared with it
(``compare.judge``).  A cell whose reference cannot compute its traffic's
extensions is refused when it is loaded, before set-up.
"""

from __future__ import annotations

import gc
import json
import os
import random
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass

from . import compare, devtrace, spec
from .reading import Reading
from .scenes import scene_file

FORBIDDEN = ("jax", "jaxlib", "flax", "zig_raytracing_contest_tpu")
CHECKED = 3  # frames of the window drawn from the seed for the check, beside the last
END_TO_END = {"mrays_s": "Mrays/s", "frame_ms_p95": "ms", "setup_s": "s"}


def cache_root():
    return spec.ROOT / "_cache"


def set_build_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    cache = cache_root()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package that this process holds,
    compared by their whole top-level name."""
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def program_config(traffic: spec.Traffic, seed: int):
    from zig_raytracing_contest_tpu_torch.config import Config

    return Config(grid_resolution=tuple(traffic.grid_resolution), num_samples=traffic.spp,
                  max_bounce=traffic.bounces, wave_size=traffic.wave, seed=seed,
                  backend=traffic.backend, **{name: True for name in traffic.extensions})


@dataclass
class Window:
    seconds: float  # wall of the window, first frame's start to last frame's end
    frame_s: list  # each frame's wall
    segments: list  # each frame's traced segments
    checked: list  # (index, image, segments) of the frames kept for the check
    trace: devtrace.DeviceTrace | None

    @property
    def frames(self) -> int:
        return len(self.frame_s)

    def p95_ms(self) -> float:
        """The 95th percentile of every frame's wall ms."""
        ms = [s * 1e3 for s in self.frame_s]
        return statistics.quantiles(ms, n=100)[94] if len(ms) > 1 else ms[0]


def run_window(render, seconds: float, seed: int, trace: bool, device) -> Window:
    """Frames ``render()`` → (image, segments) back to back until ``seconds``
    have passed.  Keeps CHECKED frames drawn from ``seed`` (a reservoir
    sample) and the last one."""
    import torch

    pick = random.Random(seed)
    kept: list = []
    frame_s, segments = [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    start = time.perf_counter()
    end = start
    last = None
    while end - start < seconds:
        t0 = time.perf_counter()
        if prof is not None:
            with record_function(devtrace.FRAME_LABEL):
                image, segs = render()
        else:
            image, segs = render()
        end = time.perf_counter()
        i = len(frame_s)
        frame_s.append(end - t0)
        segments.append(segs)
        if len(kept) < CHECKED:
            kept.append((i, image, segs))
        else:
            j = pick.randrange(i + 1)
            if j < CHECKED:
                kept[j] = (i, image, segs)
        last = (i, image, segs)
    checked = sorted({k[0]: k for k in [*kept, last]}.values(), key=lambda k: k[0])
    read = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="pathbench_trace_", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            read = devtrace.read_trace(path)
        finally:
            os.unlink(path)
    return Window(end - start, frame_s, segments, checked, read)


def run(workload_name: str, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", root=spec.ROOT, checkout=spec.CHECKOUT, cache=None, log=print):
    """One run: the result line's object and the checks' lines for the
    standard error.  ``t0``: the process's start on ``time.perf_counter``;
    ``root``, ``checkout``, ``cache``: where the benchmark's files,
    BENCHMARK.json and the scene cache are."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene

    workload = spec.load_workload(workload_name, root)
    bench = spec.benchmark(checkout)
    tr = workload.traffic
    dev = torch.device(device)
    parts = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    path = scene_file(workload.config, cache or cache_root(), root)
    parts["scene file"] = time.perf_counter() - t
    cfg = program_config(tr, seed)
    t = time.perf_counter()
    scene, camera, timers = prepare_scene(str(path), cfg, workload.config["camera"],
                                          tr.width, tr.height, device=device)
    parts["prepare_scene"] = time.perf_counter() - t
    phases = dict(timers.phases)

    def frame():
        image, stats = render_scene(scene, camera, cfg)
        return image, stats.segments

    built = set(kernels.BUILD_INFO)
    for what in ("warm-up frame", "capture frame"):
        t = time.perf_counter()
        frame()
        parts[what] = time.perf_counter() - t
    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    nvcc = {k: round(v["seconds"], 2) for k, v in kernels.BUILD_INFO.items() if k not in built}
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; nvcc builds: {nvcc or 'none'}; scene phases: {phases}", file=sys.stderr)

    win = run_window(frame, seconds, seed, trace, dev)
    launched = {k for k, v in kernels.LAUNCHES.items() if v} if dev.type == "cuda" else None
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    log(f"window: {win.frames} frames in {win.seconds:.3f} s; launched {sorted(launched or ())}",
        file=sys.stderr)
    del scene, camera, frame
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = spec.load_reference(workload.reference, root).prepare(workload, path, dev)
    ref_image, ref_segments = ref.render(seed)
    cells, refs = ref.grid_size()
    triangles = ref.triangles
    del ref
    log(f"reference frame: {time.perf_counter() - t:.3f} s, {ref_segments} segments",
        file=sys.stderr)
    correct, failed, checks = compare.judge(win.checked, ref_image, ref_segments, launched,
                                            workload)
    rays = ref_image.shape[0] * ref_image.shape[1] * tr.spp
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.frames, "failed": failed}
    if trace:
        reading = Reading(workload, win.frames, phases, win.trace, rays, ref_segments,
                          triangles, cells, refs)
        metrics = {}
        for entry in spec.per_layer_metrics(workload_name, bench):
            module = spec.load_metric(entry["name"], root)
            value = module.read(reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        if win.trace is not None:
            device_info["busy_s"] = devtrace.busy_s(win.trace)
            device_info["window_s"] = win.trace.window_s
        result["metrics"] = metrics
        result["device"] = device_info
        if win.trace is not None:
            result["breakdown"] = devtrace.breakdown(win.trace)
    else:
        total = sum(win.segments)
        result["metrics"] = {
            "mrays_s": {"value": total / win.seconds / 1e6, "unit": END_TO_END["mrays_s"]},
            "frame_ms_p95": {"value": win.p95_ms(), "unit": END_TO_END["frame_ms_p95"]},
            "setup_s": {"value": setup_s, "unit": END_TO_END["setup_s"]},
        }
        result["device"] = device_info
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines


def emit(result: dict, lines: list) -> None:
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
