"""Where a frame's host time goes: the eager wave loop, part by part.

Renders a bench row's frame (``bench.ROW``: ``official``, ``duck``, ...)
on the card through ``render.pipeline.render_scene`` with the wave loop run
eagerly, and splits each frame's wall time by host clock
(``time.perf_counter``) around the parts the pipeline calls:

* ``slot_map``: ``pipeline.slot_of_pixel``, the raster-to-tiled slot map
  (its upload to the card is in ``other``);
* ``waves``: every ``render_wave_rows`` call (one wave's Python dispatch:
  its kernels, sorts and gathers, enqueued, not waited for);
* ``ray_sort_key``: ``wavefront.ray_sort_key`` calls (inside ``waves``);
* ``finalize``: ``pipeline.finalize_image_rows`` (enqueued);
* ``tail``: from the last finalize to the end of the frame: the wait for the
  card and the copy of the image to the host;
* ``other``: the rest (the framebuffer's accumulation, set-up).

Then one more frame under ``torch.profiler``: the host operators with the
most self CPU time, the CUDA launches the host made, and the device's busy
time and idle share.  Run on the card:

    python -m zig_raytracing_contest_tpu_torch.probes.frame_host [--row official]...

A checkout whose ``render_scene`` replays CUDA graphs is measured with
``graph=False`` (the eager loop); ``--graph`` measures its default instead
(one replay a frame: the parts above run only at capture).
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import bench
from ..render import pipeline, wavefront

PARTS = ("slot_map", "waves", "ray_sort_key", "finalize")
# module, attribute and part of each timed call
HOOKS = ((pipeline, "slot_of_pixel", "slot_map"),
         (pipeline, "render_wave_rows", "waves"),
         (wavefront, "ray_sort_key", "ray_sort_key"),
         (pipeline, "finalize_image_rows", "finalize"))
TOP = 12  # host operators listed by self CPU time


class Hooks:
    """Wraps the HOOKS in host timers for the ``with`` block: ``ms`` sums
    each part's milliseconds, ``calls`` counts them, ``last_finalize`` is
    the host clock when the last finalize returned."""

    def __init__(self):
        self.ms = dict.fromkeys(PARTS, 0.0)
        self.calls = dict.fromkeys(PARTS, 0)
        self.last_finalize = None
        self._saved = []

    def _wrap(self, fn, part):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            t1 = time.perf_counter()
            self.ms[part] += (t1 - t0) * 1e3
            self.calls[part] += 1
            if part == "finalize":
                self.last_finalize = t1
            return out
        return timed

    def __enter__(self):
        for mod, name, part in HOOKS:
            if hasattr(mod, name):
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(fn, part))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def render_kw(graph: bool) -> dict:
    """``render_scene``'s keywords: the eager loop unless ``graph`` (a
    checkout without CUDA graphs takes no keyword)."""
    takes = "graph" in inspect.signature(pipeline.render_scene).parameters
    return {"graph": graph} if takes else {}


def breakdown(p: bench.Prepared, frames: int, kw: dict) -> dict:
    """Median milliseconds of each part over ``frames`` frames after two
    warmups, with the frame's wall and the calls a frame makes."""
    for _ in range(2):
        pipeline.render_scene(p.scene, p.camera, p.config, **kw)
    torch.cuda.synchronize()
    rows = []
    for _ in range(frames):
        with Hooks() as h:
            t0 = time.perf_counter()
            _, st = pipeline.render_scene(p.scene, p.camera, p.config, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        wall = (t1 - t0) * 1e3
        tail = (t1 - h.last_finalize) * 1e3 if h.last_finalize else 0.0
        row = dict(h.ms, wall=wall, tail=tail)
        row["other"] = wall - tail - sum(h.ms[k] for k in PARTS if k != "ray_sort_key")
        rows.append(row)
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    return {"ms": med, "calls": h.calls, "segments": st.segments}


def profiled(p: bench.Prepared, kw: dict) -> dict:
    """One frame under torch.profiler: the host operators with the most
    self CPU time, the CUDA launch calls and the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.render_scene(p.scene, p.camera, p.config, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    device = [e for e in avg if str(e.device_type).endswith("CUDA")
              and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in device) / 1e3
    host = sorted((e for e in avg if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                "cudaGraphLaunch"))
    return {
        "profiled_wall_ms": wall,
        "device_busy_ms": busy if device else None,
        "idle_share": 1.0 - busy / wall if device else None,
        "device_ops": sum(e.count for e in device),
        "host_launch_calls": launches,
        "top_self_cpu": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3,
                          "count": e.count} for e in host[:TOP]],
    }


def measure(name: str, frames: int, graph: bool, card: str) -> dict:
    row = bench.ROW[name]
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as d:
        path, _ = bench.write_scene(row, Path(d))
        p = bench.prepare(row, dev, path)
    kw = render_kw(graph)
    out = {"row": name, "width": p.camera.width, "height": p.camera.height,
           "graph": kw.get("graph", False), "frames": frames, "card": card,
           **breakdown(p, frames, kw), **profiled(p, kw)}
    del p
    torch.cuda.empty_cache()
    return out


def print_table(r: dict) -> None:
    ms = r["ms"]
    print(f"{r['row']} {r['width']}x{r['height']} (graph {r['graph']}, median of "
          f"{r['frames']} frames, {r['card']}): wall {ms['wall']:.2f} ms")
    for part in ("slot_map", "waves", "ray_sort_key", "finalize", "tail", "other"):
        n = r["calls"].get(part, "")
        print(f"  {part:13s} {ms[part]:9.3f} ms  {'x' + str(n) if n != '' else ''}")
    print(f"  profiled frame: wall {r['profiled_wall_ms']:.2f} ms, device busy "
          f"{r['device_busy_ms']} ms, idle share {r['idle_share']}, device ops "
          f"{r['device_ops']}, host launch calls {r['host_launch_calls']}")
    for op in r["top_self_cpu"]:
        print(f"    {op['ms']:9.3f} ms self CPU  x{op['count']:<6d} {op['name']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", action="append", choices=[r.name for r in bench.ROWS
                                                       if not r.host])
    ap.add_argument("--frames", type=int, default=5, help="measured frames per row")
    ap.add_argument("--graph", action="store_true",
                    help="render_scene's default (CUDA graphs) instead of the eager loop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("this probe measures the card: PyTorch sees no CUDA card")
    card = bench.card_line()
    print(card)
    for name in args.row or ["official", "duck"]:
        r = measure(name, args.frames, args.graph, card)
        print_table(r)
        print("frame_host: " + json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
