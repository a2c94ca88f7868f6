"""The grid walk's kernel held against its twin, and the work a wave needs.

``grid_walk_kernel`` (kernels/path_trace.cu, through
``render.wavefront.trace_wave``) must equal ``wavefront.trace_wave_ref``
bit for bit: t, u and v as f32 bits, the winning reference and the loop's
iteration count.  ``edge_rays`` builds the rays where that is hardest:
axis-parallel directions (±inf slab and crossing times), origins on cell
faces and corners (NaN slabs where a zero component meets a face),
origins inside the grid, zero directions and inactive lanes.
``walk_differs`` compares the two on one wave; ``walk_bound`` turns the
twin's work counters (``WalkWork``) into the least time the card could
take for the walk (chip_smoke.py phase k).

Run on the card, the probe times builds of the kernel against each other
in one call: the ``--large`` frame's bounce-0, 1 and 2 waves on its 128³
grid (1,843,200 rays each, walked as ``render_wave_xla`` walks them), this
checkout's build held to ``trace_wave_ref`` bit for bit, every other build
to this one (t, u, v bits, the reference and the iteration count), each
build timed queued behind a spin (``utils.timing.queued_ms``), its median
over ``--rounds`` readings taken in turns:

    python -m zig_raytracing_contest_tpu_torch.probes.grid_walk \
        --against parent.cu

``--against OTHER.cu`` (repeatable) names a source whose ``zrc_grid_walk``
takes the same arguments (an earlier commit's path_trace.cu, from ``git
show COMMIT:zig_raytracing_contest_tpu_torch/kernels/path_trace.cu``); by
default the probe times ``grid_walk_one_thread.cu`` beside this file, the
walk of one thread a ray to its end.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .. import kernels
from ..render import wavefront

# f32 operations, counted from grid_walk_kernel: one Möller–Trumbore test
# (two cross products 9 each, three dot products 5 each, 1 / det, tvec 3,
# three scalings by 1 / det, u + v: 46 arithmetic; det, u, v, u + v, t > 0
# and t < best: 7 comparisons), one DDA step (3 comparisons for the axis,
# the exit test, t += delta, best <= t_cross) and one ray's set-up (slab
# test 6 subtractions, 6 divisions, 8 comparisons and min/max; DDA set-up
# 3 divisions and abs for t_delta, 9 for hit_local, 3 divisions for the
# cell, 3 products, 3 subtractions, 3 divisions and 3 additions for
# t_next)
OPS_MT, OPS_STEP, OPS_SETUP = 53, 6, 50
# bytes: a reference's triangle (v0, e1, e2: 9 f32), its unique id under
# exclusion (int32), a cell's range (two int32); per ray in origin,
# direction (6 f32), active (1 B) and the excluded id (int64), out t, u, v
# (3 f32) and the reference (int64)
TRI_BYTES, DUP_BYTES, CELL_BYTES = 36, 4, 8
RAY_IN_BYTES, EXCLUDE_BYTES, RAY_OUT_BYTES = 25, 8, 20


def edge_rays(params, n: int, seed: int = 0):
    """``n`` rays (orig, direction (n, 3) f32, active (n,) bool; CPU
    tensors) around a grid's box (``GridParams``): random origins within
    one box size of it and random unit directions, of which some have a
    zero component (axis-parallel rays), some origins lie on cell faces or
    corners, some inside the box, a few directions are zero, and 1 in 20
    lanes is inactive."""
    rng = np.random.default_rng(seed)
    lo, hi, cs = (p.cpu().numpy().astype(np.float32)
                  for p in (params.bbox_min, params.bbox_max, params.cell_size))
    res = params.resolution.cpu().numpy()
    span = hi - lo
    o = rng.uniform(lo - span, hi + span, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = n // 16
    d[0:2 * m, 0] = 0.0  # axis-parallel in x, then in x and y
    d[m:3 * m, 1] = 0.0
    d[4 * m:5 * m, 2] = 0.0
    face = (lo + rng.integers(0, res + 1, (n, 3)) * cs).astype(np.float32)
    o[m // 2:3 * m // 2] = face[m // 2:3 * m // 2]  # on cell corners, axis-parallel
    o[5 * m:7 * m, 0] = face[5 * m:7 * m, 0]  # on x faces
    o[6 * m:8 * m, 1] = face[6 * m:8 * m, 1]  # on y faces
    o[8 * m:11 * m] = rng.uniform(lo, hi, (3 * m, 3))  # inside the grid
    d[11 * m:11 * m + 4] = 0.0  # no direction at all
    active = rng.uniform(size=n) >= 0.05
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active)


def walk_differs(scene, orig, direction, active, exclude=None, it_sums=None):
    """grid_walk_kernel (``trace_wave`` on the card) against
    ``trace_wave_ref`` on the same rays → (lanes where t, u or v bits or
    the reference differ, the kernel's iteration count, the twin's, the
    twin's TraceResult with its work counters).  ``it_sums``: a list that
    gets (the kernel's iterations summed over the rays, the twin's)
    appended."""
    sums = [torch.zeros(1, dtype=torch.int64, device=orig.device) for _ in range(2)]
    k = wavefront.trace_wave(scene, orig, direction, active, exclude, it_sum=sums[0])
    r = wavefront.trace_wave_ref(scene, orig, direction, active, exclude, work=True,
                                 it_sum=sums[1])
    if it_sums is not None:
        it_sums.append((int(sums[0]), int(sums[1])))
    off = k.dup_idx != r.dup_idx
    for a, b in ((k.t, r.t), (k.u, r.u), (k.v, r.v)):
        off |= a.view(torch.int32) != b.view(torch.int32)
    return int(off.sum()), int(k.iterations), int(r.iterations), r


def walk_bound(scene, work, rays: int, exclude: bool, peak_flops: float,
               peak_bytes: float) -> dict:
    """The least time the card could take for a wave's walk from the twin's
    counters ``work`` (``WalkWork``) over ``rays`` rays: operations
    (tests · OPS_MT + steps · OPS_STEP + walking rays · OPS_SETUP) over
    ``peak_flops``; bytes over ``peak_bytes`` twice, as gathered (every
    test's triangle and id, every entered cell's range, read again by each
    ray) and as unique (each reference of a cell any ray entered, and each
    such cell's range, once), the rays' own bytes in both.  The bound
    takes the unique bytes (each input read once)."""
    g = scene.grid
    tests = float(work.tests.sum())
    cells = float(work.cells.sum())
    walking = float((work.cells > 0).sum())
    per_test = TRI_BYTES + (DUP_BYTES if exclude else 0)
    ray_bytes = rays * (RAY_IN_BYTES + RAY_OUT_BYTES + (EXCLUDE_BYTES if exclude else 0))
    refs = float((g.cell_end - g.cell_begin)[work.visited].sum())
    visited = float(work.visited.sum())
    ops = tests * OPS_MT + cells * OPS_STEP + walking * OPS_SETUP
    gathered = tests * per_test + cells * CELL_BYTES + ray_bytes
    unique = refs * per_test + visited * CELL_BYTES + ray_bytes
    op_ms, byte_ms = ops / peak_flops * 1e3, unique / peak_bytes * 1e3
    return {"tests": tests, "cells": cells, "walking": walking, "ops": ops,
            "bytes_gathered": gathered, "bytes_unique": unique,
            "gathered_ms": gathered / peak_bytes * 1e3, "ops_ms": op_ms,
            "unique_ms": byte_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"}


# The --large frame as chip_smoke.py phase k renders it through the grid
WIDTH, HEIGHT, SPP, BOUNCES, SEED = 1280, 720, 2, 3, 0
RESOLUTION = (128, 128, 128)
# The walk of one thread a ray to its end, timed against by default
ONE_THREAD = Path(__file__).resolve().parent / "grid_walk_one_thread.cu"
# Queued walks a reading, readings a build
REPS, ROUNDS = 10, 8


class Walk:
    """One build's walk of a wave into outputs of its own: ``run()``
    launches it (zeroing its scratch first); this build's (``lib`` None)
    with the iteration sum the main path passes."""

    def __init__(self, lib, grid, o, d, live, prev):
        R, dev = o.shape[0], o.device
        self.t = torch.empty(R, dtype=torch.float32, device=dev)
        self.u, self.v = torch.empty_like(self.t), torch.empty_like(self.t)
        self.idx = torch.empty(R, dtype=torch.int64, device=dev)
        self.scratch = torch.zeros(2, dtype=torch.int32, device=dev)
        self.it_sum = None if lib is not None else torch.zeros(1, dtype=torch.int64,
                                                               device=dev)
        self.args = (grid, o, d, live, prev)
        self.lib = lib

    def run(self):
        self.scratch.zero_()
        kernels.launch_grid_walk(*self.args, self.t, self.u, self.v, self.idx, self.scratch,
                                 lib=self.lib, it_sum=self.it_sum)

    def differs(self, other: "Walk") -> int:
        off = self.idx != other.idx
        for a, b in ((self.t, other.t), (self.u, other.u), (self.v, other.v)):
            off |= a.view(torch.int32) != b.view(torch.int32)
        return int(off.sum()) + int(self.scratch[0] != other.scratch[0])


def walk_ptxas(log: str) -> str:
    """What ptxas reported for grid_walk_kernel in an nvcc log (``-Xptxas=-v``):
    its stack, spills and registers, on one line."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "grid_walk_kernel" in line
        elif on and ("spill" in line or "registers" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out) or "no report"


def large_grid_scene(where: Path, device):
    """The ``--large`` terrain on its 128³ grid, prepared as chip_smoke.py
    phase k prepares it → (scene, camera)."""
    from ..config import Config
    from ..render.pipeline import prepare_scene
    from ..scene.procedural import large_scene

    cfg = Config(backend="grid", grid_resolution=RESOLUTION, num_samples=SPP,
                 max_bounce=BOUNCES, wave_size=1 << 21, seed=SEED)
    scene, cam, _ = prepare_scene(str(large_scene(where / "large.gltf")), cfg,
                                  camera_name="Camera 1", width=WIDTH, height=HEIGHT,
                                  device=device)
    return scene, cam


def frame_waves(scene, cam, bounces: int = BOUNCES):
    """Yield (bounce, orig, direction, active, prev) of the frame's one
    wave for each bounce, as ``render_wave_xla`` walks and shades them
    (the walk: ``trace_wave``)."""
    R = WIDTH * HEIGHT * SPP
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    o, d, streams = wavefront.xla_primary_rays(par, WIDTH, SPP, 0, R, SEED)
    o = o.contiguous()
    live = torch.ones(R, dtype=torch.bool, device=o.device)
    prev = None
    for bounce in range(bounces):
        yield bounce, o, d, live, prev
        hit = wavefront.trace_wave(scene, o, d, live, prev)
        tri = scene.grid.dup_to_tri[hit.dup_idx]
        new_o, new_d, *_, missed, _ = wavefront.shade_and_scatter(
            scene, o, d, hit.t, hit.u, hit.v, tri, streams, bounce)
        stepped = live & ~missed
        o = torch.where(stepped[:, None], new_o, o).contiguous()
        d = torch.where(stepped[:, None], new_d, d).contiguous()
        live, prev = stepped, tri


def time_builds(fns: dict, rounds: int = ROUNDS, reps: int = REPS) -> dict:
    """Each of ``fns`` (label -> callable) timed with ``queued_ms`` over
    ``reps`` calls, ``rounds`` readings each, in turns (forward, then
    backward) → label -> the list of readings."""
    from ..utils.timing import queued_ms

    ms = {k: [] for k in fns}
    labels = list(fns)
    for r in range(rounds):
        for k in labels if r % 2 == 0 else labels[::-1]:
            ms[k].append(queued_ms(fns[k], reps))
    return ms


def walk_ab(scene, cam, builds: dict, card: str, rounds: int = ROUNDS) -> int:
    """The A/B on the card: per bounce, this build against the twin, every
    build of ``builds`` (label -> library) against this one, and the
    medians of their queued times.  Prints a line per build and bounce;
    returns the lanes (and iteration counts) that differ."""
    faults = 0
    ops = scene.grid.kernel_operands()
    for bounce, o, d, live, prev in frame_waves(scene, cam):
        R = o.shape[0]
        this = Walk(None, ops, o, d, live, prev)
        this.run()
        ref = wavefront.trace_wave_ref(scene, o, d, live, prev, work=True)
        off = this.differs(SimpleNamespace(t=ref.t, u=ref.u, v=ref.v, idx=ref.dup_idx,
                                           scratch=ref.iterations.view(1)))
        faults += off
        w = ref.work
        cells = float(w.cells.sum())
        print(f"grid_walk bounce {bounce}: this build vs trace_wave_ref {off} of {R} lanes "
              f"differ, iterations {int(this.scratch[0])} vs {int(ref.iterations)}; "
              f"{int((w.cells > 0).sum())} walking rays, {cells:.0f} cells entered, "
              f"{float(w.occupied.sum()) / max(cells, 1.0):.4f} of them occupied, "
              f"{float(w.tests.sum()):.0f} tests", flush=True)
        walks = {"this": this}
        walks.update({label: Walk(lib, ops, o, d, live, prev) for label, lib in builds.items()})
        ms = time_builds({k: wk.run for k, wk in walks.items()}, rounds)
        for label, wk in walks.items():
            off = wk.differs(this) if wk is not this else 0
            faults += off
            med = statistics.median(ms[label])
            print(f"  {label}: {off} lanes differ from this build, iterations "
                  f"{int(wk.scratch[0])}; median {med:.4f} ms queued "
                  f"{[round(x, 4) for x in ms[label]]} ({card})", flush=True)
    return faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="grid_walk_kernel's builds timed against each "
                                            "other on the --large frame's waves (the card)")
    p.add_argument("--against", type=Path, action="append", default=[],
                   help="another source with the same zrc_grid_walk (repeatable; default "
                        "grid_walk_one_thread.cu)")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("the probe times builds on the card: PyTorch sees no CUDA card")
    from concurrent.futures import ThreadPoolExecutor

    from ..bench import card_line

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    sources = {src.name: src for src in args.against or [ONE_THREAD]}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dirs = {k: tmp / str(n) for n, k in enumerate(sources)}
        with ThreadPoolExecutor(len(sources) + 1) as pool:
            jobs = {k: pool.submit(kernels.load_grid_walk_library, src, dirs[k])
                    for k, src in sources.items()}
            kernels.load()
            builds = {k: j.result() for k, j in jobs.items()}
        print(f"ptxas, this build: {walk_ptxas(kernels.build_log('path_trace'))}")
        for k, src in sources.items():
            print(f"ptxas, {k}: {walk_ptxas(kernels.build_log('grid_walk_other', src, dirs[k]))}")
        scene, cam = large_grid_scene(tmp, dev)
        faults = walk_ab(scene, cam, builds, card, args.rounds)
    print(f"grid_walk A/B: {faults} lanes differ in all")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
