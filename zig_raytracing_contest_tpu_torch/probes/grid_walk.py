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

``shaded_ab`` holds the shaded walk (``render_wave_grid``'s launches) to
``render_wave_xla`` bit for bit on the ``--large`` frame's wave and times
each launch.  Helpers of chip_smoke.py and the tests; no entry point of
its own.
"""

from __future__ import annotations

import statistics

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


# The --large frame as chip_smoke.py phase k renders it through the grid,
# and the timed rounds of its shaded wave
WIDTH, HEIGHT, SPP, BOUNCES, SEED = 1280, 720, 2, 3, 0
ROUNDS = 8


def walk_ptxas(log: str) -> str:
    """What ptxas reported for grid_walk_kernel in an nvcc log (``-Xptxas=-v``):
    the stack, spills and registers of each instantiation, the walk alone
    (``walk``: ``grid_walk_kernel<false>``) and the shaded walk
    (``shaded``: ``grid_walk_kernel<true>``), on one line."""
    out, on = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = None
            if "grid_walk_kernel" in line:
                on = "shaded" if "ILb1E" in line else "walk"
                out.append(f"{on}:")
        elif on and ("spill" in line or "registers" in line):
            out.append(line.split(":", 1)[-1].strip() + ";")
    return " ".join(out).rstrip(";") or "no report"


def shaded_wave(scene, cam, rounds: int = ROUNDS):
    """The frame's one wave through the shaded walk, as
    ``wavefront.render_wave_grid`` launches it, ``rounds`` times after a
    warmup, each launch timed by CUDA events → (rows4, the wave's work
    counters, each launch's median ms, the whole wave's median ms)."""
    R = WIDTH * HEIGHT * SPP
    dev = scene.device
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    ops = scene.grid.kernel_operands()
    f32 = dict(dtype=torch.float32, device=dev)
    orig, direction, thr = (torch.empty((R, 3), **f32) for _ in range(3))
    rows4 = torch.empty((4, R), **f32)
    t, u, v = (torch.empty(R, **f32) for _ in range(3))
    idx = torch.empty(R, dtype=torch.int64, device=dev)
    scratch = torch.zeros((BOUNCES + 1, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    ms = [[] for _ in range(BOUNCES + 2)]
    for r in range(rounds + 1):
        scratch.zero_()
        counts.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(BOUNCES + 2)]
        ev[0].record()
        for b in range(BOUNCES + 1):
            kernels.launch_grid_walk_shaded(ops, scene.shade_table, scene.color_data, par,
                                            WIDTH, SPP, 0, SEED, orig, direction, thr, rows4,
                                            t, u, v, idx, scratch[b], b, BOUNCES, counts)
            ev[b + 1].record()
        torch.cuda.synchronize()
        if r:  # the first round is the warmup
            for b in range(BOUNCES + 1):
                ms[b].append(ev[b].elapsed_time(ev[b + 1]))
            ms[-1].append(ev[0].elapsed_time(ev[-1]))
    med = [statistics.median(x) for x in ms]
    return rows4, counts, med[:-1], med[-1]


def shaded_ab(scene, cam, card: str, rounds: int = ROUNDS) -> int:
    """The shaded walk on the card: its wave against ``render_wave_xla``
    (the walk alone, then the PyTorch shade) bit for bit, the rays alive and
    the walk iterations it counts, and each launch's ms.  Prints two lines;
    returns the lanes (and counters) that differ."""
    R = WIDTH * HEIGHT * SPP
    rows4, counts, per, wave_ms = shaded_wave(scene, cam, rounds)
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    want_counts = torch.zeros(4, dtype=torch.int64, device=scene.device)
    want = wavefront.render_wave_xla(scene, par, WIDTH, SPP, BOUNCES, 0, R, SEED,
                                     counts=want_counts)
    off = int((rows4.view(torch.int32) != want.view(torch.int32)).any(dim=0).sum())
    off += int((counts != want_counts).sum())
    print(f"shaded walk vs render_wave_xla: {off} of {R} lanes differ (radiance and segment "
          f"bits), counters {counts.tolist()} vs {want_counts.tolist()}", flush=True)
    print(f"  shaded walk, launch ms (0: the primary rays made and walked, {BOUNCES}: shade only): "
          f"{[round(x, 4) for x in per]}, the wave {wave_ms:.4f} ms; medians of {rounds} "
          f"({card})", flush=True)
    return off
