#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's paths (zig_raytracing_contest_tpu_torch) the way a user
does: the official bench frame (the bench scene, 1920×1080, 3 spp, 4
bounces, waves of 2^19 rays) through the whole-path kernels, the
``--large`` frame of bench.py (a 100,362-triangle terrain, 1280×720, 2 spp,
3 bounces, one wave of 1,843,200 rays) through the per-bounce pipeline,
and the XLA shading path: the same terrain through the grid backend, and
the extensions (NEE, Russian roulette, PBR).
Phases, each of which exits non-zero when it fails:

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from kernels/path_trace.cu and kernels/probes.cu (one
   nvcc each, side by side) and print the build time and ptxas report;
3. build the bench scene with the port's own procedural module;
4. print the whole-path kernels' ptxas lines (a spill fails the run); hold
   each kernel against its plain PyTorch twin on the card, on the same
   inputs and in the main path's order (bounce 0, sort, bounce 1, resort,
   bounces 2-3): one wave of 2^16 rays, then one full wave of the main path
   (522240 rays), timing the three calls at the full wave beside their
   bounds; each call's work counters against the twin's (rays alive and
   boxes tested exactly, tiles swept exactly from the same input bits:
   bounce 1); the lane occupancy of the one-thread-per-ray flat loop on 64
   warps of each bounce's wave (walk_check.flat_occupancy);
5. render a 320×180, 3 spp, 4-bounce frame with the kernels and with the
   twins and hold them to the golden gates;
6. render the official frame: a warmup, then 5 timed renders; the kernel
   launch counts of these renders show the main path ran the kernels;
7. profile one more official frame: device time by kernel and the
   device's idle share;

then the ``--large`` frame:

a. the ptxas report of the per-bounce kernels (registers, stack frame,
   spills of both traces and the shade); build the scene with the port's
   procedural module and print its bake and regime;
b. hold trace_emit_aux and shade_fused against their twins on the card:
   one wave of 2^16 rays at bounce 0 in raster order, then a sort and
   bounce 1 with the previous hit; then the full wave of the frame
   (bounce 0 sorted, bounce 1 with the previous hit), the twins on the same
   inputs (bounce 0's trace on 2^16 lanes spread over the wave, the rest on
   every lane); trace_emit_kernel on 1024 lanes spread over the full
   bounce-1 wave against probes/walk_check.walk_heap_ref's replay of its
   walk, bit for bit in t, u, v, idx, tiles swept and boxes tested; the
   trace again with the main path's work counters, its aux bit for bit the
   uncounted launch's and its counters its aux rows 4-6 summed, exactly;
   time each kernel at the full wave (the trace with its counters) and
   each twin at 2^16 rays;
c. render the scene at 160×90 with the kernels and with the twins, sorted
   and unsorted, and hold them to the golden gates;
d. render the ``--large`` frame: a warmup, then 5 timed renders; the
   launch counts of these renders show the main path ran the kernels;
e. profile one more ``--large`` frame;

then the streaming regime and the 3-stage bank:

f. the 500k-triangle terrain (``large_scene(side=500)``, the 500k row of
   scripts/large_sweep.py, at the ``--large`` frame's settings): its bake,
   load and bake seconds and regime (streaming, sorted); trace_emit_aux
   (trace_stream_kernel) and shade_fused against their twins at 2^16 rays
   (bounce 0, then sorted bounce 1) and on the full wave (the trace on 2^16
   lanes spread over it); trace_stream_kernel against walk_heap_ref's
   replay of its group-heap walk on 1024 lanes of the bounce-1 wave, bit
   for bit, as in phase b, and its counters as there; the kernel timed
   (with its counters) at the full bounce-1 wave beside
   trace_emit_kernel on the same inputs (the two walks' A/B); the frame: a
   warmup and 5 timed renders, launch counts checked; one profile;
g. a 2-Mtexel bank: the ``--large`` geometry with its terrain texture
   replaced by a 2048x1024 noise image drawn from the seed, which has no
   resident form (3-stage bank): shade_fused against its twin on the full
   bounce-0 and bounce-1 waves, a 160x90 frame kernels vs twins under the
   golden gates, the full frame: a warmup and 5 timed renders; one profile.

Phase b also times trace_emit_kernel without a record (rec_out null) and
holds it against the twin.

Then a Duck-class textured GLB through the whole path, and the probes:

h. the port's Duck-class GLB (scene/duck.py, 9586 triangles in 75 tiles, a
   327,685-texel bank) at the official frame's settings: its bake line and
   walk (the flat tile loop); path_trace_gen and path_trace_fused against
   their twins at 2^16 rays and on a full wave (bounce 0, bounce 1 after
   the sort, bounces 2-3 after the resort), as in phase 4, and each call's
   flat-loop counters (lane_tiles, warp_sweeps) against the twin's; each kernel
   timed at the full wave beside its twin, its bound from the tiles swept
   and boxes tested per live ray (the bounces 2-3 call too); the lane
   occupancy as in phase 4; a 320×180 frame, kernels vs twins, under
   the golden gates; the frame: a warmup and 5 timed renders, launch
   counts checked; one profile;
i. the probe kernels: texel_fetch_kernel against its plain version on the
   paged-fetch check's three banks × three index patterns and a clamp
   texture, then on the Duck bank at the bounce-0 wave's body-texture
   hits; sort_key_kernel against sort_key_ref and the host key on 256
   lanes and on the Duck's bounce-0 wave; each timed at the Duck's shapes
   queued behind a spin (utils/timing.py queued_ms), beside the reading of
   the calls as the host issues them (cuda_ms) and the launch floor (an
   empty kernel through the same interface, queued the same way);

then the trace micro-benchmarks:

j. the ptxas lines of micro_trace_kernel, micro_bf16_kernel and the two
   probe_gather kernels (a spill fails the run); trace_emit_kernel's
   tile-heap walk against the flat loop lane by lane on the side-90
   terrain's bounce-0 wave (pixel tile 920, 522,240 rays): each differing
   lane's two winners recomputed alone,
   and a failure unless every one is a tie at equal t; then
   micro_trace_kernel (18 variants), micro_bf16_kernel (f32 and bf16 at
   16,384 and 65,536 iterations) and probe_gather_kernel (two forms at
   reps 1, 64, 512) against their plain versions, bit for bit, through the
   probes' own checks with the launch counts, then the first two on the
   staged test's boundary cases; every variant timed (the micro_trace ones
   beside trace_emit_aux on the same bank and rays; the bf16 sweep's slope
   per sweep and its error against f32; the gather's chunks and slope per
   pair, its bound at each reps and the launch floor, beside two
   torch.gather calls), the pairs each stage of the staged test takes
   (micro_trace_staged_ref, micro_bf16_staged_ref) with the bound they
   give beside the full-test bound, and the gather kernels' SASS
   instructions counted (a form that lost a rep's gathers fails the run).

then the XLA shading path, which a grid scene and the extensions take:

k. the ``--large`` terrain with ``backend: "grid"`` at the default 128³
   grid and the ``--large`` frame's settings: the grid build's seconds, D
   (duplicated references) and C (cells); bounces 0, 1 and 2 of the
   frame's one wave through grid_walk_kernel against its twin
   trace_wave_ref, lane by lane (t, u, v bits, the reference, the iteration
   count and the iterations summed over the rays: a lane or a count that
   differs fails the run), the kernel (with its sum) timed queued behind a
   spin (the median of 8 readings), the twin by CUDA events, the bound from the twin's
   counts of tests and cells (probes/grid_walk.py walk_bound) and the share
   of the cells entered that hold references, and the nearest hits against
   trace_emit_kernel on the MXU bake of the same terrain, every lane where
   the two differ in t or triangle explained (the same triangle, a tie or
   an edge decision) or the run fails; the kernel against the twin on
   65,536 built edge lanes (probes/grid_walk.py edge_rays) with and
   without an exclusion; the same on a 127×37×131 grid of the terrain,
   with the first 2^18 rays of its bounce-0 wave; both instantiations'
   ptxas lines (the walk alone, the shaded walk); the frame's wave through
   the shaded walk (the main path's) against render_wave_xla bit for bit,
   its counters equal, each launch's ms; the frame: a warmup and
   5 timed renders
   (grid_walk_kernel B + 1 = 4 launches a frame, the shaded walk's; the
   frame one CUDA graph from its second render), one profile, the graph's
   frame bit for bit against the
   eager frame, and its gate against the per-bounce MXU frame (diff > 2 on
   < 2% of channels, tests/test_render.py's bound);
l. the extensions: the Cornell box at 1920×1080, 4 bounces, held to the
   statistics of tests/test_extensions.py (NEE's mean within 6% of the
   plain mean at 48 spp, its seed-to-seed noise under 0.8× the plain
   noise at 2 spp, RR's mean within 6% at 32 spp with fewer segments), each
   frame's Mrays/s; the NEE and RR frames at 2 spp as one CUDA graph against
   their eager frames (as in phase o); the ``--large`` terrain with nee,
   russian_roulette and pbr at its frame settings: its first wave through
   the shaded trace_emit_kernel against render_wave_xla, as in phase p; a
   warmup and 5 timed renders (trace_emit_kernel 2B launches a frame: the
   shaded trace's nearest and shadow launch a bounce), one profile, and a
   320×180 frame with the kernels against the twins under the golden
   gates;

then multi-device pixel tiling and the host C++ libraries:

m. parallel/sharding.py's render_scene_sharded as one CUDA graph a card:
   each sharded frame's third call (a replay) against render_scene and
   against its eager frame (graph=False), bit for bit with equal
   segments, the launch counts of the eager frame and of the replay
   printed (each set to 0 just before it, read just after), equal, and
   each of its kernels launched, and each card's graph pool: the official
   frame over make_mesh() (every card) and over 3 and 4 tiles on cuda:0;
   finish_frame (the first device's end of a frame over several cards)
   against render_scene and its ms; render_scene, make_mesh() and 4 tiles
   as graphs and 4 tiles eager timed in turns (a warmup each, 5 rounds);
   the ``--large`` frame
   over 3 tiles (trace_emit, shade); the Cornell box at 320×180, 2 spp,
   with nee, russian_roulette and pbr, through the grid (grid_walk) and
   through the MXU bake (trace_emit), over 4 tiles; the CLI with ``--devices`` above the
   visible cards (make_mesh's ValueError); graft_entry.entry()'s step on
   the card against the CPU twins and dryrun_multichip(4); the native grid
   builder against the NumPy builder on the ``--large`` terrain at 128³
   (equal arrays, both seconds, the OpenMP build and the cores); the
   ``--cpu`` row of bench.py through render_cpu (the bench scene's 128³
   grid, a warmup at 1 spp and 1 bounce, then the official frame); and
   render_cpu against the card's grid render of tests/test_native_tracer.py's
   textured box at 160×90 under that file's gates;

then the port's bench (zig_raytracing_contest_tpu_torch/bench.py):

n. bench.measure on its official row (5 timed frames) and on its Sponza
   (scene/sponza.py at detail 1.25, height 720) and 2M-terrain
   (``large_scene(side=1000)``, 640×360, 1 spp, 2 bounces) rows at 3 timed
   frames each, every JSON line printed after ``bench:`` (the median, reps,
   launches, device-busy time and idle share against the unprofiled wall);
   each big scene's bake line; Sponza's 160×90 frame with the kernels and
   with the twins under the alpha-scene gates; trace_emit_aux
   (trace_stream_kernel) against its twin on 2^14 lanes spread over the 2M
   frame's bounce-0 and sorted bounce-1 waves, as in phase f; a 160×90 500k
   frame with nee and russian_roulette (the XLA shading path over the
   streaming bake: trace_stream_kernel with records off, and no other
   kernel), kernels vs twins under the gates, then as one CUDA graph
   against the eager loop as in phase o;

then the whole-frame device call (render.pipeline: one CUDA graph a frame):

o. ray_sort_key_kernel against its twin, bit for bit, on the official,
   Duck, --large and 500k waves after bounce 1 and on the built NaN lanes
   of probes/sort_key.py, timed at the official and
   --large waves beside the twin and its bound, with its launches a frame;
   the frame as one CUDA graph against the eager loop (graph=False) on the
   official frame (and a second camera through the same graph), Duck,
   --large, 2M, Sponza and the XLA shading path's grid_large and large_ext
   rows of the bench: images and segments bit for bit, the launch
   counts of 2 graph frames equal to 2 eager frames', the walls in
   alternating (eager, graph, graph, eager) rounds, the device busy time
   and idle share of one profiled frame of each, the graph's pool bytes;

then the benchmark's extension cell (pathbench, EXT_CELL):

p. the cell's scene (pathbench's scene writer, sponza_interior_pbr) and
   frame (1280×720, 2 spp, 4 bounces, nee, russian_roulette and pbr, one
   wave of 1,843,200 rays), the program's configuration as the benchmark
   builds it: the ptxas lines of the four shaded trace instantiations (a
   spill fails the run); the frame's wave through the shaded
   trace_stream_kernel (render_wave_shaded_trace, the main path's)
   against render_wave_xla: radiance and segment bits and the eight work
   counters exactly, each of the 8 launches timed (medians of 5 waves),
   render_wave_xla's wave timed, the wave's bound from its counters; the
   frame through the main path: a warmup and 5 timed renders
   (trace_stream_kernel 8 launches a frame and no other kernel of the
   library), one profile.

Run from the repository root: ``python3 chip_smoke.py``.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, its largest difference from the twin,
its time beside the twin's, and the least time the card could take for the
same work (its bound).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SPP = 3
MAX_BOUNCE = 4
WAVE = 1 << 19
SEED = 0
# the --large frame of bench.py (run_large)
L_W, L_H, L_SPP, L_BOUNCES, L_WAVE = 1280, 720, 2, 3, 1 << 21
# the 500k row of scripts/large_sweep.py; the 2-Mtexel bank's texture
S_SIDE, TEX_W, TEX_H = 500, 2048, 1024
# the Duck-class GLB's detail, body texture side and bake (tests/test_golden.py)
D_DETAIL, D_TEX, D_TILES = 1.0, 512, 75
SOURCE = "zig_raytracing_contest_tpu_torch/kernels/path_trace.cu"
PROBES_SOURCE = "zig_raytracing_contest_tpu_torch/kernels/probes.cu"
# (entry, kernel, TPU kernel it replaces); each entry's numbers are keyed
# by the entry, its launches by the kernel (kernels.LAUNCHES; the probes of
# PROBES_SOURCE by the entry, one key per variant); the kernels of
# PROBE_KERNELS are built from PROBES_SOURCE, the others from SOURCE
KERNELS = [
    ("path_trace_gen", "path_trace_gen_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1031"),
    ("path_trace", "path_trace_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1111"),
    ("path_trace_b23", "path_trace_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1111"),
    ("trace_emit", "trace_emit_kernel",
     "zig_raytracing_contest_tpu/ops/mxu_intersect.py:1555"),
    ("trace_emit_norec", "trace_emit_kernel",
     "zig_raytracing_contest_tpu/ops/mxu_intersect.py:1309"),
    ("trace_stream", "trace_stream_kernel",
     "zig_raytracing_contest_tpu/ops/mxu_intersect.py:1344"),
    ("shade", "shade_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1191"),
    ("shade_prep", "shade_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:84"),
    ("shade_3stage", "shade_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:200"),
    ("path_trace_gen_duck", "path_trace_gen_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1031"),
    ("path_trace_duck", "path_trace_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1111"),
    ("path_trace_duck_b23", "path_trace_kernel",
     "zig_raytracing_contest_tpu/render/fused.py:1111"),
    ("texel_fetch", "texel_fetch_kernel", "scripts/check_paged_tpu.py:57"),
    ("sort_key", "sort_key_kernel", "tests/test_fused.py:988"),
    ("micro_trace_none", "micro_trace_kernel", "scripts/micro_trace.py:156"),
    ("micro_trace_lane", "micro_trace_kernel", "scripts/micro_trace.py:156"),
    ("micro_trace_warp", "micro_trace_kernel", "scripts/micro_trace.py:156"),
    ("micro_bf16_f32", "micro_bf16_kernel", "scripts/micro_bf16.py:74"),
    ("micro_bf16_bf16", "micro_bf16_kernel", "scripts/micro_bf16.py:74"),
    ("probe_gather_smem", "probe_gather_kernel", "scripts/probe_gather.py:36"),
    ("probe_gather_shfl", "probe_gather_kernel", "scripts/probe_gather.py:36"),
    ("ray_sort_key", "ray_sort_key_kernel", "zig_raytracing_contest_tpu/render/wavefront.py:125"),
    ("grid_walk", "grid_walk_kernel", "zig_raytracing_contest_tpu/render/wavefront.py:360"),
    ("trace_emit_shaded", "trace_emit_kernel",
     "zig_raytracing_contest_tpu/render/wavefront.py:725"),
    ("trace_stream_shaded", "trace_stream_kernel",
     "zig_raytracing_contest_tpu/render/wavefront.py:725"),
]
PROBE_KERNELS = ("micro_trace_kernel", "micro_bf16_kernel", "probe_gather_kernel")
# The card's peaks (NVIDIA H100 SXM data sheet): f32 outside the tensor
# cores and device memory bandwidth.  A kernel's bound is the larger of its
# operations over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Rates the data sheet's table lacks, from NVIDIA's H100 Tensor Core GPU
# Architecture white paper (H100 SXM5): bf16 outside the tensor cores
# (packed bf16x2) and 32-bit integer operations.
PEAK_BF16_FLOPS = 133.8e12
PEAK_I32_OPS = 33.5e12
# f32 operations, counted from kernels/path_trace.cu: one triangle test of
# sweep_tile (six 3-term transforms, t, u, v, det, u + v), one slab test of
# a box (6 subtractions, 6 products, 12 min/max), one ray generation, one
# surface shade (interpolation, texel indices and filter, scatter, update).
OPS_TRI, OPS_BOX, OPS_GEN, OPS_SHADE = 42, 24, 30, 170
# The staged test of the probes.cu trace micro-benchmarks, in the same f32
# operations: stage 1 (dw, ow, det) for every swept pair, and micro_trace's
# test against the running best one product more; stage 2 (ou, ov, du,
# dv, t, u, v, u + v) for the pairs stage 1 passes on; OPS_STAGE1 +
# OPS_STAGE2 = OPS_TRI.  micro_bf16's working type takes 11 of stage 1's
# and 22 of stage 2's (the transforms).
OPS_STAGE1, OPS_PRUNE, OPS_STAGE2 = 13, 1, 29
BF_STAGE1, BF_STAGE2 = 11, 22
# f32 operations of one beam-sort key (emit_sort_key: the exit slab test
# and the two quantizations per axis; its integer bit interleave is not
# counted)
OPS_KEY = 67
# Kernel vs twin: rows 12-15 (alive, streams, segments, key) and the winner
# index exactly; value rows 0-11 to f32 rounding of libm differences;
# direction rows (3-5, after rsqrt/log/sin/cos) to 1e-5.
RTOL, ATOL, DIR_ATOL = 3e-6, 1e-6, 1e-5
# trace_emit_aux kernel vs twin: the share of lanes whose winners may differ
# (two triangles hit at the same t; each such lane is checked on its own)
TIE_SHARE = 1e-4
# lanes of a full bounce-1 wave held to walk_heap_ref's replay bit for bit
WALK_LANES = 1024
# the grid of phase k (the Config default); the grid walk against
# trace_emit_kernel: two tied triangles within TIE_RTOL·t + TIE_ATOL (4 f32
# ULP at the --large terrain's largest coordinate, 11); a barycentric
# within EDGE_UV of an edge is a decision the other form may flip (the
# transform form's barycentrics carry ulp(|M·o + c|), ~1.5e-5 for a
# 0.1-unit terrain triangle 20 units away, ~1e-4 on a grazing ray); ties
# and edge decisions together on at most EDGE_SHARE of the lanes
G_RES = (128, 128, 128)
# the queued readings of the grid walk that phase k takes, and the walks a
# reading
GW_ROUNDS, GW_REPS = 8, 10
# a grid of the same terrain with odd sides (no row a multiple of 32
# cells), and the rays of its bounce-0 wave walked there
G_ODD_RES, G_ODD_RAYS = (127, 37, 131), 1 << 18
TIE_RTOL, TIE_ATOL, EDGE_UV, EDGE_SHARE = 1e-5, 4e-6, 1e-3, 1e-4
# phase n: the timed frames of the bench's Sponza and 2M rows (3, as
# scripts/large_sweep.py times them; the bench's own default is 5), and the
# lanes of the 2M terrain's waves held to the brute-force twin (~4x the
# 500k terrain's time a ray)
BIG_REPS = 3
M2_LANES = 1 << 14
# phase p: the benchmark's cell whose frame takes the shaded trace over the
# streaming bake; the waves of the shaded trace timed in phases l and p
EXT_CELL = "sponza-720p-ext"
SHADED_ROUNDS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def bounce_waves(scene, cam, rays: int, spp: int, seed: int):
    """The main path's first two bounces of one wave of ``rays`` on the
    card's kernels (gen, sort, trace, shade, sort with the previous hit,
    trace, shade).  Returns (state, aux, idx, rec, shaded) of bounce 0 and
    (state, prev, aux, idx, rec, shaded) of bounce 1."""
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        sort_state_payload,
    )

    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    st0 = gen_rays_raster(par, seed, 0, rays, spp, cam.width)
    _, st0, _ = sort_state_payload(ray_sort_key(scene, st0), st0)
    a0, i0, r0 = mi.trace_emit_aux(scene, st0, scene.rec_table)
    s0 = fused.shade_fused(scene, st0, a0, i0, 0, r0)
    _, st1, (prev,) = sort_state_payload(ray_sort_key(scene, s0), s0, (i0,))
    a1, i1, r1 = mi.trace_emit_aux(scene, st1, scene.rec_table, prev)
    s1 = fused.shade_fused(scene, st1, a1, i1, 1, r1)
    return (st0, a0, i0, r0, s0), (st1, prev, a1, i1, r1, s1)


def lanes_off(k_state, t_state):
    """Per lane of two (16, R) states: (rows 12-15 differ in any bit, a
    value row 0-11 is beyond RTOL/ATOL, DIR_ATOL for the direction)."""
    import torch

    exact = (k_state[12:16].view(torch.int32) != t_state[12:16].view(torch.int32))
    ok_val = torch.isclose(k_state[0:12], t_state[0:12], rtol=RTOL, atol=ATOL)
    ok_val[3:6] = torch.isclose(k_state[3:6], t_state[3:6], rtol=0.0, atol=DIR_ATOL)
    return exact.any(dim=0), (~ok_val).any(dim=0)


def compare(name, k_state, k_idx, t_state, t_idx):
    """Mismatch counts and the largest value difference, kernel vs twin."""
    exact, val = lanes_off(k_state, t_state)
    n_exact, n_val = int(exact.sum()), int(val.sum())
    n_idx = 0 if k_idx is None else int((k_idx != t_idx).sum())
    err = float((k_state[0:12] - t_state[0:12]).abs().max())
    print(f"  {name}: rays {k_state.shape[1]}, mismatched rows 12-15: {n_exact}, "
          f"idx: {n_idx}, rows 0-11 beyond tolerance: {n_val}, "
          f"max |diff| rows 0-11: {err:.3e}")
    if n_exact or n_idx or n_val:
        fail(f"{name} disagrees with its plain twin")
    return err


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    op_ms, byte_ms = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def scene_bytes(scene) -> int:
    """Bytes of the scene arrays a path kernel reads: transforms, records,
    tile boxes, texels."""
    return sum(t.numel() * t.element_size() for t in (
        scene.tri_data, scene.rec_table, scene.tile_bbox, scene.bank))


def compare_trace(name, scene, state, prev, k, t):
    """trace_emit_aux kernel vs twin on the same (16, R) ``state`` and
    ``prev``, under the parity rule: aux rows 3-4 (streams, alive) and t
    exactly on every lane; where the winners agree, u, v and the record
    (when there is one) exactly.  Where they differ (a tie, which the tree walk and the flat loop
    settle by different visit orders), the kernel's winner is recomputed
    with the twin's arithmetic: a front-facing hit of that ray, not its
    previous hit, at the twin's t, with the kernel's u, v and that
    triangle's record; and ties stay under TIE_SHARE of the lanes.  Returns
    the largest |diff| of rows 0-2."""
    import torch

    from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import triangle_hit_ref

    (ka, ki, kr), (ta, ti, tr) = k, t
    n_pass = int((ka[3:5].view(torch.int32) != ta[3:5].view(torch.int32)).any(dim=0).sum())
    n_t = int((ka[2] != ta[2]).sum())
    same = ki == ti
    tied = int((~same).sum())
    n_uv = int(((ka[0:2] != ta[0:2]).any(dim=0) & same).sum())
    n_rec = 0 if kr is None else int(((kr != tr).any(dim=0) & same).sum())
    n_bad_tie = 0
    if tied:
        lane = (~same).nonzero()[:, 0]
        w = ki[lane]
        hit, t_w, u_w, v_w = triangle_hit_ref(scene.tri_data, state[0:3, lane],
                                              state[3:6, lane], w)
        good = hit & (t_w == ta[2, lane]) & (u_w == ka[0, lane]) & (v_w == ka[1, lane])
        if kr is not None:
            good &= (kr[:, lane] == scene.rec_table[:, w.long()]).all(dim=0)
        if prev is not None:
            good &= w != prev[lane]
        n_bad_tie = int((~good).sum())
    fin = same & torch.isfinite(ta[2])
    err = float((ka[0:3, fin] - ta[0:3, fin]).abs().max()) if bool(fin.any()) else 0.0
    live = ta[4] > 0
    print(f"  {name}: rays {ka.shape[1]}, mismatched rows 3-4: {n_pass}, t: {n_t}, "
          f"u/v where the winners agree: {n_uv}, records: {n_rec}, tied lanes: "
          f"{tied} (of which not a hit at the twin's t: {n_bad_tie}), max |diff| rows "
          f"0-2: {err:.3e}; tiles swept per live ray: kernel "
          f"{float(ka[5, live].mean()):.2f}, twin {float(ta[5, live].mean()):.2f}")
    if n_pass or n_t or n_uv or n_rec or n_bad_tie or tied > TIE_SHARE * ka.shape[1]:
        fail(f"{name} disagrees with its plain twin")
    return err


def held_counts(name: str, got, want) -> None:
    """A kernel's work counters ``got`` held to ``want``, exactly: both are
    sums of integers."""
    got, want = [int(x) for x in got], [int(x) for x in want]
    print(f"  {name}: work counters {got}, held to {want}")
    if got != want:
        fail(f"{name}: work counters {got}, want {want}")


def counted_trace(name, scene, state, table, prev, aux, alive: int):
    """trace_emit_aux on the same inputs as ``aux`` (its uncounted launch),
    with the work counters the main path passes: the same aux, bit for bit,
    and counters equal to its rows 4-6 summed, the rays alive to
    ``alive``.  Returns the counters (for the timed calls)."""
    import torch

    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi

    counts = torch.zeros(3, dtype=torch.int64, device=state.device)
    ac = mi.trace_emit_aux(scene, state, table, prev, counts=counts)[0]
    if not torch.equal(ac.view(torch.int32), aux.view(torch.int32)):
        fail(f"{name}: the counted launch's aux differs from the uncounted one's")
    held_counts(name, counts.tolist(), [alive, int(ac[5].to(torch.int64).sum()),
                                        int(ac[6].to(torch.int64).sum())])
    return counts


def walk_exact(name, scene, state, prev, aux, idx, groups: bool) -> None:
    """A per-bounce trace kernel's output on a (16, R) wave against
    walk_check.walk_heap_ref's replay of its walk (the group heap when
    ``groups``, else the tile heap) on WALK_LANES lanes spread over the
    wave: u, v, t bits, idx, tiles swept and boxes tested must all be
    equal, tie lanes included."""
    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch.probes import walk_check

    R = state.shape[1]
    lanes = (torch.arange(WALK_LANES) * (R // WALK_LANES)).tolist()
    t0 = time.perf_counter()
    want = walk_check.walk_lanes(scene, state, prev, lanes, groups)
    off = walk_check.lanes_off_walk(aux, idx, want, lanes)
    live = int((state[12, lanes] > 0).sum())
    print(f"  {name} vs walk_heap_ref: {off} of {WALK_LANES} lanes differ in t, u, v, idx, "
          f"swept or tested ({live} live, {np.isfinite(want['t']).sum()} hit; "
          f"replay {time.perf_counter() - t0:.1f} s)")
    if off:
        fail(f"{name} does not take walk_heap_ref's walk")


def profile_frame(render_scene, scene, cam, cfg, card) -> None:
    """Where one frame's time goes: torch.profiler's CUDA kernel time by
    name against the frame's wall time (the rest is device idle).  The
    program's ``zrc.*`` ranges, which the profiler also lists on the
    device, span kernels and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_scene(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if str(e.device_type).endswith("CUDA") and e.device_time_total > 0
        and not e.key.startswith("zrc.")
    ]
    busy_ms = sum(k[0] for k in kernels)
    if not kernels:
        print(f"profile: frame wall {wall_ms:.1f} ms; device time not measured")
        return
    print(f"profile: frame wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(k[1] for k in kernels)} device ops ({card})")
    for ms, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  x{n:<5d} {key[:80]}")


def ptxas_report(names) -> list:
    """nvcc -Xptxas=-v lines (registers, stack, spills) of the kernels whose
    mangled names contain one of ``names``, from the builds' reports."""
    from zig_raytracing_contest_tpu_torch import kernels

    out, cur = [], None
    for line in "".join(kernels.build_log(name) for name in kernels.SOURCES).splitlines():
        if "Compiling entry function" in line:
            cur = next((n for n in names if n in line), None)
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.strip()}")
    return out


def ptxas_no_spill(names, what: str) -> None:
    """The ptxas lines of the kernels ``names``; a spill fails the run."""
    import re

    lines = ptxas_report(names)
    if not lines:
        fail(f"no ptxas report of {what}: its spills cannot be checked")
    for line in lines:
        print("  " + line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and spill.groups() != ("0", "0"):
            fail(f"{what} spills: {line}")


def whole_path_ptxas() -> None:
    """The whole-path kernels' ptxas lines; a spill fails the run."""
    ptxas_no_spill(("path_trace_gen_kernel", "path_trace_kernel"), "a whole-path kernel")


def occupancy(what, scene, waves) -> None:
    """How busy the one-thread-per-ray flat loop kept a warp's lanes, per
    wave of ``waves`` ((bounce, state, prev)), on 64 warps spread over it
    (walk_check.flat_occupancy, a NumPy replay): tiles passed per live ray
    against tiles swept per warp, and the serial triangle iterations a warp
    runs in that loop against the kernel's (lane-parallel tiles, warp
    sweeps of the tiles fewer than LANE_LOOP_MIN lanes pass): the ceiling
    of what the warp sweeps can gain."""
    from zig_raytracing_contest_tpu_torch.probes import walk_check

    t0 = time.perf_counter()
    for bounce, state, prev in waves:
        occ = walk_check.flat_occupancy(scene, state, prev)
        it0, it1 = occ["iters"]
        print(f"  {what} bounce {bounce}, lane occupancy of the flat loop ({occ['warps']} "
              f"warps, {occ['lanes']} lanes, {occ['live']} live): tiles passed per live ray "
              f"{occ['passed']:.2f}, tiles swept per warp {occ['swept']:.2f}, share of "
              f"sweep lanes busy {occ['busy']:.3f}; serial triangle iterations per warp: "
              f"lane loop {it0:.1f}, at LANE_LOOP_MIN {occ['lane_loop_min']} {it1:.1f} "
              f"({it0 / max(it1, 1e-9):.2f}x)")
    print(f"  ({what} occupancy replay {time.perf_counter() - t0:.1f} s)")


def large_phases(card, timing, errs, bounds, launches) -> None:
    """Phases a-e: the --large frame through the per-bounce pipeline."""
    import torch

    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused, wavefront
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.render.wavefront import regime
    from zig_raytracing_contest_tpu_torch.scene.procedural import large_scene
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda", 0)
    # a. the per-bounce kernels' ptxas report; the scene, through the port
    for line in ptxas_report(("trace_emit_kernel", "trace_stream_kernel", "shade_kernel")):
        print("  " + line)
    tmp = tempfile.TemporaryDirectory()
    path = large_scene(Path(tmp.name) / "large.gltf")
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=L_SPP,
                 max_bounce=L_BOUNCES, wave_size=L_WAVE, seed=SEED)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=L_W,
                                  height=L_H, device=dev)
    reg = regime(scene)
    print(f"--large scene: tri_data {tuple(scene.tri_data.shape)}, tiles "
          f"{scene.tile_bbox.shape[1]}, tree_bbox {tuple(scene.tree_bbox.shape)}, "
          f"regime {reg}, texels {scene.bank.shape[0]}, emissive_dummy "
          f"{scene.emissive_dummy}")
    if reg != "per-bounce, sorted":
        fail(f"--large scene renders in the {reg} regime, expected per-bounce, sorted")

    # b. kernels vs twins on the card, in the main path's order (bounce 0,
    # sort, bounce 1 with the previous hit); the twins at 2^16 rays
    table = scene.rec_table
    small, full = 1 << 16, L_W * L_H * L_SPP
    e0, e1, es0, es1, (st1, prev1, k1) = small_wave_checks(scene, cam, "")

    # the full wave of the main path (bounce 0 sorted, then bounce 1), held
    # against the twins on the same inputs: bounce 0's trace on 2^16 lanes
    # spread over the wave, every other call on every lane
    (stf, af, idf, rf, sf), (stf1, prevf, af1, idf1, rf1, sf1) = bounce_waves(
        scene, cam, full, L_SPP, SEED)
    torch.cuda.synchronize()
    lane = torch.arange(small, device=dev) * (full // small)
    st_l = stf[:, lane].contiguous()
    e2 = compare_trace(f"trace_emit_aux (full wave, bounce 0, {small} lanes)", scene, st_l,
                       None, (af[:, lane], idf[lane], rf[:, lane]),
                       mi.trace_emit_aux_ref(scene, st_l, table))
    es2 = compare("shade_fused (full wave, bounce 0)", sf, None,
                  fused.shade_fused_ref(scene, stf, af, idf, 0, rf), None)
    tw1 = mi.trace_emit_aux_ref(scene, stf1, table, prevf)
    e3 = compare_trace("trace_emit_aux (full wave, bounce 1, prev)", scene, stf1, prevf,
                       (af1, idf1, rf1), tw1)
    walk_exact("trace_emit_kernel (full wave, bounce 1, prev)", scene, stf1, prevf, af1,
               idf1, False)
    counts = counted_trace("trace_emit_aux (full wave, bounce 1, prev)", scene, stf1, table,
                           prevf, af1, int((tw1[0][4] > 0).sum()))
    es3 = compare("shade_fused (full wave, bounce 1)", sf1, None,
                  fused.shade_fused_ref(scene, stf1, af1, idf1, 1, rf1), None)
    errs["trace_emit"] = max(e0, e1, e2, e3)
    errs["shade"] = max(es0, es1, es2, es3)
    timing["trace_emit"] = (
        cuda_ms(lambda: mi.trace_emit_aux(scene, stf1, table, prevf, counts=counts), 5),
        cuda_ms(lambda: mi.trace_emit_aux_ref(scene, st1, table, prev1), 2),
        full, small,
    )
    timing["shade"] = (
        cuda_ms(lambda: fused.shade_fused(scene, stf1, af1, idf1, 1, rf1), 5),
        cuda_ms(lambda: fused.shade_fused_ref(scene, st1, k1[0], k1[1], 1, k1[2]), 2),
        full, small,
    )
    # The least work of the timed bounce-1 calls on this run's data.  Trace:
    # the tiles swept, times 128 triangle tests, plus the boxes tested, each
    # the fewer of the flat twin's culls and the heap walk's (both find the
    # same nearest hits, so the fewer suffice); bytes: alive and streams of
    # every ray, o, d and prev of each
    # live one, aux, idx and record out, and the scene's 13 transform rows,
    # record table and heap once.  Shade: state in and out of every ray, t of
    # each live one, u, v and the 24-float record of each live hit, and the
    # texel bank once.
    tp, p2x2 = scene.tri_data.shape[1], scene.tree_bbox.shape[1]
    live = stf1[12] > 0
    n_live = float(live.sum())
    hits = float((live & torch.isfinite(af1[2])).sum())
    tiles = min(float(af1[5].sum()), float(tw1[0][5].sum()))
    boxes = min(float(af1[6].sum()), float(tw1[0][6].sum()))
    bounds["trace_emit"] = bound(
        tiles * 128 * OPS_TRI + boxes * OPS_BOX,
        full * (2 + 8 + 1 + 24) * 4 + n_live * (6 + 1) * 4 + tp * (13 + 24) * 4
        + 6 * p2x2 * 4)
    bounds["shade"] = bound(
        hits * OPS_SHADE,
        full * (16 + 16) * 4 + n_live * 4 + hits * (2 + 24) * 4 + scene.bank.numel() * 4)
    print(f"  bounce 1 (full wave): live rays {int(n_live)}, live hits {int(hits)}; per "
          f"live ray tiles swept: kernel {float(af1[5][live].mean()):.2f}, twin "
          f"{float(tw1[0][5][live].mean()):.2f}; heap boxes tested "
          f"{float(af1[6][live].mean()):.2f}")
    # the record-off trace (rec_out null) on the same bounce-1 wave: the
    # same walk, so the same aux and winners; the bound without record bytes
    an, idn, rn = mi.trace_emit_aux(scene, stf1, None, prevf)
    torch.cuda.synchronize()
    if rn is not None or not (torch.equal(an.view(torch.int32), af1.view(torch.int32))
                              and torch.equal(idn, idf1)):
        fail("trace_emit_kernel without a record disagrees with its record-on launch")
    errs["trace_emit_norec"] = compare_trace(
        "trace_emit_aux, record off (full wave, bounce 1, prev)", scene, stf1, prevf,
        (an, idn, None), (tw1[0], tw1[1], None))
    timing["trace_emit_norec"] = (
        cuda_ms(lambda: mi.trace_emit_aux(scene, stf1, None, prevf, counts=counts), 5),
        cuda_ms(lambda: mi.trace_emit_aux_ref(scene, st1, None, prev1), 2),
        full, small,
    )
    bounds["trace_emit_norec"] = bound(
        tiles * 128 * OPS_TRI + boxes * OPS_BOX,
        full * (2 + 8 + 1) * 4 + n_live * (6 + 1) * 4 + tp * 13 * 4 + 6 * p2x2 * 4)
    for name in ("trace_emit", "trace_emit_norec", "shade"):
        k_ms, p_ms, rays, p_rays = timing[name]
        print(f"  {name}: kernel {k_ms:.3f} ms at {rays} rays, plain twin {p_ms:.3f} ms "
              f"at {p_rays} rays, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
              f"({card})")
    del stf, stf1, st_l, af, af1, rf, rf1, sf, sf1, tw1, an

    # c. a small --large frame, kernels vs twins, sorted (as the scene
    # renders) and unsorted (SORT_MIN_TRIS raised past its bank: the regime
    # of 2^15 < padded triangles <= 2^16)
    s_cfg = Config(num_samples=L_SPP, max_bounce=L_BOUNCES, seed=SEED)
    s_scene, s_cam, _ = prepare_scene(str(path), s_cfg, camera_name="Camera 1", width=160,
                                      height=90, device=dev)
    sort_min = wavefront.SORT_MIN_TRIS
    try:
        for want, sort_at in (("per-bounce, sorted", sort_min),
                              ("per-bounce", s_scene.tri_data.shape[1])):
            wavefront.SORT_MIN_TRIS = sort_at
            if regime(s_scene) != want:
                fail(f"160x90 --large frame renders {regime(s_scene)}, expected {want}")
            frame_gate(render_scene, s_scene, s_cam, s_cfg, f"--large frame 160x90 ({want})")
    finally:
        wavefront.SORT_MIN_TRIS = sort_min

    # d. the --large frame, through the main path
    got = render_timed(render_scene, scene, cam, cfg, "--large", card,
                       {"trace_emit": 6 * L_BOUNCES, "shade": 6 * L_BOUNCES,
                        "trace_stream": 0})
    launches.update(trace_emit=got["trace_emit"], trace_emit_norec=got["trace_emit"],
                    shade=got["shade"])

    # e. where one --large frame's time goes
    profile_frame(render_scene, scene, cam, cfg, card)
    tmp.cleanup()


def render_timed(render_scene, scene, cam, cfg, what, card, want) -> dict:
    """A frame through the main path: the launch counts set to 0, a warmup
    and 5 timed renders, the counts read and held to ``want`` (kernel ->
    launches over the 6 renders).  Prints the median, best and spread in
    Mrays/s; returns the counts."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels

    kernels.reset_launches()
    img, stats = render_scene(scene, cam, cfg)  # warmup
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        img, stats = render_scene(scene, cam, cfg)
        torch.cuda.synchronize()
        rates.append(stats.segments / (time.perf_counter() - t0) / 1e6)
    got = dict(kernels.LAUNCHES)
    if img.shape != (cam.height, cam.width, 3) or not 0 < float(img.mean()) < 255:
        fail(f"{what} frame: shape {img.shape}, mean {float(img.mean())}")
    for name, n in want.items():
        if got[name] != n:
            fail(f"{what} frame: {name} launched {got[name]} times, expected {n}")
    med, best = statistics.median(rates), max(rates)
    spread = (max(rates) - min(rates)) / med * 100
    print(f"{what} {cam.width}x{cam.height} {cfg.num_samples} spp {cfg.max_bounce} "
          f"bounces: median {med:.3f} Mrays/s, best {best:.3f}, spread {spread:.1f}%, "
          f"segments {stats.segments}, launches {got} ({card})")
    print("  reps Mrays/s: " + ", ".join(f"{r:.3f}" for r in rates))
    return got


def frame_gate(render_scene, scene, cam, cfg, what) -> None:
    """A small frame with the kernels and with the twins, held to the golden
    gates (tests/test_golden.py's alpha-scene gates) and equal segments
    within 0.5%."""
    img_k, st_k = render_scene(scene, cam, cfg)
    img_t, st_t = render_scene(scene, cam, cfg, plain=True)
    diff = abs(img_k.astype(int) - img_t.astype(int))
    frac, mean = float((diff > 2).mean()), float(diff.mean())
    seg_rel = abs(st_k.segments - st_t.segments) / max(st_t.segments, 1)
    print(f"{what}: diff>2 on {frac:.4%} of channels, mean |diff| {mean:.4f}, segments "
          f"{st_k.segments} vs {st_t.segments} ({seg_rel:.4%})")
    if (not (frac < 0.06 and mean < 1.5 and seg_rel < 0.005)
            or img_k.shape != (cam.height, cam.width, 3)):
        fail(f"{what}: kernels and twins disagree beyond the golden gates")


def small_wave_checks(scene, cam, tag: str):
    """trace_emit_aux and shade_fused against their twins on a 2^16-ray wave
    at bounce 0 (raster order, from pixel row 300) and, after a sort with
    the previous hit, at bounce 1.  Returns the trace's and the shade's
    largest differences at each bounce and (state, prev, kernel outputs)
    of bounce 1."""
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        gen_rays_raster,
        ray_sort_key,
        sort_state_payload,
    )

    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    table = scene.rec_table
    st0 = gen_rays_raster(par, SEED, L_W * 300, 1 << 16, L_SPP, L_W)
    k0 = mi.trace_emit_aux(scene, st0, table)
    e0 = compare_trace(f"trace_emit_aux ({tag}bounce 0, raster order)", scene, st0, None,
                       k0, mi.trace_emit_aux_ref(scene, st0, table))
    sk0 = fused.shade_fused(scene, st0, k0[0], k0[1], 0, k0[2])
    es0 = compare(f"shade_fused ({tag}bounce 0)", sk0, None,
                  fused.shade_fused_ref(scene, st0, k0[0], k0[1], 0, k0[2]), None)
    _, st1, (prev1,) = sort_state_payload(ray_sort_key(scene, sk0), sk0, (k0[1],))
    k1 = mi.trace_emit_aux(scene, st1, table, prev1)
    e1 = compare_trace(f"trace_emit_aux ({tag}bounce 1 after the sort, prev)", scene, st1,
                       prev1, k1, mi.trace_emit_aux_ref(scene, st1, table, prev1))
    sk1 = fused.shade_fused(scene, st1, k1[0], k1[1], 1, k1[2])
    es1 = compare(f"shade_fused ({tag}bounce 1)", sk1, None,
                  fused.shade_fused_ref(scene, st1, k1[0], k1[1], 1, k1[2]), None)
    return e0, e1, es0, es1, (st1, prev1, k1)


def stream_phases(card, timing, errs, bounds, launches) -> None:
    """Phase f: the 500k-triangle terrain through the streaming trace."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.render.wavefront import regime, shade_bank
    from zig_raytracing_contest_tpu_torch.scene.procedural import large_scene
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda", 0)
    for line in ptxas_report(("trace_stream_kernel", "trace_emit_kernel")):
        print("  " + line)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    path = large_scene(Path(tmp.name) / "large500.gltf", side=S_SIDE)
    write_s = time.perf_counter() - t0
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=L_SPP,
                 max_bounce=L_BOUNCES, wave_size=L_WAVE, seed=SEED)
    scene, cam, timers = prepare_scene(str(path), cfg, camera_name="Camera 1", width=L_W,
                                       height=L_H, device=dev)
    ph = timers.phases
    reg, nt, ng = regime(scene), scene.tile_bbox.shape[1], scene.group_bbox.shape[1]
    print(f"500k scene: tri_data {tuple(scene.tri_data.shape)}, tile {scene.tile}, tiles "
          f"{nt}, groups {ng} of {scene.group_tiles}, group_tree_bbox "
          f"{tuple(scene.group_tree_bbox.shape)}, texels {scene.bank.shape[0]}, regime "
          f"{reg}, {shade_bank(scene)}; written in {write_s:.2f} s, loaded in "
          f"{ph['load'] + ph['preprocess']:.2f} s, baked in {ph['compile']:.2f} s")
    if reg != "streaming, sorted":
        fail(f"500k scene renders in the {reg} regime, expected streaming, sorted")
    if (tuple(scene.tri_data.shape), scene.tile, nt, ng) != ((16, 501760), 256, 1954, 245):
        fail("500k scene: the bake differs from the JAX package's shapes")

    # kernels vs twins: 2^16 rays at bounce 0 (raster order) and bounce 1
    # (sorted, with the previous hit), then the full wave
    table = scene.rec_table
    small, full = 1 << 16, L_W * L_H * L_SPP
    e0, e1, es0, es1, (st1, prev1, _) = small_wave_checks(scene, cam, "500k, ")
    (stf, af, idf, rf, sf), (stf1, prevf, af1, idf1, rf1, sf1) = bounce_waves(
        scene, cam, full, L_SPP, SEED)
    torch.cuda.synchronize()
    lane = torch.arange(small, device=dev) * (full // small)
    st_l = stf[:, lane].contiguous()
    e2 = compare_trace(f"trace_emit_aux (500k, full wave, bounce 0, {small} lanes)", scene,
                       st_l, None, (af[:, lane], idf[lane], rf[:, lane]),
                       mi.trace_emit_aux_ref(scene, st_l, table))
    es2 = compare("shade_fused (500k, full wave, bounce 0)", sf, None,
                  fused.shade_fused_ref(scene, stf, af, idf, 0, rf), None)
    st_l1, pv_l1 = stf1[:, lane].contiguous(), prevf[lane].contiguous()
    tw1 = mi.trace_emit_aux_ref(scene, st_l1, table, pv_l1)
    e3 = compare_trace(f"trace_emit_aux (500k, full wave, bounce 1, prev, {small} lanes)",
                       scene, st_l1, pv_l1, (af1[:, lane], idf1[lane], rf1[:, lane]), tw1)
    walk_exact("trace_stream_kernel (500k, full wave, bounce 1, prev)", scene, stf1, prevf,
               af1, idf1, True)
    counts = counted_trace("trace_emit_aux (500k, full wave, bounce 1, prev)", scene, stf1,
                           table, prevf, af1, int((stf1[12] > 0).sum()))
    es3 = compare("shade_fused (500k, full wave, bounce 1)", sf1, None,
                  fused.shade_fused_ref(scene, stf1, af1, idf1, 1, rf1), None)
    errs["trace_stream"] = max(e0, e1, e2, e3)
    errs["shade"] = max(errs["shade"], es0, es1, es2, es3)
    timing["trace_stream"] = (
        cuda_ms(lambda: mi.trace_emit_aux(scene, stf1, table, prevf, counts=counts), 5),
        cuda_ms(lambda: mi.trace_emit_aux_ref(scene, st1, table, prev1), 1),
        full, small,
    )
    # The least work of the timed bounce-1 call on this run's data: tiles
    # swept × 256 triangle tests plus boxes tested, each per live ray the
    # fewer of the kernel's count (whole wave) and the flat twin's (its
    # 2^16 lanes), times the live rays; bytes as phase b's, with the group
    # boxes and heap in place of the tile heap.
    tp = scene.tri_data.shape[1]
    live, live_l = stf1[12] > 0, st_l1[12] > 0
    n_live = float(live.sum())
    per_ray = {row: (float(af1[row][live].mean()), float(tw1[0][row][live_l].mean()))
               for row in (5, 6)}
    bounds["trace_stream"] = bound(
        n_live * (min(per_ray[5]) * scene.tile * OPS_TRI + min(per_ray[6]) * OPS_BOX),
        full * (2 + 8 + 1 + 24) * 4 + n_live * (6 + 1) * 4 + tp * (13 + 24) * 4
        + 6 * (nt + ng + scene.group_tree_bbox.shape[1]) * 4)
    print(f"  bounce 1 (full wave): live rays {int(n_live)}; per live ray tiles swept: "
          f"kernel {per_ray[5][0]:.2f}, twin {per_ray[5][1]:.2f}; boxes tested: kernel "
          f"{per_ray[6][0]:.2f}, twin {per_ray[6][1]:.2f}")
    k_ms, p_ms, rays, p_rays = timing["trace_stream"]
    print(f"  trace_stream: kernel {k_ms:.3f} ms at {rays} rays, plain twin {p_ms:.3f} ms "
          f"at {p_rays} rays, bound {bounds['trace_stream'][0]:.4f} ms "
          f"({bounds['trace_stream'][1]}) ({card})")

    # the two walks on the same bounce-1 inputs, launched directly:
    # trace_stream_kernel (group heap) and trace_emit_kernel (tile heap)
    outs = {name: (torch.empty((8, full), dtype=torch.float32, device=dev),
                   torch.empty(full, dtype=torch.int32, device=dev),
                   torch.empty((24, full), dtype=torch.float32, device=dev))
            for name in ("stream", "emit")}
    launch = {"stream": kernels.launch_trace_stream, "emit": kernels.launch_trace_emit}

    def walk(name):
        return lambda: launch[name](scene, stf1, prevf, table, *outs[name])

    ab = {name: [] for name in outs}
    for name in ("stream", "emit", "emit", "stream"):
        ab[name].append(cuda_ms(walk(name), 5))
    if not torch.equal(outs["stream"][0][2], outs["emit"][0][2]):
        fail("the group-heap and tile-heap walks find different nearest t")
    for name, kname in (("stream", "trace_stream_kernel"), ("emit", "trace_emit_kernel")):
        a = outs[name][0]
        print(f"  A/B {kname}: {ab[name][0]:.3f}, {ab[name][1]:.3f} ms; per live ray "
              f"tiles swept {float(a[5][live].mean()):.2f}, boxes tested "
              f"{float(a[6][live].mean()):.2f} ({card})")
    del stf, stf1, st_l, st_l1, af, af1, rf, rf1, sf, sf1, tw1, outs

    # the 500k frame, through the main path
    got = render_timed(render_scene, scene, cam, cfg, "500k", card,
                       {"trace_stream": 6 * L_BOUNCES, "shade": 6 * L_BOUNCES,
                        "trace_emit": 0})
    launches["trace_stream"] = got["trace_stream"]
    profile_frame(render_scene, scene, cam, cfg, card)
    tmp.cleanup()


def bank_phases(card, timing, errs, bounds, launches) -> None:
    """Phase g: a bank with no resident form (2-Mtexel), the 3-stage shade
    of the JAX package, through shade_kernel."""
    import torch

    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.render.wavefront import regime, shade_bank
    from zig_raytracing_contest_tpu_torch.scene.procedural import big_texture_scene, large_scene
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    path = big_texture_scene(large_scene(Path(tmp.name) / "bank.gltf"), SEED, TEX_W, TEX_H)
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=L_SPP,
                 max_bounce=L_BOUNCES, wave_size=L_WAVE, seed=SEED)
    scene, cam, timers = prepare_scene(str(path), cfg, camera_name="Camera 1", width=L_W,
                                       height=L_H, device=dev)
    reg, bank = regime(scene), shade_bank(scene)
    ph = timers.phases
    print(f"2-Mtexel scene: texels {scene.bank.shape[0]}, tri_data "
          f"{tuple(scene.tri_data.shape)}, regime {reg}, {bank}; loaded in "
          f"{ph['load'] + ph['preprocess']:.2f} s, baked in {ph['compile']:.2f} s")
    if (reg, bank) != ("per-bounce, sorted", "3-stage bank"):
        fail(f"2-Mtexel scene renders {reg}, {bank}; expected per-bounce, sorted, "
             "3-stage bank")
    small, full = 1 << 16, L_W * L_H * L_SPP
    (stf, af, idf, rf, sf), (stf1, _, af1, idf1, rf1, sf1) = bounce_waves(
        scene, cam, full, L_SPP, SEED)
    torch.cuda.synchronize()
    es0 = compare("shade_fused (2-Mtexel bank, full wave, bounce 0)", sf, None,
                  fused.shade_fused_ref(scene, stf, af, idf, 0, rf), None)
    es1 = compare("shade_fused (2-Mtexel bank, full wave, bounce 1)", sf1, None,
                  fused.shade_fused_ref(scene, stf1, af1, idf1, 1, rf1), None)
    lane = torch.arange(small, device=dev) * (full // small)
    sl = [x[..., lane].contiguous() for x in (stf1, af1, idf1, rf1)]
    ms = (cuda_ms(lambda: fused.shade_fused(scene, stf1, af1, idf1, 1, rf1), 5),
          cuda_ms(lambda: fused.shade_fused_ref(scene, sl[0], sl[1], sl[2], 1, sl[3]), 2),
          full, small)
    # The least work of the timed call: state in and out of every ray, t of
    # each live one, u, v and the record of each live hit, and each distinct
    # texel those hits read (16 B) once.
    live = stf1[12] > 0
    hit = live & torch.isfinite(af1[2])
    n_live, hits = float(live.sum()), float(hit.sum())
    idx, _ = fused.prep_math_ref(rf1[:, hit], af1[0, hit], af1[1, hit],
                                 scene.emissive_dummy)
    texels = int(torch.unique(torch.stack(idx).clamp(0, scene.bank.shape[0] - 1)).numel())
    b = bound(hits * OPS_SHADE,
              full * (16 + 16) * 4 + n_live * 4 + hits * (2 + 24) * 4 + texels * 16)
    print(f"  bounce 1 (full wave): live rays {int(n_live)}, live hits {int(hits)}, "
          f"distinct texels read {texels} of {scene.bank.shape[0]}; shade_fused: kernel "
          f"{ms[0]:.3f} ms at {full} rays, plain twin {ms[1]:.3f} ms at {small} rays, "
          f"bound {b[0]:.4f} ms ({b[1]}) ({card})")
    for entry in ("shade_prep", "shade_3stage"):
        errs[entry], timing[entry], bounds[entry] = max(es0, es1), ms, b
    del stf, stf1, af, af1, rf, rf1, sf, sf1, sl, idx

    s_cfg = Config(num_samples=L_SPP, max_bounce=L_BOUNCES, seed=SEED)
    s_scene, s_cam, _ = prepare_scene(str(path), s_cfg, camera_name="Camera 1", width=160,
                                      height=90, device=dev)
    frame_gate(render_scene, s_scene, s_cam, s_cfg, "2-Mtexel frame 160x90")
    got = render_timed(render_scene, scene, cam, cfg, "2-Mtexel", card,
                       {"trace_emit": 6 * L_BOUNCES, "shade": 6 * L_BOUNCES,
                        "trace_stream": 0})
    launches["shade_prep"] = launches["shade_3stage"] = got["shade"]
    profile_frame(render_scene, scene, cam, cfg, card)
    tmp.cleanup()


def duck_phases(card, timing, errs, bounds, launches) -> dict:
    """Phase h: the Duck-class GLB through the whole path (the flat tile
    loop).  Returns what phase i reads: the scene, the gen parameters and
    the bounce-0 full wave (input and kernel output)."""
    import torch

    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.pipeline import (
        prepare_scene,
        render_scene,
        slot_geometry,
    )
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        ray_sort_key,
        regime,
        shade_bank,
        sort_state_payload,
        trace_walk,
    )
    from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    path = write_duck_glb(Path(tmp.name) / "duck.glb", tex_size=D_TEX, detail=D_DETAIL)
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=SPP, max_bounce=MAX_BOUNCE,
                 wave_size=WAVE, seed=SEED)
    scene, cam, timers = prepare_scene(str(path), cfg, height=1080, device=dev)
    nt, walk = scene.tile_bbox.shape[1], trace_walk(scene)
    print(f"Duck scene: tri_data {tuple(scene.tri_data.shape)}, tiles {nt}, tree_bbox "
          f"{tuple(scene.tree_bbox.shape)}, texels {scene.bank.shape[0]}, regime "
          f"{regime(scene)}, {shade_bank(scene)}, walk {walk}, camera {cam.width}x"
          f"{cam.height}; loaded in {timers.phases['load'] + timers.phases['preprocess']:.2f}"
          f" s, baked in {timers.phases['compile']:.2f} s")
    if (nt, walk, regime(scene), cam.width) != (D_TILES, "flat", "whole path", 1920):
        fail("the Duck scene does not bake to 75 tiles in the whole path at 1920x1080")

    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    num_slots, tiles_x = slot_geometry(1920, 1080, True)
    gen = fused.GenParams(spp=SPP, width=1920, img_w=1920, img_h=1080, tiles_x=tiles_x)
    quantum = SPP * 1024
    full_wave = WAVE // quantum * quantum
    errs["path_trace_gen_duck"] = errs["path_trace_duck"] = errs["path_trace_duck_b23"] = 0.0
    keep = {}
    # both waves start at 32x32 pixel tile 920 (tile row 15, column 20), so
    # they cross the duck in the middle of the frame
    for R, slot_base in ((1 << 16, 1024 * 920), (full_wave, 1024 * 920)):
        meta = (slot_base, slot_base % 1920, slot_base // 1920, SEED, slot_base // 1024,
                0, 0, 0)
        args = (scene, par, meta, R, 1, gen)
        # the flat loop's (lane_tiles, warp_sweeps) of each call, kernel and twin
        sw = {k: torch.zeros((3, 2), dtype=torch.int64, device=dev) for k in ("k", "t")}
        st0 = fused.gen_rays_ref(par, meta, R, gen)
        k0 = fused.path_trace_gen(*args, emit_key=True, emit_idx=True, sweeps=sw["k"][0])
        t0 = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True, sweeps=sw["t"][0])
        torch.cuda.synchronize()
        errs["path_trace_gen_duck"] = max(errs["path_trace_gen_duck"], compare(
            "Duck path_trace_gen (bounce 0, key, idx)", *k0, *t0))
        key = k0[0][15].contiguous().view(torch.int32)
        _, st, (idx_s,) = sort_state_payload(key, k0[0], (k0[1],))
        k1 = fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s, emit_idx=True,
                                    sweeps=sw["k"][1])
        t1 = fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx_s, emit_idx=True,
                                        sweeps=sw["t"][1])
        torch.cuda.synchronize()
        errs["path_trace_duck"] = max(errs["path_trace_duck"], compare(
            "Duck path_trace_fused (bounce 1 after the sort, prev)", *k1, *t1))
        _, st2, (idx2,) = sort_state_payload(ray_sort_key(scene, k1[0]), k1[0], (k1[1],))
        k3 = fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2, sweeps=sw["k"][2])
        t3 = fused.path_trace_fused_ref(scene, st2, 2, bounce0=2, prev=idx2, sweeps=sw["t"][2])
        torch.cuda.synchronize()
        e23 = compare("Duck path_trace_fused (bounces 2-3 after the resort, prev)", k3, None,
                      t3, None)
        errs["path_trace_duck"] = max(errs["path_trace_duck"], e23)
        errs["path_trace_duck_b23"] = max(errs["path_trace_duck_b23"], e23)
        print(f"  Duck flat loop at {R} rays, (lane_tiles, warp_sweeps) of bounce 0, bounce 1, "
              f"bounces 2-3: kernel {sw['k'].tolist()}, twin {sw['t'].tolist()}")
        if not torch.equal(sw["k"], sw["t"]):
            fail("the Duck's flat loop sweep counters disagree with the twin's")
    del t0, t1, k3, t3

    # the least work of the timed calls on this run's data: tiles swept ×
    # 128 triangle tests and boxes tested, each the fewer of a tile-heap
    # walk's count (trace_emit_aux, aux rows 5-6) and the flat loop's (the
    # twin's), plus the shade of each live ray and the generation of each
    # ray; bytes: the scene's arrays once, the state out (and in)
    sc_b = scene_bytes(scene)

    def work(state, prev):
        live = state[12] > 0
        aux = mi.trace_emit_aux(scene, state, None, prev)[0]
        swept = nearest_hit_ref_swept(scene, state, live, prev)
        tiles = min(float(aux[5].sum()), swept)
        boxes = min(float(aux[6].sum()), float(live.sum()) * nt)
        n = float(live.sum())
        return tiles, boxes, n, float(aux[5][live].mean()), swept / max(n, 1.0)

    w0 = work(st0, None)
    w1 = work(st, idx_s)
    # the bounces 2-3 call: bounce 2's work and, from the kernel's bounce-2
    # output, bounce 3's
    s3, i3 = fused.path_trace_fused(scene, st2, 1, bounce0=2, prev=idx2, emit_idx=True)
    w2, w3 = work(st2, idx2), work(s3, i3)
    n23 = max(w2[2] + w3[2], 1.0)
    w23 = (w2[0] + w3[0], w2[1] + w3[1], w2[2] + w3[2],
           (w2[3] * w2[2] + w3[3] * w3[2]) / n23, (w2[4] * w2[2] + w3[4] * w3[2]) / n23)
    bounds["path_trace_gen_duck"] = bound(
        w0[0] * 128 * OPS_TRI + w0[1] * OPS_BOX + w0[2] * OPS_SHADE + full_wave * OPS_GEN,
        sc_b + full_wave * (16 + 1) * 4)
    bounds["path_trace_duck"] = bound(
        w1[0] * 128 * OPS_TRI + w1[1] * OPS_BOX + w1[2] * OPS_SHADE,
        sc_b + full_wave * (16 + 1 + 16 + 1) * 4)
    bounds["path_trace_duck_b23"] = bound(
        w23[0] * 128 * OPS_TRI + w23[1] * OPS_BOX + w23[2] * OPS_SHADE,
        sc_b + full_wave * (16 + 1 + 16) * 4)
    timing["path_trace_gen_duck"] = (
        cuda_ms(lambda: fused.path_trace_gen(*args, emit_key=True, emit_idx=True), 5),
        cuda_ms(lambda: fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True), 2),
        full_wave, full_wave)
    timing["path_trace_duck"] = (
        cuda_ms(lambda: fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s,
                                               emit_idx=True), 5),
        cuda_ms(lambda: fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx_s,
                                                   emit_idx=True), 2),
        full_wave, full_wave)
    timing["path_trace_duck_b23"] = (
        cuda_ms(lambda: fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2), 5),
        cuda_ms(lambda: fused.path_trace_fused_ref(scene, st2, 2, bounce0=2, prev=idx2), 1),
        full_wave, full_wave)
    for name, w in (("path_trace_gen_duck", w0), ("path_trace_duck", w1),
                    ("path_trace_duck_b23", w23)):
        k_ms, p_ms, rays, _ = timing[name]
        print(f"  {name} at {rays} rays: kernel {k_ms:.3f} ms, plain twin {p_ms:.3f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}); live rays {int(w[2])}, "
              f"tiles swept per live ray: tile-heap walk {w[3]:.2f}, flat loop {w[4]:.2f} "
              f"({card})")

    occupancy("Duck", scene, ((0, st0, None), (1, st, idx_s), (2, st2, idx2), (3, s3, i3)))
    del s3, i3, st2, idx2

    # a small Duck frame, kernels vs twins
    s_cfg = Config(num_samples=SPP, max_bounce=MAX_BOUNCE, seed=SEED)
    s_scene, s_cam, _ = prepare_scene(str(path), s_cfg, height=180, device=dev)
    frame_gate(render_scene, s_scene, s_cam, s_cfg, "Duck frame 320x180")

    # the Duck frame, through the main path
    num_waves = -(-num_slots * SPP // full_wave)
    got = render_timed(render_scene, scene, cam, cfg, "Duck", card,
                       {"path_trace_gen": 6 * num_waves, "trace_emit": 0, "shade": 0,
                        "trace_stream": 0})
    if got["path_trace"] == 0:
        fail("Duck frame: the main path launched no path_trace_kernel")
    launches["path_trace_gen_duck"] = got["path_trace_gen"]
    launches["path_trace_duck"] = launches["path_trace_duck_b23"] = got["path_trace"]
    profile_frame(render_scene, scene, cam, cfg, card)
    keep.update(scene=scene, par=par, tmp=tmp, st0=st0, k0=k0[0])
    return keep


def nearest_hit_ref_swept(scene, state, live, prev) -> float:
    """Tiles the flat twin sweeps over the live rays of ``state``."""
    from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import nearest_hit_ref

    pv = None if prev is None else prev.long()
    return float(nearest_hit_ref(scene.tri_data, scene.tile_bbox, scene.tile, state[0:3],
                                 state[3:6], live, pv)[4].sum())


def probe_phases(card, timing, errs, bounds, launches, duck) -> None:
    """Phase i: the probe kernels against their plain versions."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.probes import check_fetch, sort_key
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import ray_sort_key
    from zig_raytracing_contest_tpu_torch.scene.types import PCOL_BASE
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms, queued_ms

    dev = torch.device("cuda", 0)
    # the probes' own entry points, launch counts set to 0 just before
    kernels.reset_launches()
    fetch = check_fetch.run_checks(dev)
    keys = sort_key.run_checks(dev)
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    for label, lanes, bad in fetch:
        print(f"  texel_fetch {label}: {bad} of {lanes} lanes differ")
    for label, lanes, n_ref, n_host in keys:
        print(f"  sort_key {label}: {n_ref} of {lanes} lanes differ from sort_key_ref, "
              f"{n_host} from the host key")
    if any(bad for _, _, bad in fetch) or any(a or b for _, _, a, b in keys):
        fail("a probe kernel disagrees with its plain version")
    launches["texel_fetch"], launches["sort_key"] = got["texel_fetch"], got["sort_key"]
    if got["texel_fetch"] != len(fetch) or got["sort_key"] != len(keys):
        fail(f"probe launches {got}")

    # the Duck bank, at the body-texture hits of the bounce-0 wave
    scene, st0, k0, par = duck["scene"], duck["st0"], duck["k0"], duck["par"]
    aux, _, rec = mi.trace_emit_aux(scene, st0, scene.rec_table)
    tex_idx, _ = fused.prep_math_ref(rec, aux[0], aux[1], scene.emissive_dummy)
    hitl = (aux[4] > 0) & torch.isfinite(aux[2])
    body = hitl & (rec[PCOL_BASE + 1].abs() == D_TEX)
    off = int(rec[PCOL_BASE][body][0])
    texture = (off, D_TEX, D_TEX, int(rec[PCOL_BASE + 1][body][0] < 0),
               int(rec[PCOL_BASE + 2][body][0] < 0))
    demand = body & (rec[PCOL_BASE] == off)
    base = torch.where(demand, tex_idx[0], off).to(torch.int32)
    got_f = check_fetch.texel_fetch(scene.bank, texture, base, demand)
    want_f = check_fetch.texel_fetch_ref(scene.bank, texture, base, demand)
    bad = int((got_f.view(torch.int32) != want_f.view(torch.int32)).any(dim=0).sum())
    # the same corners at the shade's own four texel indices
    shade_px = torch.stack([scene.bank[tex_idx[c].clamp(0, scene.bank.shape[0] - 1)]
                            for c in range(4)])  # (4, B, 4)
    shade_px = torch.where(demand[None, :, None], shade_px, 0.0)
    n_shade = int((shade_px.permute(0, 2, 1).reshape(16, -1) != got_f).any(dim=0).sum())
    B = base.shape[0]
    corners = check_fetch.corner_indices(texture, base[demand])
    texels = int(torch.unique(corners).numel())
    # the kernel's time queued behind a spin (queued_ms), beside the
    # earlier reading (cuda_ms: events around 20 calls as the host issues
    # them) and the launch floor (an empty kernel queued the same way)
    floor_ms = queued_ms(lambda: kernels.launch_empty(dev), 20)

    def fetch_duck():
        return check_fetch.texel_fetch(scene.bank, texture, base, demand)

    timing["texel_fetch"] = (
        queued_ms(fetch_duck, 20),
        cuda_ms(lambda: check_fetch.texel_fetch_ref(scene.bank, texture, base, demand), 5),
        B, B)
    issued_ms = cuda_ms(fetch_duck, 20)
    bounds["texel_fetch"] = bound(0.0, B * (4 + 1 + 16 * 4) + texels * 16)
    errs["texel_fetch"] = float((got_f - want_f).abs().max())
    print(f"  texel_fetch, Duck bank ({scene.bank.shape[0]} texels), body texture {texture} "
          f"at the bounce-0 wave's hits: demanded lanes {int(demand.sum())} of {B}, lanes "
          f"differing from the plain version {bad}, from the shade's four texel indices "
          f"{n_shade}; kernel {timing['texel_fetch'][0]:.5f} ms queued (as issued "
          f"{issued_ms:.5f} ms; launch floor {floor_ms:.5f} ms), plain "
          f"{timing['texel_fetch'][1]:.4f} ms, bound {bounds['texel_fetch'][0]:.5f} ms "
          f"({bounds['texel_fetch'][1]}, {texels} distinct texels) ({card})")
    if bad or n_shade or not bool(demand.any()):
        fail("texel_fetch_kernel disagrees on the Duck bank")

    # the key of the Duck's bounce-0 wave (as path_trace_gen leaves it)
    key = sort_key.sort_key(k0, par)
    n_ref = int((key != fused.sort_key_ref(k0, par)).sum())
    n_gen = int((key != k0[15].contiguous().view(torch.int32)).sum())
    host = ray_sort_key(scene, k0)
    n_host = int((key != host).sum())
    n_dead = int(((key >> 30) != (host >> 30)).sum())
    R = k0.shape[1]
    timing["sort_key"] = (queued_ms(lambda: sort_key.sort_key(k0, par), 20),
                          cuda_ms(lambda: fused.sort_key_ref(k0, par), 5), R, R)
    issued_ms = cuda_ms(lambda: sort_key.sort_key(k0, par), 20)
    bounds["sort_key"] = bound(R * float(OPS_KEY), R * (7 + 1) * 4 + 32 * 4)
    errs["sort_key"] = float((key - fused.sort_key_ref(k0, par)).abs().max())
    print(f"  sort_key, Duck bounce-0 wave of {R} rays: lanes differing from sort_key_ref "
          f"{n_ref}, from the key path_trace_gen emitted {n_gen}, from the host key "
          f"{n_host} (dead bit {n_dead}); kernel {timing['sort_key'][0]:.5f} ms queued (as "
          f"issued {issued_ms:.5f} ms; launch floor {floor_ms:.5f} ms), plain "
          f"{timing['sort_key'][1]:.4f} ms, bound {bounds['sort_key'][0]:.5f} ms "
          f"({bounds['sort_key'][1]}) ({card})")
    # the host key rounds (o - bmin) / span · 32, the kernel key
    # (o - bmin) · (32 / span): a ray may sit one cell apart at a boundary
    if n_ref or n_gen or n_dead or n_host > 1e-3 * R:
        fail("sort_key_kernel disagrees with its plain version")
    duck["tmp"].cleanup()


def trace_probe_phases(card, timing, errs, bounds, launches, library) -> None:
    """Phase j: the tile-heap walk against the flat loop lane by lane on
    the wave where they once chose different winners, then the three trace
    micro-benchmark kernels against their plain versions, and their
    times."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes import (
        micro_bf16,
        micro_trace,
        probe_gather,
        walk_check,
    )
    from zig_raytracing_contest_tpu_torch.utils.timing import queued_ms

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # the redesigned kernels' lines: a spill fails the run
    ptxas_no_spill(("micro_trace_kernel", "micro_bf16_kernel", "probe_gather_smem_kernel",
                    "probe_gather_shfl_kernel"),
                   "a redesigned probe kernel")
    # trace_emit_kernel (the walk) against nearest_hit_ref (the flat loop)
    # on the side-90 terrain's bounce-0 wave from pixel tile 920
    for label, res, notes in walk_check.run_checks(dev):
        n_tie = sum(row["tie"] for row in res["lanes"])
        print(f"  walk vs flat, {label}: {len(res['lanes'])} of {res['rays']} lanes "
              f"differ ({res['live']} live), {n_tie} ties at equal t")
        for row, note in zip(res["lanes"], notes):
            print("    " + walk_check.format_lane(row))
            print("      " + note)
        if n_tie != len(res["lanes"]):
            fail("the tile-heap walk and the flat loop find different nearest t")

    # the probes' own checks, launch counts set to 0 just before
    kernels.reset_launches()
    trace = micro_trace.run_checks(dev)
    sweeps = micro_bf16.run_checks(dev)
    gathers = probe_gather.run_checks(dev)
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    for label, n, bad, tied, err in trace:
        print(f"  micro_trace {label}: {bad} of {n} lanes differ, {tied} tied, max |diff| "
              f"rows 0-2 {err:.3e}")
    for label, n, bad in sweeps:
        print(f"  micro_bf16 {label}: {bad} of {n} lanes differ")
    for label, n, bad in gathers:
        print(f"  probe_gather {label}: {bad} of {n} elements differ")
    if (any(r[2] for r in trace) or any(r[3] for r in trace[:-1])
            or any(r[2] for r in sweeps) or any(r[2] for r in gathers)):
        fail("a trace probe kernel disagrees with its plain version")
    # one launch per check: 6 per cull, 2 per working type, 3 per form
    want = {f"micro_trace_{c}": sum(v[1] == c for v in micro_trace.variants())
            for c in micro_trace.CULLS}
    want.update({f"micro_bf16_{n}": 2 for n in ("f32", "bf16")})
    want.update({f"probe_gather_{f}": len(probe_gather.REPS) for f in probe_gather.FORMS})
    if any(got[entry] != n for entry, n in want.items()):
        fail(f"trace probe launches {got}, expected {want}")
    launches.update({entry: got[entry] for entry in want})
    # the staged test's boundary cases (after the counts are read)
    edge_t = micro_trace.boundary_checks(dev)
    edge_b = micro_bf16.boundary_checks(dev)
    torch.cuda.synchronize()
    print(f"  micro_trace boundary cases: {sum(r[2] for r in edge_t)} lanes differ, "
          f"{sum(r[3] for r in edge_t)} tied, over {len(edge_t)} variants of "
          f"{edge_t[0][1]} rays; micro_bf16: {sum(r[2] for r in edge_b)} lanes differ over "
          f"{len(edge_b)} runs of {edge_b[0][1]} lanes")
    for label, n, bad, *tied in edge_t + edge_b:
        if bad or any(tied):
            print(f"    {label}: {bad} of {n} lanes differ, {tied} tied")
    if any(r[2] or r[3] for r in edge_t) or any(r[2] for r in edge_b):
        fail("a staged probe kernel disagrees with its plain version on the boundary cases")

    # micro_trace: every variant beside the yardstick; the entries at u/v
    # on and 256 threads.  Bound (the staged test): stage 1 for the pairs
    # the variant's cull sweeps, stage 2 for the pairs stage 1 passes on
    # (both counted by micro_trace_staged_ref on these rays), one box test
    # per live ray and tile with a cull; bytes: 8 state floats in, 9 out
    # per ray, the 13 bank rows and the boxes once.  Beside it the full-test
    # bound: 42 operations for every pair the lane cull sweeps (R x
    # 1024 without a cull), and the box tests.
    tm = micro_trace.time_variants(dev)
    R, ms = tm["rays"], tm["ms"]
    for key, k_ms in ms.items():
        print(f"  micro_trace {micro_trace.label(key)}: {k_ms:.4f} ms at {R} rays ({card})")
    nbytes = R * (8 + 9) * 4 + 13 * 2048 * 4 + 6 * 4 * 4
    errs_t = {cull: max(r[4] for r in trace if f"cull={cull} " in r[0])
              for cull in micro_trace.CULLS}
    tris = micro_trace.make_bank(0)
    tri = torch.from_numpy(tris.tri_data).to(dev)
    bbox = torch.from_numpy(tris.tile_bbox).to(dev)
    state = torch.from_numpy(micro_trace.make_state(1)).to(dev)
    for cull in micro_trace.CULLS:
        entry = f"micro_trace_{cull}"
        _, n = micro_trace.micro_trace_staged_ref(tri, bbox, tris.tile, state, True, cull)
        boxes = 0 if cull == "none" else n["boxes"]
        ops = n["swept"] * (OPS_STAGE1 + OPS_PRUNE) + n["stage2"] * OPS_STAGE2 + boxes * OPS_BOX
        old_ops = (R * micro_trace.T * OPS_TRI if cull == "none" else
                   tm["tiles_swept"] * micro_trace.TILE * OPS_TRI + tm["boxes"] * OPS_BOX)
        bounds[entry] = bound(ops, nbytes)
        timing[entry] = (ms[True, cull, 256], ms["plain", cull], R, R)
        errs[entry] = errs_t[cull]
        print(f"  {entry}: pairs swept {n['swept']} ({n['swept'] / (R * micro_trace.T):.4f} "
              f"of R x 1024), stage 2 {n['stage2']} ({n['stage2'] / n['swept']:.4f} of the "
              f"swept), hits {n['hits']}; box tests {boxes}")
        print(f"  {entry}: kernel {timing[entry][0]:.4f} ms (u/v, 256 threads), plain "
              f"{timing[entry][1]:.3f} ms, bound {bounds[entry][0]:.4f} ms "
              f"({bounds[entry][1]}; full-test bound {bound(old_ops, nbytes)[0]:.4f} ms); "
              f"trace_emit_aux {ms['trace_emit_aux']:.4f} ms ({card})")
    print(f"  micro_trace lane cull: {tm['tiles_swept'] / R:.3f} tiles swept per ray of 4")
    sb = micro_trace.survivor_balance(tri[:, :micro_trace.T], state)
    print(f"  micro_trace stage 1 survivors (no best): {sb['share']:.4f} of the pairs; stage-2 "
          f"rounds a triangle: each lane its own survivors {sb['lane']:.4f} (64-triangle "
          f"blocks), each lane a triangle's {sb['triangle']:.4f}, full warps {sb['full']:.4f}")

    # micro_bf16: the slope per (128 x 512) sweep; entries at ITERS_HI.
    # Bound (the staged test, counted by micro_bf16_staged_ref over the
    # ITERS_HI sweeps): stage 1 for every pair, 11 of its 13 operations in
    # the working type; stage 2 for the pairs stage 1 passes on, 22 of its
    # 29.  Beside it the full-test bound: 65,536 tests a sweep of 30
    # transform operations in the working type and a 12-operation f32 tail.
    # The plain version computes the same output by sweeping the 64
    # distinct tiles once (a min is idempotent): its ms is that of 64
    # sweeps, not of ITERS_HI.
    sw = micro_bf16.time_sweeps(dev)
    tests = micro_bf16.K * micro_bf16.LB
    lo, hi = micro_bf16.ITERS_LO, micro_bf16.ITERS_HI
    nbytes = 13 * micro_bf16.NT * micro_bf16.K * 4 + micro_bf16.LB * (6 * 4 + 4)
    bank, states = micro_bf16.device_inputs(dev)
    for name, entry, dt, rate in (
            ("float32", "micro_bf16_f32", torch.float32, PEAK_F32_FLOPS),
            ("bfloat16", "micro_bf16_bf16", torch.bfloat16, PEAK_BF16_FLOPS)):
        r = sw[name]
        _, n = micro_bf16.micro_bf16_staged_ref(bank, states[dt], hi)
        w = PEAK_F32_FLOPS / rate  # a working-type operation, in f32 operations
        ops = (n["swept"] * (BF_STAGE1 * w + OPS_STAGE1 - BF_STAGE1)
               + n["stage2"] * (BF_STAGE2 * w + OPS_STAGE2 - BF_STAGE2))
        per_sweep = tests * (30 * w + 12)  # the full test, in f32 operations
        bounds[entry] = bound(ops, nbytes)
        timing[entry] = (r["ms"][hi], r["plain_ms"], micro_bf16.LB, micro_bf16.LB)
        errs[entry] = 0.0
        print(f"  micro_bf16 {name}: pairs {n['swept']}, stage 2 {n['stage2']} "
              f"({n['stage2'] / n['swept']:.4f}), hits {n['hits']} over {hi} sweeps")
        print(f"  micro_bf16 {name}: t({lo}) {r['ms'][lo]:.4f} ms, t({hi}) "
              f"{r['ms'][hi]:.4f} ms -> {r['us_per_sweep']:.6f} us per (128x512) sweep, "
              f"bound {bounds[entry][0] / hi * 1e3:.6f} us per sweep, "
              f"{bounds[entry][0]:.4f} ms at {hi} (full-test bound "
              f"{per_sweep / PEAK_F32_FLOPS * 1e6:.6f} us per sweep, "
              f"{bound(hi * per_sweep, nbytes)[0]:.4f} ms); plain {r['plain_ms']:.3f} ms (64 "
              f"sweeps, {r['plain_us_per_sweep']:.3f} us each) ({card})")
    rel, flips = sw["bf16_error"]
    print(f"  micro_bf16 bf16 best t against f32: max relative error {rel:.3e} where both "
          f"hit, {flips} of {micro_bf16.LB} lanes flip between a hit and none")

    # probe_gather: device time per call (queued behind a spin) and SM
    # cycles of the reps loop summed over the chunks at reps 1, 64, 512,
    # each one's slope per pair, the library's pair (two torch.gather
    # calls); entries at reps 1, whose function is one pair.  Bound at each
    # reps: 16 KB in and out once, 2 int32 additions per element and rep;
    # the gathers are on-chip traffic (shared memory or shuffles), not
    # device bytes.  Beside it the launch floor (an empty kernel, queued).
    pgt = probe_gather.time_forms(dev)
    floor_ms = queued_ms(lambda: kernels.launch_empty(dev), 20)
    pg_bounds = {r: bound(2 * 1024 * r * PEAK_F32_FLOPS / PEAK_I32_OPS, 4 * 1024 * 4)
                 for r in probe_gather.REPS}
    for form in probe_gather.FORMS:
        entry = f"probe_gather_{form}"
        f_ms = pgt[form]["ms"]
        bounds[entry] = pg_bounds[1]
        timing[entry] = (f_ms[1], pgt["plain_ms"], 1024, 1024)
        errs[entry] = 0.0
        library[entry] = pgt["library_ms"]
        print(f"  probe_gather {form}, device time per call: " + ", ".join(
            f"reps={r} {f_ms[r] * 1e3:.3f} us ({c} chunks of {p})"
            for r, (c, p) in zip(probe_gather.REPS, pgt[form]["chunks"].values()))
            + f" -> {pgt[form]['us_per_pair'] * 1e3:.3f} ns per gather pair; SM cycles of "
            "the reps loop over the chunks: " + ", ".join(
                f"reps={r} {c}" for r, c in pgt[form]["cycles"].items())
            + f" -> {pgt[form]['cycles_per_pair']:.1f} per pair ({card})")
    print("  probe_gather bound: " + ", ".join(
        f"reps={r} {b[0] * 1e3:.6f} us ({b[1]})" for r, b in pg_bounds.items())
        + f"; launch floor {floor_ms * 1e3:.3f} us ({card})")
    print(f"  probe_gather plain (reps=1) {pgt['plain_ms'] * 1e3:.3f} us; two torch.gather "
          f"calls {pgt['library_ms'] * 1e3:.3f} us per pair ({card})")
    sass_report(kernels.library_path("probes"))
    print(f"phase j: {time.perf_counter() - t0:.1f} s")


def sass_report(lib) -> None:
    """Shared-memory loads and stores, shuffles, barriers, branches and
    atomics in the SASS of each probe_gather kernel (cuobjdump), each
    instantiation on its own line: "fold", the chunked kernel that adds
    into the output, and "store", the one-chunk kernel.  A rep keeps its
    two gathers: the smem form at least two LDS and two BAR, the shfl form
    at least 128 SHFL, or the run fails."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"  probe_gather SASS: not read ({exc})")
        return
    least = {"smem": {"LDS": 2, "BAR": 2}, "shfl": {"SHFL": 128}}
    functions = sass.split("Function : ")[1:]
    for form in ("smem", "shfl"):
        name = f"probe_gather_{form}_kernel"
        bodies = [f for f in functions if name in f.split("\n", 1)[0]]
        if not bodies:
            fail(f"{name}: not in the SASS of {lib}")
        for body in bodies:
            kind = "fold" if "ILb1E" in body.split("\n", 1)[0] else "store"
            counts = {op: body.count(f" {op}")
                      for op in ("LDS", "STS", "SHFL", "BAR", "BRA", "RED", "ATOMS")}
            print(f"  {name} ({kind}) SASS: {counts}")
            if any(counts[op] < n for op, n in least[form].items()):
                fail(f"{name}: a rep lost a gather (SASS {counts}, at least {least[form]})")


def grid_differences(what, card, t_g, tri_g, u_g, v_g, aux, tri_k) -> None:
    """Lanes where the grid walk (Möller–Trumbore) and trace_emit_kernel (the
    transform form) differ in t or triangle, each explained or the run
    fails: the same triangle (the two forms of the test round differently;
    a grazing ray's t is ill-conditioned in both), a tie (two triangles
    within TIE_RTOL·t + TIE_ATOL of each other), or an edge decision (the
    nearer winner within EDGE_UV of an edge of its triangle in its own
    test, so the other test's rounding put the ray past it); ties and
    edge decisions on at most EDGE_SHARE of the lanes."""
    import torch

    t_k, u_k, v_k = aux[2], aux[0], aux[1]
    hit_g, hit_k = torch.isfinite(t_g), torch.isfinite(t_k)
    differ = (t_g != t_k) | ((tri_g != tri_k) & (hit_g | hit_k))
    both = hit_g & hit_k
    same_tri = differ & both & (tri_g == tri_k)
    rel = ((t_g - t_k).abs() / torch.minimum(t_g, t_k))[same_tri]
    close = both & ((t_g - t_k).abs() <= TIE_RTOL * torch.minimum(t_g, t_k) + TIE_ATOL)
    tie = differ & close & (tri_g != tri_k)
    g_near = torch.where(hit_k, t_g < t_k, hit_g)
    u_n, v_n = torch.where(g_near, u_g, u_k), torch.where(g_near, v_g, v_k)
    edge_dist = torch.minimum(torch.minimum(u_n, v_n), 1.0 - u_n - v_n)
    edge = differ & ~same_tri & ~tie & (edge_dist.abs() <= EDGE_UV)
    bad = differ & ~same_tri & ~tie & ~edge
    near_edge = edge_dist[edge].abs()
    print(f"  {what}: grid vs trace_emit_kernel on the same rays: {int(differ.sum())} of "
          f"{t_g.numel()} lanes differ in t or triangle: {int(same_tri.sum())} the same "
          f"triangle (the two forms of the test round differently; |dt|/t at most "
          f"{float(rel.max()) if rel.numel() else 0.0:.3e}, beyond {TIE_RTOL:g} on "
          f"{int((rel > TIE_RTOL).sum())}), {int(tie.sum())} ties (two triangles within "
          f"{TIE_RTOL:g}·t + {TIE_ATOL:g}), {int(edge.sum())} edge decisions (the nearer "
          f"winner within {EDGE_UV:g} of an edge; at most "
          f"{float(near_edge.max()) if near_edge.numel() else 0.0:.3e}), {int(bad.sum())} "
          f"unexplained ({card})")
    if int(tie.sum() + edge.sum()) > EDGE_SHARE * t_g.numel():
        fail(f"{what}: ties and edge decisions on more than {EDGE_SHARE:g} of the lanes")
    if int(bad.sum()):
        lane = int(bad.nonzero()[0, 0])
        fail(f"{what}: lane {lane} differs unexplained: grid t {float(t_g[lane])} tri "
             f"{int(tri_g[lane])}, kernel t {float(t_k[lane])} tri {int(tri_k[lane])}")


def grid_phases(card, timing, errs, bounds, launches) -> None:
    """Phase k: the --large terrain through the grid backend (the XLA
    shading path, the DDA walk grid_walk_kernel on the card)."""
    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.grid.builder import build_grid
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.probes.grid_walk import (
        edge_rays,
        shaded_ab,
        walk_bound,
        walk_differs,
        walk_ptxas,
    )
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
    from zig_raytracing_contest_tpu_torch.scene.procedural import large_scene
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms, queued_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    path = large_scene(Path(tmp.name) / "large.gltf")
    geo = load_geometry(load_gltf(str(path)))
    t0 = time.perf_counter()
    gb = build_grid(geo.positions, G_RES)
    print(f"phase k: grid build {time.perf_counter() - t0:.2f} s (NumPy, host), resolution "
          f"{G_RES}: D {len(gb.dup_to_tri)} duplicated references of {geo.num_triangles} "
          f"triangles, C {gb.stats['num_cells']} cells ({gb.stats['empty_cells']} empty, "
          f"at most {gb.stats['max_tris']} references)")
    del gb
    kw = dict(grid_resolution=G_RES, num_samples=L_SPP, max_bounce=L_BOUNCES,
              wave_size=L_WAVE, seed=SEED)
    cfg = Config(backend="grid", **kw)
    scene, cam, timers = prepare_scene(str(path), cfg, camera_name="Camera 1", width=L_W,
                                       height=L_H, device=dev)
    reg = wf.regime(scene)
    print(f"  grid scene: regime {reg}, D {scene.grid.num_refs}, C {scene.grid.num_cells}, "
          f"grid built and uploaded in {timers.phases['compile']:.2f} s")
    if reg != "XLA shading, grid" or scene.tri_data is not None:
        fail(f"the grid scene renders {reg}")
    print(f"  grid_walk_kernel ptxas: {walk_ptxas(kernels.build_log('path_trace'))}")
    mcfg = Config(**kw)
    mscene, _, _ = prepare_scene(str(path), mcfg, camera_name="Camera 1", width=L_W,
                                 height=L_H, device=dev)
    T = geo.num_triangles  # the bake's real triangles are its first T positions
    morton = torch.empty(T, dtype=torch.int64, device=dev)  # unique id -> Morton
    morton[mscene.perm[:T]] = torch.arange(T, device=dev)

    # bounces 0, 1 and 2 of the frame's one wave, as render_wave_xla runs
    # them: grid_walk_kernel against its twin lane by lane, both timed, the
    # bound from the twin's counts; the nearest hits against
    # trace_emit_kernel's
    R = L_W * L_H * L_SPP
    par = wf.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    o, d, streams = wf.xla_primary_rays(par, L_W, L_SPP, 0, R, SEED)
    o = o.contiguous()
    live = torch.ones(R, dtype=torch.bool, device=dev)
    prev = None
    it_sum = torch.zeros(1, dtype=torch.int64, device=dev)
    for bounce in range(L_BOUNCES):
        it_sums = []
        off, k_it, t_it, res = walk_differs(scene, o, d, live, prev, it_sums)
        readings = [queued_ms(lambda: wf.trace_wave(scene, o, d, live, prev, it_sum=it_sum),
                              GW_REPS) for _ in range(GW_ROUNDS)]
        k_ms = statistics.median(readings)
        t_ms = cuda_ms(lambda: wf.trace_wave_ref(scene, o, d, live, prev), 1)
        b = walk_bound(scene, res.work, R, prev is not None, PEAK_F32_FLOPS, PEAK_BYTES)
        occupied = float(res.work.occupied.sum()) / max(b["cells"], 1.0)
        print(f"  grid_walk_kernel vs trace_wave_ref, bounce {bounce}: {off} of {R} lanes "
              f"differ (t, u, v bits, reference), iterations {k_it} vs {t_it}; kernel "
              f"{k_ms:.4f} ms (the median of {GW_ROUNDS} queued readings), twin "
              f"{t_ms:.1f} ms; {int(live.sum())} live rays, "
              f"{int(b['walking'])} walking, {int(torch.isfinite(res.t).sum())} hits; "
              f"{b['tests']:.0f} tests, {b['cells']:.0f} cells entered, {occupied:.4f} of "
              f"them occupied; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['ops'] / 1e9:.3f} GFLOP "
              f"{b['ops_ms']:.4f} ms, unique {b['bytes_unique'] / 1e6:.1f} MB "
              f"{b['unique_ms']:.4f} ms; gathered {b['bytes_gathered'] / 1e9:.3f} GB "
              f"{b['gathered_ms']:.4f} ms), {b['bound_ms'] / k_ms:.1%} of it ({card})")
        print("  grid_walk: " + json.dumps({"bounce": bounce, "rays": R, "differ": off,
                                            "iterations": k_it, "ms": k_ms, "plain_ms": t_ms,
                                            "ms_readings": readings,
                                            "occupied_share": occupied, **b, "card": card}))
        held_counts(f"grid_walk_kernel's iteration sum, bounce {bounce}", it_sums[0][:1],
                    it_sums[0][1:])
        if off or k_it != t_it:
            fail(f"grid_walk_kernel differs from trace_wave_ref at bounce {bounce}")
        if bounce == 1:  # the kernels line keeps the bounce-1 wave, as before
            timing["grid_walk"] = (k_ms, t_ms, R, R)
            bounds["grid_walk"] = (b["bound_ms"], b["bound_by"])
        tri_g = scene.grid.dup_to_tri[res.dup_idx]
        state = torch.zeros((16, R), dtype=torch.float32, device=dev)
        state[0:3], state[3:6], state[12] = o.T, d.T, live.to(torch.float32)
        prev_m = None if prev is None else morton[prev].to(torch.int32)
        e_ms = cuda_ms(lambda: mi.trace_emit_aux(mscene, state, None, prev_m), 3)
        aux, idx, _ = mi.trace_emit_aux(mscene, state, None, prev_m)
        tri_k = torch.where(torch.isfinite(aux[2]), mscene.perm[idx.to(torch.int64)], 0)
        print(f"  trace_emit_kernel on the same rays (the MXU bake): {e_ms:.3f} ms ({card})")
        grid_differences(f"bounce {bounce}", card, res.t, tri_g, res.u, res.v, aux, tri_k)
        del state, aux, idx
        new_o, new_d, *_, missed, _ = wf.shade_and_scatter(scene, o, d, res.t, res.u, res.v,
                                                           tri_g, streams, bounce)
        stepped = live & ~missed
        o = torch.where(stepped[:, None], new_o, o)
        d = torch.where(stepped[:, None], new_d, d)
        live, prev = stepped, tri_g
    errs["grid_walk"] = 0.0  # every bit equal, or the run failed
    del o, d, streams, live, prev, res, new_o, new_d
    # the same wave through the shaded walk (the main path's: B + 1
    # launches), against render_wave_xla bit for bit, each launch timed
    if shaded_ab(scene, cam, card, GW_ROUNDS):
        fail("the shaded walk's wave differs from render_wave_xla's")
    # the built edge lanes, with and without an exclusion
    eo, ed, ea = (x.to(dev) for x in edge_rays(scene.grid.params, 1 << 16, seed=SEED))
    rng = np.random.default_rng(SEED)
    ex = scene.grid.dup_to_tri[torch.from_numpy(rng.integers(0, scene.grid.num_refs, 1 << 16))
                               .to(dev)]
    for label, exclude in (("edge lanes", None), ("edge lanes, excluded", ex)):
        it_sums = []
        off, k_it, t_it, _ = walk_differs(scene, eo, ed, ea, exclude, it_sums)
        print(f"  grid_walk_kernel vs trace_wave_ref, {label}: {off} of {eo.shape[0]} lanes "
              f"differ, iterations {k_it} vs {t_it}, summed over the rays {it_sums[0]}")
        if off or k_it != t_it or it_sums[0][0] != it_sums[0][1]:
            fail(f"grid_walk_kernel differs from trace_wave_ref on the {label}")
    del eo, ed, ea, ex
    # the same terrain on a grid of odd sides (its rows no multiple of 32
    # cells): the bounce-0 wave's first G_ODD_RAYS rays, and the edge lanes
    # with and without an exclusion
    oscene, _, _ = prepare_scene(str(path), Config(backend="grid", **{**kw, "grid_resolution":
                                                                     G_ODD_RES}),
                                 camera_name="Camera 1", width=L_W, height=L_H, device=dev)
    og = oscene.grid
    o, d, _ = wf.xla_primary_rays(par, L_W, L_SPP, 0, G_ODD_RAYS, SEED)
    eo, ed, ea = (x.to(dev) for x in edge_rays(og.params, 1 << 16, seed=SEED))
    ex = og.dup_to_tri[torch.from_numpy(rng.integers(0, og.num_refs, 1 << 16)).to(dev)]
    lit = torch.ones(G_ODD_RAYS, dtype=torch.bool, device=dev)
    for label, rays in (("bounce 0", (o.contiguous(), d, lit, None)),
                        ("edge lanes", (eo, ed, ea, None)),
                        ("edge lanes, excluded", (eo, ed, ea, ex))):
        off, k_it, t_it, _ = walk_differs(oscene, *rays)
        print(f"  grid_walk_kernel vs trace_wave_ref, {G_ODD_RES} grid, {label}: {off} of "
              f"{rays[0].shape[0]} lanes differ, iterations {k_it} vs {t_it}")
        if off or k_it != t_it:
            fail(f"grid_walk_kernel differs from trace_wave_ref on the {G_ODD_RES} grid "
                 f"({label})")
    del oscene, og, o, d, lit, eo, ed, ea, ex

    # the frame, through the main path (one CUDA graph a frame from the
    # second on): the shaded walk's B + 1 launches a wave
    got = render_timed(render_scene, scene, cam, cfg, "grid --large", card,
                       {"grid_walk": 6 * (L_BOUNCES + 1), "trace_emit": 0, "trace_stream": 0,
                        "shade": 0, "path_trace": 0, "path_trace_gen": 0})
    launches["grid_walk"] = got["grid_walk"]
    profile_frame(render_scene, scene, cam, cfg, card)
    # the graph's frame against the eager frame, and against the same frame
    # through the MXU bake's per-bounce path
    img_e, st_e = render_scene(scene, cam, cfg, graph=False)
    img_g, st_g = render_scene(scene, cam, cfg)
    same = bool(np.array_equal(img_g, img_e)) and st_g.segments == st_e.segments
    print(f"grid --large: graph frame bit-identical to the eager frame {same}, segments "
          f"{st_g.segments} vs {st_e.segments}")
    if not same:
        fail("the grid frame's CUDA graph differs from its eager frame")
    img_m, st_m = render_scene(mscene, cam, mcfg)
    diff = abs(img_g.astype(int) - img_m.astype(int))
    frac = float((diff > 2).mean())
    print(f"grid --large vs the MXU per-bounce frame {L_W}x{L_H}: diff>2 on {frac:.4%} of "
          f"channels, mean |diff| {float(diff.mean()):.4f}, segments {st_g.segments} vs "
          f"{st_m.segments}")
    if not frac < 0.02 or img_g.shape != (L_H, L_W, 3):
        fail("the grid frame and the MXU frame disagree beyond tests/test_render.py's bound")
    tmp.cleanup()
    print(f"phase k: {time.perf_counter() - t_phase:.1f} s")


def timed_frame(render_scene, scene, cam, cfg, what, card):
    """One frame, timed to torch.cuda.synchronize(): (image as float64,
    stats); prints its Mrays/s."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, st = render_scene(scene, cam, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  {what}: {st.segments / dt / 1e6:.3f} Mrays/s ({st.segments} segments in "
          f"{dt * 1e3:.1f} ms, mean {float(img.mean()):.3f}) ({card})")
    return img.astype("float64"), st


def extension_phases(card, timing, errs, bounds, launches) -> None:
    """Phase l: the extensions through the XLA shading path (on the card, a
    baked scene's waves through the shaded trace)."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.scene.procedural import cornell_like_box, large_scene

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    # (1) the Cornell box (its ceiling is the light) at 1920x1080, 4 bounces:
    # the statistics of tests/test_extensions.py:56-89 at this size, at its
    # samples per pixel (the means are of the 8-bit image, whose clamp at 1
    # biases a noisy estimator's mean at few samples)
    box = cornell_like_box(Path(tmp.name) / "box.gltf")
    scene, cam, _ = prepare_scene(str(box), Config(), width=1920, height=1080, device=dev)
    if scene.lights is None or wf.regime(scene, Config(nee=True).ext_flags) != (
            "XLA shading, tile heap"):
        fail("the Cornell box has no lights or does not take the XLA shading path")
    print(f"phase l: Cornell box 1920x1080, {MAX_BOUNCE} bounces, lights "
          f"{scene.lights.tri.numel()}; plain frames through the {wf.regime(scene)}")

    def frame(what, **kw):
        cfg = Config(max_bounce=MAX_BOUNCE, **kw)
        return timed_frame(render_scene, scene, cam, cfg, what, card)

    kernels.reset_launches()
    plain, _ = frame("plain 48 spp, seed 3", num_samples=48, seed=3)
    nee, _ = frame("NEE 48 spp, seed 3", num_samples=48, seed=3, nee=True)
    rel = abs(plain.mean() - nee.mean()) / max(plain.mean(), 1)
    noise = {}
    for name, ext in (("plain", {}), ("NEE", {"nee": True})):
        a, _ = frame(f"{name} 2 spp, seed 1", num_samples=2, seed=1, **ext)
        b, _ = frame(f"{name} 2 spp, seed 2", num_samples=2, seed=2, **ext)
        noise[name] = float(abs(a - b).mean())
    p5, sp = frame("plain 32 spp, seed 5", num_samples=32, seed=5)
    rr, sr = frame("RR 32 spp, seed 5", num_samples=32, seed=5, russian_roulette=True)
    rr_rel = abs(p5.mean() - rr.mean()) / max(p5.mean(), 1)
    xla_launches = kernels.LAUNCHES["trace_emit"]
    print(f"  NEE mean vs plain: {rel:.4f} (limit 0.06); seed-to-seed noise at 2 spp: NEE "
          f"{noise['NEE']:.4f}, plain {noise['plain']:.4f}, ratio "
          f"{noise['NEE'] / noise['plain']:.4f} (limit 0.8); RR mean vs plain {rr_rel:.4f} "
          f"(limit 0.06), segments {sr.segments} vs {sp.segments}; trace_emit launches "
          f"{xla_launches}")
    if not (rel < 0.06 and noise["NEE"] < 0.8 * noise["plain"] and rr_rel < 0.06
            and sr.segments < sp.segments):
        fail("the Cornell box's NEE / RR statistics are off")
    if xla_launches == 0:
        fail("the XLA shading path launched no trace kernel")
    del plain, nee, p5, rr
    # the NEE and RR frames as one CUDA graph against their eager frames
    for what, ext in (("NEE", {"nee": True}), ("RR", {"russian_roulette": True})):
        graph_ab(f"Cornell 1920x1080 {what} 2 spp", scene, cam,
                 Config(max_bounce=MAX_BOUNCE, num_samples=2, seed=1, **ext), card, 1)
    del scene

    # (2) the --large terrain with all three extensions; its ceiling light
    # gives NEE its lights, so a bounce traces twice (the nearest hit and the
    # shadow rays)
    path = large_scene(Path(tmp.name) / "large.gltf")
    cfg = Config(num_samples=L_SPP, max_bounce=L_BOUNCES, wave_size=L_WAVE, seed=SEED,
                 nee=True, russian_roulette=True, pbr=True)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=L_W,
                                  height=L_H, device=dev)
    n_lights = 0 if scene.lights is None else scene.lights.tri.numel()
    print(f"  --large with nee, russian_roulette, pbr: regime "
          f"{wf.regime(scene, cfg.ext_flags)}, lights {n_lights}")
    timing["trace_emit_shaded"], bounds["trace_emit_shaded"] = shaded_trace_check(
        "--large extensions", scene, cam, cfg, card)
    errs["trace_emit_shaded"] = 0.0  # every bit equal, or the run failed
    # the shaded trace: a nearest and a shadow launch a bounce
    got = render_timed(render_scene, scene, cam, cfg, "--large extensions", card,
                       {"trace_emit": 6 * 2 * L_BOUNCES, "trace_stream": 0, "shade": 0})
    launches["trace_emit_shaded"] = xla_launches + got["trace_emit"]
    profile_frame(render_scene, scene, cam, cfg, card)
    s_scene, s_cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=320,
                                      height=180, device=dev)
    frame_gate(render_scene, s_scene, s_cam, cfg, "--large extensions 320x180")
    tmp.cleanup()
    print(f"phase l: {time.perf_counter() - t_phase:.1f} s")


def textured_box(path: Path) -> Path:
    """tests/test_native_tracer.py's scene: the Cornell box with a checker
    texture, an emissive ceiling and a BLEND quad, camera "c"."""
    import numpy as np

    from zig_raytracing_contest_tpu_torch.scene.procedural import SceneBuilder, quad

    b = SceneBuilder()
    white = b.add_material(base_color_factor=(0.73, 0.73, 0.73, 1))
    red = b.add_material(base_color_factor=(0.65, 0.05, 0.05, 1))
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(5, 5, 5))
    checker = np.zeros((4, 4, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [220, 220, 220, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [40, 40, 40, 255]
    tex = b.add_material(base_color_texture=b.add_texture(b.add_image_png(checker)))
    holes = np.full((1, 1, 4), 255, np.uint8)
    holes[0, 0, 3] = 120
    glass = b.add_material(base_color_texture=b.add_texture(b.add_image_png(holes)),
                           alpha_mode="BLEND")
    for center, uax, vax, mat in (((0, -1, 0), (1, 0, 0), (0, 0, -1), tex),
                                  ((0, 1, 0), (1, 0, 0), (0, 0, 1), light),
                                  ((0, 0, -1), (1, 0, 0), (0, 1, 0), white),
                                  ((-1, 0, 0), (0, 0, 1), (0, 1, 0), red),
                                  ((0, 0, 0.3), (0.5, 0, 0), (0, 0.5, 0), glass)):
        p, i, n, t = quad(center, uax, vax)
        b.add_mesh_node(p, i, mat, normals=n, texcoords=t * 2)
    b.add_camera_node((0, 0, 3.2), (0, 0, 0), yfov=0.9, name="c")
    return b.write_gltf(path)


def sharded_same(scene, cam, cfg, mesh, what, want):
    """One frame through render_scene_sharded over ``mesh`` as a CUDA graph
    replay (its third frame: warm-up, capture, replay) against
    render_scene and against the eager sharded frame (graph=False):
    bit-identical images and equal segments; the launch counts of the
    eager frame and of the replay (each set to 0 just before it, read just
    after) printed and equal, and each kernel of ``want`` launched at
    least once; each device's graph pool.  Returns the pools in bytes."""
    import numpy as np

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.parallel import sharding
    from zig_raytracing_contest_tpu_torch.render.pipeline import frame_graph, render_scene

    img_s, st_s = render_scene(scene, cam, cfg)
    got = {}
    for graph in (False, True):
        for _ in range(2 if graph else 0):  # the graph's warm-up and capture
            sharding.render_scene_sharded(scene, cam, cfg, mesh)
        kernels.reset_launches()
        img_m, st_m = sharding.render_scene_sharded(scene, cam, cfg, mesh, graph=graph)
        got[graph] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        same = img_m.shape == img_s.shape and bool(np.array_equal(img_m, img_s))
        if not graph:
            img_e, st_e = img_m, st_m
        else:
            same &= bool(np.array_equal(img_m, img_e)) and st_m.segments == st_e.segments
        if not same or st_m.segments != st_s.segments:
            fail(f"{what}: the sharded frame (graph {graph}) differs from render_scene")
    plans = sharding.device_plans(scene, cam, cfg, mesh)
    graphs = {d: frame_graph(sharding.replica(scene, d), p) for d, p in plans.items()}
    pools = {str(d): g.pool_bytes for d, g in graphs.items()}
    print(f"  {what} over {len(mesh)} tile(s) on {sorted({str(d) for d in mesh})}: graph "
          f"replay bit-identical to render_scene and to the eager sharded frame True, "
          f"segments {st_m.segments} vs {st_s.segments}, launches replay {got[True]}, "
          f"eager {got[False]}; pool per card "
          f"{ {d: f'{b / 2**20:.1f} MiB' for d, b in pools.items()} }")
    if any(g.replay is None for g in graphs.values()):
        fail(f"{what}: a card's sharded frame is not a CUDA graph replay")
    if got[True] != got[False]:
        fail(f"{what}: the replay launched {got[True]}, the eager frame {got[False]}")
    for name in want:
        if not got[True].get(name):
            fail(f"{what}: the sharded frame launched no {name}")
    return pools


def finish_check(scene, cam, cfg, card) -> None:
    """sharding.finish_frame, which ends a frame over several distinct
    cards on the first one: on one card it is never on the sharded path
    (the encode is in the card's graph), so the 4-tile plan's waves are
    rendered without their encode and finished by it as if from four
    cards (no peer copy), bit for bit against render_scene; its ms by CUDA
    events."""
    import dataclasses

    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch.parallel import sharding
    from zig_raytracing_contest_tpu_torch.render import pipeline
    from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    mesh = (scene.device,) * 4
    plan = dataclasses.replace(sharding.device_plans(scene, cam, cfg, mesh)[scene.device],
                               encode=False)
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    outs = {scene.device: pipeline._render_frame_waves(scene, plan, par, None, ext=plan.ext)}
    perm = pipeline.device_slot_map(scene, plan.width, plan.height, plan.tiles_x)
    img, tally = pipeline.image_to_host(*sharding.finish_frame(outs, mesh, plan, perm), plan)
    want, st = pipeline.render_scene(scene, cam, cfg)
    same = bool(np.array_equal(img, want)) and tally[0] == st.segments
    ms = cuda_ms(lambda: sharding.finish_frame(outs, mesh, plan, perm), 20)
    print(f"  finish_frame on the first device (4 tiles' {plan.tile_slots} slots gathered, "
          f"permuted, encoded; no peer copy): {ms:.4f} ms (CUDA events, mean of 20), "
          f"bit-identical to render_scene {same} ({card})")
    if not same:
        fail("finish_frame's image differs from render_scene's")
    del outs
    torch.cuda.empty_cache()


def sharding_phases(card, path, scene, cam, cfg) -> None:
    """Phase m: multi-device pixel tiling, the graft entry points, the
    native grid builder and the CPU tracer.  ``path``: the bench scene's
    file; ``scene``, ``cam``, ``cfg``: the official frame's."""
    import os

    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch import cli, graft_entry
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.grid.builder import build_grid
    from zig_raytracing_contest_tpu_torch.grid.native import build_grid_native
    from zig_raytracing_contest_tpu_torch.grid.native import load_library as grid_library
    from zig_raytracing_contest_tpu_torch.ops.linalg import vec3_to_rgb
    from zig_raytracing_contest_tpu_torch.parallel.sharding import (
        make_mesh,
        render_scene_sharded,
    )
    from zig_raytracing_contest_tpu_torch.render.native_cpu import load_library, render_cpu
    from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
    from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
    from zig_raytracing_contest_tpu_torch.scene.procedural import cornell_like_box, large_scene

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    cards = make_mesh()
    print(f"phase m: make_mesh() = {[str(d) for d in cards]}")

    # (1) the official frame over every card, and over 3 and 4 tiles on cuda:0
    meshes = {"make_mesh()": cards, "3 tiles": (dev,) * 3, "4 tiles": (dev,) * 4}
    for what, mesh in meshes.items():
        sharded_same(scene, cam, cfg, mesh, f"official {what}",
                     ("path_trace_gen", "path_trace"))
    finish_check(scene, cam, cfg, card)
    # timed in turns: render_scene, the sharded graphs, the eager 4 tiles;
    # a warmup each, then 5 rounds
    runs = {"render_scene": lambda: render_scene(scene, cam, cfg),
            "sharded make_mesh() graph": lambda: render_scene_sharded(scene, cam, cfg, cards),
            "sharded 4 tiles graph": lambda: render_scene_sharded(scene, cam, cfg, (dev,) * 4),
            "sharded 4 tiles eager": lambda: render_scene_sharded(scene, cam, cfg, (dev,) * 4,
                                                                  graph=False)}
    rates = {k: [] for k in runs}
    for fn in runs.values():
        fn()
    for _ in range(5):
        for k, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = fn()
            torch.cuda.synchronize()
            rates[k].append(st.segments / (time.perf_counter() - t0) / 1e6)
    for k, r in rates.items():
        med = statistics.median(r)
        print(f"  official {k}: median {med:.3f} Mrays/s, best {max(r):.3f}, spread "
              f"{(max(r) - min(r)) / med * 100:.1f}% ({card})")
        print("    reps Mrays/s: " + ", ".join(f"{x:.3f}" for x in r))

    # (2) the --large frame over 3 tiles
    lpath = large_scene(Path(tmp.name) / "large.gltf")
    lcfg = Config(num_samples=L_SPP, max_bounce=L_BOUNCES, wave_size=L_WAVE, seed=SEED)
    lscene, lcam, _ = prepare_scene(str(lpath), lcfg, camera_name="Camera 1", width=L_W,
                                    height=L_H, device=dev)
    sharded_same(lscene, lcam, lcfg, (dev,) * 3, "--large", ("trace_emit", "shade"))
    del lscene

    # (3) the Cornell box with the extensions, grid and MXU bake, over 4 tiles
    box = cornell_like_box(Path(tmp.name) / "box.gltf")
    for backend, want in (("grid", ("grid_walk",)), ("mxu", ("trace_emit",))):
        ecfg = Config(num_samples=2, max_bounce=MAX_BOUNCE, seed=SEED, backend=backend,
                      nee=True, russian_roulette=True, pbr=True)
        escene, ecam, _ = prepare_scene(str(box), ecfg, width=320, height=180, device=dev)
        sharded_same(escene, ecam, ecfg, (dev,) * 4, f"Cornell 320x180 nee+rr+pbr, {backend}",
                     want)

    # (4) --devices above the visible cards: the clean error of make_mesh
    cfg_path = Path(tmp.name) / "config.json"
    cfg_path.write_text(json.dumps({"grid_resolution": [8, 8, 8], "num_threads": None,
                                    "num_samples": 1, "max_bounce": 2}))
    too_many = torch.cuda.device_count() + 1
    try:
        cli.main(["--in", str(box), "--out", str(Path(tmp.name) / "o.png"), "--width", "16",
                  "--height", "16", "--config", str(cfg_path), "--devices", str(too_many)])
        fail(f"--devices {too_many} rendered")
    except ValueError as exc:
        print(f"  cli --devices {too_many}: ValueError: {exc}")
        if "visible" not in str(exc):
            fail("--devices above the visible cards: not make_mesh's error")

    # (5) the graft entry points on the card
    from zig_raytracing_contest_tpu_torch import kernels

    kernels.reset_launches()
    step, args = graft_entry.entry()
    rows3, segs = step(*args)
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    cstep, cargs = graft_entry.entry(device="cpu")
    crows3, csegs = cstep(*cargs)
    diff = (vec3_to_rgb(rows3.T).cpu().numpy().astype(int)
            - vec3_to_rgb(crows3.T).numpy().astype(int))
    diff = np.abs(diff)
    print(f"  graft_entry.entry() step on {rows3.device}: rows {tuple(rows3.shape)}, segments "
          f"{int(segs)} (CPU twins {int(csegs)}), diff>2 on {(diff > 2).mean():.4%} of "
          f"channels, mean |diff| {diff.mean():.4f}, launches {got}")
    if (tuple(rows3.shape) != (3, 1024) or not bool(torch.isfinite(rows3).all())
            or not (diff > 2).mean() < 0.06 or not diff.mean() < 1.5
            or abs(int(segs) - int(csegs)) > 0.005 * int(csegs) or not got.get("path_trace_gen")):
        fail("graft_entry.entry()'s step on the card")
    kernels.reset_launches()
    graft_entry.dryrun_multichip(4)
    print(f"  graft_entry.dryrun_multichip(4): ok, launches "
          f"{ {k: v for k, v in kernels.LAUNCHES.items() if v} }")

    # (6) the native grid builder against NumPy on the --large terrain, 128³
    positions = load_geometry(load_gltf(str(lpath))).positions
    gl = grid_library()
    t0 = time.perf_counter()
    a = build_grid(positions, G_RES)
    t_numpy = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = build_grid_native(positions, G_RES)
    t_native = time.perf_counter() - t0
    same = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "bbox_min", "bbox_max", "resolution", "cell_size", "cell_begin", "cell_end",
        "dup_to_tri")) and a.stats == b.stats
    threads = len(os.sched_getaffinity(0))
    print(f"  grid build --large {G_RES}: native {t_native:.3f} s, NumPy {t_numpy:.3f} s "
          f"({t_numpy / t_native:.1f}x), D {b.stats['total_refs']}, equal arrays {same}; "
          f"OpenMP build {gl.openmp}, os.cpu_count() {os.cpu_count()}, usable cores {threads}")
    if not same:
        fail("the native grid builder differs from the NumPy builder")
    del a, b, positions

    # (7) the --cpu row of bench.py: the bench scene's grid at 128³, a warmup
    # at 1 spp and 1 bounce, then the official frame
    tl = load_library()
    gcfg = Config(grid_resolution=G_RES, num_samples=SPP, max_bounce=MAX_BOUNCE, seed=SEED,
                  backend="grid")
    gscene, gcam, _ = prepare_scene(str(path), gcfg, camera_name="Camera 1", width=1920,
                                    height=1080, device=dev)
    render_cpu(gscene, gcam, spp=1, max_bounce=1)
    img, segments, seconds = render_cpu(gscene, gcam, spp=SPP, max_bounce=MAX_BOUNCE)
    print(f"  --cpu row: " + json.dumps({
        "metric": "cpu_Mrays/s", "value": segments / seconds / 1e6, "unit": "Mrays/s",
        "threads": os.cpu_count(), "usable_cores": threads, "openmp": tl.openmp,
        "segments": segments, "seconds": seconds}))
    if img.shape != (1080, 1920, 3) or not segments > 0:
        fail("the CPU tracer's official frame")
    del gscene

    # (8) the CPU tracer against the card's grid render, 160x90, under
    # tests/test_native_tracer.py's gates
    tpath = textured_box(Path(tmp.name) / "t.gltf")
    tcfg = Config(grid_resolution=(8, 8, 8), num_samples=4, max_bounce=4, seed=11,
                  backend="grid")
    tscene, tcam, _ = prepare_scene(str(tpath), tcfg, camera_name="c", width=160, height=90,
                                    device=dev)
    img_g, st_g = render_scene(tscene, tcam, tcfg)
    img_c, seg_c, _ = render_cpu(tscene, tcam, spp=4, max_bounce=4, seed=11)
    diff = np.abs(img_g.astype(int) - img_c.astype(int))
    frac, mean = float((diff > 2).mean()), float(diff.mean())
    print(f"  render_cpu vs the card's grid render, textured box 160x90: diff>2 on "
          f"{frac:.4%} of channels, mean |diff| {mean:.4f}, segments {seg_c} vs "
          f"{st_g.segments}")
    if not (frac < 0.02 and mean < 1.0
            and abs(seg_c - st_g.segments) <= max(8, st_g.segments // 1000)):
        fail("the CPU tracer and the card's grid render disagree beyond the gates")
    tmp.cleanup()
    print(f"phase m: {time.perf_counter() - t_phase:.1f} s")


def bench_phases(card, errs) -> None:
    """Phase n: the port's bench (bench.measure) on its official, Sponza
    and 2M rows; Sponza's 160x90 frame and a 160x90 500k frame with NEE and
    Russian roulette (the XLA shading path over the streaming bake),
    kernels vs twins and graph vs eager; trace_stream_kernel against its twin on the 2M
    terrain's bounce-0 and sorted bounce-1 waves."""
    import torch

    from zig_raytracing_contest_tpu_torch import bench, kernels
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as mi
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import (
        backend_line,
        prepare_scene,
        render_scene,
    )
    from zig_raytracing_contest_tpu_torch.scene.procedural import large_scene

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)

    def bake_line(name, p, write_s):
        s, ph = p.scene, p.phases
        print(f"  {name}: {s.shade_table.shape[0]} triangles, tri_data "
              f"{tuple(s.tri_data.shape)}, tile {s.tile}, tiles {s.tile_bbox.shape[1]}, "
              f"groups {s.group_bbox.shape[1]}, group_tree_bbox "
              f"{tuple(s.group_tree_bbox.shape)}, texels {s.bank.shape[0]}, "
              f"{backend_line(s)}, camera {p.camera.width}x{p.camera.height}; written in "
              f"{write_s:.2f} s, loaded in {ph['load'] + ph['preprocess']:.2f} s, "
              f"baked in {ph['compile']:.2f} s")
        if wf.regime(s) != "streaming, sorted":
            fail(f"{name} renders {wf.regime(s)}, expected streaming, sorted")

    # (1) the official row, as the bench runs it (5 timed frames)
    print("bench: " + json.dumps(bench.measure(bench.ROW["official"], dev)))

    # (2) Sponza: the row at BIG_REPS timed frames, then its 160x90 frame
    # with the kernels and with the twins under the alpha-scene gates
    row = bench.ROW["sponza"]
    path, write_s = bench.write_scene(row, d)
    prep = bench.prepare(row, dev, path)
    bake_line("Sponza", prep, write_s)
    print(f"bench ({BIG_REPS} timed frames): "
          + json.dumps(bench.measure(row, dev, reps=BIG_REPS, prepared=prep)))
    del prep
    small = bench.prepare(row, dev, path, height=90)
    if (small.camera.width, small.camera.height) != (160, 90):
        fail(f"Sponza's camera at height 90 gives {small.camera.width}x90")
    frame_gate(render_scene, small.scene, small.camera, small.config, "Sponza frame 160x90")
    del small
    torch.cuda.empty_cache()

    # (3) the 2M terrain: the row at BIG_REPS timed frames, then
    # trace_stream_kernel against its twin on M2_LANES lanes spread over
    # the frame's bounce-0 wave and its sorted bounce-1 wave
    row = bench.ROW["2m"]
    path, write_s = bench.write_scene(row, d)
    prep = bench.prepare(row, dev, path)
    bake_line("2M terrain", prep, write_s)
    leaves = prep.scene.group_tree_bbox.shape[1] // 2
    if leaves > 1 << kernels.TREE_STACK:
        fail(f"2M terrain: a group heap of {leaves} leaves is past the walk's stack")
    print(f"bench ({BIG_REPS} timed frames): "
          + json.dumps(bench.measure(row, dev, reps=BIG_REPS, prepared=prep)))
    s, cam = prep.scene, prep.camera
    full = cam.width * cam.height * row.spp
    (st0, a0, i0, r0, _), (st1, prev1, a1, i1, r1, _) = bounce_waves(s, cam, full, row.spp,
                                                                     SEED)
    torch.cuda.synchronize()
    lane = torch.arange(M2_LANES, device=dev) * (full // M2_LANES)
    for bounce, st, prev, (a, i, r) in ((0, st0, None, (a0, i0, r0)),
                                        (1, st1, prev1, (a1, i1, r1))):
        st_l = st[:, lane].contiguous()
        pv = None if prev is None else prev[lane].contiguous()
        t0 = time.perf_counter()
        twin = mi.trace_emit_aux_ref(s, st_l, s.rec_table, pv)
        twin_s = time.perf_counter() - t0
        errs["trace_stream"] = max(errs["trace_stream"], compare_trace(
            f"trace_emit_aux (2M terrain, full wave, bounce {bounce}"
            f"{', sorted, prev' if bounce else ''}, {M2_LANES} lanes; twin {twin_s:.1f} s)",
            s, st_l, pv, (a[:, lane], i[lane], r[:, lane]), twin))
    del prep, s, st0, st1, a0, a1, r0, r1, st_l, twin
    torch.cuda.empty_cache()

    # (4) the XLA shading path over a streaming bake: the 500k terrain at
    # 160x90 with NEE and Russian roulette, kernels vs twins; its nearest
    # hits and shadow rays launch trace_stream_kernel with records off
    path = large_scene(d / "large500.gltf", side=S_SIDE)
    cfg = Config(num_samples=L_SPP, max_bounce=L_BOUNCES, seed=SEED, nee=True,
                 russian_roulette=True)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=160,
                                  height=90, device=dev)
    reg = wf.regime(scene, cfg.ext_flags)
    print(f"  500k with nee, russian_roulette: {backend_line(scene, cfg.ext_flags)}")
    if reg != "XLA shading, group heap":
        fail(f"500k with nee, russian_roulette renders {reg}, expected XLA shading, "
             "group heap")
    kernels.reset_launches()
    frame_gate(render_scene, scene, cam, cfg, "500k nee+rr frame 160x90")
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"  500k nee+rr frame 160x90: launches {got} ({card})")
    if set(got) != {"trace_stream"}:
        fail("the streaming NEE/RR frame did not run on trace_stream_kernel alone")
    graph_ab("500k nee+rr 160x90", scene, cam, cfg, card, 1)
    tmp.cleanup()
    print(f"phase n: {time.perf_counter() - t_phase:.1f} s")


def key_check(what, scene, state) -> None:
    """ray_sort_key_kernel against ray_sort_key_ref on ``state``: every
    lane's key bit for bit."""
    from zig_raytracing_contest_tpu_torch.render.wavefront import ray_sort_key, ray_sort_key_ref

    off = int((ray_sort_key(scene, state) != ray_sort_key_ref(scene, state)).sum())
    print(f"  ray_sort_key_kernel vs ray_sort_key_ref, {what}: {off} of {state.shape[1]} "
          f"lanes differ ({int((state[12] > 0).sum())} live)")
    if off:
        fail(f"ray_sort_key_kernel differs from its twin on the {what}")


def whole_path_bounce1(scene, cam, cfg):
    """The middle wave of a whole-path frame after bounce 1 on the card's
    kernels (gen, sort on the emitted key, bounce 1): the mid resort's
    input (the first waves of the official frame are sky: every ray dead
    after bounce 0)."""
    import torch

    from zig_raytracing_contest_tpu_torch.render import fused, pipeline
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        sort_state_payload,
    )

    plan = pipeline.frame_plan(scene, cam, cfg)
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(spp=plan.spp, width=plan.width, img_w=plan.width,
                          img_h=plan.height, tiles_x=plan.tiles_x)
    slot_base = plan.num_waves // 2 * plan.wave_pixels
    y_base, x_base = divmod(slot_base, plan.width)
    meta = (slot_base, x_base, y_base, cfg.seed & 0xFFFFFFFF, slot_base // 1024, 0, 0, 0)
    st, idx = fused.path_trace_gen(scene, par, meta, plan.wave_size, 1, gen, emit_key=True,
                                   emit_idx=True)
    _, st, (idx,) = sort_state_payload(st[15].contiguous().view(torch.int32), st, (idx,))
    return fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx)


def profiled_frame(scene, cam, cfg, graph: bool) -> dict:
    """One frame under torch.profiler: its wall, the device's busy time (None
    where the profiler saw no device time), the device operations and the
    CUDA launch calls the host made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zig_raytracing_contest_tpu_torch.render import pipeline

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.render_scene(scene, cam, cfg, graph=graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    device = [e for e in avg if str(e.device_type).endswith("CUDA") and e.device_time_total > 0
              and not e.key.startswith("zrc.")]  # the program's ranges span kernels
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                "cudaGraphLaunch"))
    return {"profiled_wall_ms": wall,
            "device_busy_ms": sum(e.device_time_total for e in device) / 1e3 if device else None,
            "device_ops": sum(e.count for e in device), "host_launch_calls": launches}


def graph_ab(what, scene, cam, cfg, card, rounds: int, cam2=None) -> dict:
    """A frame as one CUDA graph against the eager wave loop (graph=False)
    on the card: the graph's frames (warm-up, capture, replays) bit for bit
    against the eager frame, image and segments; kernels.LAUNCHES after 2
    graph frames as after 2 eager ones; with ``cam2``, another camera
    through the same cache entry; ``rounds`` of (eager, graph, graph,
    eager) walls; one profiled frame of each (device busy, idle share); the
    graph's pool bytes.  Returns the numbers printed."""
    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import pipeline

    def frame(graph, c=cam):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, st = pipeline.render_scene(scene, c, cfg, graph=graph)
        torch.cuda.synchronize()
        return img, st.segments, (time.perf_counter() - t0) * 1e3

    plan = pipeline.frame_plan(scene, cam, cfg)
    if not pipeline.graph_route(scene, cfg.ext_flags):
        fail(f"{what}: the frame does not take the graph route")
    want_img, want_segs, _ = frame(False)
    same = True
    for _ in range(3):  # warm-up, capture and replay, replay
        img, segs, _ = frame(True)
        same &= bool(np.array_equal(img, want_img)) and segs == want_segs
    entry = pipeline.frame_graph(scene, plan)
    if entry.replay is None:
        fail(f"{what}: no CUDA graph was captured")
    counts = {}
    for graph in (False, True):
        kernels.reset_launches()
        frame(graph)
        frame(graph)
        counts[graph] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    out = {"what": what, "waves": plan.num_waves, "wave": plan.wave_size,
           "bit_identical": same, "launches_2_frames": counts[True],
           "pool_bytes": entry.pool_bytes, "card": card}
    if cam2 is not None:
        img2_e, segs2_e, _ = frame(False, cam2)
        img2_g, segs2_g, _ = frame(True, cam2)
        img1_g, segs1_g, _ = frame(True)
        out["second_camera_bit_identical"] = (
            bool(np.array_equal(img2_g, img2_e)) and segs2_g == segs2_e
            and bool(np.array_equal(img1_g, want_img)) and segs1_g == want_segs
            and not np.array_equal(img2_e, want_img))
        same &= out["second_camera_bit_identical"]
    walls = {False: [], True: []}
    for _ in range(rounds):
        for graph in (False, True, True, False):
            walls[graph].append(frame(graph)[2])
    for graph, name in ((False, "eager"), (True, "graph")):
        prof = profiled_frame(scene, cam, cfg, graph)
        wall = statistics.median(walls[graph])
        out[name] = {"walls_ms": walls[graph], "wall_ms": wall,
                     "mrays_s": want_segs / wall / 1e3,
                     "device_busy_ms": prof["device_busy_ms"],
                     "idle_share": (None if prof["device_busy_ms"] is None
                                    else 1.0 - prof["device_busy_ms"] / wall),
                     "profiled_wall_ms": prof["profiled_wall_ms"],
                     "device_ops": prof["device_ops"],
                     "host_launch_calls": prof["host_launch_calls"]}
    e, g = out["eager"], out["graph"]
    print(f"  {what}: {plan.num_waves} wave(s) of {plan.wave_size} rays; graph frames "
          f"bit-identical to eager {same}; eager {e['wall_ms']:.2f} ms (busy "
          f"{e['device_busy_ms']} ms, idle {e['idle_share']}), graph {g['wall_ms']:.2f} ms "
          f"(busy {g['device_busy_ms']} ms, idle {g['idle_share']}); pool "
          f"{entry.pool_bytes / 2**20:.1f} MiB; launches over 2 frames {counts[True]} ({card})")
    print("  frame_ab: " + json.dumps(out))
    if not same:
        fail(f"{what}: the graph's frame differs from the eager frame")
    if counts[True] != counts[False]:
        fail(f"{what}: launches after 2 graph frames {counts[True]}, after 2 eager "
             f"frames {counts[False]}")
    return out


def frame_phases(card, timing, errs, bounds, official) -> None:
    """Phase o: the whole-frame device call (one CUDA graph a frame) and
    ray_sort_key_kernel.  ``official``: the official frame's (scene,
    camera, config)."""
    import dataclasses

    import numpy as np
    import torch

    from zig_raytracing_contest_tpu_torch import bench, kernels
    from zig_raytracing_contest_tpu_torch.probes import sort_key
    from zig_raytracing_contest_tpu_torch.render.pipeline import render_scene
    from zig_raytracing_contest_tpu_torch.render.wavefront import ray_sort_key, ray_sort_key_ref
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms, queued_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    scene, cam, cfg = official
    errs["ray_sort_key"] = 0.0

    duck_row = bench.ROW["duck"]
    duck_path, _ = bench.write_scene(duck_row, d)
    dk = bench.prepare(duck_row, dev, duck_path)

    # (1) ray_sort_key_kernel: the official and Duck waves after bounce 1,
    # the built NaN lanes, times at the full official wave
    s1 = whole_path_bounce1(scene, cam, cfg)
    torch.cuda.synchronize()
    key_check("official wave after bounce 1", scene, s1)
    key_check("Duck wave after bounce 1", dk.scene, whole_path_bounce1(dk.scene, dk.camera,
                                                                      dk.config))
    for label, lanes, n in sort_key.run_host_key_checks(dev):
        print(f"  ray_sort_key_kernel vs ray_sort_key_ref, {label}: {n} of {lanes} lanes "
              f"differ")
        if n:
            fail(f"ray_sort_key_kernel differs from its twin on the {label}")
    R = s1.shape[1]
    k_ms = queued_ms(lambda: ray_sort_key(scene, s1), 200)
    p_ms = cuda_ms(lambda: ray_sort_key_ref(scene, s1), 10)
    timing["ray_sort_key"] = (k_ms, p_ms, R, R)
    bounds["ray_sort_key"] = (R * 32 / PEAK_BYTES * 1e3, "bytes")
    kernels.reset_launches()
    render_scene(scene, cam, cfg, graph=False)
    per_frame = kernels.LAUNCHES["ray_sort_key"]
    print(f"  ray_sort_key_kernel at the official wave ({R} rays): {k_ms:.4f} ms (queued "
          f"behind a spin), twin {p_ms:.3f} ms, bound {bounds['ray_sort_key'][0]:.4f} ms "
          f"(bytes); {per_frame} launches a frame ({card})")

    # (2) graph against eager: official (and a second camera), Duck
    cam2 = dataclasses.replace(cam, origin=cam.origin + np.float32([0.4, -0.2, 0.3]))
    graph_ab("official", scene, cam, cfg, card, 5, cam2=cam2)
    graph_ab("Duck", dk.scene, dk.camera, dk.config, card, 5)
    del dk, s1
    torch.cuda.empty_cache()

    # (3) the per-bounce rows: --large (the key at its wave, graph against
    # eager), the 500k wave after bounce 1, 2M and Sponza (graph against
    # eager, the A/B)
    row = bench.ROW["large"]
    p = bench.prepare(row, dev, bench.write_scene(row, d)[0])
    full = p.camera.width * p.camera.height * row.spp
    (_, _, _, _, s0), (_, _, _, _, _, s1) = bounce_waves(p.scene, p.camera, full, row.spp,
                                                         p.config.seed)
    key_check("--large wave after bounce 1", p.scene, s1)
    lk_ms = queued_ms(lambda: ray_sort_key(p.scene, s1), 50)
    lp_ms = cuda_ms(lambda: ray_sort_key_ref(p.scene, s1), 5)
    kernels.reset_launches()
    render_scene(p.scene, p.camera, p.config, graph=False)
    print(f"  ray_sort_key_kernel at the --large wave ({full} rays): {lk_ms:.4f} ms, twin "
          f"{lp_ms:.3f} ms, bound {full * 32 / PEAK_BYTES * 1e3:.4f} ms (bytes); "
          f"{kernels.LAUNCHES['ray_sort_key']} launches a frame ({card})")
    del s0, s1
    graph_ab("--large", p.scene, p.camera, p.config, card, 1)
    del p
    torch.cuda.empty_cache()
    row = bench.ROW["500k"]
    p = bench.prepare(row, dev, bench.write_scene(row, d)[0])
    full = p.camera.width * p.camera.height * row.spp
    (_, _, _, _, s0), (_, _, _, _, _, s1) = bounce_waves(p.scene, p.camera, full, row.spp,
                                                         p.config.seed)
    key_check("500k wave after bounce 1", p.scene, s1)
    del p, s0, s1
    torch.cuda.empty_cache()
    for name, rounds in (("2m", 10), ("sponza", 5), ("grid_large", 3), ("large_ext", 3)):
        row = bench.ROW[name]
        p = bench.prepare(row, dev, bench.write_scene(row, d)[0])
        graph_ab(name, p.scene, p.camera, p.config, card, rounds)
        del p
        torch.cuda.empty_cache()
    tmp.cleanup()
    print(f"phase o: {time.perf_counter() - t_phase:.1f} s")


def shaded_trace_check(what, scene, cam, cfg, card, rounds: int = SHADED_ROUNDS):
    """The frame's first wave through the bake's shaded trace as the main
    path runs it (wavefront.render_wave_shaded_trace at the frame plan's
    wave size) against render_wave_xla on the same inputs: radiance and
    segment bits and the eight work counters exactly, else the run fails.
    Each of its 2B launches is timed by CUDA events (medians of ``rounds``
    waves after a warmup), render_wave_xla's wave once after a warmup.
    Returns ((the wave's ms, render_wave_xla's ms, rays, rays), the wave's
    bound from its counters)."""
    import torch

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import frame_plan

    ext = cfg.ext_flags
    if not wf.shaded_trace(scene, ext, False):
        fail(f"{what}: the wave does not take the shaded trace")
    R, B, spp = frame_plan(scene, cam, cfg).wave_size, cfg.max_bounce, cfg.num_samples
    par = wf.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    launch, ev = kernels.launch_trace_shaded, []

    def timed_launch(*args, **kw):  # events around each launch of the wave
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        launch(*args, **kw)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    counts = torch.zeros(len(wf.WORK_COUNTERS), dtype=torch.int64, device=par.device)
    ms = [[] for _ in range(2 * B + 1)]
    kernels.launch_trace_shaded = timed_launch
    try:
        for r in range(rounds + 1):
            ev.clear()
            counts.zero_()
            rows4 = wf.render_wave_shaded_trace(scene, par, cam.width, spp, B, 0, R, cfg.seed,
                                                ext, counts)
            torch.cuda.synchronize()
            if len(ev) != 4 * B:
                fail(f"{what}: the wave made {len(ev) // 2} launches, not {2 * B}")
            if r:  # the first wave is the warmup
                for k in range(2 * B):
                    ms[k].append(ev[2 * k].elapsed_time(ev[2 * k + 1]))
                ms[-1].append(ev[0].elapsed_time(ev[-1]))
    finally:
        kernels.launch_trace_shaded = launch
    med = [statistics.median(x) for x in ms]
    want_counts = torch.zeros_like(counts)
    for _ in range(2):  # a warmup, then the timed wave
        want_counts.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = wf.render_wave_xla(scene, par, cam.width, spp, B, 0, R, cfg.seed, ext,
                                  counts=want_counts)
        e1.record()
        torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    off = int((rows4.view(torch.int32) != want.view(torch.int32)).any(dim=0).sum())
    c = [int(x) for x in counts.tolist()]
    # the least work of the wave: each traced ray's tiles swept × tile
    # triangles and boxes tested, both traces, and one surface shade a
    # nearest ray; bytes: the bake once, the primary rays and the radiance
    # and segments once, each lane's flags at every launch
    b = bound((c[1] + c[5]) * scene.tile * OPS_TRI + (c[2] + c[6]) * OPS_BOX
              + c[0] * OPS_SHADE,
              scene.tri_data.numel() * 4 + R * (12 + 8 + 16) + 2 * B * R)
    print(f"  {what}: the shaded trace's wave ({R} rays, {B} bounces) vs render_wave_xla: "
          f"{off} lanes differ (radiance and segment bits); launch ms (nearest, shadow a "
          f"bounce) {[round(x, 4) for x in med[:-1]]}, the wave {med[-1]:.4f} ms (medians "
          f"of {rounds}), render_wave_xla {plain_ms:.3f} ms; bound {b[0]:.4f} ms ({b[1]}), "
          f"{b[0] / med[-1]:.1%} of it ({card})", flush=True)
    held_counts(f"{what}: the shaded trace's wave", c, want_counts.tolist())
    if off:
        fail(f"{what}: the shaded trace's wave differs from render_wave_xla's")
    return (med[-1], plain_ms, R, R), b


def ext_cell_phases(card, timing, errs, bounds, launches) -> None:
    """Phase p: the benchmark's EXT_CELL frame, through the shaded
    trace_stream_kernel."""
    import torch

    from pathbench import harness, spec
    from pathbench.scenes import scene_file
    from zig_raytracing_contest_tpu_torch.render import wavefront as wf
    from zig_raytracing_contest_tpu_torch.render.pipeline import (
        backend_line,
        prepare_scene,
        render_scene,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    cell = spec.load_workload(EXT_CELL)
    tr = cell.traffic
    cfg = harness.program_config(tr, SEED)
    t0 = time.perf_counter()
    path = scene_file(cell.config, Path(tmp.name))
    write_s = time.perf_counter() - t0
    scene, cam, timers = prepare_scene(str(path), cfg, cell.config["camera"], tr.width,
                                       tr.height, device=dev)
    reg = wf.regime(scene, cfg.ext_flags)
    print(f"phase p: {EXT_CELL}: {cell.config['name']} written in {write_s:.2f} s, "
          f"{scene.tri_data.shape[1]} padded triangles, {scene.lights.tri.numel()} light "
          f"triangles, {cam.width}x{cam.height}, {cfg.num_samples} spp, {cfg.max_bounce} "
          f"bounces, {', '.join(tr.extensions)}; {backend_line(scene, cfg.ext_flags)}; "
          f"scene phases {timers.phases}")
    if reg != "XLA shading, group heap":
        fail(f"{EXT_CELL} renders {reg}, expected XLA shading, group heap")
    ptxas_no_spill(tuple(f"{k}_kernelILi{f}E" for k in ("trace_stream", "trace_emit")
                         for f in (1, 2)), "a shaded trace")
    timing["trace_stream_shaded"], bounds["trace_stream_shaded"] = shaded_trace_check(
        EXT_CELL, scene, cam, cfg, card)
    errs["trace_stream_shaded"] = 0.0  # every bit equal, or the run failed
    got = render_timed(render_scene, scene, cam, cfg, EXT_CELL, card,
                       {"trace_stream": 6 * 2 * cfg.max_bounce})
    if {k for k, n in got.items() if n} != {"trace_stream"}:
        fail(f"{EXT_CELL}: the frame launched {got}, not trace_stream_kernel alone")
    launches["trace_stream_shaded"] = got["trace_stream"]
    profile_frame(render_scene, scene, cam, cfg, card)
    tmp.cleanup()
    print(f"phase p: {time.perf_counter() - t_phase:.1f} s")


def official_frame(render_scene, scene, cam, cfg, card) -> dict:
    """Phase 6: the official frame through the main path, a warmup and 5
    timed renders; returns the launch counts of the 6 renders."""
    from zig_raytracing_contest_tpu_torch.render.pipeline import slot_geometry

    num_slots, _ = slot_geometry(1920, 1080, True)
    full_wave = WAVE // (SPP * 1024) * (SPP * 1024)
    num_waves = -(-num_slots * SPP // full_wave)
    got = render_timed(render_scene, scene, cam, cfg, "official", card,
                       {"path_trace_gen": 6 * num_waves, "ray_sort_key": 6 * num_waves})
    if got["path_trace"] == 0:
        fail("path_trace: the main path launched no kernel")
    print(f"  waves {num_waves} of {full_wave} rays")
    return got


def main() -> int:
    import torch

    t_start = time.perf_counter()
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    from zig_raytracing_contest_tpu_torch.bench import card_line

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from zig_raytracing_contest_tpu_torch import kernels
    from zig_raytracing_contest_tpu_torch.config import Config
    from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import nearest_hit_ref
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.pipeline import (
        prepare_scene,
        render_scene,
        slot_geometry,
    )
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        ray_sort_key,
        sort_state_payload,
    )
    from zig_raytracing_contest_tpu_torch.scene.procedural import bench_scene
    from zig_raytracing_contest_tpu_torch.utils.timing import cuda_ms

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    kernels.load()
    kernels.load_probes()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc " + ", ".join(
        f"{name} {b['seconds']:.2f} s" for name, b in kernels.BUILD_INFO.items()) + ")")
    for b in kernels.BUILD_INFO.values():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())

    # 3. the bench scene, through the port
    tmp = tempfile.TemporaryDirectory()
    path = bench_scene(Path(tmp.name) / "bench.gltf")
    cfg = Config(grid_resolution=(128, 128, 128), num_samples=SPP,
                 max_bounce=MAX_BOUNCE, wave_size=WAVE, seed=SEED)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=1920, height=1080, device=dev)
    print(f"scene: tri_data {tuple(scene.tri_data.shape)}, tiles "
          f"{scene.tile_bbox.shape[1]}, texels {scene.bank.shape[0]}, "
          f"emissive_dummy {scene.emissive_dummy}")

    # 4. kernels vs twins on the card
    whole_path_ptxas()
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    _, tiles_x = slot_geometry(1920, 1080, True)
    gen = fused.GenParams(spp=SPP, width=1920, img_w=1920, img_h=1080,
                          tiles_x=tiles_x)
    quantum = SPP * 1024
    full_wave = WAVE // quantum * quantum
    errs = {"path_trace_gen": 0.0, "path_trace": 0.0, "path_trace_b23": 0.0}
    timing, bounds = {}, {}
    for R, slot_base in ((1 << 16, 1024 * 900), (full_wave, 5 * (full_wave // SPP))):
        meta = (slot_base, slot_base % 1920, slot_base // 1920, SEED,
                slot_base // 1024, 0, 0, 0)
        args = (scene, par, meta, R, 1, gen)
        # the work counters: kernel and twin from the same generation; the
        # rays alive and the boxes (every tile's for a live ray) exactly,
        # the tiles swept exactly where the inputs are the same bits
        ck = [torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(3)]
        ct = [torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(3)]
        k_state, k_idx = fused.path_trace_gen(*args, emit_key=True, emit_idx=True,
                                              counts=ck[0])
        t_state, t_idx = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True,
                                                  counts=ct[0])
        torch.cuda.synchronize()
        errs["path_trace_gen"] = max(errs["path_trace_gen"], compare(
            "path_trace_gen (bounce 0, key, idx)", k_state, k_idx, t_state, t_idx))
        key = k_state[15].contiguous().view(torch.int32)
        _, st, (idx_s,) = sort_state_payload(key, k_state, (k_idx,))
        k2, ki2 = fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s, emit_idx=True,
                                         counts=ck[1])
        t2, ti2 = fused.path_trace_fused_ref(scene, st, 1, bounce0=1, prev=idx_s,
                                             emit_idx=True, counts=ct[1])
        torch.cuda.synchronize()
        errs["path_trace"] = max(errs["path_trace"], compare(
            "path_trace_fused (bounce 1 after the sort, prev)", k2, ki2, t2, ti2))
        # the main path's last call: resort on the host key, bounces 2-3
        _, st2, (idx2,) = sort_state_payload(ray_sort_key(scene, k2), k2, (ki2,))
        k3 = fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2, counts=ck[2])
        t3 = fused.path_trace_fused_ref(scene, st2, 2, bounce0=2, prev=idx2, counts=ct[2])
        torch.cuda.synchronize()
        for what, a, b, same in (("path_trace_gen (bounce 0)", ck[0], ct[0], False),
                                 ("path_trace_fused (bounce 1)", ck[1], ct[1], True),
                                 ("path_trace_fused (bounces 2-3)", ck[2], ct[2], False)):
            a, b = a.tolist(), b.tolist()
            print(f"  {what}, {R} rays: tiles swept {a[1]} (twin {b[1]})")
            held_counts(f"{what}, {R} rays", a if same else a[0::2], b if same else b[0::2])
        e23 = compare("path_trace_fused (bounces 2-3 after the resort, prev)", k3, None, t3,
                      None)
        errs["path_trace"] = max(errs["path_trace"], e23)
        errs["path_trace_b23"] = max(errs["path_trace_b23"], e23)
        if R == full_wave:
            # the work of the timed calls, counted by the twin: tiles whose
            # box each live ray passes (the flat loop sweeps those)
            sc_b = scene_bytes(scene)
            nt = scene.tile_bbox.shape[1]
            g0 = fused.gen_rays_ref(par, meta, R, gen)
            live0 = g0[12] > 0
            sw0 = nearest_hit_ref(scene.tri_data, scene.tile_bbox, scene.tile, g0[0:3],
                                  g0[3:6], live0)[4]
            n0 = float(live0.sum())
            bounds["path_trace_gen"] = bound(
                float(sw0.sum()) * 128 * OPS_TRI + n0 * (nt * OPS_BOX + OPS_SHADE)
                + R * OPS_GEN, sc_b + R * (16 + 1) * 4)
            live1 = st[12] > 0
            sw1 = nearest_hit_ref(scene.tri_data, scene.tile_bbox, scene.tile, st[0:3],
                                  st[3:6], live1, idx_s)[4]
            n1 = float(live1.sum())
            bounds["path_trace"] = bound(
                float(sw1.sum()) * 128 * OPS_TRI + n1 * (nt * OPS_BOX + OPS_SHADE),
                sc_b + R * (16 + 1 + 16 + 1) * 4)
            timing["path_trace_gen"] = (
                cuda_ms(lambda: fused.path_trace_gen(*args, emit_key=True, emit_idx=True), 5),
                cuda_ms(lambda: fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True), 2),
            )
            timing["path_trace"] = (
                cuda_ms(lambda: fused.path_trace_fused(scene, st, 1, bounce0=1, prev=idx_s,
                                                       emit_idx=True), 5),
                cuda_ms(lambda: fused.path_trace_fused_ref(scene, st, 1, bounce0=1,
                                                           prev=idx_s, emit_idx=True), 2),
            )
            # the bounces 2-3 call, counted as bounce 1's: the tiles the twin
            # sweeps at bounce 2 and, from the kernel's bounce-2 output, at 3
            s3, i3 = fused.path_trace_fused(scene, st2, 1, bounce0=2, prev=idx2,
                                            emit_idx=True)
            sw23 = n23 = 0.0
            for sb, pb in ((st2, idx2), (s3, i3)):
                lb = sb[12] > 0
                sw23 += float(nearest_hit_ref(scene.tri_data, scene.tile_bbox, scene.tile,
                                              sb[0:3], sb[3:6], lb, pb)[4].sum())
                n23 += float(lb.sum())
            bounds["path_trace_b23"] = bound(
                sw23 * 128 * OPS_TRI + n23 * (nt * OPS_BOX + OPS_SHADE),
                sc_b + R * (16 + 1 + 16) * 4)
            timing["path_trace_b23"] = (
                cuda_ms(lambda: fused.path_trace_fused(scene, st2, 2, bounce0=2, prev=idx2), 5),
                cuda_ms(lambda: fused.path_trace_fused_ref(scene, st2, 2, bounce0=2,
                                                           prev=idx2), 1),
            )
            occupancy("official", scene, ((0, g0, None), (1, st, idx_s), (2, st2, idx2),
                                          (3, s3, i3)))
            del s3, i3
    for name in list(timing):
        k_ms, p_ms = timing[name]
        timing[name] = (k_ms, p_ms, full_wave, full_wave)
        print(f"  {name} at {full_wave} rays: kernel {k_ms:.3f} ms, plain twin "
              f"{p_ms:.3f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
              f"({card})")

    # 5. a small frame, kernels vs twins
    small_cfg = Config(num_samples=SPP, max_bounce=MAX_BOUNCE, seed=SEED)
    s_scene, s_cam, _ = prepare_scene(str(path), small_cfg, camera_name="Camera 1",
                                      width=320, height=180, device=dev)
    img_k, st_k = render_scene(s_scene, s_cam, small_cfg)
    img_t, st_t = render_scene(s_scene, s_cam, small_cfg, plain=True)
    diff = abs(img_k.astype(int) - img_t.astype(int))
    frac, mean = float((diff > 2).mean()), float(diff.mean())
    seg_rel = abs(st_k.segments - st_t.segments) / max(st_t.segments, 1)
    print(f"frame 320x180: diff>2 on {frac:.4%} of channels, mean |diff| {mean:.4f}, "
          f"segments {st_k.segments} vs {st_t.segments} ({seg_rel:.4%})")
    if not (frac < 0.06 and mean < 1.5 and seg_rel < 0.005):
        fail("320x180 frame: kernels and twins disagree beyond the golden gates")
    if img_k.shape != (180, 320, 3):
        fail(f"frame shape {img_k.shape}")

    # 6. the official frame, through the main path
    got = official_frame(render_scene, scene, cam, cfg, card)
    launches = {"path_trace_gen": got["path_trace_gen"], "path_trace": got["path_trace"],
                "ray_sort_key": got["ray_sort_key"],
                "path_trace_b23": got["path_trace"]}
    profile_frame(render_scene, scene, cam, cfg, card)

    large_phases(card, timing, errs, bounds, launches)
    stream_phases(card, timing, errs, bounds, launches)
    bank_phases(card, timing, errs, bounds, launches)
    duck = duck_phases(card, timing, errs, bounds, launches)
    probe_phases(card, timing, errs, bounds, launches, duck)
    library = {}
    trace_probe_phases(card, timing, errs, bounds, launches, library)
    grid_phases(card, timing, errs, bounds, launches)
    extension_phases(card, timing, errs, bounds, launches)
    sharding_phases(card, path, scene, cam, cfg)
    bench_phases(card, errs)
    frame_phases(card, timing, errs, bounds, (scene, cam, cfg))
    ext_cell_phases(card, timing, errs, bounds, launches)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda",
         "source": PROBES_SOURCE if kname in PROBE_KERNELS else SOURCE,
         "replaces": replaces, "launches": launches[entry], "max_abs_err": errs[entry],
         "ms": timing[entry][0], "plain_ms": timing[entry][1],
         "rays": timing[entry][2], "plain_rays": timing[entry][3],
         "bound_ms": bounds[entry][0], "bound_by": bounds[entry][1],
         "library_ms": library.get(entry)}
        for entry, kname, replaces in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
