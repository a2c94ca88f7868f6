"""One wave of the frame: kernel calls, beam sorts and the unsort, or the
XLA shading path.

The port of ``zig_raytracing_contest_tpu/render/wavefront.py``.  Scenes up
to REC_EMIT_MAX_TRIS padded triangles whose texel bank has a resident form
in the JAX package take the whole path, per wave:

1. ``path_trace_gen`` makes the primary rays and runs bounce 0, emitting
   the beam-sort key and each ray's winner triangle;
2. a sort packs dead rays at the tail and groups live rays into beams;
3. ``path_trace_fused`` runs bounce 1;
4. a second sort (``MID_RESORT_BOUNCES = (1,)``) on the host key;
5. ``path_trace_fused`` runs bounces 2 .. max_bounce-1;
6. an unsort brings radiance and segment counts back to wave order.

Other scenes with the MXU bake take the per-bounce pipeline (the fused
branch of ``render_wave``): raster-order primary rays made here, then per
bounce one ``trace_emit_aux`` and one ``shade_fused`` call; past
SORT_MIN_TRIS padded triangles the wave is beam-sorted before every bounce
and unsorted at the end.  Past VMEM_RESIDENT_MAX_TRIS padded triangles the
trace streams (its kernel walks the group heap), and a bank without a
resident form is the JAX package's 3-stage shade; the port shades both
kinds of bank with one kernel.

A grid scene, and any scene with an extension on, takes the XLA shading
path (``render_wave_xla``, the XLA branch of the JAX ``render_wave``):
(R, 3) ray buffers in raster order, per bounce ``trace_any`` and
``shade_and_scatter`` (the (R, 32) shade-table gather and the f32
sampler), then the extensions.  ``trace_any`` finds the nearest hit with
``trace_emit_aux`` on a scene with the MXU bake, so its kernels run under
this path too, and with the grid walk ``trace_wave`` on a grid scene
(``grid_walk_kernel`` on the card, its twin ``trace_wave_ref`` on the
CPU).  On the card a grid scene with no extension on shades inside the
walk instead (``render_wave_grid``: B + 1 launches of the shaded
``grid_walk_kernel`` for B bounces), and a baked scene with an extension
on inside the bake's trace (``render_wave_shaded_trace``: 2B launches of
the shaded ``trace_stream_kernel`` or ``trace_emit_kernel``); the first
launch of each makes the primary rays.  Each is bit for bit
``render_wave_xla``, which stays their twin and the route of the CPU,
``plain`` and the grid with an extension on.

A ray's result does not depend on its lane, so the sorts change speed,
not the image.  Sorting is PyTorch: a stable ``torch.sort`` of the int32
key and a gather by the permutation give the same order as the JAX
package's payload sort on (key, lane).  The host key of the mid resort and
of the sorted per-bounce waves (``ray_sort_key``, the JAX package's
``_ray_sort_key``, which XLA fuses into the jitted wave) is one launch of
``ray_sort_key_kernel`` on the card and its twin ``ray_sort_key_ref`` on
the CPU.

A wave of any regime holds no host synchronisation on the card, so
``render.pipeline`` captures a frame's waves into one CUDA graph and
replays it per frame: one device call a frame, as the JAX package's
fori_loop chunks are.  Waves of ``plain`` runs (the twins synchronise)
run wave by wave, eagerly.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from .. import kernels
from ..config import ExtFlags
from ..ops import dda, linalg, mxu_intersect
from ..ops.rng import normal3, ray_streams, streams_to_f32, uniform, uniform2_soa
from ..ops.texture import sample_texture
from ..scene.types import COL_BASE_DESC, COL_EMIS_DESC, COL_NRM, COL_UV, TorchScene
from . import fused
from .extensions import pbr_scatter, roulette, sample_direct_light

INF = float("inf")
log = logging.getLogger("zig_raytracing_contest_tpu_torch")

# Mid-path resorts: absolute bounces after which the wave sorts again.
MID_RESORT_BOUNCES: tuple = (1,)

# Per-bounce scenes past this many padded triangles beam-sort the wave
# before every bounce (the JAX package's SORT_MIN_TRIS).  Read at call
# time, so a test can lower it.
SORT_MIN_TRIS = 1 << 16

# Triangles the grid walk tests per ray and loop iteration (the JAX
# package's TRI_BATCH; grid_walk_kernel's GRID_TRI_BATCH).
TRI_BATCH = 4
# The grid walk's twin drops its finished rays, and stops when none is
# left, every GRID_CHECK_EVERY iterations: one host sync each time.
GRID_CHECK_EVERY = 8

# A wave's work counters, in the order of the (10,) int64 ``counts`` a wave
# adds them to (the frame's tally after its segments: render.pipeline),
# summed over its bounces: the rays alive at each bounce's trace, the tiles
# swept and the boxes tested by the tile traces (the per-bounce traces'
# aux rows 4-6, the whole-path kernels' same sums), and the grid walk's
# iterations summed over its rays; then NEE's shadow rays (the lanes whose
# light sample faces them, which trace), the tiles and boxes their traces
# swept and tested, and the specular bounces ``pbr`` took; then the
# whole-path kernels' flat tile loop: the tiles a warp swept lane-parallel
# and the passing lanes a warp swept a tile for with all its lanes (each
# warp of 32 lanes).  Every route counts all ten; work a route does not do
# (tiles on the grid, a walk over tiles, shadow rays without NEE, the flat
# loop off the whole path) counts 0.
WORK_COUNTERS = ("alive", "tiles", "boxes", "walk_iterations",
                 "shadow_rays", "shadow_tiles", "shadow_boxes", "specular",
                 "lane_tiles", "warp_sweeps")
# slices of a wave's counts: the tile traces' three, the walk's iterations,
# the shadow traces' three, the specular bounces, the flat loop's two
NEAREST, WALK, SHADOW, SPECULAR, FLAT = slice(0, 3), slice(3, 4), slice(4, 7), 7, slice(8, 10)


def xla_path(scene: TorchScene, ext: ExtFlags | None = None) -> bool:
    """True when the wave takes the XLA shading path: an extension is on,
    or the scene has no MXU bake (a grid scene)."""
    return scene.tri_data is None or (ext is not None and ext.any)


def whole_path_regime(scene: TorchScene, ext: ExtFlags | None = None) -> bool:
    """True when the wave renders through the whole-path kernels: not the
    XLA shading path, the texel bank has a resident form and the padded
    triangle bank is within both REC_EMIT_MAX_TRIS and SORT_MIN_TRIS (the
    JAX package's whole_path_regime with use_fused)."""
    if xla_path(scene, ext):
        return False
    tp = scene.tri_data.shape[1]
    return (scene.bank_resident and tp <= mxu_intersect.REC_EMIT_MAX_TRIS
            and tp <= SORT_MIN_TRIS)


def sorts_every_bounce(scene: TorchScene) -> bool:
    """The per-bounce pipeline beam-sorts before every bounce."""
    return scene.tri_data.shape[1] > SORT_MIN_TRIS


def regime(scene: TorchScene, ext: ExtFlags | None = None) -> str:
    """The regime a frame of ``scene`` renders in, for logs and reports:
    "whole path", "per-bounce", "per-bounce, sorted", "streaming, sorted"
    (past VMEM_RESIDENT_MAX_TRIS padded triangles), or on the XLA shading
    path "XLA shading, " and its walk ("grid", "tile heap", "group
    heap")."""
    if xla_path(scene, ext):
        return "XLA shading, " + trace_walk(scene, ext)
    if whole_path_regime(scene, ext):
        return "whole path"
    name = "streaming" if mxu_intersect.streams_bank(scene) else "per-bounce"
    return name + ", sorted" if sorts_every_bounce(scene) else name


def trace_walk(scene: TorchScene, ext: ExtFlags | None = None) -> str:
    """How the card's kernels find each bounce's nearest hit, for logs and
    reports: in the whole path "flat" (the tile loop: on the H100 it beat a
    walk of the tile heap at every tile count the whole path serves), in
    the per-bounce pipeline and the XLA shading path "tile heap"
    (trace_emit_kernel) or, streaming, "group heap" (trace_stream_kernel);
    on a grid scene "grid" (the DDA walk: grid_walk_kernel on the card).
    The CPU twins take the flat tile loop for every scene with the bake."""
    if scene.tri_data is None:
        return "grid"
    if whole_path_regime(scene, ext):
        return "flat"
    return "group heap" if mxu_intersect.streams_bank(scene) else "tile heap"


def shaded_walk(scene: TorchScene, ext: ExtFlags | None = None, plain: bool = False) -> bool:
    """True when a wave shades inside the grid walk (``render_wave_grid``):
    a grid scene, no extension on, through the kernels, on a card.  The
    bake with an extension on shades inside its trace instead
    (``shaded_trace``); every other XLA-path wave takes ``render_wave_xla``:
    the grid's extensions, ``plain`` and CPU waves."""
    return (scene.tri_data is None and not (ext is not None and ext.any) and not plain
            and scene.device.type == "cuda")


def shaded_trace(scene: TorchScene, ext: ExtFlags | None = None, plain: bool = False) -> bool:
    """True when a wave shades inside the bake's trace
    (``render_wave_shaded_trace``): a scene with the MXU bake, an extension
    on, through the kernels, on a card.  Its twin ``render_wave_xla`` keeps
    the CPU, ``plain`` and the grid with an extension on; a bake with no
    extension takes the whole path or the per-bounce pipeline."""
    return (scene.tri_data is not None and ext is not None and ext.any and not plain
            and scene.device.type == "cuda")


def shade_bank(scene: TorchScene, ext: ExtFlags | None = None) -> str:
    """Which shade of the JAX package the scene's bank takes: "resident
    bank" (one kernel) or "3-stage bank" (prep, gather, shade), which the
    port's ``shade_kernel`` both serves, or on the XLA shading path "XLA
    sampler" (``shade_and_scatter`` on the f32 bank), on the card's grid
    with no extension "sampler in the walk" (``render_wave_grid``), on the
    card's bake with an extension "sampler in the trace"
    (``render_wave_shaded_trace``)."""
    if shaded_walk(scene, ext):
        return "sampler in the walk"
    if shaded_trace(scene, ext):
        return "sampler in the trace"
    if xla_path(scene, ext):
        return "XLA sampler"
    return "resident bank" if scene.bank_resident else "3-stage bank"


def build_gen_par(scene: TorchScene, cam_origin, cam_lower_left, cam_right,
                  cam_up) -> torch.Tensor:
    """(32,) f32 scalar bank of the ray generator (fused.PAR_* rows): the
    camera basis and the scene box quantization of the beam-sort key."""
    dev = scene.device
    vec = [torch.as_tensor(v, dtype=torch.float32, device=dev)
           for v in (cam_origin, cam_lower_left, cam_right, cam_up)]
    span = torch.clamp_min(scene.bbox_max - scene.bbox_min, 1e-30)
    return torch.cat(vec + [scene.bbox_min, 32.0 / span,
                            torch.zeros(14, dtype=torch.float32, device=dev)])


def ray_sort_key_ref(scene: TorchScene, state: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``ray_sort_key``: the host beam-sort key
    (``_ray_sort_key``, corridor variant) → (R,) int32: dead bit, then the
    6-D Morton code of the origin × the point where the ray leaves the
    scene box.  Divides by the raw direction (±inf slabs: fmax drops a NaN,
    the min over the axes and the clamps keep one)."""
    dead = (state[12] <= 0.0).to(torch.int32)
    bmin = scene.bbox_min[:, None]
    bmax = scene.bbox_max[:, None]
    span = torch.clamp_min(scene.bbox_max - scene.bbox_min, 1e-30)[:, None]
    o, d = state[0:3], state[3:6]
    rel = (o - bmin) / span
    q = torch.clamp(rel * 32.0, 0.0, 31.0).to(torch.int32)
    inv = 1.0 / d
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    far = torch.fmax(ta, tb)
    texit = torch.clamp_min(
        torch.minimum(torch.minimum(far[0], far[1]), far[2]), 0.0
    )
    ex = (o + d * texit[None, :] - bmin) / span
    dq = torch.clamp(ex * 32.0, 0.0, 31.0).to(torch.int32)
    return fused.interleave_key(dead, list(q), list(dq))


def ray_sort_key(scene: TorchScene, state: torch.Tensor) -> torch.Tensor:
    """The host beam-sort key of every column of the (16, R) ``state`` →
    (R,) int32: ``ray_sort_key_kernel`` on a CUDA state (bit for bit the
    twin's), ``ray_sort_key_ref`` on a CPU state."""
    kind = state.device.type
    if kind == "cpu":
        return ray_sort_key_ref(scene, state)
    if kind != "cuda":
        raise ValueError(f"no sort key kernel for device {state.device}")
    key = torch.empty(state.shape[1], dtype=torch.int32, device=state.device)
    kernels.launch_ray_sort_key(state, scene.bbox_min, scene.bbox_max, key)
    return key


def sort_state_payload(key: torch.Tensor, state: torch.Tensor, extra=()):
    """Sort ray-state columns by ``key``, ties by lane (stable sort).
    Returns (perm, sorted_state, sorted_extras)."""
    perm = torch.sort(key, stable=True).indices
    return perm, state[:, perm], tuple(e[perm] for e in extra)


def unsort_rows(order: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows`` ((k, R), sorted lane order) back to wave order;
    ``order`` holds each lane's original position."""
    out = torch.empty_like(rows)
    out[:, order] = rows
    return out


def finish_path_sorted(scene: TorchScene, state, idx0, max_bounce: int,
                       key0=None, plain: bool = False, counts=None, sweeps=None):
    """Whole-path continuation after bounce 0: beam-sort the wave, trace the
    remaining bounces in one ``path_trace_fused`` call per resort segment,
    and unsort.  ``idx0`` is the bounce-0 winner per lane; ``key0`` the
    kernel-emitted key (the host key when None).  ``plain`` runs the twin;
    ``counts`` (3,) and ``sweeps`` (2,) int64 get the traces' work added
    (``path_trace_gen``).

    Returns rows4 (4, R) in wave order: radiance rows 9-11 and the segment
    counter row 14."""
    trace = fused.path_trace_fused_ref if plain else fused.path_trace_fused
    host_key = ray_sort_key_ref if plain else ray_sort_key
    bounds = [1] + sorted(
        {r + 1 for r in MID_RESORT_BOUNCES if 1 <= r <= max_bounce - 2}
    ) + [max_bounce]
    order = None  # running map: current lane -> original wave position
    idx_cur = idx0
    for i in range(len(bounds) - 1):
        b_start, b_end = bounds[i], bounds[i + 1]
        key = key0 if i == 0 and key0 is not None else host_key(scene, state)
        extra = (idx_cur,) if order is None else (idx_cur, order)
        perm, state, extras = sort_state_payload(key, state, extra)
        idx_cur = extras[0]
        order = perm if order is None else extras[1]
        last = i == len(bounds) - 2
        out = trace(scene, state, b_end - b_start, bounce0=b_start,
                    prev=idx_cur, emit_idx=not last, counts=counts, sweeps=sweeps)
        if last:
            state = out
        else:
            state, idx_cur = out
    return unsort_rows(order, torch.cat([state[9:12], state[14:15]]))


def wave_pixel_coords(local: torch.Tensor, spp: int, width: int, pix_base: int):
    """(pixel int64, x f32, y f32) of wave-local ray ids ``local`` in raster
    order from the wave's first pixel ``pix_base``.  Integer division here
    equals the JAX package's exact f32 divmod below 2^23."""
    y_base, x_base = divmod(int(pix_base), width)
    lp = local // spp
    row_off = x_base + lp
    x = row_off % width
    y = y_base + row_off // width
    return pix_base + lp, x.to(torch.float32), y.to(torch.float32)


def gen_rays_raster(par: torch.Tensor, seed: int, slot_base: int,
                    wave_size: int, spp: int, width: int) -> torch.Tensor:
    """The per-bounce pipeline's primary rays (``render_wave``, raster
    order) → (16, R) state.  The RNG stream keys on the global ray id
    slot_base·spp + lane.  Every ray is born alive: rays past the image
    trace like the rest and the caller masks them out."""
    dev = par.device
    R = wave_size
    local = torch.arange(R, dtype=torch.int64, device=dev)
    streams = ray_streams(seed, slot_base * spp + local)
    _, x, y = wave_pixel_coords(local, spp, width, slot_base)
    jx, jy = uniform2_soa(streams, 0)
    sx = x + jx
    sy = y + jy
    dr = [par[fused.PAR_LLC + a] + par[fused.PAR_RIGHT + a] * sx
          + par[fused.PAR_UP + a] * sy for a in range(3)]
    inv_len = 1.0 / linalg.sqrt_rn(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2])
    ones = torch.ones(R, dtype=torch.float32, device=dev)
    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    return torch.stack(
        [par[fused.PAR_ORIGIN + a] * ones for a in range(3)]
        + [dr[a] * inv_len for a in range(3)]
        + [ones, ones, ones, zeros, zeros, zeros]
        + [ones, streams_to_f32(streams), zeros, zeros]
    )


def render_wave_per_bounce(scene: TorchScene, par, width: int, spp: int,
                           max_bounce: int, slot_base: int, wave_size: int,
                           seed: int, plain: bool = False, counts=None) -> torch.Tensor:
    """One per-bounce wave in raster slot order → rows4 (4, R) in wave
    order: radiance rows 9-11 and the segment counter row 14.

    Per bounce: a beam sort (scenes past SORT_MIN_TRIS) that carries each
    lane's original position and previous hit, ``trace_emit_aux`` with the
    previous hit excluded, ``shade_fused`` from its aux and records.
    ``plain`` runs the twins on any device.  ``counts`` (WORK_COUNTERS):
    each trace adds its rays alive, tiles swept and boxes tested."""
    work = None if counts is None else counts[0:3]
    trace = mxu_intersect.trace_emit_aux_ref if plain else mxu_intersect.trace_emit_aux
    shade = fused.shade_fused_ref if plain else fused.shade_fused
    host_key = ray_sort_key_ref if plain else ray_sort_key
    state = gen_rays_raster(par, seed, slot_base, wave_size, spp, width)
    sort_rays = sorts_every_bounce(scene)
    order = torch.arange(wave_size, device=state.device)  # lane -> wave position
    prev = None  # each lane's previous winner (Morton index)
    for bounce in range(max_bounce):
        if sort_rays:
            extra = (order,) if prev is None else (order, prev)
            _, state, extras = sort_state_payload(host_key(scene, state), state, extra)
            order = extras[0]
            if prev is not None:
                prev = extras[1]
        aux, prev, rec = trace(scene, state, rec_table=scene.rec_table, prev=prev,
                               counts=work)
        state = shade(scene, state, aux, prev, bounce, rec)
    rows4 = torch.cat([state[9:12], state[14:15]])
    return unsort_rows(order, rows4) if sort_rays else rows4


def render_wave_whole_path(scene: TorchScene, par, width: int, height: int,
                           spp: int, max_bounce: int, slot_base: int,
                           wave_size: int, seed: int, tiles_x: int,
                           plain: bool = False, counts=None) -> torch.Tensor:
    """One whole-path wave → rows4 (4, R) in wave order: radiance rows 9-11
    and the segment counter row 14.  ``plain`` runs the twins on any
    device.  ``counts`` (WORK_COUNTERS): the kernels add their rays alive,
    tiles swept and boxes tested, and their flat loop's sweeps."""
    work = None if counts is None else counts[NEAREST]
    sweeps = None if counts is None else counts[FLAT]
    gen = fused.GenParams(spp=spp, width=width, img_w=width, img_h=height,
                          tiles_x=tiles_x)
    y_base, x_base = divmod(slot_base, width)
    meta = (slot_base, x_base, y_base, seed & 0xFFFFFFFF, slot_base // 1024,
            0, 0, 0)
    do_sort = max_bounce > 1  # split at bounce 0, beam-sort the survivors
    gen_fn = fused.path_trace_gen_ref if plain else fused.path_trace_gen
    out = gen_fn(scene, par, meta, wave_size, 1 if do_sort else max_bounce, gen,
                 emit_key=do_sort, emit_idx=do_sort, counts=work, sweeps=sweeps)
    if not do_sort:
        return torch.cat([out[9:12], out[14:15]])
    state, idx0 = out
    key = state[15].contiguous().view(torch.int32)
    return finish_path_sorted(scene, state, idx0, max_bounce, key0=key,
                              plain=plain, counts=work, sweeps=sweeps)


class WalkWork(NamedTuple):
    """What a grid walk did, counted by ``trace_wave_ref(work=True)``:
    per ray the references it tested (``tests``) and the cells it entered
    (``cells``: a ray tests every reference of each cell it enters, and
    each DDA step either enters a cell or ends the walk, so this is also
    its DDA steps), ``visited`` (C,) bool, the cells any ray entered, and
    per ray the cells it entered that hold references (``occupied``)."""

    tests: torch.Tensor
    cells: torch.Tensor
    visited: torch.Tensor
    occupied: torch.Tensor


class TraceResult(NamedTuple):
    """The grid walk's nearest hits: t (+inf on a miss), u, v, the index of
    the winning reference into the duplicated triangle arrays (0 on a
    miss), the loop's iteration count (the JAX ``while_loop``'s) as a 0-d
    int32 tensor on the wave's device, and with ``work`` the twin's
    counters (else None)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    dup_idx: torch.Tensor
    iterations: torch.Tensor
    work: WalkWork | None = None


def trace_any(scene: TorchScene, orig, direction, active, exclude=None,
              plain: bool = False, counts=None, it_sum=None):
    """Nearest hit of each ray (orig, direction: (R, 3); active: (R,) bool)
    → (t, u, v, tri, prev): ``tri`` the unique triangle id (on a miss 0
    with the bake, the first reference's triangle on the grid, as in the
    JAX package), ``prev`` the winner in the backend's own ids, to pass back as
    ``exclude`` (the previous hit, never hit again) on the next bounce.

    With the MXU bake: ``trace_emit_aux`` (its kernel on the card, the flat
    twin on the CPU, or with ``plain``), ``prev`` the Morton index the
    kernel compares; else the grid walk ``trace_wave`` (grid_walk_kernel
    on the card, ``trace_wave_ref`` on the CPU or with ``plain``), ``prev``
    the unique id.  Both find the same nearest hit (the grid only prunes
    work).  ``counts`` (3,) int64: the bake's trace adds its rays alive,
    tiles swept and boxes tested (no operation of its own; the grid walk
    counts none of them); ``it_sum`` (1,) int64: the grid walk adds its
    rays' iterations."""
    if scene.tri_data is None:
        walk = trace_wave_ref if plain else trace_wave
        hit = walk(scene, orig, direction, active, exclude=exclude, it_sum=it_sum)
        if orig.device.type == "cpu":  # reading the count on a card would sync
            log.debug("grid walk: %d loop iterations over %d rays", int(hit.iterations),
                      orig.shape[0])
        tri = scene.grid.dup_to_tri[hit.dup_idx]
        return hit.t, hit.u, hit.v, tri, tri
    R = orig.shape[0]
    state = torch.zeros((16, R), dtype=torch.float32, device=orig.device)
    state[0:3] = orig.T
    state[3:6] = direction.T
    state[12] = active.to(torch.float32)
    trace = mxu_intersect.trace_emit_aux_ref if plain else mxu_intersect.trace_emit_aux
    aux, idx, _ = trace(scene, state, None, prev=exclude, counts=counts)
    t = aux[2]
    tri = torch.where(torch.isfinite(t), scene.perm[idx.to(torch.int64)], 0)
    return t, aux[0], aux[1], tri, idx


def trace_wave(scene: TorchScene, orig, direction, active, exclude=None,
               it_sum=None) -> TraceResult:
    """Nearest hit of a wave of rays by the grid's DDA and Möller–Trumbore
    (Scene.traceRay, src/stage3.zig:152-186; the JAX ``trace_wave``):
    one launch of ``grid_walk_kernel`` on CUDA tensors (bit for bit
    ``trace_wave_ref``'s results and iteration count; no host
    synchronisation), ``trace_wave_ref`` on CPU tensors.  ``exclude`` (R,)
    is each ray's previous hit in unique triangle space.  ``it_sum`` (1,)
    int64: every ray's iterations are added to it (by the kernel's warps,
    with no operation of its own)."""
    kind = orig.device.type
    if kind == "cpu":
        return trace_wave_ref(scene, orig, direction, active, exclude, it_sum=it_sum)
    if kind != "cuda":
        raise ValueError(f"no grid walk kernel for device {orig.device}")
    R = orig.shape[0]
    dev = orig.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int64, device=dev)
    # the iteration count and the counter the warps take rays from
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    kernels.launch_grid_walk(
        scene.grid.kernel_operands(), orig.contiguous(), direction.contiguous(),
        active.contiguous(), None if exclude is None else exclude.to(torch.int64).contiguous(),
        t, u, v, idx, scratch, it_sum=it_sum)
    return TraceResult(t, u, v, idx, scratch[0])


def trace_wave_ref(scene: TorchScene, orig, direction, active, exclude=None,
                   work: bool = False, it_sum=None) -> TraceResult:
    """Plain twin of ``trace_wave``, on any device.

    Per iteration a ray tests up to TRI_BATCH references of its cell, then
    steps to the next cell once the cell is exhausted; it is done when its
    best t is at most the t where it leaves the cell (or when it leaves
    the grid: +inf <= +inf).  The JAX loop runs every lane until the last
    one is done; here only the rays still walking run: every
    GRID_CHECK_EVERY iterations the finished ones are dropped (one host
    sync).  A finished ray's state does not change, so the results are the
    JAX loop's.  Rays not active, or missing the grid, are misses.
    ``work`` counts what the walk did (``WalkWork``).  ``it_sum`` (1,)
    int64 gets each ray's iterations added: the iteration in which it was
    done (1 for a ray done in its first), 0 for a ray that does not walk;
    the loop's count is the largest of them, and their sum is the rays
    walking at the start of each iteration, summed over the iterations."""
    g = scene.grid
    grid = g.params
    R = orig.shape[0]
    dev = orig.device
    last_cell = g.num_cells - 1
    out_t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    out_u = torch.zeros(R, dtype=torch.float32, device=dev)
    out_v = torch.zeros(R, dtype=torch.float32, device=dev)
    out_i = torch.zeros(R, dtype=torch.int64, device=dev)
    out_tests = torch.zeros(R, dtype=torch.int64, device=dev) if work else None
    out_cells = torch.zeros(R, dtype=torch.int64, device=dev) if work else None
    out_occupied = torch.zeros(R, dtype=torch.int64, device=dev) if work else None
    visited = torch.zeros(g.num_cells, dtype=torch.bool, device=dev) if work else None

    def result(iterations: int) -> TraceResult:
        return TraceResult(out_t, out_u, out_v, out_i,
                           torch.tensor(iterations, dtype=torch.int32, device=dev),
                           WalkWork(out_tests, out_cells, visited, out_occupied)
                           if work else None)

    entered, state = dda.dda_setup(grid, orig, direction)
    lanes = (entered & active).nonzero()[:, 0]
    if lanes.numel() == 0:
        return result(0)

    o, d = orig[lanes][:, None, :], direction[lanes][:, None, :]
    st = dda.DDAState(*(f[lanes] for f in state))
    ex = None if exclude is None else exclude[lanes][:, None]
    cell_lin = dda.linearize_cell_idx(grid, st.cell).clamp(0, last_cell)
    cursor, cur_end = g.cell_begin[cell_lin], g.cell_end[cell_lin]
    n = lanes.numel()
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    if work:
        tests = torch.zeros(n, dtype=torch.int64, device=dev)
        cells = torch.ones(n, dtype=torch.int64, device=dev)
        occupied = (cur_end > cursor).to(torch.int64)
        visited[cell_lin] = True
    batch = torch.arange(TRI_BATCH, device=dev)
    iterations = 0
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        walking = []
        for _ in range(GRID_CHECK_EVERY):
            alive = ~done
            if it_sum is not None:
                walked += alive.sum()
            # triangle phase: up to TRI_BATCH tests against the current
            # cell; the JAX loop's sequential strict-< update keeps the
            # first of the batch's smallest t, which argmin returns
            idx = cursor[:, None] + batch
            has = alive[:, None] & (idx < cur_end[:, None])
            idx = torch.where(has, idx, 0)
            valid, t, u, v = linalg.moller_trumbore(o, d, g.tri_v0[idx], g.tri_e1[idx],
                                                    g.tri_e2[idx])
            ok = has & valid & (t > 0.0)
            if ex is not None:
                ok = ok & (g.dup_to_tri[idx] != ex)
            t = torch.where(ok, t, INF)
            k = t.argmin(dim=1, keepdim=True)
            t_min = t.gather(1, k)[:, 0]
            better = t_min < best_t
            best_t = torch.where(better, t_min, best_t)
            best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
            best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
            best_i = torch.where(better, idx.gather(1, k)[:, 0], best_i)
            cursor = cursor + has.sum(dim=1)
            # cell-advance phase: rays whose cell is exhausted step the DDA
            need_advance = alive & (cursor >= cur_end)
            t_cross, st = dda.dda_next(st, active=need_advance)
            newly_done = need_advance & (best_t <= t_cross)
            done = done | newly_done
            moved = need_advance & ~newly_done
            cell_lin = dda.linearize_cell_idx(grid, st.cell).clamp(0, last_cell)
            cursor = torch.where(moved, g.cell_begin[cell_lin], cursor)
            cur_end = torch.where(moved, g.cell_end[cell_lin], cur_end)
            if work:
                tests = tests + has.sum(dim=1)
                cells = cells + moved
                occupied = occupied + (moved & (cur_end > cursor))
                visited[cell_lin[moved]] = True
            walking.append((~done).any())
        out_t[lanes], out_u[lanes], out_v[lanes], out_i[lanes] = best_t, best_u, best_v, best_i
        if work:
            out_tests[lanes], out_cells[lanes], out_occupied[lanes] = tests, cells, occupied
        keep = (~done).nonzero()[:, 0]
        if keep.numel() == 0:
            # the JAX loop stops after the first iteration that leaves no
            # ray walking
            iterations += int(torch.stack(walking).sum()) + 1
            if it_sum is not None:
                it_sum += walked
            return result(iterations)
        iterations += GRID_CHECK_EVERY
        lanes, o, d = lanes[keep], o[keep], d[keep]
        st = dda.DDAState(*(f[keep] for f in st))
        ex = None if ex is None else ex[keep]
        cursor, cur_end = cursor[keep], cur_end[keep]
        best_t, best_u, best_v, best_i = (x[keep] for x in (best_t, best_u, best_v, best_i))
        done = done[keep]
        if work:
            tests, cells, occupied = tests[keep], cells[keep], occupied[keep]


def _interpolate(per_vertex, u, v):
    """Barycentric interpolation v0·(1-u-v) + v1·u + v2·v
    (Triangle.Data.interpolate, src/stage3.zig:53-71); per_vertex (R, 3, C)."""
    w0 = (1.0 - u - v)[:, None]
    return per_vertex[:, 0] * w0 + per_vertex[:, 1] * u[:, None] + per_vertex[:, 2] * v[:, None]


def shade_and_scatter(scene: TorchScene, orig, direction, t, u, v, tri, streams,
                      bounce: int):
    """One shading round of the XLA path (traceRayRecursive's body,
    src/stage3.zig:188-220): the (R, 32) shade-table gather, the base and
    emissive textures, the alpha test (tag 2b+1) and the diffuse scatter
    (Gaussian tag 2b+2).  ``tri`` indexes the unique triangles.  Returns
    (new_orig, new_dir, emissive, albedo, pass_through, missed, normal),
    all gated by the caller's alive mask."""
    missed = t == INF
    rec = scene.shade_table[tri]  # (R, 32)
    tri_nrm = rec[:, COL_NRM: COL_NRM + 9].reshape(-1, 3, 3)
    tri_uv = rec[:, COL_UV: COL_UV + 6].reshape(-1, 3, 2)
    base_desc = rec[:, COL_BASE_DESC: COL_BASE_DESC + 7]
    emis_desc = rec[:, COL_EMIS_DESC: COL_EMIS_DESC + 7]

    texcoord = _interpolate(tri_uv, u, v)
    tc_u, tc_v = texcoord[:, 0], texcoord[:, 1]
    base = sample_texture(scene.color_data, base_desc, tc_u, tc_v)  # (R, 4)
    albedo = base[:, :3]
    opacity = base[:, 3]  # the reference's "transparency" is the base alpha
    emissive = sample_texture(scene.color_data, emis_desc, tc_u, tc_v)[:, :3]
    normal = _interpolate(tri_nrm, u, v)

    # stochastic alpha: rand > opacity continues straight through
    # (src/stage3.zig:207-213); both branches consume a bounce
    pass_through = uniform(streams, 2 * bounce + 1) > opacity
    # diffuse bounce: normalize(normal + randomUnitVector)
    # (src/stage3.zig:214-217, src/linalg.zig:140-148)
    gauss = normal3(streams, 2 * bounce + 2)
    scattered = linalg.normalize(normal + linalg.normalize(gauss))
    new_orig = linalg.ray_at(orig, direction, t + fused.FLT_EPSILON)
    new_dir = torch.where(pass_through[:, None], direction, scattered)
    return new_orig, new_dir, emissive, albedo, pass_through, missed, normal


def xla_primary_rays(par, width: int, spp: int, slot_base: int, wave_size: int,
                     seed: int):
    """The XLA shading path's primary rays of one raster-order wave from
    pixel ``slot_base`` → (orig (R, 3), direction (R, 3), streams (R,)): the
    jittered pixel through ``normalize`` of the camera basis (the JAX
    ``render_wave``'s XLA branch).  ``render_wave_xla``'s; the shaded
    walk's and the shaded trace's first launches make the same bits on the
    card (path_trace.cu ``wave_primary_ray``)."""
    local = torch.arange(wave_size, dtype=torch.int64, device=par.device)
    streams = ray_streams(seed, slot_base * spp + local)
    _, x, y = wave_pixel_coords(local, spp, width, slot_base)
    jx, jy = uniform2_soa(streams, 0)
    sx, sy = x + jx, y + jy
    cam = [par[p: p + 3] for p in (fused.PAR_ORIGIN, fused.PAR_LLC, fused.PAR_RIGHT,
                                     fused.PAR_UP)]
    direction = linalg.normalize(cam[1] + cam[2] * sx[:, None] + cam[3] * sy[:, None])
    return cam[0].expand(wave_size, 3), direction, streams


def render_wave_xla(scene: TorchScene, par, width: int, spp: int, max_bounce: int,
                    slot_base: int, wave_size: int, seed: int,
                    ext: ExtFlags | None = None, plain: bool = False,
                    counts=None) -> torch.Tensor:
    """One wave of the XLA shading path (the XLA branch of the JAX
    ``render_wave``) in raster slot order → rows4 (4, R): radiance and the
    segment count per ray, the route of the CPU, ``plain`` and the card's
    grid with an extension on; on a card the grid with no extension takes
    ``render_wave_grid`` and the bake with an extension
    ``render_wave_shaded_trace``, which equal it bit for bit.  ``ext``
    switches the extensions on; ``plain`` traces with the twin on any
    device.  ``counts`` (WORK_COUNTERS): the
    nearest hits add their work (``trace_any``: no operation of its own)
    and, on the grid, which counts no rays alive, the wave adds its lanes'
    segment counts, summed once a wave (three operations); NEE's shadow
    rays add theirs (``sample_direct_light``), and with ``pbr`` each
    bounce adds its specular bounces (three operations)."""
    ext = ext or ExtFlags()
    dev = par.device
    R = wave_size
    orig, direction, streams = xla_primary_rays(par, width, spp, slot_base, R, seed)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    segments = torch.zeros(R, dtype=torch.int32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    # NEE: an emissive hit counts only when the previous segment was not
    # sampled directly already (render/extensions.py)
    count_emissive = torch.ones(R, dtype=torch.bool, device=dev)
    use_nee = ext.nee and scene.lights is not None
    prev = None  # each ray's previous hit, in the backend's ids
    for bounce in range(max_bounce):
        if ext.russian_roulette:
            throughput, alive = roulette(throughput, streams, bounce, alive)
        segments = segments + alive.to(torch.int32)
        t, u, v, tri, prev = trace_any(
            scene, orig, direction, alive, exclude=prev, plain=plain,
            counts=None if counts is None else counts[NEAREST],
            it_sum=None if counts is None else counts[WALK])
        new_orig, new_dir, emissive, albedo, pass_through, missed, normal = (
            shade_and_scatter(scene, orig, direction, t, u, v, tri, streams, bounce))
        add_env = alive & missed
        radiance = radiance + torch.where(
            add_env[:, None], throughput * linalg.env_color(direction), 0.0)
        shaded = alive & ~missed & ~pass_through
        add_emis = shaded & count_emissive if use_nee else shaded
        radiance = radiance + torch.where(add_emis[:, None], throughput * emissive, 0.0)
        take_spec = None
        if ext.pbr and scene.ext_mr is not None:
            spec_or_diff, take_spec = pbr_scatter(scene, tri, direction, normal, new_dir,
                                                  streams, bounce)
            new_dir = torch.where(pass_through[:, None], direction, spec_or_diff)
            if counts is not None:
                counts[SPECULAR].add_((shaded & take_spec).sum())
        if use_nee:
            nee_lanes = shaded if take_spec is None else shaded & ~take_spec
            radiance = radiance + sample_direct_light(
                scene, new_orig, normal, albedo, throughput, streams, bounce, nee_lanes,
                plain=plain, counts=None if counts is None else counts[SHADOW])
            # the next hit's emissive is counted twice only on NEE'd lanes
            count_emissive = torch.where(shaded, ~nee_lanes, count_emissive)
        throughput = torch.where(shaded[:, None], throughput * albedo, throughput)
        stepped = alive & ~missed
        orig = torch.where(stepped[:, None], new_orig, orig)
        direction = torch.where(stepped[:, None], new_dir, direction)
        alive = stepped
        del t, u, v, tri, new_orig, new_dir, emissive, albedo, normal
        # rays alive after the last bounce add nothing: depth exhaustion
        # returns black (src/stage3.zig:189-191)
    if counts is not None and scene.tri_data is None:
        # a lane's segments are the bounces it was alive; summed in int32
        # where the sum fits (no cast of the wave to int64)
        exact = torch.int32 if R * max_bounce < 1 << 31 else torch.int64
        counts[0].add_(segments.sum(dtype=exact))
    return torch.cat([radiance.T, segments[None].to(torch.float32)])


def render_wave_grid(scene: TorchScene, par, width: int, spp: int, max_bounce: int,
                     slot_base: int, wave_size: int, seed: int, counts=None) -> torch.Tensor:
    """``render_wave_xla`` of a grid scene with no extension on the card,
    bit for bit: ``max_bounce`` + 1 launches of the shaded grid_walk_kernel
    (``kernels.launch_grid_walk_shaded``) over the wave's state on the
    device: launch b shades each live ray's hit of bounce b - 1 and walks
    bounce b, launch 0 makes the primary rays (``xla_primary_rays``' bits,
    from ``par`` and the wave's scalars) and walks them, the last only
    shades.  → rows4 (4, R): radiance and the segment count per ray.
    ``counts`` (WORK_COUNTERS): the launches add the rays they walk and
    their iterations (its first four)."""
    R = wave_size
    dev = par.device
    f32 = dict(dtype=torch.float32, device=dev)
    orig, direction, thr = (torch.empty((R, 3), **f32) for _ in range(3))
    rows4 = torch.empty((4, R), **f32)
    t, u, v = (torch.empty(R, **f32) for _ in range(3))
    idx = torch.empty(R, dtype=torch.int64, device=dev)
    scratch = torch.zeros((max_bounce + 1, 2), dtype=torch.int32, device=dev)
    ops = scene.grid.kernel_operands()
    for bounce in range(max_bounce + 1):
        kernels.launch_grid_walk_shaded(ops, scene.shade_table, scene.color_data, par, width,
                                        spp, slot_base, seed, orig, direction, thr, rows4, t,
                                        u, v, idx, scratch[bounce], bounce, max_bounce,
                                        None if counts is None else counts[0:4])
    return rows4


def render_wave_shaded_trace(scene: TorchScene, par, width: int, spp: int, max_bounce: int,
                             slot_base: int, wave_size: int, seed: int, ext: ExtFlags,
                             counts=None) -> torch.Tensor:
    """``render_wave_xla`` of a baked scene with an extension on, on the
    card, bit for bit: for each bounce two launches of the bake's trace
    (``kernels.launch_trace_shaded``: trace_stream_kernel past
    VMEM_RESIDENT_MAX_TRIS padded triangles, else trace_emit_kernel) over
    the wave's state on the device, the two traces ``render_wave_xla``
    makes: the nearest launch of bounce 0 makes the primary rays
    (``xla_primary_rays``' bits, from ``par`` and the wave's scalars); the
    nearest launch rolls Russian roulette, counts each live ray's segment
    and finds its nearest hit; the shadow
    launch shades that hit (the sky, the shade table's row and texels,
    ``pbr_scatter``, the emissive term, NEE's light sample), traces NEE's
    shadow rays and steps the rays.  → rows4 (4, R): radiance and the
    segment count per ray.  ``counts`` (WORK_COUNTERS): the nearest
    launches add their rays, tiles and boxes, the shadow launches their
    shadow rays, tiles, boxes and specular bounces (the first eight)."""
    R = wave_size
    dev = par.device
    f32 = dict(dtype=torch.float32, device=dev)
    if max_bounce < 1:
        return torch.zeros((4, R), **f32)
    orig, direction, thr = (torch.empty((R, 3), **f32) for _ in range(3))
    rows4 = torch.empty((4, R), **f32)
    hit = torch.empty((3, R), **f32)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    flags = torch.empty(R, dtype=torch.uint8, device=dev)
    groups = mxu_intersect.streams_bank(scene)
    lights = scene.lights if ext.nee else None
    mr = scene.ext_mr if ext.pbr else None
    for bounce in range(max_bounce):
        for shadow in (False, True):
            kernels.launch_trace_shaded(scene, groups, par, width, spp, slot_base, seed, orig,
                                        direction, thr, rows4, hit, idx, flags, bounce, shadow,
                                        lights, mr, ext.russian_roulette,
                                        None if counts is None else counts[:SPECULAR + 1])
    return rows4


def render_wave_rows(scene: TorchScene, par, width: int, height: int,
                     spp: int, max_bounce: int, slot_base: int, slot_cap: int,
                     wave_size: int, seed: int, tiles_x: int,
                     plain: bool = False, ext: ExtFlags | None = None, counts=None):
    """One wave → (rows3 (3, R) radiance in wave-slot order, segments as a
    0-d int64 tensor).  Rays past ``slot_cap`` contribute exact zeros.
    Whole-path scenes take the slot order ``tiles_x`` gives; per-bounce
    and XLA-path waves take raster order (``tiles_x`` = 0).  An XLA-path
    wave takes one of three routes: on a card, a grid scene with no
    extension shades inside the grid walk (``shaded_walk``:
    ``render_wave_grid``) and a baked scene with an extension inside the
    bake's trace (``shaded_trace``: ``render_wave_shaded_trace``); every
    other wave (the CPU, ``plain``, the grid with an extension) takes
    ``render_wave_xla``.  ``plain`` runs the twins on any device; ``ext``
    the extensions.  ``counts`` (10,) int64 on the scene's device gets the
    wave's WORK_COUNTERS added (every lane counts, past ``slot_cap``
    too)."""
    if xla_path(scene, ext):
        if tiles_x:
            raise ValueError("tiled slot order requires the whole-path regime")
        if shaded_walk(scene, ext, plain):
            rows4 = render_wave_grid(scene, par, width, spp, max_bounce, slot_base,
                                     wave_size, seed, counts)
        elif shaded_trace(scene, ext, plain):
            rows4 = render_wave_shaded_trace(scene, par, width, spp, max_bounce, slot_base,
                                             wave_size, seed, ext, counts)
        else:
            rows4 = render_wave_xla(scene, par, width, spp, max_bounce, slot_base,
                                    wave_size, seed, ext, plain, counts)
    elif whole_path_regime(scene):
        rows4 = render_wave_whole_path(scene, par, width, height, spp,
                                       max_bounce, slot_base, wave_size, seed,
                                       tiles_x, plain, counts)
    elif tiles_x:
        raise ValueError("tiled slot order requires the whole-path regime")
    else:
        rows4 = render_wave_per_bounce(scene, par, width, spp, max_bounce,
                                       slot_base, wave_size, seed, plain, counts)
    slot_lane = slot_base + torch.arange(wave_size, device=scene.device) // spp
    mask = slot_lane < slot_cap
    rows3 = torch.where(mask[None, :], rows4[0:3], 0.0)
    segs = torch.where(mask, rows4[3], 0.0).to(torch.int64).sum()
    return rows3, segs
