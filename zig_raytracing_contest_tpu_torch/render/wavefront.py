"""One wave of the frame: kernel calls, beam sorts and the unsort.

The port of ``zig_raytracing_contest_tpu/render/wavefront.py``'s MXU
regimes.  Scenes up to REC_EMIT_MAX_TRIS padded triangles whose texel bank
has a resident form in the JAX package take the whole path, per wave:

1. ``path_trace_gen`` makes the primary rays and runs bounce 0, emitting
   the beam-sort key and each ray's winner triangle;
2. a sort packs dead rays at the tail and groups live rays into beams;
3. ``path_trace_fused`` runs bounce 1;
4. a second sort (``MID_RESORT_BOUNCES = (1,)``) on the host key;
5. ``path_trace_fused`` runs bounces 2 .. max_bounce-1;
6. an unsort brings radiance and segment counts back to wave order.

Every other scene takes the per-bounce pipeline (the fused branch of
``render_wave``): raster-order primary rays made here, then per bounce one
``trace_emit_aux`` and one ``shade_fused`` call; past SORT_MIN_TRIS padded
triangles the wave is beam-sorted before every bounce and unsorted at the
end.  Past VMEM_RESIDENT_MAX_TRIS padded triangles the trace streams (its
kernel walks the group heap), and a bank without a resident form is the
JAX package's 3-stage shade; the port shades both kinds of bank with one
kernel.

A ray's result does not depend on its lane, so the sorts change speed,
not the image.  Sorting is PyTorch: a stable ``torch.sort`` of the int32
key and a gather by the permutation give the same order as the JAX
package's payload sort on (key, lane).
"""

from __future__ import annotations

import torch

from ..config import ExtFlags
from ..ops import mxu_intersect
from ..ops.rng import ray_streams, streams_to_f32, uniform2_soa
from ..scene.types import TorchScene
from . import fused

# Mid-path resorts: absolute bounces after which the wave sorts again.
MID_RESORT_BOUNCES: tuple = (1,)

# Per-bounce scenes past this many padded triangles beam-sort the wave
# before every bounce (the JAX package's SORT_MIN_TRIS).  Read at call
# time, so a test can lower it.
SORT_MIN_TRIS = 1 << 16


def whole_path_regime(scene: TorchScene, ext: ExtFlags | None = None) -> bool:
    """True when the wave renders through the whole-path kernels: no
    extension is on, the texel bank has a resident form and the padded
    triangle bank is within both REC_EMIT_MAX_TRIS and SORT_MIN_TRIS (the
    JAX package's whole_path_regime with use_fused)."""
    if ext is not None and ext.any:
        return False
    tp = scene.tri_data.shape[1]
    return (scene.bank_resident and tp <= mxu_intersect.REC_EMIT_MAX_TRIS
            and tp <= SORT_MIN_TRIS)


def sorts_every_bounce(scene: TorchScene) -> bool:
    """The per-bounce pipeline beam-sorts before every bounce."""
    return scene.tri_data.shape[1] > SORT_MIN_TRIS


def regime(scene: TorchScene, ext: ExtFlags | None = None) -> str:
    """The regime a frame of ``scene`` renders in, for logs and reports:
    "whole path", "per-bounce", "per-bounce, sorted" or "streaming,
    sorted" (past VMEM_RESIDENT_MAX_TRIS padded triangles)."""
    if whole_path_regime(scene, ext):
        return "whole path"
    name = "streaming" if mxu_intersect.streams_bank(scene) else "per-bounce"
    return name + ", sorted" if sorts_every_bounce(scene) else name


def trace_walk(scene: TorchScene, ext: ExtFlags | None = None) -> str:
    """How the card's kernels find each bounce's nearest hit, for logs and
    reports: in the whole path "flat" (the tile loop: on the H100 it beat a
    walk of the tile heap at every tile count the whole path serves), in
    the per-bounce pipeline "tile heap" (trace_emit_kernel) or, streaming,
    "group heap" (trace_stream_kernel).  The CPU twins take the flat tile
    loop for every scene."""
    if whole_path_regime(scene, ext):
        return "flat"
    return "group heap" if mxu_intersect.streams_bank(scene) else "tile heap"


def shade_bank(scene: TorchScene) -> str:
    """Which shade of the JAX package the scene's bank takes: "resident
    bank" (one kernel) or "3-stage bank" (prep, gather, shade).  The port's
    ``shade_kernel`` serves both."""
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


def ray_sort_key(scene: TorchScene, state: torch.Tensor) -> torch.Tensor:
    """The host beam-sort key (``_ray_sort_key``, corridor variant) → (R,)
    int32: dead bit, then the 6-D Morton code of the origin × the point
    where the ray leaves the scene box.  Divides by the raw direction
    (±inf slabs; fmax/fmin drop the NaNs)."""
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
                       key0=None, plain: bool = False):
    """Whole-path continuation after bounce 0: beam-sort the wave, trace the
    remaining bounces in one ``path_trace_fused`` call per resort segment,
    and unsort.  ``idx0`` is the bounce-0 winner per lane; ``key0`` the
    kernel-emitted key (the host key when None).  ``plain`` runs the twin.

    Returns rows4 (4, R) in wave order: radiance rows 9-11 and the segment
    counter row 14."""
    trace = fused.path_trace_fused_ref if plain else fused.path_trace_fused
    bounds = [1] + sorted(
        {r + 1 for r in MID_RESORT_BOUNCES if 1 <= r <= max_bounce - 2}
    ) + [max_bounce]
    order = None  # running map: current lane -> original wave position
    idx_cur = idx0
    for i in range(len(bounds) - 1):
        b_start, b_end = bounds[i], bounds[i + 1]
        key = key0 if i == 0 and key0 is not None else ray_sort_key(scene, state)
        extra = (idx_cur,) if order is None else (idx_cur, order)
        perm, state, extras = sort_state_payload(key, state, extra)
        idx_cur = extras[0]
        order = perm if order is None else extras[1]
        last = i == len(bounds) - 2
        out = trace(scene, state, b_end - b_start, bounce0=b_start,
                    prev=idx_cur, emit_idx=not last)
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
    inv_len = 1.0 / fused._sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2])
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
                           seed: int, plain: bool = False) -> torch.Tensor:
    """One per-bounce wave in raster slot order → rows4 (4, R) in wave
    order: radiance rows 9-11 and the segment counter row 14.

    Per bounce: a beam sort (scenes past SORT_MIN_TRIS) that carries each
    lane's original position and previous hit, ``trace_emit_aux`` with the
    previous hit excluded, ``shade_fused`` from its aux and records.
    ``plain`` runs the twins on any device."""
    trace = mxu_intersect.trace_emit_aux_ref if plain else mxu_intersect.trace_emit_aux
    shade = fused.shade_fused_ref if plain else fused.shade_fused
    state = gen_rays_raster(par, seed, slot_base, wave_size, spp, width)
    sort_rays = sorts_every_bounce(scene)
    order = torch.arange(wave_size, device=state.device)  # lane -> wave position
    prev = None  # each lane's previous winner (Morton index)
    for bounce in range(max_bounce):
        if sort_rays:
            extra = (order,) if prev is None else (order, prev)
            _, state, extras = sort_state_payload(ray_sort_key(scene, state),
                                                  state, extra)
            order = extras[0]
            if prev is not None:
                prev = extras[1]
        aux, prev, rec = trace(scene, state, rec_table=scene.rec_table, prev=prev)
        state = shade(scene, state, aux, prev, bounce, rec)
    rows4 = torch.cat([state[9:12], state[14:15]])
    return unsort_rows(order, rows4) if sort_rays else rows4


def render_wave_whole_path(scene: TorchScene, par, width: int, height: int,
                           spp: int, max_bounce: int, slot_base: int,
                           wave_size: int, seed: int, tiles_x: int,
                           plain: bool = False) -> torch.Tensor:
    """One whole-path wave → rows4 (4, R) in wave order: radiance rows 9-11
    and the segment counter row 14.  ``plain`` runs the twins on any
    device."""
    gen = fused.GenParams(spp=spp, width=width, img_w=width, img_h=height,
                          tiles_x=tiles_x)
    y_base, x_base = divmod(slot_base, width)
    meta = (slot_base, x_base, y_base, seed & 0xFFFFFFFF, slot_base // 1024,
            0, 0, 0)
    do_sort = max_bounce > 1  # split at bounce 0, beam-sort the survivors
    gen_fn = fused.path_trace_gen_ref if plain else fused.path_trace_gen
    out = gen_fn(scene, par, meta, wave_size, 1 if do_sort else max_bounce, gen,
                 emit_key=do_sort, emit_idx=do_sort)
    if not do_sort:
        return torch.cat([out[9:12], out[14:15]])
    state, idx0 = out
    key = state[15].contiguous().view(torch.int32)
    return finish_path_sorted(scene, state, idx0, max_bounce, key0=key,
                              plain=plain)


def render_wave_rows(scene: TorchScene, par, width: int, height: int,
                     spp: int, max_bounce: int, slot_base: int, slot_cap: int,
                     wave_size: int, seed: int, tiles_x: int,
                     plain: bool = False):
    """One wave → (rows3 (3, R) radiance in wave-slot order, segments as a
    0-d int64 tensor).  Rays past ``slot_cap`` contribute exact zeros.
    Whole-path scenes take the slot order ``tiles_x`` gives; per-bounce
    scenes take raster order (``tiles_x`` = 0).  ``plain`` runs the twins
    on any device."""
    if whole_path_regime(scene):
        rows4 = render_wave_whole_path(scene, par, width, height, spp,
                                       max_bounce, slot_base, wave_size, seed,
                                       tiles_x, plain)
    elif tiles_x:
        raise ValueError("tiled slot order requires the whole-path regime")
    else:
        rows4 = render_wave_per_bounce(scene, par, width, spp, max_bounce,
                                       slot_base, wave_size, seed, plain)
    slot_lane = slot_base + torch.arange(wave_size, device=scene.device) // spp
    mask = slot_lane < slot_cap
    rows3 = torch.where(mask[None, :], rows4[0:3], 0.0)
    segs = torch.where(mask, rows4[3], 0.0).to(torch.int64).sum()
    return rows3, segs
