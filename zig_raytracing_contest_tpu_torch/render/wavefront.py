"""Whole-path wave: kernel calls, beam sorts and the unsort, per wave.

The port of the whole-path branch of
``zig_raytracing_contest_tpu/render/wavefront.py``.  Per wave:

1. ``path_trace_gen`` makes the primary rays and runs bounce 0, emitting
   the beam-sort key and each ray's winner triangle;
2. a sort packs dead rays at the tail and groups live rays into beams;
3. ``path_trace_fused`` runs bounce 1;
4. a second sort (``MID_RESORT_BOUNCES = (1,)``) on the host key;
5. ``path_trace_fused`` runs bounces 2 .. max_bounce-1;
6. an unsort brings radiance and segment counts back to wave order.

A ray's result does not depend on its lane, so the sorts change speed,
not the image.  Sorting is PyTorch: a stable ``torch.sort`` of the int32
key and a gather by the permutation give the same order as the JAX
package's payload sort on (key, lane).
"""

from __future__ import annotations

import torch

from ..config import ExtFlags
from ..ops.mxu_intersect import REC_EMIT_MAX_TRIS
from ..scene.types import TorchScene
from . import fused

# Mid-path resorts: absolute bounces after which the wave sorts again.
MID_RESORT_BOUNCES: tuple = (1,)


def whole_path_regime(scene: TorchScene, ext: ExtFlags | None = None) -> bool:
    """True when the wave renders through the whole-path kernels: no
    extension is on and the padded triangle bank is within
    REC_EMIT_MAX_TRIS (TorchScene's constructor already refused texel banks
    past PAGED_MAX_TEXELS)."""
    if ext is not None and ext.any:
        return False
    return scene.tri_data.shape[1] <= REC_EMIT_MAX_TRIS


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


def render_wave_rows(scene: TorchScene, par, width: int, height: int,
                     spp: int, max_bounce: int, slot_base: int, slot_cap: int,
                     wave_size: int, seed: int, tiles_x: int,
                     plain: bool = False):
    """One whole-path wave → (rows3 (3, R) radiance in wave-slot order,
    segments as a 0-d int64 tensor).  Rays past ``slot_cap`` contribute
    exact zeros.  ``plain`` runs the twins on any device."""
    R = wave_size
    dev = scene.device
    slot_lane = slot_base + torch.arange(R, device=dev) // spp
    mask = slot_lane < slot_cap
    gen = fused.GenParams(spp=spp, width=width, img_w=width, img_h=height,
                          tiles_x=tiles_x)
    y_base, x_base = divmod(slot_base, width)
    meta = (slot_base, x_base, y_base, seed & 0xFFFFFFFF, slot_base // 1024,
            0, 0, 0)
    do_sort = max_bounce > 1  # split at bounce 0, beam-sort the survivors
    gen_fn = fused.path_trace_gen_ref if plain else fused.path_trace_gen
    out = gen_fn(scene, par, meta, R, 1 if do_sort else max_bounce, gen,
                 emit_key=do_sort, emit_idx=do_sort)
    if do_sort:
        state, idx0 = out
        key = state[15].contiguous().view(torch.int32)
        rows4 = finish_path_sorted(scene, state, idx0, max_bounce, key0=key,
                                   plain=plain)
    else:
        rows4 = torch.cat([out[9:12], out[14:15]])
    rows3 = torch.where(mask[None, :], rows4[0:3], 0.0)
    segs = torch.where(mask, rows4[3], 0.0).to(torch.int64).sum()
    return rows3, segs
