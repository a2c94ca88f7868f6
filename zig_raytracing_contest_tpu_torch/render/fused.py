"""Path kernels: primary-ray generation, trace and shade of every bounce,
and the per-bounce shade.

The port of the Pallas kernels of ``zig_raytracing_contest_tpu/render/fused.py``:

* ``path_trace_gen`` (fused.py:1031) generates one wave of primary rays
  (``_gen_rays``), traces and shades its first ``max_bounce`` bounces, and
  can emit the beam-sort key (``_emit_sort_key``) and each ray's last
  winner triangle;
* ``path_trace_fused`` (fused.py:1111) continues the (sorted) state for
  ``max_bounce`` bounces numbered from ``bounce0``, excluding each ray's
  previous hit;
* ``shade_fused`` (fused.py:1191: the single-kernel ``_make_shade1_kernel``
  and the 3-stage ``_make_prep_kernel`` + gather + ``_make_shade_kernel``)
  shades one bounce of the per-bounce pipeline from the trace's aux and
  records, for any bank.

Each entry point is a wrapper with two bodies: the CUDA kernel of
kernels/path_trace.cu for tensors on a CUDA device, and the plain PyTorch
twin (``path_trace_gen_ref`` / ``path_trace_fused_ref`` / ``shade_fused_ref``,
composed from ``gen_rays_ref``, ``nearest_hit_ref``, ``shade_ref`` and
``sort_key_ref``) for tensors on the CPU.  The device decides; there is no
fallback from one to the other.

State layout (16, R) f32, one ray per column:
  [ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb,
   alive, streams (u32 bit pattern), segments, sort key (i32 bit pattern) / 0]

Per-ray semantics: a bounce leaves a dead ray's state untouched; a live ray
traces, shades, and clears row 15.  The JAX kernels decide dead-skipping
per 1024-lane block, which changes only row 15 of dead lanes and the
never-read winner index of dead lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops.linalg import sqrt_rn as _sqrt
from ..ops.mxu_intersect import nearest_hit_ref, records_ref
from ..ops.rng import _TWO_PI, _bits, _u01, f32_to_streams, ray_streams, streams_to_f32
from ..scene.types import PCOL_BASE, PCOL_EMIS, PCOL_NRM, PCOL_UV, TorchScene

FLT_EPSILON = 1.1920928955078125e-07  # float32 machine epsilon
INF = float("inf")


class GenParams(NamedTuple):
    """Static ray-generation geometry."""

    spp: int
    width: int  # image width (camera/raster math)
    img_w: int
    img_h: int
    tiles_x: int = 0  # 0 = raster slot order; else 32×32 pixel tiles


PAR_ORIGIN = 0
PAR_LLC = 3
PAR_RIGHT = 6
PAR_UP = 9
PAR_BMIN = 12
PAR_SCALE = 15  # 32 / span, per axis
# meta: 8 ints [slot_base, x_base, y_base, seed, tile_base, 0, 0, 0]
META_X_BASE = 1
META_Y_BASE = 2
META_SEED = 3
META_TILE_BASE = 4
PIX_TILE = 32  # tiled order: 32×32-pixel squares = 1024 slots

# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _texel_pair(c, size_f, is_repeat):
    """Float-math texel indices — the JAX package's ops/texture.py rule:
    repeat wraps the floored fraction; clamp clamps floor(size·c) to
    [0, size - 1]."""
    fc = c - torch.floor(c)
    r1 = torch.minimum(torch.floor(size_f * fc), size_f - 1.0)
    r2 = r1 + 1.0
    r2 = torch.where(r2 >= size_f, r2 - size_f, r2)
    cc = torch.floor(size_f * torch.clamp(c, -8.0e9, 8.0e9))
    c1 = torch.minimum(torch.clamp_min(cc, 0.0), size_f - 1.0)
    c2 = torch.minimum(torch.clamp_min(cc + 1.0, 0.0), size_f - 1.0)
    return torch.where(is_repeat, r1, c1), torch.where(is_repeat, r2, c2)


def prep_math_ref(rec: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  emissive_dummy: bool):
    """Interpolated normal/uv and texel indices (``_prep_math``, non-tiled).

    ``rec`` (24, R) winner records.  Returns (idx: 5 or 8 (R,) int64 texel
    indices [base p11, p21, p12, p22, emissive ...], svec: [nx, ny, nz,
    fu, fv, base scale, emissive scale])."""
    w0 = 1.0 - u - v
    tc_u = rec[PCOL_UV + 0] * w0 + rec[PCOL_UV + 2] * u + rec[PCOL_UV + 4] * v
    tc_v = rec[PCOL_UV + 1] * w0 + rec[PCOL_UV + 3] * u + rec[PCOL_UV + 5] * v
    nx = rec[PCOL_NRM + 0] * w0 + rec[PCOL_NRM + 3] * u + rec[PCOL_NRM + 6] * v
    ny = rec[PCOL_NRM + 1] * w0 + rec[PCOL_NRM + 4] * u + rec[PCOL_NRM + 7] * v
    nz = rec[PCOL_NRM + 2] * w0 + rec[PCOL_NRM + 5] * u + rec[PCOL_NRM + 8] * v

    def tex_indices(d):
        # Packed descriptor [offset, ±w, ±h, scale]: sign = repeat wrap on
        # that axis; clamp bounds are always [0, size-1].
        wf_s = rec[d + 1]
        hf_s = rec[d + 2]
        wf = torch.abs(wf_s)
        hf = torch.abs(hf_s)
        x1, x2 = _texel_pair(tc_u, wf, wf_s < 0)
        y1, y2 = _texel_pair(tc_v, hf, hf_s < 0)
        off = rec[d].to(torch.int64)
        w_i = wf.to(torch.int64)
        x1i, x2i = x1.to(torch.int64), x2.to(torch.int64)
        y1w, y2w = y1.to(torch.int64) * w_i, y2.to(torch.int64) * w_i
        return [off + y1w + x1i, off + y1w + x2i, off + y2w + x1i, off + y2w + x2i]

    idx = tex_indices(PCOL_BASE)
    if emissive_dummy:
        # Every emissive entry is a 1×1 dummy: its one texel sits at the
        # descriptor offset.
        idx.append(rec[PCOL_EMIS].to(torch.int64))
    else:
        idx += tex_indices(PCOL_EMIS)
    svec = [
        nx, ny, nz,
        torch.abs(tc_u - torch.trunc(tc_u)),
        torch.abs(tc_v - torch.trunc(tc_v)),
        rec[PCOL_BASE + 3],
        rec[PCOL_EMIS + 3],
    ]
    return idx, svec


def shade_ref(state: torch.Tensor, t: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor, rec: torch.Tensor, bank: torch.Tensor,
              bounce: int, emissive_dummy: bool) -> torch.Tensor:
    """One bounce of shading (``_shade_live``) → the new (16, R) state.

    Texels are dequantized per corner (f32(u16) · scale) before the
    bilinear filter, in the order of the JAX package's ops/texture.py.
    Stochastic alpha draws tag 2b+1, the diffuse scatter tag 2b+2 (b the
    absolute bounce).  Hits re-originate at t + FLT_EPSILON."""
    alive = state[12] > 0.0
    missed = ~(t < INF)
    fetch = alive & ~missed
    idx, sv = prep_math_ref(rec, u, v, emissive_dummy)
    last = bank.shape[0] - 1

    def texel(i, scale):
        ii = torch.where(fetch, idx[i], 0).clamp(0, last)
        px = torch.where(fetch[:, None], bank[ii], 0.0)
        return [px[:, c] * scale for c in range(4)]

    fu, fv = sv[3], sv[4]
    p11, p21, p12, p22 = (texel(i, sv[5]) for i in range(4))

    def bilinear(q11, q21, q12, q22, c):
        r1 = q11[c] * (1.0 - fu) + q21[c] * fu
        r2 = q12[c] * (1.0 - fu) + q22[c] * fu
        return r1 * (1.0 - fv) + r2 * fv

    ar, ag, ab, opacity = (bilinear(p11, p21, p12, p22, c) for c in range(4))
    if emissive_dummy:
        er, eg, eb, _ = texel(4, sv[6])
    else:
        e = [texel(i, sv[6]) for i in range(4, 8)]
        er, eg, eb = (bilinear(*e, c) for c in range(3))

    streams = f32_to_streams(state[13])
    rnd = _u01(_bits(streams, 2 * bounce + 1, 0))
    pass_through = rnd > opacity
    g_tag = 2 * bounce + 2
    u1, u2, u3, u4 = (_u01(_bits(streams, g_tag, w)) for w in range(4))
    r1 = _sqrt(-2.0 * torch.log(u1))
    r2 = _sqrt(-2.0 * torch.log(u3))
    gx = r1 * torch.cos(_TWO_PI * u2)
    gy = r1 * torch.sin(_TWO_PI * u2)
    gz = r2 * torch.cos(_TWO_PI * u4)
    g_inv = torch.rsqrt(gx * gx + gy * gy + gz * gz)
    swx = sv[0] + gx * g_inv
    swy = sv[1] + gy * g_inv
    swz = sv[2] + gz * g_inv
    s_inv = torch.rsqrt(swx * swx + swy * swy + swz * swz)

    ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb = state[0:12]

    # sky on miss (src/stage3.zig:144-150)
    sky_t = 0.5 * (dy + 1.0)
    env_w = (alive & missed).to(torch.float32)
    rr = rr + env_w * tr * (1.0 - 0.5 * sky_t)
    rg = rg + env_w * tg * (1.0 - 0.3 * sky_t)
    rb = rb + env_w * tb

    shaded = alive & ~missed & ~pass_through
    sh_w = shaded.to(torch.float32)
    rr = rr + sh_w * tr * er
    rg = rg + sh_w * tg * eg
    rb = rb + sh_w * tb * eb
    tr = torch.where(shaded, tr * ar, tr)
    tg = torch.where(shaded, tg * ag, tg)
    tb = torch.where(shaded, tb * ab, tb)

    stepped = alive & ~missed
    t_step = t + FLT_EPSILON
    ndx = torch.where(pass_through, dx, swx * s_inv)
    ndy = torch.where(pass_through, dy, swy * s_inv)
    ndz = torch.where(pass_through, dz, swz * s_inv)
    new = torch.stack([
        torch.where(stepped, ox + dx * t_step, ox),
        torch.where(stepped, oy + dy * t_step, oy),
        torch.where(stepped, oz + dz * t_step, oz),
        torch.where(stepped, ndx, dx),
        torch.where(stepped, ndy, dy),
        torch.where(stepped, ndz, dz),
        tr, tg, tb, rr, rg, rb,
        stepped.to(torch.float32),
        state[13],
        state[14] + 1.0,
        torch.zeros_like(t),
    ])
    # A dead ray is left as it was (no trace, no shade, no segment).
    return torch.where(alive[None, :], new, state)


def gen_rays_ref(par: torch.Tensor, meta, wave_size: int,
                 gen: GenParams) -> torch.Tensor:
    """A wave of primary rays (``_gen_rays``) → (16, R) state.

    Slot ``i`` of the wave maps to (pixel, sample) in raster or 32×32-tiled
    order; the RNG stream keys on the RASTER global ray id
    (y·width + x)·spp + s, so the image does not depend on the pixel order.
    Integer division here equals the JAX package's exact f32 divmod for
    every v < 2^23, which the pipeline's wave sizing guarantees.  Rays whose
    pixel lies outside the image (tile padding) are born dead."""
    dev = par.device
    i = torch.arange(wave_size, dtype=torch.int64, device=dev)
    qi, s = i // gen.spp, i % gen.spp
    if gen.tiles_x:
        tile = int(meta[META_TILE_BASE]) + qi // (PIX_TILE * PIX_TILE)
        w_in = qi % (PIX_TILE * PIX_TILE)
        x = (tile % gen.tiles_x) * PIX_TILE + w_in % PIX_TILE
        y = (tile // gen.tiles_x) * PIX_TILE + w_in // PIX_TILE
    else:
        row_off = int(meta[META_X_BASE]) + qi
        x = row_off % gen.width
        y = int(meta[META_Y_BASE]) + row_off // gen.width
    in_range = (x < gen.img_w) & (y < gen.img_h)
    g = (y * gen.width + x) * gen.spp + s
    streams = ray_streams(int(meta[META_SEED]), g)
    jx = _u01(_bits(streams, 0, 0))
    jy = _u01(_bits(streams, 0, 1))
    sx = x.to(torch.float32) + jx
    sy = y.to(torch.float32) + jy
    dr = [par[PAR_LLC + a] + par[PAR_RIGHT + a] * sx + par[PAR_UP + a] * sy
          for a in range(3)]
    inv_len = 1.0 / _sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2])
    ones = torch.ones(wave_size, dtype=torch.float32, device=dev)
    zeros = torch.zeros(wave_size, dtype=torch.float32, device=dev)
    return torch.stack(
        [par[PAR_ORIGIN + a] * ones for a in range(3)]
        + [dr[a] * inv_len for a in range(3)]
        + [ones, ones, ones, zeros, zeros, zeros]
        + [in_range.to(torch.float32), streams_to_f32(streams), zeros, zeros]
    )


def sort_key_ref(state: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """The kernel variant of the beam-sort key (``_emit_sort_key``) → (R,)
    int32: the dead bit, then a 6-D interleaved Morton code of the origin ×
    the scene-exit point.  |d| is clamped to ≥ 1e-12 (sign kept) before the
    slab test, unlike the host key of the mid-path resort."""
    dead = (state[12] <= 0.0).to(torch.int32)
    far = None
    o3, d3 = [], []
    for a in range(3):
        o3.append(state[a])
        d = state[3 + a]
        d = torch.where(d >= 0.0, torch.clamp_min(d, 1e-12),
                        torch.clamp_max(d, -1e-12))
        d3.append(d)
        bmin = par[PAR_BMIN + a]
        span = 32.0 / par[PAR_SCALE + a]
        inv = 1.0 / d
        ta = (bmin - o3[a]) * inv
        tb = (bmin + span - o3[a]) * inv
        fa = torch.maximum(ta, tb)
        far = fa if far is None else torch.minimum(far, fa)
    texit = torch.clamp_min(far, 0.0)
    q, dq = [], []
    for a in range(3):
        rel = (o3[a] - par[PAR_BMIN + a]) * par[PAR_SCALE + a]
        q.append(torch.clamp(rel, 0.0, 31.0).to(torch.int32))
        ex = rel + d3[a] * texit * par[PAR_SCALE + a]
        dq.append(torch.clamp(ex, 0.0, 31.0).to(torch.int32))
    return interleave_key(dead, q, dq)


def interleave_key(dead, q, dq) -> torch.Tensor:
    """(dead << 30) | 6-D Morton of 5-bit q (origin) and dq (second point)."""
    key = torch.zeros_like(dead)
    for b in range(5):
        for a in range(3):
            key = key | (((q[a] >> b) & 1) << (6 * b + 2 * a))
            key = key | (((dq[a] >> b) & 1) << (6 * b + 2 * a + 1))
    return (dead << 30) | key


def _bounces_ref(scene: TorchScene, state, idx, prev_first, bounces, counts=None,
                 sweeps=None):
    """Trace + shade each bounce in ``bounces`` for the live rays.
    ``prev_first`` excludes each ray's previous hit at the first bounce;
    later bounces exclude the winner of the bounce before.  ``counts``
    (3,) int64 gets each bounce's rays alive, tiles swept and boxes tested
    (every tile for a live ray) added, as the kernels add theirs;
    ``sweeps`` (2,) int64 the flat loop's tiles swept lane-parallel and
    passing lanes swept by the whole warp, for each warp of 32 lanes."""
    prev = prev_first
    for bounce in bounces:
        alive = state[12] > 0.0
        if not bool(alive.any()):
            break
        t, hit, u, v, swept = nearest_hit_ref(
            scene.tri_data, scene.tile_bbox, scene.tile, state[0:3],
            state[3:6], alive, prev, sweeps=sweeps,
        )
        if counts is not None:
            live = alive.sum()
            counts += torch.stack([live, swept.to(torch.int64).sum(),
                                   live * scene.tile_bbox.shape[1]])
        state = shade_ref(state, t, u, v, records_ref(scene.rec_table, t, hit),
                          scene.bank, bounce, scene.emissive_dummy)
        idx = torch.where(alive, hit, idx)
        prev = idx
    return state, idx


def path_trace_gen_ref(scene: TorchScene, par, meta, wave_size: int,
                       max_bounce: int, gen: GenParams, emit_key: bool = False,
                       emit_idx: bool = False, counts=None, sweeps=None):
    """Plain twin of ``path_trace_gen``."""
    state = gen_rays_ref(par, meta, wave_size, gen)
    idx = torch.zeros(wave_size, dtype=torch.int64, device=state.device)
    state, idx = _bounces_ref(scene, state, idx, None, range(max_bounce), counts, sweeps)
    if emit_key:
        state[15] = sort_key_ref(state, par).view(torch.float32)
    return (state, idx.to(torch.int32)) if emit_idx else state


def path_trace_fused_ref(scene: TorchScene, state16, max_bounce: int,
                         bounce0: int = 0, prev=None, emit_idx: bool = False,
                         counts=None, sweeps=None):
    """Plain twin of ``path_trace_fused``."""
    R = state16.shape[1]
    idx = (prev.to(torch.int64) if prev is not None
           else torch.zeros(R, dtype=torch.int64, device=state16.device))
    state, idx = _bounces_ref(
        scene, state16.clone(), idx,
        None if prev is None else idx, range(bounce0, bounce0 + max_bounce), counts, sweeps,
    )
    return (state, idx.to(torch.int32)) if emit_idx else state


def shade_fused_ref(scene: TorchScene, state, aux, tri, bounce: int, rec=None):
    """Plain twin of ``shade_fused``: ``shade_ref`` fed from aux."""
    if rec is None:
        rec = records_ref(scene.rec_table, aux[2], tri.to(torch.int64))
    return shade_ref(state, aux[2], aux[0], aux[1], rec, scene.bank, bounce,
                     scene.emissive_dummy)


# ---------------------------------------------------------------------------
# Wrappers: CUDA kernel for CUDA tensors, twin for CPU tensors
# ---------------------------------------------------------------------------


def _device_kind(scene: TorchScene) -> str:
    kind = scene.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no path kernel for device {scene.device}")
    return kind


def path_trace_gen(scene: TorchScene, par, meta, wave_size: int,
                   max_bounce: int, gen: GenParams, emit_key: bool = False,
                   emit_idx: bool = False, counts=None, sweeps=None):
    """Generate one wave of primary rays and path-trace its first
    ``max_bounce`` bounces.  Returns the (16, R) state; with ``emit_key``
    row 15 holds the beam-sort key (int32 bit pattern); with ``emit_idx``
    returns (state, idx (R,) int32): each ray's last winner triangle, which
    seeds the continuation's previous-hit exclusion.

    ``par`` (32,) f32 on the scene's device (PAR_* rows); ``meta`` 8 ints
    (META_* rows).  ``counts`` (3,) int64 on the scene's device gets the
    wave's rays alive at each bounce's trace, tiles swept and boxes tested
    added, and ``sweeps`` (2,) int64 the flat tile loop's tiles swept
    lane-parallel and passing lanes swept by the whole warp (inside the
    kernel on the card: no operation of its own)."""
    if _device_kind(scene) == "cpu":
        return path_trace_gen_ref(scene, par, meta, wave_size, max_bounce,
                                  gen, emit_key, emit_idx, counts, sweeps)
    state = torch.empty((16, wave_size), dtype=torch.float32, device=scene.device)
    idx = torch.empty(wave_size, dtype=torch.int32, device=scene.device)
    kernels.launch_path_trace_gen(scene, par, meta, gen, max_bounce, emit_key,
                                  state, idx, counts=counts, sweeps=sweeps)
    return (state, idx) if emit_idx else state


def path_trace_fused(scene: TorchScene, state16, max_bounce: int,
                     bounce0: int = 0, prev=None, emit_idx: bool = False, counts=None,
                     sweeps=None):
    """Path-trace ``max_bounce`` bounces numbered from ``bounce0`` (the RNG
    tags are per absolute bounce).  ``prev`` (R,) int32: each ray's previous
    hit, excluded at the first bounce.  Returns the (16, R) state, or
    (state, idx) with ``emit_idx``.  ``counts`` and ``sweeps`` as
    ``path_trace_gen``'s."""
    if _device_kind(scene) == "cpu":
        return path_trace_fused_ref(scene, state16, max_bounce, bounce0, prev,
                                    emit_idx, counts, sweeps)
    R = state16.shape[1]
    state = torch.empty((16, R), dtype=torch.float32, device=scene.device)
    idx = torch.empty(R, dtype=torch.int32, device=scene.device)
    kernels.launch_path_trace(scene, state16, prev, bounce0, max_bounce, state, idx,
                              counts=counts, sweeps=sweeps)
    return (state, idx) if emit_idx else state


def shade_fused(scene: TorchScene, state, aux, tri, bounce: int, rec=None):
    """One bounce of the per-bounce pipeline's shading → the new (16, R)
    state, from the (16, R) state, the trace's aux (8, R) and winners
    ``tri`` (R,) int32, and their records ``rec`` (24, R) (gathered from
    the scene's table when None).  ``bounce`` is the absolute bounce (RNG
    tags 2b+1, 2b+2).

    A dead ray's state passes through, as under the JAX function's
    ``block_skip``; its kernel decides per ray, so the port has no
    block_skip switch (on this path a dead ray's row 15 is already 0, the
    only row the JAX kernel would rewrite).

    The same kernel serves every bank.  The JAX function shades a resident
    bank in one kernel (``_make_shade1_kernel``) and any other bank in three
    steps: ``_make_prep_kernel`` (interpolation and texel indices), an XLA
    gather of u16×2-packed texels, ``_make_shade_kernel``; the split exists
    because a TPU kernel cannot gather from a bank past its VMEM.  Here a
    texel is one float4 load from the (P, 4) bank at any P below 2^24, so
    ``shade_kernel`` computes the 3-stage result too (the indices of
    ``prep_math_ref``, the texels, ``_shade_live``).  JAX's gather fills an
    out-of-range index where the kernel clamps it; such indices come only
    from missed or dead lanes, whose texels are masked."""
    if _device_kind(scene) == "cpu":
        return shade_fused_ref(scene, state, aux, tri, bounce, rec)
    if rec is None:
        rec = records_ref(scene.rec_table, aux[2], tri.to(torch.int64))
    out = torch.empty_like(state)
    kernels.launch_shade(scene, state, aux, rec, bounce, out)
    return out
