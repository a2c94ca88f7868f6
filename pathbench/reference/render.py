"""The plain reference path tracer, in PyTorch: the frame a run's program
must produce, worked out again from the scene file, the camera and the
seed.

The semantics are the upstream renderer's (tigrazone/zig_raytracing_contest,
src/stage3.zig), with its sampling rules:

* a counter-based hash gives every random draw from (seed, ray id, tag,
  word): the ray id of pixel (x, y) and sample s is ``(y·width + x)·spp + s``;
* the primary ray passes through the pixel jittered by the draw of tag 0;
* per bounce ``b`` (at most ``max_bounce``) a live ray counts one traced
  segment and finds its nearest hit: Möller–Trumbore with back faces
  culled (det < 1e-8), barycentrics in the triangle, t > 0, never the
  triangle it left; ties go to the first found;
* a miss adds the sky ``lerp(white, (0.5, 0.7, 1.0), (dir.y + 1) / 2)``
  times the throughput and ends the ray;
* a hit interpolates the texcoords and the (unnormalised) normal, samples
  the base (albedo, opacity) and emissive textures bilinearly with the
  upstream quirks (texel ``floor(size·uv)``, wrapped or clamped, weights
  ``|uv - trunc(uv)|`` of the raw uv), and re-originates at
  ``t + FLT_EPSILON``; a draw of tag 2b+1 above the opacity passes
  straight through; else the emissive times the throughput is added, the
  throughput takes the albedo and the ray scatters to
  ``normalize(normal + normalize(gauss))``, the Gaussian from four words
  of tag 2b+2 by Box–Muller;
* a pixel is the mean of its samples, encoded as
  ``trunc(min(c^(1/2.2), 0.999999)·256)``.

The nearest hit is found through the reference's own uniform grid and a
3D-DDA walk (upstream's acceleration structure), built here from the
triangles; a grid only prunes, so the hit is the exhaustive test's.  The
triangle test takes one of the two forms the system's backends compute,
both exact in real numbers: Möller–Trumbore on the vertices (``"mt"``, the
grid backend) or the baked transform (``"transform"``, the default
backend: each triangle's reciprocal basis of (e1, e2, e1 x e2) and offset,
inverted in float64 and rounded to float32, so ``t = -ow / dw``).  The two
round differently, and where a re-originated ray meets the coplanar twin
of the quad it left (a two-sided quad) at t ≈ 0, the rounding decides the
hit: the reference computes the form of the backend it checks.

``dtype`` sets the precision of the arithmetic (the intersection, the
shading, the accumulation): float32 is the reference, and a lower type
(bfloat16) is the control that the comparison must fail.  The grid's
traversal and the random hash are exact in every precision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .scene import RefCamera, RefScene

MASK32 = 0xFFFFFFFF
FLT_EPSILON = 1.1920928955078125e-07
TWO_PI = 6.283185307179586
MT_EPSILON = 1e-8
GAMMA = 2.2
INF = float("inf")
TESTS_PER_STEP = 8  # references a ray tests of its cell per walk iteration
COMPACT_EVERY = 4  # walk iterations between drops of finished rays
CELLS_PER_TRIANGLE = 4  # the grid's cell count, per triangle
MAX_RES = 128  # cells per axis at most
CHUNK_RAYS = 1 << 20  # rays rendered together (whole pixels)


# --------------------------------------------------------------------------
# the hash


def _mul32(x, c: int):
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix(x):
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def streams_of(seed: int, ray_ids: torch.Tensor) -> torch.Tensor:
    s = (int(seed) & MASK32) * 0x9E3779B9 & MASK32
    return _mix((ray_ids & MASK32) ^ s ^ 0x85EBCA6B)


def uniform(streams, tag: int, word: int = 0) -> torch.Tensor:
    """The (tag, word) draw in (0, 1), float32: 24 bits, never 0."""
    t = (int(tag) * 2 + 1) & MASK32
    w = (word * 0x9E3779B9 + 0x6A09E667) & MASK32
    bits = _mix(streams ^ ((t * 0xB5297A4D) & MASK32) ^ w)
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


# --------------------------------------------------------------------------
# the scene on the device


@dataclass
class DeviceScene:
    form: str  # the triangle test: "mt" or "transform"
    tri: torch.Tensor  # (T, 9) v0, e1, e2 ("mt") or (T, 13) the transform's rows
    normals: torch.Tensor  # (T, 3, 3)
    texcoords: torch.Tensor  # (T, 3, 2)
    base: torch.Tensor  # (T,) texture id
    emissive: torch.Tensor
    texels: torch.Tensor  # (P, 4) every texture's texels
    tex_desc: torch.Tensor  # (N, 5) float32: offset, width, height, repeat u, repeat v
    grid: "Grid"


@dataclass
class Grid:
    lo: torch.Tensor  # (3,) float32
    cell: torch.Tensor  # (3,) cell size
    res: torch.Tensor  # (3,) int64
    begin: torch.Tensor  # (C,) int64
    end: torch.Tensor
    refs: torch.Tensor  # (N,) triangle ids, by cell

    @property
    def num_refs(self) -> int:
        return int(self.refs.shape[0])


def grid_resolution(lo: np.ndarray, hi: np.ndarray, num_triangles: int) -> np.ndarray:
    """CELLS_PER_TRIANGLE cells a triangle, as near cubes as the box
    allows, at most MAX_RES a side."""
    ext = np.maximum(hi - lo, 1e-6).astype(np.float64)
    density = (CELLS_PER_TRIANGLE * num_triangles / float(np.prod(ext))) ** (1.0 / 3.0)
    return np.clip(np.round(ext * density), 1, MAX_RES).astype(np.int64)


def build_grid(positions: torch.Tensor, res=None) -> Grid:
    """Bin every triangle into each cell its bounding box overlaps."""
    dev = positions.device
    pmin = positions.amin(dim=(0, 1))
    pmax = positions.amax(dim=(0, 1))
    pad = (pmax - pmin).clamp_min(1e-6) * 1e-4 + 1e-6
    lo, hi = pmin - pad, pmax + pad
    if res is None:
        res = grid_resolution(lo.cpu().numpy(), hi.cpu().numpy(), positions.shape[0])
    res_t = torch.as_tensor(np.asarray(res), dtype=torch.int64, device=dev)
    cell = (hi - lo) / res_t
    tlo = positions.amin(dim=1)
    thi = positions.amax(dim=1)
    c0 = torch.floor((tlo - lo) / cell).to(torch.int64).clamp(min=0)
    c1 = torch.floor((thi - lo) / cell).to(torch.int64)
    c0 = torch.minimum(c0, res_t - 1)
    c1 = torch.minimum(torch.maximum(c1, c0), res_t - 1)
    span = c1 - c0 + 1
    count = span.prod(dim=1)
    tri = torch.repeat_interleave(torch.arange(positions.shape[0], device=dev), count)
    first = torch.cumsum(count, 0) - count
    local = torch.arange(tri.shape[0], device=dev) - first[tri]
    sp = span[tri]
    cx = c0[tri, 0] + local % sp[:, 0]
    cy = c0[tri, 1] + (local // sp[:, 0]) % sp[:, 1]
    cz = c0[tri, 2] + local // (sp[:, 0] * sp[:, 1])
    cid = (cz * res_t[1] + cy) * res_t[0] + cx
    order = torch.argsort(cid, stable=True)
    cid, refs = cid[order], tri[order]
    num_cells = int(res_t.prod())
    counts = torch.bincount(cid, minlength=num_cells)
    end = torch.cumsum(counts, 0)
    return Grid(lo, cell, res_t, end - counts, end, refs)


def transform_rows(pos: np.ndarray) -> np.ndarray:
    """(T, 13) float32 of each triangle's transform: the rows of the
    reciprocal basis of (e1, e2, n = e1 x e2), the offset ``-M·v0`` and
    ``|n|^2``, worked out in float64 from the float32 vertices and edges."""
    v0 = pos[:, 0].astype(np.float64)
    e1 = (pos[:, 1] - pos[:, 0]).astype(np.float64)
    e2 = (pos[:, 2] - pos[:, 0]).astype(np.float64)
    n = np.cross(e1, e2)
    n_sq = np.sum(n * n, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / n_sq
        m = np.stack([np.cross(e2, n) * inv[:, None], np.cross(n, e1) * inv[:, None],
                      n * inv[:, None]], axis=1)
    c = -np.einsum("tak,tk->ta", m, v0)
    return np.concatenate([m.reshape(-1, 9), c, n_sq[:, None]], axis=1).astype(np.float32)


def upload(scene: RefScene, device, form: str = "mt") -> DeviceScene:
    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    pos = t(scene.positions)
    offsets, desc = 0, []
    for tex in scene.textures:
        desc.append([offsets, tex.width, tex.height, float(tex.repeat_u), float(tex.repeat_v)])
        offsets += tex.width * tex.height
    texels = np.concatenate([tex.texels for tex in scene.textures])
    mat = scene.material
    p = scene.positions
    rows = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=1) \
        if form == "mt" else transform_rows(p)
    return DeviceScene(
        form, t(rows),
        t(scene.normals), t(scene.texcoords), t(scene.mat_base[mat], torch.int64),
        t(scene.mat_emissive[mat], torch.int64), t(texels), t(np.asarray(desc, np.float64)),
        build_grid(pos))


# --------------------------------------------------------------------------
# the nearest hit


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def intersect(form: str, o, d, rows, dtype):
    """The triangle test of ``form`` in ``dtype`` → (hit, t, u, v), back
    faces culled; ``rows`` (..., 9 or 13) the triangles' data."""
    o, d, rows = o.to(dtype), d.to(dtype), rows.to(dtype)
    if form == "transform":
        m = [rows[..., k] for k in range(13)]
        ou = m[0] * o[..., 0] + m[1] * o[..., 1] + m[2] * o[..., 2] + m[9]
        ov = m[3] * o[..., 0] + m[4] * o[..., 1] + m[5] * o[..., 2] + m[10]
        ow = m[6] * o[..., 0] + m[7] * o[..., 1] + m[8] * o[..., 2] + m[11]
        du = m[0] * d[..., 0] + m[1] * d[..., 1] + m[2] * d[..., 2]
        dv = m[3] * d[..., 0] + m[4] * d[..., 1] + m[5] * d[..., 2]
        dw = m[6] * d[..., 0] + m[7] * d[..., 1] + m[8] * d[..., 2]
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        hit = (-dw * m[12] >= MT_EPSILON) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        return hit, t.float(), u.float(), v.float()
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv = 1.0 / det
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    hit = (det >= MT_EPSILON) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return hit, t.float(), u.float(), v.float()


def nearest_hit(ds: DeviceScene, o, d, exclude, dtype=torch.float32):
    """Each ray's nearest hit (t, u, v, triangle; triangle -1 on a miss)
    by the grid's 3D-DDA walk: a ray tests its cell's references, up to
    TESTS_PER_STEP an iteration, and steps to the next cell once they are
    done, until its best t lies within the cell or it leaves the grid."""
    g = ds.grid
    n = o.shape[0]
    dev = o.device
    out_t = torch.full((n,), INF, device=dev)
    out_u = torch.zeros(n, device=dev)
    out_v = torch.zeros(n, device=dev)
    out_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    hi = g.lo + g.cell * g.res
    inv = 1.0 / d
    ta, tb = (g.lo - o) * inv, (hi - o) * inv
    t_in = torch.minimum(ta, tb).nan_to_num(-INF).amax(dim=1).clamp_min(0.0)
    t_out = torch.maximum(ta, tb).nan_to_num(INF).amin(dim=1)
    lanes = (t_in <= t_out).nonzero()[:, 0]
    if lanes.numel() == 0:
        return out_t, out_u, out_v, out_i
    o, d, inv, ex = o[lanes], d[lanes], inv[lanes], exclude[lanes]
    entry = o + d * t_in[lanes, None]
    cell = torch.floor((entry - g.lo) / g.cell).to(torch.int64)
    cell = torch.minimum(cell.clamp_min(0), g.res - 1)
    step = torch.where(d > 0, 1, torch.where(d < 0, -1, 0))
    boundary = g.lo + (cell + (step > 0).to(torch.int64)) * g.cell
    t_next = torch.where(step != 0, (boundary - o) * inv, INF)
    t_delta = torch.where(step != 0, g.cell * inv.abs(), INF)
    cid = (cell[:, 2] * g.res[1] + cell[:, 1]) * g.res[0] + cell[:, 0]
    cursor, stop = g.begin[cid], g.end[cid]
    m = lanes.numel()
    best_t = torch.full((m,), INF, device=dev)
    best_u = torch.zeros(m, device=dev)
    best_v = torch.zeros(m, device=dev)
    best_i = torch.full((m,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    batch = torch.arange(TESTS_PER_STEP, device=dev)
    last_ref = max(g.num_refs - 1, 0)
    rows = torch.arange(3, device=dev)
    iteration = 0
    while True:
        idx = cursor[:, None] + batch
        has = (idx < stop[:, None]) & ~done[:, None]
        tri = g.refs[idx.clamp(max=last_ref)] if g.num_refs else torch.zeros_like(idx)
        hit, t, u, v = intersect(ds.form, o[:, None], d[:, None], ds.tri[tri], dtype)
        t = torch.where(has & hit & (tri != ex[:, None]), t, INF)
        k = t.argmin(dim=1, keepdim=True)
        t_k = t.gather(1, k)[:, 0]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
        best_i = torch.where(better, tri.gather(1, k)[:, 0], best_i)
        cursor = torch.minimum(cursor + TESTS_PER_STEP, stop)
        # a ray whose cell is done ends there or steps to the next cell
        spent = ~done & (cursor >= stop)
        axis = t_next.argmin(dim=1)
        t_exit = t_next.gather(1, axis[:, None])[:, 0]
        finish = spent & (best_t <= t_exit)
        move = spent & ~finish
        pick = (rows == axis[:, None]) & move[:, None]
        cell = cell + torch.where(pick, step, 0)
        t_next = t_next + torch.where(pick, t_delta, 0.0)
        outside = ((cell < 0) | (cell >= g.res)).any(dim=1)
        done = done | finish | (move & outside)
        cid = (cell[:, 2].clamp(0, None) * g.res[1] + cell[:, 1].clamp(0, None)) * g.res[0] \
            + cell[:, 0].clamp(0, None)
        cid = cid.clamp(max=g.begin.shape[0] - 1)
        entered = move & ~outside
        cursor = torch.where(entered, g.begin[cid], cursor)
        stop = torch.where(entered, g.end[cid], stop)
        iteration += 1
        if iteration % COMPACT_EVERY:
            continue
        out_t[lanes], out_u[lanes], out_v[lanes], out_i[lanes] = best_t, best_u, best_v, best_i
        keep = (~done).nonzero()[:, 0]
        if keep.numel() == 0:
            return out_t, out_u, out_v, out_i
        if keep.numel() < done.numel():
            lanes, o, d, ex = lanes[keep], o[keep], d[keep], ex[keep]
            cell, step, t_next, t_delta = cell[keep], step[keep], t_next[keep], t_delta[keep]
            cursor, stop, done = cursor[keep], stop[keep], done[keep]
            best_t, best_u, best_v, best_i = (x[keep] for x in (best_t, best_u, best_v, best_i))


# --------------------------------------------------------------------------
# shading


def sample(ds: DeviceScene, tex: torch.Tensor, tu, tv, dtype):
    """Bilinear RGBA of textures ``tex`` at (tu, tv), the upstream way."""
    desc = ds.tex_desc[tex]
    off, w, h = desc[:, 0].to(torch.int64), desc[:, 1], desc[:, 2]

    def pair(c, size, repeat):
        f = c - torch.floor(c)
        r1 = torch.minimum(torch.floor(size * f), size - 1)
        r2 = torch.where(r1 + 1 >= size, r1 + 1 - size, r1 + 1)
        cc = torch.floor(size * c.clamp(-2.0 ** 31, 2.0 ** 31))
        c1 = torch.minimum(cc.clamp_min(0), size - 1)
        c2 = torch.minimum((cc + 1).clamp_min(0), size - 1)
        rep = repeat > 0
        return (torch.where(rep, r1, c1).to(torch.int64),
                torch.where(rep, r2, c2).to(torch.int64))

    x1, x2 = pair(tu, w, desc[:, 3])
    y1, y2 = pair(tv, h, desc[:, 4])
    wi = w.to(torch.int64)

    def px(x, y):
        return ds.texels[off + y * wi + x].to(dtype)

    fu = (tu - torch.trunc(tu)).abs().to(dtype)[:, None]
    fv = (tv - torch.trunc(tv)).abs().to(dtype)[:, None]
    r1 = px(x1, y1) * (1 - fu) + px(x2, y1) * fu
    r2 = px(x1, y2) * (1 - fu) + px(x2, y2) * fu
    return r1 * (1 - fv) + r2 * fv


def _normalize(a):
    return a * (1.0 / torch.sqrt(_dot(a, a)))[..., None]


def trace_paths(ds: DeviceScene, o, d, streams, max_bounce: int, dtype):
    """Radiance (R, 3) and traced segments (R,) of the paths from (o, d)."""
    n = o.shape[0]
    dev = o.device
    radiance = torch.zeros((n, 3), dtype=dtype, device=dev)
    throughput = torch.ones((n, 3), dtype=dtype, device=dev)
    segments = torch.zeros(n, dtype=torch.int64, device=dev)
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    sky = torch.tensor([0.5, 0.7, 1.0], dtype=dtype, device=dev)
    for bounce in range(max_bounce):
        if live.numel() == 0:
            break
        segments[live] += 1
        t, u, v, tri = nearest_hit(ds, o, d, prev[live], dtype)
        miss = tri < 0
        rows = live[miss]
        s = (0.5 * (d[miss, 1].to(dtype) + 1.0))[:, None]
        radiance[rows] += throughput[rows] * ((1.0 - s) + sky * s)
        hit = ~miss
        live, o, d, t, u, v, tri = (x[hit] for x in (live, o, d, t, u, v, tri))
        if live.numel() == 0:
            break
        u_, v_ = u.to(dtype)[:, None], v.to(dtype)[:, None]
        w0 = 1.0 - u_ - v_
        uv = ds.texcoords[tri].to(dtype)
        tc = uv[:, 0] * w0 + uv[:, 1] * u_ + uv[:, 2] * v_
        nv = ds.normals[tri].to(dtype)
        normal = nv[:, 0] * w0 + nv[:, 1] * u_ + nv[:, 2] * v_
        tu, tv = tc[:, 0].float(), tc[:, 1].float()
        base = sample(ds, ds.base[tri], tu, tv, dtype)
        emis = sample(ds, ds.emissive[tri], tu, tv, dtype)[:, :3]
        st = streams[live]
        through = uniform(st, 2 * bounce + 1).to(dtype) > base[:, 3]
        u1, u2, u3, u4 = (uniform(st, 2 * bounce + 2, w).to(dtype) for w in range(4))
        r1 = torch.sqrt(-2.0 * torch.log(u1))
        r2 = torch.sqrt(-2.0 * torch.log(u3))
        gauss = torch.stack([r1 * torch.cos(TWO_PI * u2), r1 * torch.sin(TWO_PI * u2),
                             r2 * torch.cos(TWO_PI * u4)], dim=-1)
        scattered = _normalize(normal + _normalize(gauss))
        o = (o.to(dtype) + d.to(dtype) * (t.to(dtype) + FLT_EPSILON)[:, None]).float()
        shaded = ~through
        rows = live[shaded]
        radiance[rows] += throughput[rows] * emis[shaded]
        throughput[rows] = throughput[rows] * base[shaded, :3]
        d = torch.where(shaded[:, None], scattered.float(), d)
        prev[live] = tri
    return radiance, segments


def render(ds: DeviceScene, cam: RefCamera, spp: int, max_bounce: int, seed: int,
           dtype=torch.float32, chunk_rays: int = CHUNK_RAYS):
    """The frame: ((height, width, 3) uint8 on the host, traced segments)."""
    dev = ds.tri.device
    w, h = cam.width, cam.height
    num_pixels = w * h
    vec = [torch.as_tensor(v, dtype=torch.float32, device=dev)
           for v in (cam.origin, cam.lower_left, cam.right, cam.up)]
    image = torch.empty((num_pixels, 3), dtype=torch.uint8, device=dev)
    segments = 0
    pixels_per_chunk = max(1, chunk_rays // spp)
    for p0 in range(0, num_pixels, pixels_per_chunk):
        p1 = min(p0 + pixels_per_chunk, num_pixels)
        ids = torch.arange(p0 * spp, p1 * spp, dtype=torch.int64, device=dev)
        pix = ids // spp
        streams = streams_of(seed, ids)
        sx = (pix % w).to(torch.float32) + uniform(streams, 0, 0)
        sy = (pix // w).to(torch.float32) + uniform(streams, 0, 1)
        dr = vec[1] + vec[2] * sx[:, None] + vec[3] * sy[:, None]
        d = _normalize(dr.to(dtype)).float()
        o = vec[0].expand_as(d).to(dtype).float()
        rad, segs = trace_paths(ds, o, d, streams, max_bounce, dtype)
        segments += int(segs.sum())
        color = rad.reshape(-1, spp, 3).sum(dim=1) / spp
        encoded = torch.pow(color.float().clamp_min(0.0), 1.0 / GAMMA).nan_to_num(0.0)
        image[p0:p1] = (encoded.clamp(0.0, 0.999999) * 256.0).to(torch.uint8)
    return image.reshape(h, w, 3).cpu().numpy(), segments
