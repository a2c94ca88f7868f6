"""Triangle bake and nearest hit in the transform form.

The port of ``zig_raytracing_contest_tpu/ops/mxu_intersect.py``: the NumPy
bake (``_bvh_order``, ``_build_heap``, ``bake_triangles``) is copied as it
is, so the port's arrays equal the JAX package's (tests/test_torch_bake.py),
and ``nearest_hit_ref`` is the plain PyTorch twin of the resident trace
body's flat tile loop (``_trace_body_resident`` with ``_cull_any`` and
``_tile_update``).  The CUDA kernels (kernels/path_trace.cu) run the same
arithmetic per ray.

Every triangle (v0, e1, e2) is baked into its world→barycentric affine
transform M = [e1 e2 n]⁻¹ (n = e1 × e2), c = -M·v0.  For a ray (o, d):

    o' = M·o + c        d' = M·d
    t  = -o'_w / d'_w   u = o'_u + t·d'_u     v = o'_v + t·d'_v

and the reference's back-face cull ``det < 1e-8`` (src/linalg.zig:705)
becomes ``-d'_w · |n|² < 1e-8`` with |n|² baked per triangle.

Tie rule: within a tile the lowest index wins, across tiles a later tile
replaces the best only on a strictly smaller t; on the ascending flat loop
that is the lexicographic minimum of (t, Morton index).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MT_EPSILON = 1e-8
INF = float("inf")

TRI_TILE = 256
TRI_TILE_SMALL = 128  # resident scenes (scene/types.py picks)
GROUP_TILES = 8  # tiles per second-level cull group

# tri_data row layout: 9 rows of M (row-major), 3 rows of c, 1 row of |n|²,
# padded to 16 rows.
_ROWS = 13
_BANK_ROWS = 16

# Past this many padded triangles the JAX package leaves the whole-path
# regime for the per-bounce pipeline (ops/mxu_intersect.py REC_EMIT_MAX_TRIS).
REC_EMIT_MAX_TRIS = 1 << 15
# Resident scenes (VMEM_RESIDENT_MAX_TRIS in the JAX package) bake 128-
# triangle tiles.
VMEM_RESIDENT_MAX_TRIS = 1 << 17


@dataclass(frozen=True)
class MXUTriangles:
    """Baked, BVH-ordered triangle bank (NumPy), padded to a group quantum.

    tri_data:  (16, Tp) f32 — transforms in Morton order; padding has
               |n|² = 0, which the det test culls unconditionally.
    tile_bbox: (6, ceil(T / tile)) f32 — [min xyz, max xyz] per REAL tile.
    perm:      (Tp,) int32 — Morton position → original triangle id.
    group_bbox / tree_bbox / group_tree_bbox: the JAX package's cull
               groups and implicit heaps, kept for parity of the bake; the
               flat tile loop reads none of them.
    """

    tri_data: np.ndarray
    tile_bbox: np.ndarray
    perm: np.ndarray
    group_bbox: np.ndarray
    tree_bbox: np.ndarray
    group_tree_bbox: np.ndarray
    tile: int = TRI_TILE
    group_tiles: int = GROUP_TILES


def _bvh_order(centroid: np.ndarray, tile: int) -> np.ndarray:
    """BVH-quality triangle order: recursive capacity-aligned spatial splits
    (copied from the JAX package: each heap node covers a set that an
    actual axis partition produced, and real tiles stay a prefix)."""
    T = centroid.shape[0]
    num_tiles = -(-max(T, 1) // tile)
    p2 = 1
    while p2 < num_tiles:
        p2 *= 2
    out = np.empty(T, np.int64)
    pos = 0
    stack: list[tuple[np.ndarray, int]] = [(np.arange(T, dtype=np.int64), p2)]
    while stack:
        idx, cap = stack.pop()
        n = idx.shape[0]
        if n == 0:
            continue
        if cap == 1 or n <= tile:
            out[pos : pos + n] = idx
            pos += n
            continue
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n_left = min(n, (cap // 2) * tile)
        part = np.argpartition(c[:, axis], n_left - 1)
        stack.append((idx[part[n_left:]], cap // 2))  # right (popped later)
        stack.append((idx[part[:n_left]], cap // 2))  # left (popped first)
    return out


def _build_heap(leaf_bbox: np.ndarray) -> np.ndarray:
    """(6, N) leaf boxes → (6, 2·P2) implicit binary heap (P2 = next pow2);
    empty subtrees store the always-miss box [min=max=+inf]."""
    n = leaf_bbox.shape[1]
    p2 = 1
    while p2 < n:
        p2 *= 2
    tree = np.zeros((6, 2 * p2), np.float32)
    tree[0:3, :] = np.float32(np.inf)
    tree[3:6, :] = -np.float32(np.inf)
    tree[:, p2 : p2 + n] = leaf_bbox
    for i in range(p2 - 1, 0, -1):
        tree[0:3, i] = np.minimum(tree[0:3, 2 * i], tree[0:3, 2 * i + 1])
        tree[3:6, i] = np.maximum(tree[3:6, 2 * i], tree[3:6, 2 * i + 1])
    em = (tree[3:6] < tree[0:3]).any(axis=0)
    tree[:, em] = np.float32(np.inf)
    return tree


def bake_triangles(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    tile: int = TRI_TILE,
    group_tiles: int = GROUP_TILES,
) -> MXUTriangles:
    """Host-side bake: MT arrays → BVH-ordered transform bank + tile boxes
    (float64 inverses, cast to f32)."""
    assert tile % 128 == 0, f"tile {tile} must be a multiple of 128"
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = v0.shape[0]

    centroid = v0 + (e1 + e2) / 3.0
    order = _bvh_order(centroid, tile)
    v0, e1, e2 = v0[order], e1[order], e2[order]

    n = np.cross(e1, e2)
    n_sq = np.sum(n * n, axis=-1)
    # M rows are the reciprocal basis of [e1 e2 n]; det3 = dot(e1, e2×n) = |n|².
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det3 = 1.0 / n_sq
        r_u = np.cross(e2, n) * inv_det3[:, None]
        r_v = np.cross(n, e1) * inv_det3[:, None]
        r_w = n * inv_det3[:, None]
    M = np.stack([r_u, r_v, r_w], axis=1)  # (T, 3, 3)
    c = -np.einsum("tak,tk->ta", M, v0)  # (T, 3)

    quantum = tile * group_tiles
    Tp = -(-max(T, 1) // quantum) * quantum
    tri_data = np.zeros((_BANK_ROWS, Tp), np.float32)
    tri_data[0:9, :T] = M.reshape(T, 9).T.astype(np.float32)
    tri_data[9:12, :T] = c.T.astype(np.float32)
    tri_data[12, :T] = n_sq.astype(np.float32)

    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T, 3, 3)
    num_tiles = -(-max(T, 1) // tile)
    tile_bbox = np.zeros((6, num_tiles), np.float32)
    tile_bbox[0:3] = np.float32(np.inf)
    tile_bbox[3:6] = -np.float32(np.inf)
    for ti in range(num_tiles):
        chunk = verts[ti * tile : min((ti + 1) * tile, T)]
        if len(chunk):
            flat = chunk.reshape(-1, 3)
            tile_bbox[0:3, ti] = flat.min(axis=0)
            tile_bbox[3:6, ti] = flat.max(axis=0)

    num_groups = -(-num_tiles // group_tiles)
    group_bbox = np.zeros((6, num_groups), np.float32)
    g_pad = np.full((6, num_groups * group_tiles), np.nan, np.float32)
    g_pad[0:3] = np.float32(np.inf)
    g_pad[3:6] = -np.float32(np.inf)
    g_pad[:, :num_tiles] = tile_bbox
    g_tiles = g_pad.reshape(6, num_groups, group_tiles)
    group_bbox[0:3] = g_tiles[0:3].min(axis=2)
    group_bbox[3:6] = g_tiles[3:6].max(axis=2)

    perm = np.zeros(Tp, np.int32)
    perm[:T] = order.astype(np.int32)
    return MXUTriangles(
        tri_data=tri_data,
        tile_bbox=tile_bbox,
        perm=perm,
        group_bbox=group_bbox,
        tree_bbox=_build_heap(tile_bbox),
        group_tree_bbox=_build_heap(group_bbox),
        tile=tile,
        group_tiles=group_tiles,
    )


def cull_mask_ref(box: torch.Tensor, o, inv, best, active):
    """Per-ray pass mask of the slab test against one (6,) box vs the running
    best t (``_cull_mask``).  NaN-robust conservative form: a 0·inf NaN must
    NOT skip the box, so every miss condition is a comparison that a NaN
    evaluates False; min/max propagate NaN like the JAX package's."""
    tx1 = (box[0] - o[0]) * inv[0]
    tx2 = (box[3] - o[0]) * inv[0]
    ty1 = (box[1] - o[1]) * inv[1]
    ty2 = (box[4] - o[1]) * inv[1]
    tz1 = (box[2] - o[2]) * inv[2]
    tz2 = (box[5] - o[2]) * inv[2]
    tmin = torch.maximum(
        torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2)),
        torch.minimum(tz1, tz2),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2)),
        torch.maximum(tz1, tz2),
    )
    box_miss = (tmin > tmax) | (tmax <= 0.0) | (tmin >= best)
    return active & ~box_miss


# Rays per vectorized chunk of the twin: bounds the (chunk, tile) temporaries.
_RAY_CHUNK = 1 << 15


def nearest_hit_ref(tri_data: torch.Tensor, tile_bbox: torch.Tensor, tile: int,
                    o: torch.Tensor, d: torch.Tensor, active: torch.Tensor,
                    prev: torch.Tensor | None = None):
    """Nearest front-facing hit over the flat tile loop.

    ``o``/``d``: (3, R) f32; ``active``: (R,) bool; ``prev``: optional (R,)
    int64 Morton index each ray may not hit again (the previous hit).  Each
    real tile is culled per ray against its box and the running best, then
    folded with the tie rule above.  Returns (t, idx, u, v): t = +inf,
    idx = u = v = 0 where nothing was hit.
    """
    R = o.shape[1]
    out = [torch.empty(R, dtype=dt, device=o.device)
           for dt in (torch.float32, torch.int64, torch.float32, torch.float32)]
    for c0 in range(0, R, _RAY_CHUNK):
        sl = slice(c0, min(c0 + _RAY_CHUNK, R))
        res = _nearest_hit_chunk(
            tri_data, tile_bbox, tile, o[:, sl], d[:, sl], active[sl],
            None if prev is None else prev[sl],
        )
        for dst, src in zip(out, res):
            dst[sl] = src
    return tuple(out)


def _nearest_hit_chunk(tri_data, tile_bbox, tile, o, d, active, prev):
    R = o.shape[1]
    dev = o.device
    best_t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    inv = [1.0 / d[a] for a in range(3)]
    ox, oy, oz = (o[a][:, None] for a in range(3))
    dx, dy, dz = (d[a][:, None] for a in range(3))
    ids = torch.arange(tile, device=dev)
    for j in range(tile_bbox.shape[1]):
        passed = cull_mask_ref(tile_bbox[:, j], o, inv, best_t, active)
        if not bool(passed.any()):
            continue
        s = j * tile
        rows = tri_data[:_ROWS, s : s + tile]
        m = [rows[r][None, :] for r in range(_ROWS)]
        ou = m[0] * ox + m[1] * oy + m[2] * oz + m[9]
        ov = m[3] * ox + m[4] * oy + m[5] * oz + m[10]
        ow = m[6] * ox + m[7] * oy + m[8] * oz + m[11]
        du = m[0] * dx + m[1] * dy + m[2] * dz
        dv = m[3] * dx + m[4] * dy + m[5] * dz
        dw = m[6] * dx + m[7] * dy + m[8] * dz
        t = -ow / dw
        u = ou + t * du
        v = ov + t * dv
        det = -dw * m[12]
        ok = (det >= MT_EPSILON) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        if prev is not None:
            ok = ok & ((ids[None, :] + s) != prev[:, None])
        t = torch.where(ok, t, INF)
        tile_min = t.min(dim=1).values
        cand = torch.where(t <= tile_min[:, None], ids[None, :], tile).min(dim=1).values
        cand_c = cand.clamp_max(tile - 1)[:, None]
        better = passed & (tile_min < best_t)
        best_t = torch.where(better, tile_min, best_t)
        best_i = torch.where(better, s + cand, best_i)
        best_u = torch.where(better, u.gather(1, cand_c)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, cand_c)[:, 0], best_v)
    return best_t, best_i, best_u, best_v
