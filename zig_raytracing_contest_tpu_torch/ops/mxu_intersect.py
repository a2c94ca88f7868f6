"""Triangle bake and nearest hit in the transform form.

The port of ``zig_raytracing_contest_tpu/ops/mxu_intersect.py``: the NumPy
bake (``_bvh_order``, ``_build_heap``, ``bake_triangles``) is copied as it
is, so the port's arrays equal the JAX package's (tests/test_torch_bake.py),
and ``nearest_hit_ref`` is the plain PyTorch twin of the resident trace
body's flat tile loop (``_trace_body_resident`` with ``_cull_any`` and
``_tile_update``).  The CUDA kernels (kernels/path_trace.cu) run the same
arithmetic per ray.  ``trace_emit_aux`` is the per-bounce pipeline's
nearest hit: its CUDA kernels walk the tile heap (``tree_bbox``) of a
resident scene or the group heap (``group_tree_bbox``) of a streaming one,
its twin ``trace_emit_aux_ref`` is the flat loop plus the record load.

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

from .. import kernels

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
# Read at call time (render/wavefront.py), so a test can lower it.
REC_EMIT_MAX_TRIS = 1 << 15
# Resident scenes (VMEM_RESIDENT_MAX_TRIS in the JAX package) bake 128-
# triangle tiles; past it the JAX package streams the bank from HBM.  Past
# it in padded triangles, trace_emit_aux launches the streaming kernel.
# Read at call time, so a test can lower it.
VMEM_RESIDENT_MAX_TRIS = 1 << 17


@dataclass(frozen=True)
class MXUTriangles:
    """Baked, BVH-ordered triangle bank (NumPy), padded to a group quantum.

    tri_data:  (16, Tp) f32 — transforms in Morton order; padding has
               |n|² = 0, which the det test culls unconditionally.
    tile_bbox: (6, ceil(T / tile)) f32 — [min xyz, max xyz] per REAL tile.
    perm:      (Tp,) int32 — Morton position → original triangle id.
    group_bbox / tree_bbox / group_tree_bbox: the cull groups' boxes and
               the implicit heaps over the tiles and over the groups (the
               per-bounce trace kernels walk them; the flat loop reads
               none of them).
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
                    prev: torch.Tensor | None = None, widen=None):
    """Nearest front-facing hit over the flat tile loop.

    ``o``/``d``: (3, R) f32; ``active``: (R,) bool; ``prev``: optional (R,)
    int64 Morton index each ray may not hit again (the previous hit).  Each
    real tile is culled per ray against its box and the running best, then
    folded with the tie rule above.  ``widen``, when given, maps each
    tile's per-ray pass mask to the rays that sweep the tile (a cull
    variant of the trace micro-benchmark; rays are handed to it in chunks
    of a multiple of 32 from ray 0).  Returns (t, idx, u, v, swept): t =
    +inf, idx = u = v = 0 where nothing was hit; ``swept`` (R,) f32 counts
    the tiles each ray swept (the work a per-ray kernel does).
    """
    R = o.shape[1]
    out = [torch.empty(R, dtype=dt, device=o.device)
           for dt in (torch.float32, torch.int64, torch.float32, torch.float32,
                      torch.float32)]
    for c0 in range(0, R, _RAY_CHUNK):
        sl = slice(c0, min(c0 + _RAY_CHUNK, R))
        res = _nearest_hit_chunk(
            tri_data, tile_bbox, tile, o[:, sl], d[:, sl], active[sl],
            None if prev is None else prev[sl], widen,
        )
        for dst, src in zip(out, res):
            dst[sl] = src
    return tuple(out)


def _transform_hit(m, o, d):
    """(front-facing hit, t, u, v) of the transform-form test: ``m`` the 13
    rows of tri_data, broadcast against the ray components ``o``, ``d``."""
    ou = m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[9]
    ov = m[3] * o[0] + m[4] * o[1] + m[5] * o[2] + m[10]
    ow = m[6] * o[0] + m[7] * o[1] + m[8] * o[2] + m[11]
    du = m[0] * d[0] + m[1] * d[1] + m[2] * d[2]
    dv = m[3] * d[0] + m[4] * d[1] + m[5] * d[2]
    dw = m[6] * d[0] + m[7] * d[1] + m[8] * d[2]
    t = -ow / dw
    u = ou + t * du
    v = ov + t * dv
    det = -dw * m[12]
    ok = (det >= MT_EPSILON) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return ok, t, u, v


def triangle_hit_ref(tri_data: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                     idx: torch.Tensor):
    """(hit, t, u, v) of each ray (o, d: (3, R)) against its own triangle
    ``idx`` (R,), with the flat loop's arithmetic: the check of a winner
    that another triangle ties at the same t."""
    m = tri_data[:_ROWS, idx.to(torch.int64)]
    return _transform_hit(m, o, d)


def _nearest_hit_chunk(tri_data, tile_bbox, tile, o, d, active, prev, widen):
    R = o.shape[1]
    dev = o.device
    best_t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    swept = torch.zeros(R, dtype=torch.float32, device=dev)
    inv = [1.0 / d[a] for a in range(3)]
    ox, oy, oz = (o[a][:, None] for a in range(3))
    dx, dy, dz = (d[a][:, None] for a in range(3))
    ids = torch.arange(tile, device=dev)
    for j in range(tile_bbox.shape[1]):
        passed = cull_mask_ref(tile_bbox[:, j], o, inv, best_t, active)
        if widen is not None:
            passed = widen(passed)
        # Sweep only the lanes whose box test passed: the same per-lane
        # arithmetic as a sweep of every lane, at the cost of the tile's
        # real work.
        lanes = passed.nonzero()[:, 0]
        if lanes.numel() == 0:
            continue
        swept += passed
        s = j * tile
        rows = tri_data[:_ROWS, s : s + tile]
        ok, t, u, v = _transform_hit([rows[r][None, :] for r in range(_ROWS)],
                                     tuple(c[lanes] for c in (ox, oy, oz)),
                                     tuple(c[lanes] for c in (dx, dy, dz)))
        if prev is not None:
            ok = ok & ((ids[None, :] + s) != prev[lanes, None])
        t = torch.where(ok, t, INF)
        tile_min = t.min(dim=1).values
        cand = torch.where(t <= tile_min[:, None], ids[None, :], tile).min(dim=1).values
        cand_c = cand.clamp_max(tile - 1)[:, None]
        better = tile_min < best_t[lanes]
        win = lanes[better]
        best_t[win] = tile_min[better]
        best_i[win] = s + cand[better]
        best_u[win] = u.gather(1, cand_c)[better, 0]
        best_v[win] = v.gather(1, cand_c)[better, 0]
    return best_t, best_i, best_u, best_v, swept


def records_ref(table: torch.Tensor, t: torch.Tensor, idx: torch.Tensor):
    """The winner's (24,) column of the (24, Tp) record ``table`` per ray,
    zeros on a miss (the JAX kernels' record extraction reads a miss as
    zeros)."""
    return torch.where((t < INF)[None, :], table[:, idx], 0.0)


def trace_emit_aux_ref(scene, state16: torch.Tensor, rec_table=None, prev=None,
                       counts=None):
    """Plain twin of ``trace_emit_aux``: the flat tile loop and the record
    load.  aux rows 5-6 count, per ray, the tiles swept and the tile boxes
    tested (every real tile for a live ray); ``counts`` gets their sums
    and the rays alive added, as the kernels add theirs."""
    alive = state16[12] > 0.0
    t, idx, u, v, swept = nearest_hit_ref(
        scene.tri_data, scene.tile_bbox, scene.tile, state16[0:3], state16[3:6],
        alive, prev,
    )
    tested = alive.to(torch.float32) * scene.tile_bbox.shape[1]
    aux = torch.stack([u, v, t, state16[13], state16[12], swept, tested,
                       torch.zeros_like(t)])
    rec = None if rec_table is None else records_ref(rec_table, t, idx)
    if counts is not None:
        counts += torch.stack([alive.sum(), swept.to(torch.int64).sum(),
                               tested.to(torch.int64).sum()])
    return aux, idx.to(torch.int32), rec


def streams_bank(scene) -> bool:
    """The scene takes the streaming trace: more than VMEM_RESIDENT_MAX_TRIS
    padded triangles (the JAX package's ``trace_emit_aux`` test)."""
    return scene.tri_data.shape[1] > VMEM_RESIDENT_MAX_TRIS


def trace_emit_aux(scene, state16: torch.Tensor, rec_table=None, prev=None, counts=None):
    """Field-major nearest hit of the per-bounce pipeline (the JAX
    package's ``trace_emit_aux``): (16, R) state → (aux (8, R) f32,
    idx (R,) int32 Morton index, rec (24, R) f32 or None).

    aux rows: [u, v, t, streams, alive, tiles swept, boxes tested, 0]; a
    dead or missing ray has t = +inf, u = v = 0, idx = 0 and an all-zero
    record.  ``rec_table`` (24, Tp): the Morton-ordered packed records to
    emit the winner's from (None: no record).  ``prev`` (R,) int32: each
    ray's previous hit, never hit again.  ``counts``: None, or (3,) int64
    on the scene's device that gets the sums of aux rows 4-6 added (rays
    alive, tiles swept, boxes tested): inside the kernel on the card, so
    the call adds no operation.

    On a CUDA scene this launches ``trace_emit_kernel`` (a per-ray walk of
    ``scene.tree_bbox``) or, past VMEM_RESIDENT_MAX_TRIS padded triangles,
    ``trace_stream_kernel`` (a per-ray walk of ``scene.group_tree_bbox``,
    sweeping each reached group's tiles); on a CPU scene it runs
    ``trace_emit_aux_ref``.  They find the same nearest t; where two
    triangles tie at that t the walks keep the first they swept, the flat
    loop the lower index."""
    kind = scene.device.type
    if kind == "cpu":
        return trace_emit_aux_ref(scene, state16, rec_table, prev, counts)
    if kind != "cuda":
        raise ValueError(f"no trace kernel for device {scene.device}")
    R = state16.shape[1]
    dev = scene.device
    aux = torch.empty((8, R), dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    rec = (None if rec_table is None
           else torch.empty((24, R), dtype=torch.float32, device=dev))
    if streams_bank(scene):
        kernels.launch_trace_stream(scene, state16, prev, rec_table, aux, idx, rec,
                                    counts=counts)
    else:
        kernels.launch_trace_emit(scene, state16, prev, rec_table, aux, idx, rec,
                                  counts=counts)
    return aux, idx, rec
