"""Uniform-grid acceleration structure builder (host side, NumPy).

A copy of ``zig_raytracing_contest_tpu/grid/builder.py``: stage2's two-pass
counting sort (src/stage2.zig:44-135) and bake (src/stage2.zig:137-164).
The scene box over every triangle vertex, a fixed resolution from the
config, exact 13-axis SAT triangle–AABB binning (src/linalg.zig:500-563,
edges normalized first :524-526), per-cell ``[begin, end)`` ranges, and
triangles duplicated per overlapping cell in x-fastest, z-major cell order,
each cell's list in triangle-index order.

The reference's per-triangle loops are one vectorized pass over all
(triangle, candidate cell) pairs, generated triangle-major so that a
stable sort by cell gives the reference's per-cell order, in chunks of
bounded memory.  ``scene_bbox`` is the box alone, which the beam-sort keys
of the MXU regimes read (``render/wavefront.build_gen_par``).  The OpenMP
builder (``grid/native.py``) returns the same build; the tests hold the
two equal, and this one is the fallback where no compiler can build it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

_SAT_CHUNK = 1 << 20  # candidate pairs per vectorized SAT batch


def scene_bbox(positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """positions: (T, 3, 3) world triangles → (bbox_min, bbox_max) (3,) f32
    (initGrid, src/stage2.zig:44-57)."""
    verts = np.asarray(positions, np.float32).reshape(-1, 3)
    return verts.min(axis=0), verts.max(axis=0)


@dataclass
class GridBuild:
    bbox_min: np.ndarray  # (3,) f32
    bbox_max: np.ndarray  # (3,) f32
    resolution: np.ndarray  # (3,) int32
    cell_size: np.ndarray  # (3,) f32
    cell_begin: np.ndarray  # (C,) int32 — C = rx*ry*rz, x-fastest z-major
    cell_end: np.ndarray  # (C,) int32
    dup_to_tri: np.ndarray  # (D,) int32 — duplicated triangle indices
    stats: dict


def _get_cell_idx(p: np.ndarray, bbox_min, cell_size, resolution) -> np.ndarray:
    """(N, 3) points → clamped int cell indices (src/linalg.zig:424-427)."""
    idx = ((p - bbox_min) / cell_size).astype(np.int32)
    return np.clip(idx, 0, resolution - 1)


def sat_triangle_aabb(tri: np.ndarray, center: np.ndarray, extents: np.ndarray) -> np.ndarray:
    """Vectorized 13-axis SAT test (src/linalg.zig:500-563).

    tri: (K, 3, 3) world triangles; center/extents: (K, 3) per-candidate cell.
    Degenerate edges normalize to NaN; NaN projections never separate
    (`NaN > r` is False), matching the reference's IEEE behavior.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        a = tri[:, 0] - center
        b = tri[:, 1] - center
        c = tri[:, 2] - center

        def norm(v):
            return v / np.linalg.norm(v, axis=-1, keepdims=True)

        ab = norm(b - a)
        bc = norm(c - b)
        ca = norm(a - c)

        zeros = np.zeros(ab.shape[0], ab.dtype)
        axes = [
            # cross(edge, x-axis), cross(edge, y-axis), cross(edge, z-axis)
            np.stack([zeros, -ab[:, 2], ab[:, 1]], -1),
            np.stack([zeros, -bc[:, 2], bc[:, 1]], -1),
            np.stack([zeros, -ca[:, 2], ca[:, 1]], -1),
            np.stack([ab[:, 2], zeros, -ab[:, 0]], -1),
            np.stack([bc[:, 2], zeros, -bc[:, 0]], -1),
            np.stack([ca[:, 2], zeros, -ca[:, 0]], -1),
            np.stack([-ab[:, 1], ab[:, 0], zeros], -1),
            np.stack([-bc[:, 1], bc[:, 0], zeros], -1),
            np.stack([-ca[:, 1], ca[:, 0], zeros], -1),
            np.broadcast_to(np.asarray([1.0, 0, 0], ab.dtype), ab.shape),
            np.broadcast_to(np.asarray([0, 1.0, 0], ab.dtype), ab.shape),
            np.broadcast_to(np.asarray([0, 0, 1.0], ab.dtype), ab.shape),
            np.cross(ab, bc),
        ]

        intersects = np.ones(ab.shape[0], dtype=bool)
        for axis in axes:
            p0 = np.sum(a * axis, -1)
            p1 = np.sum(b * axis, -1)
            p2 = np.sum(c * axis, -1)
            r = np.sum(extents * np.abs(axis), -1)
            max_p = np.maximum(p0, np.maximum(p1, p2))
            min_p = np.minimum(p0, np.minimum(p1, p2))
            separated = np.maximum(-max_p, min_p) > r
            intersects &= ~separated
        return intersects


def _candidate_pairs(tri_lo: np.ndarray, tri_hi: np.ndarray):
    """Expand per-triangle cell ranges into (tri_id, cx, cy, cz) arrays,
    triangle-major (preserves reference per-cell triangle order)."""
    span = (tri_hi - tri_lo + 1).astype(np.int64)
    counts = span.prod(axis=1)
    total = int(counts.sum())
    tri_id = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(total, dtype=np.int64) - starts[tri_id]
    nx = span[tri_id, 0]
    ny = span[tri_id, 1]
    cx = tri_lo[tri_id, 0] + rank % nx
    cy = tri_lo[tri_id, 1] + (rank // nx) % ny
    cz = tri_lo[tri_id, 2] + rank // (nx * ny)
    return tri_id, cx, cy, cz


def build_grid(
    positions: np.ndarray,
    resolution,
    log: Callable[[str], None] | None = None,
) -> GridBuild:
    """positions: (T, 3, 3) world triangles; resolution: (3,) ints."""
    log = log or (lambda msg: None)
    positions = np.asarray(positions, np.float32)
    resolution = np.asarray(resolution, np.int32)

    # initGrid (src/stage2.zig:44-57)
    bbox_min, bbox_max = scene_bbox(positions)
    cell_size = ((bbox_max - bbox_min) / resolution.astype(np.float32)).astype(
        np.float32
    )
    log(f"Grid resolution: {tuple(int(r) for r in resolution)}")

    tri_min = positions.min(axis=1)
    tri_max = positions.max(axis=1)
    tri_lo = _get_cell_idx(tri_min, bbox_min, cell_size, resolution)
    tri_hi = _get_cell_idx(tri_max, bbox_min, cell_size, resolution)

    tri_id, cx, cy, cz = _candidate_pairs(tri_lo, tri_hi)

    keep_chunks = []
    for s in range(0, len(tri_id), _SAT_CHUNK):
        e = min(s + _SAT_CHUNK, len(tri_id))
        ids = tri_id[s:e]
        cell = np.stack([cx[s:e], cy[s:e], cz[s:e]], axis=-1).astype(np.float32)
        # getCellBbox (src/linalg.zig:433-441) then center/extents
        # (src/linalg.zig:316-322) — float op order matters for boundary
        # cells, so follow the reference formula exactly.
        lo = (bbox_min + cell * cell_size).astype(np.float32)
        hi = (lo + cell_size).astype(np.float32)
        center = (lo + hi) * np.float32(0.5)
        extents = (hi - lo) * np.float32(0.5)
        keep_chunks.append(sat_triangle_aabb(positions[ids], center, extents))
    keep = (
        np.concatenate(keep_chunks) if keep_chunks else np.zeros(0, dtype=bool)
    )

    tri_id = tri_id[keep]
    rx, ry = int(resolution[0]), int(resolution[1])
    cell_lin = (cz[keep] * ry + cy[keep]) * rx + cx[keep]

    num_cells = int(resolution.prod(dtype=np.int64))
    counts = np.bincount(cell_lin, minlength=num_cells).astype(np.int64)
    begin = np.concatenate([[0], np.cumsum(counts)[:-1]])
    end = begin + counts

    # Stable sort by cell keeps triangle-major generation order within each
    # cell — identical to the reference's pass-2 write order
    # (src/stage2.zig:104-129).
    order = np.argsort(cell_lin, kind="stable")
    dup_to_tri = tri_id[order].astype(np.int32)

    # Stats logging parity (src/stage2.zig:97-100, 126-128).
    nonzero = counts[counts > 0]
    total_refs = int(counts.sum())
    empty = num_cells - len(nonzero)
    if len(nonzero):
        log(
            "Empty cells: {}/{} ({:.2f}%) min triangles: {} max triangles: {} "
            "mean_triangles: {}".format(
                empty,
                num_cells,
                empty / num_cells * 100,
                int(nonzero.min()),
                int(nonzero.max()),
                total_refs // len(nonzero),
            )
        )
    num_tri = positions.shape[0]
    if total_refs:
        log(
            "Unique triangle count: {}/{} ({:.2f}%)".format(
                num_tri, total_refs, num_tri / total_refs * 100
            )
        )

    return GridBuild(
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        resolution=resolution,
        cell_size=cell_size,
        cell_begin=begin.astype(np.int32),
        cell_end=end.astype(np.int32),
        dup_to_tri=dup_to_tri,
        stats={
            "num_cells": num_cells,
            "empty_cells": int(empty),
            "total_refs": total_refs,
            "min_tris": int(nonzero.min()) if len(nonzero) else 0,
            "max_tris": int(nonzero.max()) if len(nonzero) else 0,
            "duplication": total_refs / max(num_tri, 1),
        },
    )
