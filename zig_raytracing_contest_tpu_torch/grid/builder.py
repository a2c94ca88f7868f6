"""Scene bounding box — the part of the grid builder the main path needs.

The port of ``zig_raytracing_contest_tpu/grid/builder.py:125-126`` (initGrid,
src/stage2.zig:44-57): the box over every triangle vertex, in f32.  The
renderer reads it for the beam-sort keys' quantization
(``render/wavefront.build_gen_par``, ``ray_sort_key``).  The 128³ SAT grid
and its DDA belong to the grid fallback, which the port has not taken over
yet.
"""

from __future__ import annotations

import numpy as np


def scene_bbox(positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """positions: (T, 3, 3) world triangles → (bbox_min, bbox_max) (3,) f32."""
    verts = np.asarray(positions, np.float32).reshape(-1, 3)
    return verts.min(axis=0), verts.max(axis=0)
