"""Vectorized 3D-DDA (Amanatides–Woo) uniform-grid traversal.

The port of ``zig_raytracing_contest_tpu/ops/dda.py`` (the reference's grid
iterator, src/linalg.zig:407-498).  The iterator state is a struct of
tensors over a wave of rays, and ``dda_next`` steps every ray one cell in
lock-step.  Steps are signed integers; the exit test fires before the
step, so the reference's u32 wraparound is never observable.

The stepping axis comes from a 3-bit comparison mask and the table
``{2,1,2,1,2,2,0,0}`` (src/linalg.zig:478-484): on a diagonal tie y steps
before x.  The reference's unit tests (src/linalg.zig:583-681) pin the
cell sequences, and tests/test_torch_grid.py holds them against the JAX
package's walk.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from . import linalg

# Axis lookup: index = (t0<t1)<<2 | (t0<t2)<<1 | (t1<t2)  (src/linalg.zig:483)
_AXIS_MAP = (2, 1, 2, 1, 2, 2, 0, 0)

INF = float("inf")


@lru_cache(maxsize=None)
def _axis_map(device: torch.device) -> torch.Tensor:
    return torch.tensor(_AXIS_MAP, dtype=torch.int64, device=device)


class GridParams(NamedTuple):
    """``Grid{bbox, resolution, cell_size}`` (src/linalg.zig:407-418) as (3,)
    tensors: f32 boxes and cell size, int64 resolution."""

    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    resolution: torch.Tensor
    cell_size: torch.Tensor

    def to(self, device) -> "GridParams":
        return GridParams(*(t.to(device) for t in self))


class DDAState(NamedTuple):
    """Per-ray iterator state (``Grid.Iterator``, src/linalg.zig:471-477),
    every field (R, 3): int64 cells, exits and steps, f32 times."""

    cell: torch.Tensor
    exit: torch.Tensor
    step: torch.Tensor
    t_delta: torch.Tensor
    t_next_crossing: torch.Tensor


def make_grid(bbox_min, bbox_max, resolution, device="cpu") -> GridParams:
    """GridParams with ``cell_size = size / resolution`` (Grid.init,
    src/linalg.zig:412-418)."""
    bbox_min = torch.as_tensor(bbox_min, dtype=torch.float32, device=device)
    bbox_max = torch.as_tensor(bbox_max, dtype=torch.float32, device=device)
    resolution = torch.as_tensor(resolution, dtype=torch.int64, device=device)
    cell_size = (bbox_max - bbox_min) / resolution.to(torch.float32)
    return GridParams(bbox_min, bbox_max, resolution, cell_size)


def linearize_cell_idx(grid: GridParams, cell: torch.Tensor) -> torch.Tensor:
    """x-fastest, z-major flat cell index (src/linalg.zig:429-431)."""
    rx, ry = grid.resolution[0], grid.resolution[1]
    return (cell[..., 2] * ry + cell[..., 1]) * rx + cell[..., 0]


def _clip_cell(grid: GridParams, idx: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp_min(idx, 0), grid.resolution - 1)


def get_cell_idx(grid: GridParams, point: torch.Tensor) -> torch.Tensor:
    """A point's cell, clamped to [0, res - 1] (src/linalg.zig:424-427; the
    reference's u32 truncation of a slightly negative coordinate is
    undefined, the clamp is the JAX package's)."""
    pos = (point - grid.bbox_min) / grid.cell_size
    return _clip_cell(grid, pos.to(torch.int64))


def dda_setup(grid: GridParams, orig: torch.Tensor, direction: torch.Tensor):
    """Enter the grid: slab test and Amanatides–Woo set-up → ``(entered,
    state)``; the state of a ray that misses the box is garbage, to be
    masked (``Grid.traceRay``, src/linalg.zig:443-469).  The entry t is
    clamped to 0 when the origin is inside the box (:448)."""
    hit, t_entry = linalg.ray_bbox_intersection(orig, direction, grid.bbox_min,
                                                grid.bbox_max)
    t_entry = torch.clamp_min(t_entry, 0.0)
    sign = direction < 0.0
    one = torch.ones((), dtype=torch.int64, device=orig.device)
    step = torch.where(sign, -one, one)
    exit_cell = torch.where(sign, 0 * one, grid.resolution - 1)
    t_delta = torch.abs(grid.cell_size / direction)
    hit_local = linalg.ray_at(orig, direction, t_entry) - grid.bbox_min
    cell = _clip_cell(grid, (hit_local / grid.cell_size).to(torch.int64))
    next_cell = (cell + torch.where(sign, 0 * one, one)).to(torch.float32)
    t_next = t_entry[..., None] + (next_cell * grid.cell_size - hit_local) / direction
    return hit, DDAState(cell, exit_cell, step, t_delta, t_next)


def dda_next(state: DDAState, active: torch.Tensor | None = None):
    """Advance every (active) ray one cell → ``(t_crossing, new_state)``.

    ``t_crossing`` is the t at which the ray leaves its current cell, or
    +inf when it is already at the grid's boundary on the stepping axis
    (``Iterator.next``, src/linalg.zig:478-496).  Rays with ``active``
    False keep their state and get +inf."""
    t = state.t_next_crossing
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    k = ((t0 < t1).to(torch.int64) * 4 + (t0 < t2).to(torch.int64) * 2
         + (t1 < t2).to(torch.int64))
    axis = _axis_map(t.device)[k]
    onehot = axis[..., None] == torch.arange(3, device=t.device)
    ax = axis[..., None]
    at_exit = state.cell.gather(-1, ax)[..., 0] == state.exit.gather(-1, ax)[..., 0]
    t_crossing = torch.where(at_exit, INF, t.gather(-1, ax)[..., 0])
    do_step = ~at_exit
    if active is not None:
        do_step = do_step & active
        t_crossing = torch.where(active, t_crossing, INF)
    stepmask = onehot & do_step[..., None]
    new_cell = state.cell + torch.where(stepmask, state.step, 0)
    new_t = t + torch.where(stepmask, state.t_delta, 0.0)
    return t_crossing, state._replace(cell=new_cell, t_next_crossing=new_t)
