"""ctypes binding of the native C++ grid builder (native/grid_builder.cpp).

The port of ``zig_raytracing_contest_tpu/grid/native.py``: the host-side
"compile" stage (exact SAT binning, two-pass counting sort) in native code,
OpenMP-parallel where the reference's Zig build stage runs on one thread.
The library is built at first use (``native.load``).

``build_grid_native`` returns what ``grid.builder.build_grid`` returns: the
same arrays, the same per-cell triangle order, the same stats and the same
log lines; the tests hold the two equal.  ``render/pipeline.prepare_scene``
tries it first and falls back to the NumPy builder with a warning when
there is no compiler.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Callable

import numpy as np

from .. import native
from .builder import GridBuild

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def load_library() -> native.NativeLibrary:
    """The builder's library, built at first use; ``.openmp`` says whether
    it was built with OpenMP."""
    nl = native.load("grid_builder")
    lib = nl.lib
    lib.zrc_grid_count.restype = ctypes.c_int64
    lib.zrc_grid_count.argtypes = [_f32p, ctypes.c_int64, _i32p, _f32p, _f32p, _f32p, _i32p]
    lib.zrc_grid_fill.restype = None
    lib.zrc_grid_fill.argtypes = [
        _f32p, ctypes.c_int64, _i32p, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
    ]
    return nl


def native_available() -> bool:
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _fp(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def build_grid_native(
    positions: np.ndarray,
    resolution,
    log_fn: Callable[[str], None] | None = None,
) -> GridBuild:
    """positions: (T, 3, 3) world triangles; resolution: (3,) ints.  The
    drop-in twin of ``grid.builder.build_grid``."""
    lib = load_library().lib
    log_fn = log_fn or (lambda msg: None)
    positions = np.ascontiguousarray(positions, np.float32)
    resolution = np.ascontiguousarray(resolution, np.int32)
    if positions.ndim != 3 or positions.shape[1:] != (3, 3) or resolution.shape != (3,):
        raise ValueError(f"positions {positions.shape} (want (T, 3, 3)), resolution "
                         f"{resolution.shape} (want (3,))")
    num_tris = positions.shape[0]
    num_cells = int(np.prod(resolution, dtype=np.int64))

    bbox_min = np.zeros(3, np.float32)
    bbox_max = np.zeros(3, np.float32)
    cell_size = np.zeros(3, np.float32)
    counts = np.zeros(num_cells, np.int32)

    log_fn(f"Grid resolution: {tuple(int(r) for r in resolution)}")
    total = lib.zrc_grid_count(
        _fp(positions, ctypes.c_float), num_tris, _fp(resolution, ctypes.c_int32),
        _fp(bbox_min, ctypes.c_float), _fp(bbox_max, ctypes.c_float),
        _fp(cell_size, ctypes.c_float), _fp(counts, ctypes.c_int32),
    )

    begin = np.zeros(num_cells, np.int64)
    np.cumsum(counts[:-1], out=begin[1:])
    begin32 = begin.astype(np.int32)
    cursors = np.zeros(num_cells, np.int32)
    dup = np.zeros(max(int(total), 1), np.int32)

    lib.zrc_grid_fill(
        _fp(positions, ctypes.c_float), num_tris, _fp(resolution, ctypes.c_int32),
        _fp(bbox_min, ctypes.c_float), _fp(cell_size, ctypes.c_float),
        _fp(begin32, ctypes.c_int32), _fp(counts, ctypes.c_int32),
        _fp(cursors, ctypes.c_int32), _fp(dup, ctypes.c_int32),
    )

    end = begin + counts
    nonzero = counts[counts > 0]
    empty = num_cells - len(nonzero)
    if len(nonzero):
        log_fn(
            "Empty cells: {}/{} ({:.2f}%) min triangles: {} max triangles: {} "
            "mean_triangles: {}".format(
                empty, num_cells, empty / num_cells * 100,
                int(nonzero.min()), int(nonzero.max()),
                int(total) // len(nonzero),
            )
        )
    if total:
        log_fn(
            "Unique triangle count: {}/{} ({:.2f}%)".format(
                num_tris, int(total), num_tris / int(total) * 100
            )
        )

    return GridBuild(
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        resolution=resolution,
        cell_size=cell_size,
        cell_begin=begin32,
        cell_end=end.astype(np.int32),
        dup_to_tri=dup[: int(total)],
        stats={
            "num_cells": num_cells,
            "empty_cells": int(empty),
            "total_refs": int(total),
            "min_tris": int(nonzero.min()) if len(nonzero) else 0,
            "max_tris": int(nonzero.max()) if len(nonzero) else 0,
            "duplication": int(total) / max(num_tris, 1),
        },
    )
