"""ctypes binding of the native C++ CPU tracer (native/cpu_tracer.cpp).

The port of ``zig_raytracing_contest_tpu/render/native_cpu.py``: the
measured stand-in for the reference Zig binary, with the same algorithm
(per-ray grid DDA, Möller–Trumbore, textured diffuse path tracing over OS
threads; src/stage3.zig:222-256), driven by the grid scene's arrays.  It is
the CPU row of the bench (``bench.py --cpu``) and an independent oracle
for the renderer.  The library is built at first use (``native.load``).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .. import native
from ..ops import linalg
from ..scene.camera import Camera
from ..scene.types import TorchScene

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the tracer's C entry point on ``lib``."""
    lib.zrc_cpu_render.restype = ctypes.c_int64
    lib.zrc_cpu_render.argtypes = [
        _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint32, _f32p, _f32p, _i32p, _i32p,
        _i32p, _f32p, _f32p, _f32p, _i32p, _f32p, _f32p, ctypes.c_int32,
        _f32p,
    ]
    return lib


def load_library() -> native.NativeLibrary:
    """The tracer's library, built at first use; ``.openmp`` says whether
    it was built with OpenMP."""
    nl = native.load("cpu_tracer")
    bind(nl.lib)
    return nl


def _c(t, dtype) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a, dtype)


def render_cpu(
    scene: TorchScene,
    camera: Camera,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    num_threads: int = 0,  # 0 = OpenMP default (all cores)
    lib: ctypes.CDLL | None = None,
):
    """Render ``scene`` (which must carry a grid) on the host CPU.  Returns
    (img_u8 (h, w, 3), segments, seconds).  ``lib``: a bound library of
    cpu_tracer.cpp (default ``load_library()``).

    The grid's int64 tensors go to the tracer as int32, with the pad row of
    ``dup_to_tri`` and the triangle rows kept: the layout of the JAX
    package's scene.  The gamma encode is ``linalg.vec3_to_rgb`` on the CPU,
    the renderer's own quantization."""
    if scene.grid is None:
        raise ValueError("render_cpu needs a scene with a grid (backend: \"grid\")")
    lib = load_library().lib if lib is None else lib
    g = scene.grid
    w, h = camera.width, camera.height
    cam = np.concatenate(
        [camera.origin, camera.lower_left_corner, camera.right, camera.up]
    ).astype(np.float32)
    fb = np.zeros((h * w, 3), np.float32)
    args = [
        (_c(g.params.bbox_min, np.float32), _f32p),
        (_c(g.params.cell_size, np.float32), _f32p),
        (_c(g.params.resolution, np.int32), _i32p),
        (_c(g.cell_begin, np.int32), _i32p),
        (_c(g.cell_end, np.int32), _i32p),
        (_c(g.tri_v0, np.float32), _f32p),
        (_c(g.tri_e1, np.float32), _f32p),
        (_c(g.tri_e2, np.float32), _f32p),
        (_c(g.dup_to_tri, np.int32), _i32p),
        (_c(scene.shade_table, np.float32), _f32p),
        (_c(scene.color_data, np.float32), _f32p),
    ]
    t0 = time.perf_counter()
    segments = lib.zrc_cpu_render(
        cam.ctypes.data_as(_f32p), w, h, spp, max_bounce, ctypes.c_uint32(seed),
        *(a.ctypes.data_as(p) for a, p in args),
        num_threads, fb.ctypes.data_as(_f32p),
    )
    seconds = time.perf_counter() - t0
    img = linalg.vec3_to_rgb(torch.from_numpy(fb) / spp).numpy().reshape(h, w, 3)
    return img, int(segments), seconds
