"""Build and bind the CUDA kernels of path_trace.cu.

At first use the source is compiled with ``nvcc`` into a shared library
with a plain C interface, under ``kernels/_build/`` (keyed on a hash of the
source and the flags), and loaded with ``ctypes``.  The wrappers take
tensors, check them, and launch on PyTorch's current stream; they allocate
nothing and do not synchronise.

Flags: ``-O3 -arch=sm_90a --fmad=false``.  ``--fmad=false`` keeps every
a*b+c rounded twice, as the PyTorch twins round it; without it nvcc fuses
multiply-adds into FMAs and near-tie hits flip against the twins.
Nothing here is imported or built until a CUDA tensor reaches a wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "path_trace.cu"
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = ["-O3", "-arch=sm_90a", "--fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
# What the last build did: seconds spent (0.0 when the library was already
# built) and nvcc's report (ptxas registers / spills per kernel).
BUILD_INFO = {"seconds": None, "log": ""}


class ZrcScene(ctypes.Structure):
    _fields_ = [
        ("tri", ctypes.c_void_p),
        ("tile_bbox", ctypes.c_void_p),
        ("rec", ctypes.c_void_p),
        ("bank", ctypes.c_void_p),
        ("nt", ctypes.c_int),
        ("tile", ctypes.c_int),
        ("num_texels", ctypes.c_int),
        ("emissive_dummy", ctypes.c_int),
    ]


class ZrcGen(ctypes.Structure):
    _fields_ = [
        ("par", ctypes.c_void_p),
        ("x_base", ctypes.c_int),
        ("y_base", ctypes.c_int),
        ("tile_base", ctypes.c_int),
        ("seed", ctypes.c_uint),
        ("spp", ctypes.c_int),
        ("width", ctypes.c_int),
        ("img_w", ctypes.c_int),
        ("img_h", ctypes.c_int),
        ("tiles_x", ctypes.c_int),
    ]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")


def library_path() -> Path:
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libzrc_path_trace_{key}.so"


def build() -> Path:
    """Compile path_trace.cu unless the library for this source exists."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(seconds=0.0, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log=res.stdout + res.stderr)
    return out


def load():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.zrc_path_trace_gen.restype = i32
            lib.zrc_path_trace_gen.argtypes = [
                ctypes.POINTER(ZrcScene), ctypes.POINTER(ZrcGen), i32, i32,
                ptr, ptr, i32, i32, ptr,
            ]
            lib.zrc_path_trace.restype = i32
            lib.zrc_path_trace.argtypes = [
                ctypes.POINTER(ZrcScene), ptr, ptr, i32, i32, ptr, ptr, i32,
                i32, ptr,
            ]
            lib.zrc_error_string.restype = ctypes.c_char_p
            lib.zrc_error_string.argtypes = [i32]
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _scene_struct(scene, device):
    tri, rec, tile_bbox, bank = scene.kernel_operands()
    tp = tri.shape[0]
    _check(tri, "tri", torch.float32, (tp, 16), device)
    _check(rec, "rec", torch.float32, (tp, 24), device)
    _check(tile_bbox, "tile_bbox", torch.float32, (6, tile_bbox.shape[1]), device)
    _check(bank, "bank", torch.float32, (bank.shape[0], 4), device)
    if tile_bbox.shape[1] * scene.tile > tp:
        raise ValueError("tile_bbox covers more triangles than the bank holds")
    return ZrcScene(
        tri.data_ptr(), tile_bbox.data_ptr(), rec.data_ptr(), bank.data_ptr(),
        tile_bbox.shape[1], scene.tile, bank.shape[0], int(scene.emissive_dummy),
    )


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.zrc_error_string(err).decode()}")


def launch_path_trace_gen(scene, par, meta, gen, max_bounce: int,
                          emit_key: bool, state_out, idx_out) -> None:
    """Launch path_trace_gen_kernel into ``state_out`` (16, R) and
    ``idx_out`` (R,) int32."""
    lib = load()
    dev = scene.device
    R = state_out.shape[1]
    _check(par, "par", torch.float32, (32,), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if R >= 1 << 23:
        raise ValueError(f"wave of {R} rays: slot math is exact below 2^23")
    sc = _scene_struct(scene, dev)
    g = ZrcGen(par.data_ptr(), int(meta[1]), int(meta[2]), int(meta[4]),
               int(meta[3]) & 0xFFFFFFFF, gen.spp, gen.width, gen.img_w,
               gen.img_h, gen.tiles_x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_path_trace_gen(
        ctypes.byref(sc), ctypes.byref(g), int(max_bounce), int(emit_key),
        state_out.data_ptr(), idx_out.data_ptr(), R, dev.index or 0, stream,
    )
    _raise_on(lib, err, "path_trace_gen_kernel")


def launch_path_trace(scene, state_in, prev, bounce0: int, max_bounce: int,
                      state_out, idx_out) -> None:
    """Launch path_trace_kernel: ``state_in`` (16, R) → ``state_out``;
    ``prev`` (R,) int32 or None."""
    lib = load()
    dev = scene.device
    R = state_in.shape[1]
    _check(state_in, "state_in", torch.float32, (16, R), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if prev is not None:
        _check(prev, "prev", torch.int32, (R,), dev)
    sc = _scene_struct(scene, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_path_trace(
        ctypes.byref(sc), state_in.data_ptr(),
        None if prev is None else prev.data_ptr(), int(bounce0),
        int(max_bounce), state_out.data_ptr(), idx_out.data_ptr(), R,
        dev.index or 0, stream,
    )
    _raise_on(lib, err, "path_trace_kernel")
