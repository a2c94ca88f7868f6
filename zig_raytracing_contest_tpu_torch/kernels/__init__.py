"""Build and bind the CUDA kernels, and count their launches.

Two sources: ``path_trace.cu`` (the renderer's kernels, the grid walk and
the probes of its device functions) and ``probes.cu`` (the trace
micro-benchmarks).  At first use each is compiled on its own with ``nvcc``
into a shared library with a plain C interface, under ``kernels/_build/``
(keyed on a hash of the source and the flags), and loaded with ``ctypes``:
``load()`` builds path_trace.cu, ``load_probes()`` probes.cu, and binds
each C entry point as ``ENTRY_POINTS`` declares it (one entry point a
kernel).  The wrappers take tensors, check them, and launch on PyTorch's
current stream; they allocate nothing, do not synchronise, and count
their launches in ``LAUNCHES``.

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
SOURCES = {"path_trace": _DIR / "path_trace.cu", "probes": _DIR / "probes.cu"}
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = ["-O3", "-arch=sm_90a", "--fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
# The compiles this process ran, by source name: {"seconds": wall seconds
# of the nvcc run, "log": its report (ptxas registers / spills per
# kernel)}.
BUILD_INFO: dict = {}

# Launches per CUDA kernel, counted by the launchers below right after a
# launch is accepted; the twins never count.  A CUDA graph's replay
# launches without the launchers: its caller adds the launches the capture
# counted (``add_launches``; render.pipeline.FrameGraph).  The probes count per variant:
# micro_trace per cull, micro_bf16 per working type, probe_gather per form.
LAUNCHES = {"path_trace_gen": 0, "path_trace": 0, "trace_emit": 0,
            "trace_stream": 0, "shade": 0, "texel_fetch": 0, "sort_key": 0,
            "ray_sort_key": 0, "grid_walk": 0,
            "micro_trace_none": 0, "micro_trace_lane": 0, "micro_trace_warp": 0,
            "micro_bf16_f32": 0, "micro_bf16_bf16": 0,
            "probe_gather_smem": 0, "probe_gather_shfl": 0}
# What a C entry point returns when its work is empty and it launched
# nothing (a CUDA error is positive, success 0)
NOTHING_LAUNCHED = -1
# The deepest heap the per-bounce traces walk: 2^TREE_STACK leaves
# (path_trace.cu's per-thread stack)
TREE_STACK = 24


# The work the frames did, summed over the frames ``render_scene`` returned
# since the last ``reset_launches()``: ``frames``, and each work counter a
# frame reported (``RenderStats.counters``: segments, lanes issued, rays
# alive, tiles swept, boxes tested, grid-walk iterations), a counter absent
# until a frame reports it.  Separate from LAUNCHES, whose keys are
# kernels.
COUNTERS: dict = {"frames": 0}

# guards LAUNCHES and COUNTERS: the sharded render launches from one host
# thread a card
_count_lock = threading.Lock()


def reset_launches() -> None:
    """Set LAUNCHES to zeros and COUNTERS back to no frame."""
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        COUNTERS.clear()
        COUNTERS["frames"] = 0


def add_counters(counts: dict) -> None:
    """Add one frame's work counters (name -> count) to COUNTERS."""
    with _count_lock:
        COUNTERS["frames"] += 1
        for k, v in counts.items():
            COUNTERS[k] = COUNTERS.get(k, 0) + v


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def launches_since(before: dict) -> dict:
    """The launches counted since the snapshot ``before`` (a copy of
    LAUNCHES), by kernel; kernels not launched are left out."""
    with _count_lock:
        return {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (kernel -> launches) to LAUNCHES: a CUDA graph's
    replay launches its kernels without passing through the launchers, so
    its caller counts them (``counts`` negative takes back what a capture,
    which launches nothing, counted)."""
    with _count_lock:
        for k, v in counts.items():
            LAUNCHES[k] += v


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
        ("tri_rows", ctypes.c_void_p),
        ("tp", ctypes.c_int),
    ]


class ZrcHeap(ctypes.Structure):
    _fields_ = [
        ("tree", ctypes.c_void_p),
        ("gbox", ctypes.c_void_p),
        ("p2", ctypes.c_int),
        ("ng", ctypes.c_int),
        ("group_tiles", ctypes.c_int),
    ]


class ZrcTexture(ctypes.Structure):
    _fields_ = [
        ("off", ctypes.c_int),
        ("w", ctypes.c_int),
        ("h", ctypes.c_int),
        ("repeat_u", ctypes.c_int),
        ("repeat_v", ctypes.c_int),
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


class ZrcGrid(ctypes.Structure):
    _fields_ = [
        ("tri", ctypes.c_void_p),
        ("cells", ctypes.c_void_p),
        ("bmin", ctypes.c_float * 3),
        ("bmax", ctypes.c_float * 3),
        ("cell", ctypes.c_float * 3),
        ("res", ctypes.c_int * 3),
        ("num_cells", ctypes.c_int),
    ]


class ZrcGridWave(ctypes.Structure):
    _fields_ = [
        ("orig", ctypes.c_void_p),
        ("dir", ctypes.c_void_p),
        ("thr", ctypes.c_void_p),
        ("rows4", ctypes.c_void_p),
        ("gen", ZrcGen),
        ("shade", ctypes.c_void_p),
        ("bank", ctypes.c_void_p),
        ("num_texels", ctypes.c_int),
        ("bounce", ctypes.c_int),
        ("walk", ctypes.c_int),
        ("alive", ctypes.c_void_p),
    ]


class ZrcTraceWave(ctypes.Structure):
    _fields_ = [
        ("orig", ctypes.c_void_p),
        ("dir", ctypes.c_void_p),
        ("thr", ctypes.c_void_p),
        ("rows4", ctypes.c_void_p),
        ("gen", ZrcGen),
        ("hit", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("shade", ctypes.c_void_p),
        ("bank", ctypes.c_void_p),
        ("num_texels", ctypes.c_int),
        ("perm", ctypes.c_void_p),
        ("mr", ctypes.c_void_p),
        ("light_tri", ctypes.c_void_p),
        ("light_v0", ctypes.c_void_p),
        ("light_e1", ctypes.c_void_p),
        ("light_e2", ctypes.c_void_p),
        ("light_n", ctypes.c_void_p),
        ("light_cdf", ctypes.c_void_p),
        ("light_area", ctypes.c_void_p),
        ("lights", ctypes.c_int),
        ("bounce", ctypes.c_int),
        ("roulette", ctypes.c_int),
        ("counts", ctypes.c_void_p),
    ]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of source ``name`` is built: keyed on a hash of the
    source and the flags."""
    key = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir / f"libzrc_{name}_{key[:16]}.so"


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """The library of source ``name``, built into ``build_dir``, compiled by
    nvcc if it does not exist yet (raises if nvcc fails).  Builds of
    different sources, or of one into different directories, may run at
    once, from separate threads."""
    out = library_path(name, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    _log_path(out).write_text(log)
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


def _log_path(lib: Path) -> Path:
    """Where a library's nvcc report is kept, beside it."""
    return lib.with_name(lib.name + ".log")


def build_log(name: str, build_dir: Path = BUILD_DIR) -> str:
    """The nvcc report (ptxas registers / spills per kernel) of the build of
    ``name`` into ``build_dir``: this process's, else the one kept beside
    the library; empty if it was never built."""
    info = BUILD_INFO.get(name)
    if info:
        return info["log"]
    log = _log_path(library_path(name, build_dir))
    return log.read_text() if log.exists() else ""


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
_P = ctypes.POINTER
# Every C entry point of each source, (restype, argtypes), bound by _load.
# A pointer to counters (``counts``, ``sweeps``, ``it_sum``) may be None: the kernel
# then counts into a buffer of the library's that nothing reads.
ENTRY_POINTS = {
    "path_trace": {
        "zrc_path_trace_gen": (_i32, [_P(ZrcScene), _P(ZrcGen), _i32, _i32, _ptr, _ptr, _ptr,
                                      _ptr, _i32, _i32, _ptr]),
        "zrc_path_trace": (_i32, [_P(ZrcScene), _ptr, _ptr, _i32, _i32, _ptr, _ptr, _ptr, _ptr,
                                  _i32, _i32, _ptr]),
        "zrc_trace_emit": (_i32, [_P(ZrcScene), _P(ZrcHeap), _ptr, _ptr, _ptr, _i32, _ptr, _ptr,
                                  _ptr, _ptr, _i32, _i32, _ptr]),
        "zrc_shade": (_i32, [_P(ZrcScene), _ptr, _ptr, _ptr, _i32, _ptr, _i32, _i32, _ptr]),
        "zrc_texel_fetch": (_i32, [_P(ZrcScene), _P(ZrcTexture), _ptr, _ptr, _ptr, _i32, _i32,
                                   _ptr]),
        "zrc_sort_key": (_i32, [_ptr, _ptr, _ptr, _i32, _i32, _ptr]),
        "zrc_ray_sort_key": (_i32, [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _ptr]),
        "zrc_grid_walk": (_i32, [_P(ZrcGrid), _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                 _ptr, _ptr, _i32, _i32, _ptr]),
        "zrc_grid_walk_shaded": (_i32, [_P(ZrcGrid), _P(ZrcGridWave), _ptr, _ptr, _ptr, _ptr,
                                        _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr]),
        "zrc_trace_shaded": (_i32, [_P(ZrcScene), _P(ZrcHeap), _P(ZrcTraceWave), _i32, _i32,
                                    _i32, _ptr]),
        "zrc_empty": (_i32, [_i32, _ptr]),
        "zrc_error_string": (ctypes.c_char_p, [_i32]),
    },
    "probes": {
        "zrc_micro_trace": (_i32, [_ptr, _i32, _ptr, _i32, _i32, _ptr, _i32, _i32, _i32, _ptr,
                                   _ptr, _i32, _i32, _ptr]),
        "zrc_micro_bf16": (_i32, [_ptr, _i32, _ptr, _i32, _i32, _i32, _ptr, _i32, _ptr]),
        "zrc_probe_gather_chunks": (_i32, [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr, _ptr,
                                           _i32, _ptr]),
        "zrc_probes_error_string": (ctypes.c_char_p, [_i32]),
    },
}


def _load(name: str):
    """The loaded library of source ``name`` (built at first call), its
    ENTRY_POINTS bound."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in ENTRY_POINTS[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def load():
    """The loaded library of path_trace.cu (built at first call)."""
    return _load("path_trace")


def load_probes():
    """The loaded library of probes.cu (built at first call)."""
    return _load("probes")


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
    _check(scene.tri_data, "tri_data", torch.float32, (16, tp), device)
    if tile_bbox.shape[1] * scene.tile > tp:
        raise ValueError("tile_bbox covers more triangles than the bank holds")
    return ZrcScene(
        tri.data_ptr(), tile_bbox.data_ptr(), rec.data_ptr(), bank.data_ptr(),
        tile_bbox.shape[1], scene.tile, bank.shape[0], int(scene.emissive_dummy),
        scene.tri_data.data_ptr(), tp,
    )


def _launched(err: int, message, what: str) -> bool:
    """True when a C entry point launched its kernel, False when its work
    was empty; raises on a CUDA error (``message``: the source's error
    string function)."""
    if err == NOTHING_LAUNCHED:
        return False
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {message(err).decode()}")
    return True


def _addr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _check_work(counts, sweeps, device) -> None:
    """The whole-path kernels' counters: ``counts`` (3,) and ``sweeps``
    (2,) int64 on ``device``, each or both None."""
    if counts is not None:
        _check(counts, "counts", torch.int64, (3,), device)
    if sweeps is not None:
        _check(sweeps, "sweeps", torch.int64, (2,), device)


def launch_path_trace_gen(scene, par, meta, gen, max_bounce: int,
                          emit_key: bool, state_out, idx_out, counts=None,
                          sweeps=None) -> None:
    """Launch path_trace_gen_kernel into ``state_out`` (16, R) and
    ``idx_out`` (R,) int32.  ``counts`` (3,) int64 or None gets the wave's
    rays alive at each bounce's trace, tiles swept and boxes tested
    added; ``sweeps`` (2,) int64 or None the flat tile loop's tiles swept
    lane-parallel and passing lanes swept by the whole warp."""
    lib = load()
    dev = scene.device
    R = state_out.shape[1]
    _check(par, "par", torch.float32, (32,), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    _check_work(counts, sweeps, dev)
    if R >= 1 << 23:
        raise ValueError(f"wave of {R} rays: slot math is exact below 2^23")
    sc = _scene_struct(scene, dev)
    g = ZrcGen(par.data_ptr(), int(meta[1]), int(meta[2]), int(meta[4]),
               int(meta[3]) & 0xFFFFFFFF, gen.spp, gen.width, gen.img_w,
               gen.img_h, gen.tiles_x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_path_trace_gen(
        ctypes.byref(sc), ctypes.byref(g), int(max_bounce), int(emit_key),
        state_out.data_ptr(), idx_out.data_ptr(), _addr(counts), _addr(sweeps), R,
        dev.index or 0, stream)
    if _launched(err, lib.zrc_error_string, "path_trace_gen_kernel"):
        _count("path_trace_gen")


def launch_path_trace(scene, state_in, prev, bounce0: int, max_bounce: int,
                      state_out, idx_out, counts=None, sweeps=None) -> None:
    """Launch path_trace_kernel: ``state_in`` (16, R) → ``state_out``;
    ``prev`` (R,) int32 or None; ``counts`` and ``sweeps`` as
    ``launch_path_trace_gen``."""
    lib = load()
    dev = scene.device
    R = state_in.shape[1]
    _check(state_in, "state_in", torch.float32, (16, R), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if prev is not None:
        _check(prev, "prev", torch.int32, (R,), dev)
    _check_work(counts, sweeps, dev)
    sc = _scene_struct(scene, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_path_trace(
        ctypes.byref(sc), state_in.data_ptr(), _addr(prev), int(bounce0), int(max_bounce),
        state_out.data_ptr(), idx_out.data_ptr(), _addr(counts), _addr(sweeps), R,
        dev.index or 0, stream)
    if _launched(err, lib.zrc_error_string, "path_trace_kernel"):
        _count("path_trace")


def _heap(tree, gbox, group_tiles: int, leaves: int, device) -> ZrcHeap:
    """The heap struct of a (6, 2·p2) ``tree`` over ``leaves`` leaves
    (tiles, or the groups of ``gbox`` (6, ng))."""
    p2 = tree.shape[1] // 2
    _check(tree, "heap", torch.float32, (6, 2 * p2), device)
    if p2 & (p2 - 1) or p2 < leaves or p2 > 1 << TREE_STACK:
        raise ValueError(f"heap of {p2} leaves does not fit {leaves} leaves")
    if gbox is None:
        return ZrcHeap(tree.data_ptr(), None, p2, 0, 0)
    _check(gbox, "group_bbox", torch.float32, (6, leaves), device)
    if group_tiles < 1:
        raise ValueError(f"groups of {group_tiles} tiles")
    return ZrcHeap(tree.data_ptr(), gbox.data_ptr(), p2, leaves, group_tiles)


def _launch_trace(scene, heap: ZrcHeap, state, prev, table, aux_out, idx_out,
                  rec_out, counts=None) -> None:
    """Launch the walk of ``heap``: trace_stream_kernel when it has group
    boxes, else trace_emit_kernel; ``counts`` as ``launch_trace_emit``."""
    lib = load()
    dev = scene.device
    R = state.shape[1]
    _check(state, "state", torch.float32, (16, R), dev)
    _check(aux_out, "aux_out", torch.float32, (8, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if prev is not None:
        _check(prev, "prev", torch.int32, (R,), dev)
    tp = scene.tri_data.shape[1]
    if table is not None:
        _check(table, "table", torch.float32, (24, tp), dev)
        _check(rec_out, "rec_out", torch.float32, (24, R), dev)
    if counts is not None:
        _check(counts, "counts", torch.int64, (3,), dev)
    err = lib.zrc_trace_emit(
        ctypes.byref(_scene_struct(scene, dev)), ctypes.byref(heap), state.data_ptr(),
        _addr(prev), _addr(table), tp, aux_out.data_ptr(), idx_out.data_ptr(),
        None if table is None else rec_out.data_ptr(), _addr(counts), R, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "trace_stream" if heap.gbox else "trace_emit"
    if _launched(err, lib.zrc_error_string, f"{name}_kernel"):
        _count(name)


def _scene_heap(scene, groups: bool) -> ZrcHeap:
    """The heap a trace of ``scene`` walks: the group heap (trace_stream_kernel)
    or the tile heap (trace_emit_kernel)."""
    nt = scene.tile_bbox.shape[1]
    if not groups:
        return _heap(scene.tree_bbox, None, 0, nt, scene.device)
    ng = scene.group_bbox.shape[1]
    if ng != -(-nt // scene.group_tiles):
        raise ValueError(f"{ng} groups of {scene.group_tiles} do not cover {nt} tiles")
    return _heap(scene.group_tree_bbox, scene.group_bbox, scene.group_tiles, ng, scene.device)


def launch_trace_emit(scene, state, prev, table, aux_out, idx_out, rec_out,
                      counts=None) -> None:
    """Launch trace_emit_kernel (the walk of ``scene.tree_bbox``):
    ``state`` (16, R) → ``aux_out`` (8, R), ``idx_out`` (R,) int32 and,
    when ``table`` (24, Tp) is given, ``rec_out`` (24, R); ``prev`` (R,)
    int32 or None; ``counts`` (3,) int64 or None gets the sums of aux rows
    4-6 (rays alive, tiles swept, boxes tested) added."""
    _launch_trace(scene, _scene_heap(scene, False), state, prev, table, aux_out, idx_out,
                  rec_out, counts)


def launch_trace_stream(scene, state, prev, table, aux_out, idx_out, rec_out,
                        counts=None) -> None:
    """Launch trace_stream_kernel (the walk of ``scene.group_tree_bbox``,
    each reached group's tiles culled and swept); arguments as
    ``launch_trace_emit``."""
    _launch_trace(scene, _scene_heap(scene, True), state, prev, table, aux_out, idx_out,
                  rec_out, counts)


def _wave_gen(par, width: int, spp: int, slot_base: int, seed: int, device) -> ZrcGen:
    """Check a shaded wave's generator (``wavefront.xla_primary_rays``'
    inputs: the (32,) f32 ``par`` on ``device``, ``width`` and ``spp`` from
    1, the raster slot base from 0) → the ``ZrcGen`` its first launch makes
    the primary rays from and every launch its streams.  The seed and the
    global ray ids wrap to 32 bits, as ``ops.rng.ray_streams`` masks them."""
    _check(par, "par", torch.float32, (32,), device)
    if not 1 <= spp < 1 << 31:
        raise ValueError(f"{spp} samples a pixel")
    if not 1 <= width < 1 << 31:
        raise ValueError(f"width {width}")
    if slot_base < 0:
        raise ValueError(f"slot base {slot_base}")
    y_base, x_base = divmod(int(slot_base), int(width))
    if y_base >= 1 << 31:
        raise ValueError(f"slot base {slot_base}: row {y_base} past 2^31 - 1")
    return ZrcGen(par.data_ptr(), x_base, y_base, 0, int(seed) & 0xFFFFFFFF, int(spp),
                  int(width), 0, 0, 0)


def launch_trace_shaded(scene, groups: bool, par, width: int, spp: int, slot_base: int,
                        seed: int, orig, direction, thr, rows4, hit, idx, flags, bounce: int,
                        shadow: bool, lights=None, mr=None, roulette: bool = False,
                        counts=None) -> None:
    """Launch one of the 2B launches of the bake's shaded wave
    (``wavefront.render_wave_shaded_trace``: for each bounce b of B, the
    nearest launch, then the shadow launch, ``shadow``; equal to
    ``wavefront.render_wave_xla``): trace_stream_kernel's shaded form on
    the group heap (``groups``), else trace_emit_kernel's on the tile heap.
    The wave's generator: ``par`` (32,) f32 (``wavefront.build_gen_par``),
    the image ``width``, ``spp``, the raster ``slot_base`` and ``seed``, as
    ``wavefront.xla_primary_rays`` takes them: the nearest launch of bounce
    0 makes each lane's primary ray from them, bit for bit that function's,
    and every launch each lane's stream.  The wave's state, kept between its
    launches: ``orig``, ``direction`` and ``thr`` (R, 3) f32 (origin,
    direction, throughput; written by the nearest launch of bounce 0),
    ``rows4`` (4, R) f32 (radiance, segments: the wave's result after the
    last launch), ``hit`` (3, R) f32 (t, u, v of each lane's last nearest
    hit), ``idx`` (R,) int32 (its Morton index) and ``flags`` (R,) uint8.
    The shade reads the scene's shade table, texel bank and ``perm``;
    ``lights`` (``extensions.LightSet``) or None switches NEE on, ``mr``
    ((T, 2) f32 metallic and roughness) or None ``pbr``, ``roulette``
    Russian roulette.  ``counts`` (8,) int64 (the first eight of
    ``wavefront.WORK_COUNTERS``) or None: the nearest launch adds its rays,
    tiles and boxes to [0:3], the shadow launch its shadow rays, tiles and
    boxes to [4:7] and its specular bounces to [7].  Every check of the
    wave runs before the library is loaded; CPU tensors raise."""
    dev = orig.device
    R = orig.shape[0]
    if not 0 < R < 1 << 31:
        raise ValueError(f"{R} rays: 1 to 2^31 - 1 a wave")
    if bounce < 0:
        raise ValueError(f"bounce {bounce}")
    shade, bank = scene.shade_table, scene.color_data
    checks = [("orig", orig, torch.float32, (R, 3)),
              ("direction", direction, torch.float32, (R, 3)),
              ("thr", thr, torch.float32, (R, 3)), ("rows4", rows4, torch.float32, (4, R)),
              ("hit", hit, torch.float32, (3, R)),
              ("idx", idx, torch.int32, (R,)), ("flags", flags, torch.uint8, (R,)),
              ("shade", shade, torch.float32, (shade.shape[0], 32)),
              ("bank", bank, torch.float32, (bank.shape[0], 4)),
              ("perm", scene.perm, torch.int64, (scene.perm.shape[0],))]
    if mr is not None:
        checks.append(("mr", mr, torch.float32, (shade.shape[0], 2)))
    if lights is not None:
        L = lights.tri.shape[0]
        checks += [("lights.tri", lights.tri, torch.int64, (L,)),
                   ("lights.cdf", lights.cdf, torch.float32, (L,)),
                   ("lights.total_area", lights.total_area, torch.float32, (1,))]
        checks += [(f"lights.{k}", getattr(lights, k), torch.float32, (L, 3))
                   for k in ("v0", "e1", "e2", "normal")]
        if L < 1:
            raise ValueError("a light set of no light")
    if counts is not None:
        checks.append(("counts", counts, torch.int64, (8,)))
    for name, t, dtype, shape in checks:
        _check(t, name, dtype, shape, dev)
    gen = _wave_gen(par, width, spp, slot_base, seed, dev)
    if not 1 <= bank.shape[0] < 1 << 31:
        raise ValueError(f"{bank.shape[0]} texels: 1 to 2^31 - 1")
    for name, t in (("shade", shade), ("bank", bank)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (float4 rows)")
    if dev.type != "cuda":
        raise ValueError(f"the shaded trace needs CUDA tensors, got {dev}")
    sc = _scene_struct(scene, dev)
    heap = _scene_heap(scene, groups)
    lib = load()
    lt = (None,) * 7 if lights is None else (
        lights.tri, lights.v0, lights.e1, lights.e2, lights.normal, lights.cdf,
        lights.total_area)
    w = ZrcTraceWave(orig.data_ptr(), direction.data_ptr(), thr.data_ptr(), rows4.data_ptr(),
                     gen, hit.data_ptr(), idx.data_ptr(), flags.data_ptr(),
                     shade.data_ptr(), bank.data_ptr(), bank.shape[0], scene.perm.data_ptr(),
                     _addr(mr), *(_addr(t) for t in lt), 0 if lights is None else L,
                     int(bounce), int(roulette), _addr(counts))
    err = lib.zrc_trace_shaded(ctypes.byref(sc), ctypes.byref(heap), ctypes.byref(w),
                               int(shadow), R, dev.index or 0,
                               torch.cuda.current_stream(dev).cuda_stream)
    name = "trace_stream" if groups else "trace_emit"
    if _launched(err, lib.zrc_error_string, f"{name}_kernel"):
        _count(name)


def launch_shade(scene, state_in, aux, rec, bounce: int, state_out) -> None:
    """Launch shade_kernel: ``state_in`` (16, R), ``aux`` (8, R) and
    ``rec`` (24, R) → ``state_out`` (16, R)."""
    lib = load()
    dev = scene.device
    R = state_in.shape[1]
    _check(state_in, "state_in", torch.float32, (16, R), dev)
    _check(aux, "aux", torch.float32, (8, R), dev)
    _check(rec, "rec", torch.float32, (24, R), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    sc = _scene_struct(scene, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_shade(
        ctypes.byref(sc), state_in.data_ptr(), aux.data_ptr(), rec.data_ptr(),
        int(bounce), state_out.data_ptr(), R, dev.index or 0, stream,
    )
    if _launched(err, lib.zrc_error_string, "shade_kernel"):
        _count("shade")


def launch_texel_fetch(bank, texture, base, demand, out) -> None:
    """Launch texel_fetch_kernel: the four bilinear corners (self, +x, +y,
    +xy under the texture's wrap mode) of each base texel ``base`` (B,)
    int32 of ``texture`` (off, w, h, repeat_u, repeat_v) in the (P, 4)
    ``bank``, into ``out`` (16, B) f32, row 4·corner + channel; lanes where
    ``demand`` (B,) bool is False read 0."""
    lib = load()
    dev = bank.device
    B = base.shape[0]
    _check(bank, "bank", torch.float32, (bank.shape[0], 4), dev)
    _check(base, "base", torch.int32, (B,), dev)
    _check(demand, "demand", torch.bool, (B,), dev)
    _check(out, "out", torch.float32, (16, B), dev)
    off, w, h, rep_u, rep_v = (int(x) for x in texture)
    if w < 1 or h < 1 or off < 0 or off + w * h > bank.shape[0]:
        raise ValueError(f"texture {tuple(texture)} does not lie in a bank of "
                         f"{bank.shape[0]} texels")
    sc = ZrcScene(None, None, None, bank.data_ptr(), 0, 0, bank.shape[0], 0, None, 0)
    tex = ZrcTexture(off, w, h, rep_u, rep_v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_texel_fetch(ctypes.byref(sc), ctypes.byref(tex), base.data_ptr(),
                              demand.data_ptr(), out.data_ptr(), B, dev.index or 0,
                              stream)
    if _launched(err, lib.zrc_error_string, "texel_fetch_kernel"):
        _count("texel_fetch")


def launch_sort_key(state, par, key_out) -> None:
    """Launch sort_key_kernel: the whole-path kernels' beam-sort key of
    every column of ``state`` (16, R) with the gen parameters ``par``
    (32,), into ``key_out`` (R,) int32."""
    lib = load()
    dev = state.device
    R = state.shape[1]
    _check(state, "state", torch.float32, (16, R), dev)
    _check(par, "par", torch.float32, (32,), dev)
    _check(key_out, "key_out", torch.int32, (R,), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_sort_key(state.data_ptr(), par.data_ptr(), key_out.data_ptr(), R,
                           dev.index or 0, stream)
    if _launched(err, lib.zrc_error_string, "sort_key_kernel"):
        _count("sort_key")


def launch_ray_sort_key(state, bbox_min, bbox_max, key_out) -> None:
    """Launch ray_sort_key_kernel: the host beam-sort key
    (``wavefront.ray_sort_key_ref``) of every column of ``state`` (16, R)
    in the scene box ``bbox_min`` / ``bbox_max`` (3,), into ``key_out``
    (R,) int32.  A thread takes two lanes with float2 loads and an int2 store:
    R must be even and ``state`` and ``key_out`` 8-byte aligned (every
    wave is; a view that is not raises).  Every check runs before the
    library is loaded; CPU tensors raise (the CPU keys with
    ``wavefront.ray_sort_key_ref``)."""
    dev = state.device
    R = state.shape[1]
    _check(state, "state", torch.float32, (16, R), dev)
    _check(bbox_min, "bbox_min", torch.float32, (3,), dev)
    _check(bbox_max, "bbox_max", torch.float32, (3,), dev)
    _check(key_out, "key_out", torch.int32, (R,), dev)
    if R % 2:
        raise ValueError(f"ray_sort_key_kernel takes two lanes a thread: R = {R} is odd")
    for name, t in (("state", state), ("key_out", key_out)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} is not 8-byte aligned (float2 / int2 rows)")
    if dev.type != "cuda":
        raise ValueError(f"ray_sort_key_kernel needs CUDA tensors, got {dev}")
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_ray_sort_key(state.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
                               key_out.data_ptr(), R, dev.index or 0, stream)
    if _launched(err, lib.zrc_error_string, "ray_sort_key_kernel"):
        _count("ray_sort_key")


# The most rays one grid walk takes: the warps take positions 32 at a time
# from an int32 counter that may pass R by 32 a warp before they stop
GRID_MAX_RAYS = (1 << 31) - (1 << 24)


def _grid_struct(grid, device) -> ZrcGrid:
    """Check the grid's operands (``scene.types.GridOperands``) on
    ``device`` → the ``ZrcGrid`` the walk reads.  Refused: a grid of 2^31
    cells or more (its int32 indices)."""
    rx, ry, rz = grid.resolution
    cells = rx * ry * rz
    _check(grid.tri, "grid.tri", torch.float32, (grid.tri.shape[0], 12), device)
    _check(grid.cells, "grid.cells", torch.int32, (grid.cells.shape[0], 2), device)
    if grid.cells.shape[0] != cells or cells >= 1 << 31:
        raise ValueError(f"{grid.cells.shape[0]} cell ranges for a {grid.resolution} grid")
    if grid.tri.shape[0] >= 1 << 31 or grid.tri.shape[0] < 1:
        raise ValueError(f"{grid.tri.shape[0]} references: 1 to 2^31 - 1")
    return ZrcGrid(grid.tri.data_ptr(), grid.cells.data_ptr(),
                   (ctypes.c_float * 3)(*grid.bbox_min), (ctypes.c_float * 3)(*grid.bbox_max),
                   (ctypes.c_float * 3)(*grid.cell_size), (ctypes.c_int * 3)(*grid.resolution),
                   cells)


def launch_grid_walk(grid, orig, direction, active, exclude, t_out, u_out, v_out,
                     idx_out, iterations, it_sum=None) -> None:
    """Launch grid_walk_kernel: the nearest hit of each ray ``orig`` /
    ``direction`` (R, 3) f32 with ``active`` (R,) bool by the walk of
    ``grid`` (``scene.types.GridOperands``), ``exclude`` (R,) int64 (the
    previous hit's unique triangle) or None, into ``t_out``, ``u_out``,
    ``v_out`` (R,) f32 and ``idx_out`` (R,) int64.  ``iterations`` is (2,)
    int32 scratch that must hold zeros: the loop's iteration count goes
    into [0], and [1] is the counter the warps take ray positions from.
    ``it_sum`` (1,) int64 or None gets every ray's iterations added.
    Every check runs before the library is loaded; CPU tensors raise (the
    CPU walks with
    ``wavefront.trace_wave_ref``).  Refused: a grid of 2^31 cells or more
    (its int32 indices) and R above GRID_MAX_RAYS."""
    dev = orig.device
    R = orig.shape[0]
    if R > GRID_MAX_RAYS:
        raise ValueError(f"{R} rays: at most {GRID_MAX_RAYS} a walk")
    for name, t, dtype, shape in (
            ("orig", orig, torch.float32, (R, 3)), ("direction", direction, torch.float32, (R, 3)),
            ("active", active, torch.bool, (R,)), ("t_out", t_out, torch.float32, (R,)),
            ("u_out", u_out, torch.float32, (R,)), ("v_out", v_out, torch.float32, (R,)),
            ("idx_out", idx_out, torch.int64, (R,)), ("iterations", iterations, torch.int32, (2,))):
        _check(t, name, dtype, shape, dev)
    if exclude is not None:
        _check(exclude, "exclude", torch.int64, (R,), dev)
    if it_sum is not None:
        _check(it_sum, "it_sum", torch.int64, (1,), dev)
    g = _grid_struct(grid, dev)
    if dev.type != "cuda":
        raise ValueError(f"grid_walk_kernel needs CUDA tensors, got {dev}")
    lib = load()
    err = lib.zrc_grid_walk(
        ctypes.byref(g), orig.data_ptr(), direction.data_ptr(), active.data_ptr(), _addr(exclude),
        t_out.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), idx_out.data_ptr(),
        iterations.data_ptr(), _addr(it_sum), R, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if _launched(err, lib.zrc_error_string, "grid_walk_kernel"):
        _count("grid_walk")


def launch_grid_walk_shaded(grid, shade, bank, par, width: int, spp: int, slot_base: int,
                            seed: int, orig, direction, thr, rows4, t_out, u_out, v_out,
                            idx_out, iterations, bounce: int, bounces: int,
                            counts=None) -> None:
    """Launch ``bounce`` (0 .. ``bounces``) of a shaded wave of grid_walk_kernel
    (``wavefront.render_wave_grid``: launches 0 .. bounces in turn make a
    wave of ``bounces`` bounces, equal to ``wavefront.render_wave_xla``).
    The wave's generator: ``par`` (32,) f32 (``wavefront.build_gen_par``),
    the image ``width``, ``spp``, the raster ``slot_base`` and ``seed``, as
    ``wavefront.xla_primary_rays`` takes them: launch 0 makes each ray's
    primary ray from them, bit for bit that function's, and every launch
    each ray's stream.  The wave's state, kept between its launches:
    ``orig``, ``direction`` and ``thr`` (R, 3) f32 (origin, direction,
    throughput; written by launch 0), ``rows4`` (4, R) f32 (radiance,
    segments; set by launch 0, the wave's result after the last) and the
    hits ``t_out``, ``u_out``, ``v_out`` (R,) f32 and ``idx_out`` (R,)
    int64.  ``shade`` (T, 32) f32 and ``bank`` (P, 4) f32 are the scene's
    shade table and texel bank (``shade_table``, ``color_data``);
    ``iterations`` (2,) int32 scratch that must hold zeros, as
    ``launch_grid_walk``'s.  ``counts`` (4,) int64
    (``wavefront.WORK_COUNTERS``) or None: the launch adds the rays it walks
    to [0] and their iterations to [3].  Every check runs before the library
    is loaded; CPU tensors raise."""
    dev = orig.device
    R = orig.shape[0]
    if R > GRID_MAX_RAYS:
        raise ValueError(f"{R} rays: at most {GRID_MAX_RAYS} a walk")
    if not 0 <= bounce <= bounces:
        raise ValueError(f"launch {bounce} of a wave of {bounces} bounces")
    for name, t, dtype, shape in (
            ("orig", orig, torch.float32, (R, 3)), ("direction", direction, torch.float32, (R, 3)),
            ("thr", thr, torch.float32, (R, 3)), ("rows4", rows4, torch.float32, (4, R)),
            ("t_out", t_out, torch.float32, (R,)),
            ("u_out", u_out, torch.float32, (R,)), ("v_out", v_out, torch.float32, (R,)),
            ("idx_out", idx_out, torch.int64, (R,)), ("iterations", iterations, torch.int32, (2,)),
            ("shade", shade, torch.float32, (shade.shape[0], 32)),
            ("bank", bank, torch.float32, (bank.shape[0], 4))):
        _check(t, name, dtype, shape, dev)
    if counts is not None:
        _check(counts, "counts", torch.int64, (4,), dev)
    gen = _wave_gen(par, width, spp, slot_base, seed, dev)
    if not 1 <= bank.shape[0] < 1 << 31:
        raise ValueError(f"{bank.shape[0]} texels: 1 to 2^31 - 1")
    for name, t in (("shade", shade), ("bank", bank)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (float4 rows)")
    g = _grid_struct(grid, dev)
    if dev.type != "cuda":
        raise ValueError(f"grid_walk_kernel needs CUDA tensors, got {dev}")
    lib = load()
    w = ZrcGridWave(orig.data_ptr(), direction.data_ptr(), thr.data_ptr(), rows4.data_ptr(),
                    gen, shade.data_ptr(), bank.data_ptr(), bank.shape[0], 0, 0, None)
    err = lib.zrc_grid_walk_shaded(
        ctypes.byref(g), ctypes.byref(w), t_out.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
        idx_out.data_ptr(), iterations.data_ptr(), _addr(counts), bounce, bounces, R,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if _launched(err, lib.zrc_error_string, "grid_walk_kernel"):
        _count("grid_walk")


def launch_empty(device) -> None:
    """Launch empty_kernel (one thread, no work) on ``device``'s current
    stream: the launch floor of this interface.  Not counted: no path
    runs it."""
    lib = load()
    dev = torch.device(device)
    err = lib.zrc_empty(dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _launched(err, lib.zrc_error_string, "empty_kernel")


# ------------------------------------------------------------- probes.cu

MICRO_TRACE_CULLS = ("none", "lane", "warp")
MICRO_TRACE_MAX_TILE = 256
MICRO_BF16_TILE = 128
PROBE_GATHER_FORMS = ("smem", "shfl")


def launch_micro_trace(tri_data, tile_bbox, tile: int, state, cull: str,
                       extract_uv: bool, threads: int, aux_out, idx_out) -> None:
    """Launch micro_trace_kernel: the nearest hit of every column of
    ``state`` (16, R) over the flat loop of the field-major (16, Tp)
    ``tri_data`` in tiles of ``tile`` with boxes ``tile_bbox`` (6, nt), into
    ``aux_out`` (8, R) and ``idx_out`` (1, R) int32; ``cull`` one of
    MICRO_TRACE_CULLS, ``threads`` per block 128, 256 or 512."""
    lib = load_probes()
    dev = state.device
    R, tp, nt = state.shape[1], tri_data.shape[1], tile_bbox.shape[1]
    _check(tri_data, "tri_data", torch.float32, (16, tp), dev)
    _check(tile_bbox, "tile_bbox", torch.float32, (6, nt), dev)
    _check(state, "state", torch.float32, (16, R), dev)
    _check(aux_out, "aux_out", torch.float32, (8, R), dev)
    _check(idx_out, "idx_out", torch.int32, (1, R), dev)
    if cull not in MICRO_TRACE_CULLS:
        raise ValueError(f"cull {cull!r} not one of {MICRO_TRACE_CULLS}")
    if threads not in (128, 256, 512):
        raise ValueError(f"{threads} threads per block: 128, 256 or 512")
    if not 0 < tile <= MICRO_TRACE_MAX_TILE or nt * tile > tp:
        raise ValueError(f"{nt} tiles of {tile} do not fit a bank of {tp} triangles "
                         f"(tile at most {MICRO_TRACE_MAX_TILE})")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_micro_trace(
        tri_data.data_ptr(), tp, tile_bbox.data_ptr(), nt, tile, state.data_ptr(),
        MICRO_TRACE_CULLS.index(cull), int(extract_uv), threads, aux_out.data_ptr(),
        idx_out.data_ptr(), R, dev.index or 0, stream)
    if _launched(err, lib.zrc_probes_error_string, "micro_trace_kernel"):
        _count(f"micro_trace_{cull}")


def launch_micro_bf16(bank, state, iters: int, best_out) -> None:
    """Launch micro_bf16_kernel: ``iters`` sweeps of the (13, nt·128)
    ``bank`` (sweep i over tile i mod nt) against the rays of ``state`` (6,
    L) f32 or bf16 (the transform's working type), each lane's positive hit
    t min-folded into ``best_out`` (1, L) f32, which must hold +inf (or a
    bound) before the launch: the kernel cuts the iterations into chunks
    run by separate blocks, folded with atomicMin on the f32 bits."""
    lib = load_probes()
    dev = state.device
    L = state.shape[1]
    nt = bank.shape[1] // MICRO_BF16_TILE
    _check(bank, "bank", torch.float32, (13, nt * MICRO_BF16_TILE), dev)
    if state.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"state has dtype {state.dtype}, expected float32 or bfloat16")
    _check(state, "state", state.dtype, (6, L), dev)
    _check(best_out, "best_out", torch.float32, (1, L), dev)
    if nt < 1 or iters < 0:
        raise ValueError(f"bank of {nt} tiles, {iters} iterations")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_micro_bf16(bank.data_ptr(), nt, state.data_ptr(),
                             int(state.dtype == torch.bfloat16), L, int(iters),
                             best_out.data_ptr(), dev.index or 0, stream)
    if _launched(err, lib.zrc_probes_error_string, "micro_bf16_kernel"):
        _count(f"micro_bf16_{'bf16' if state.dtype == torch.bfloat16 else 'f32'}")


def launch_probe_gather(page, col, row, reps: int, chunks: int, per: int, form: str, out,
                        cycles=None) -> None:
    """Launch probe_gather_kernel: ``out`` (8, 128) int32 = the sum over r <
    ``reps`` of take(take(page + r, col, axis=1), row, axis=0) for the (8,
    128) int32 ``page``, ``col`` and ``row``, in ``chunks`` blocks of
    ``per`` reps (``probes.probe_gather.rep_chunks``); ``form`` "smem" (the
    page in shared memory, indexed loads) or "shfl" (a warp a chunk,
    __shfl_sync).  With ``cycles`` (1,) int64, the SM clock cycles of the
    reps loop summed over the chunks."""
    lib = load_probes()
    dev = page.device
    for name, t in (("page", page), ("col", col), ("row", row), ("out", out)):
        _check(t, name, torch.int32, (8, 128), dev)
    if cycles is not None:
        _check(cycles, "cycles", torch.int64, (1,), dev)
    if form not in PROBE_GATHER_FORMS:
        raise ValueError(f"form {form!r} not one of {PROBE_GATHER_FORMS}")
    if reps < 0 or chunks < 1 or per < 0 or chunks * per < reps:
        raise ValueError(f"{chunks} chunks of {per} do not cover {reps} repetitions")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_probe_gather_chunks(page.data_ptr(), col.data_ptr(), row.data_ptr(),
                                      int(reps), int(chunks), int(per),
                                      PROBE_GATHER_FORMS.index(form), out.data_ptr(),
                                      _addr(cycles), dev.index or 0, stream)
    if _launched(err, lib.zrc_probes_error_string, "probe_gather_kernel"):
        _count(f"probe_gather_{form}")
