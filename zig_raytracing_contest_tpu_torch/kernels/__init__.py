"""Build and bind the CUDA kernels, and count their launches.

Two sources: ``path_trace.cu`` (the renderer's kernels, the grid walk and
the probes of its device functions) and ``probes.cu`` (the trace
micro-benchmarks).  At first use each is compiled on its own with ``nvcc``
into a shared library with a plain C interface, under ``kernels/_build/``
(keyed on a hash of the source and the flags), and loaded with ``ctypes``:
``load()`` builds path_trace.cu, ``load_probes()`` probes.cu.  The
wrappers take tensors, check them, and launch on PyTorch's current stream;
they allocate nothing and do not synchronise.

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
# The compiles this process ran, by source name (another file: "name path"):
# {"seconds": wall seconds of the nvcc run, "log": its report (ptxas
# registers / spills per kernel)}.
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


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH)")


def library_path(name: str, src: Path | None = None, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of source ``name`` (or of the file ``src``) is
    built: keyed on a hash of the source and the flags."""
    src = SOURCES[name] if src is None else src
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"libzrc_{name}_{key}.so"


def build(name: str, src: Path | None = None, build_dir: Path = BUILD_DIR) -> Path:
    """The library of source ``name`` (or of the file ``src``, built into
    ``build_dir``), compiled by nvcc if it does not exist yet (raises if nvcc
    fails).  Builds of different sources, or of one into different
    directories, may run at once, from separate threads."""
    key = _build_key(name, src)
    src = SOURCES[name] if src is None else Path(src)
    out = library_path(name, src, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    _log_path(out).write_text(log)
    os.replace(tmp, out)
    BUILD_INFO[key] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


def _build_key(name: str, src) -> str:
    return name if src is None else f"{name} {Path(src)}"


def _log_path(lib: Path) -> Path:
    """Where a library's nvcc report is kept, beside it."""
    return lib.with_name(lib.name + ".log")


def build_log(name: str, src: Path | None = None, build_dir: Path = BUILD_DIR) -> str:
    """The nvcc report (ptxas registers / spills per kernel) of the build of
    ``name`` (or of the file ``src``, built into ``build_dir``): this
    process's, else the one kept beside the library; empty if it was never
    built."""
    info = BUILD_INFO.get(_build_key(name, src))
    if info:
        return info["log"]
    src = SOURCES[name] if src is None else Path(src)
    log = _log_path(library_path(name, src, build_dir))
    return log.read_text() if log.exists() else ""


def _bind_trace(lib) -> None:
    """Bind the entry points of path_trace.cu that another build of it is
    compared on: the whole-path kernels, the per-bounce traces and the host
    beam-sort key."""
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
    lib.zrc_trace_emit.restype = i32
    lib.zrc_trace_emit.argtypes = [
        ctypes.POINTER(ZrcScene), ctypes.POINTER(ZrcHeap), ptr, ptr, ptr,
        i32, ptr, ptr, ptr, i32, i32, ptr,
    ]
    lib.zrc_ray_sort_key.restype = i32
    lib.zrc_ray_sort_key.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.zrc_error_string.restype = ctypes.c_char_p
    lib.zrc_error_string.argtypes = [i32]


def _bind_grid_walk(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.zrc_grid_walk.restype = i32
    lib.zrc_grid_walk.argtypes = [
        ctypes.POINTER(ZrcGrid), ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr,
    ]
    lib.zrc_error_string.restype = ctypes.c_char_p
    lib.zrc_error_string.argtypes = [i32]


def load_grid_walk_library(src: Path, build_dir: Path):
    """Another build of grid_walk_kernel: a source whose ``zrc_grid_walk``
    takes the same arguments and ``ZrcGrid`` (an earlier commit's
    path_trace.cu, or ``probes/grid_walk_one_thread.cu``), built into
    ``build_dir`` and loaded, for the ``lib`` argument of
    ``launch_grid_walk``."""
    lib = ctypes.CDLL(str(build("grid_walk_other", Path(src), Path(build_dir))))
    _bind_grid_walk(lib)
    return lib


def load_trace_library(src: Path, build_dir: Path):
    """Another build of a path_trace.cu whose ``zrc_path_trace_gen``,
    ``zrc_path_trace``, ``zrc_trace_emit`` and ``zrc_ray_sort_key`` take the
    same arguments (an earlier commit's, to compare with): built into
    ``build_dir`` and loaded, for the ``lib`` argument of
    ``launch_path_trace_gen``, ``launch_path_trace``, ``launch_trace_emit``,
    ``launch_trace_stream`` and ``launch_ray_sort_key``."""
    lib = ctypes.CDLL(str(build("path_trace_other", Path(src), Path(build_dir))))
    _bind_trace(lib)
    return lib


# The entry points whose ``*_counted`` twin takes the kernel's work
# counters, and where their pointer goes in the arguments.
_COUNTED_AT = {"zrc_path_trace_gen": 6, "zrc_path_trace": 7, "zrc_trace_emit": 9,
               "zrc_grid_walk": 10}


def _call(lib, name: str, args: list, counts, own: bool):
    """Call entry point ``name`` of ``lib`` with ``args``, or with
    ``counts`` (a checked int64 tensor) its ``*_counted`` twin, which this
    build alone (``own``) has.  The kernel counts its work either way:
    without ``counts`` into a buffer of the library's that nothing reads."""
    if counts is None:
        return getattr(lib, name)(*args)
    if not own:
        raise ValueError(f"another build's {name} takes no counts")
    at = _COUNTED_AT[name]
    return getattr(lib, name + "_counted")(*args[:at], counts.data_ptr(), *args[at:])


def load():
    """The loaded library of path_trace.cu (built at first call)."""
    with _lock:
        if "path_trace" not in _libs:
            lib = ctypes.CDLL(str(build("path_trace")))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            _bind_trace(lib)
            lib.zrc_shade.restype = i32
            lib.zrc_shade.argtypes = [
                ctypes.POINTER(ZrcScene), ptr, ptr, ptr, i32, ptr, i32, i32, ptr,
            ]
            lib.zrc_texel_fetch.restype = i32
            lib.zrc_texel_fetch.argtypes = [
                ctypes.POINTER(ZrcScene), ctypes.POINTER(ZrcTexture), ptr, ptr, ptr,
                i32, i32, ptr,
            ]
            lib.zrc_sort_key.restype = i32
            lib.zrc_sort_key.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
            _bind_grid_walk(lib)
            # this build's entry points that take the work counters: each
            # the one without the suffix with a pointer before R
            for name, at in _COUNTED_AT.items():
                plain = getattr(lib, name)
                fn = getattr(lib, name + "_counted")
                fn.restype = i32
                fn.argtypes = plain.argtypes[:at] + [ptr] + plain.argtypes[at:]
            lib.zrc_empty.restype = i32
            lib.zrc_empty.argtypes = [i32, ptr]
            _libs["path_trace"] = lib
        return _libs["path_trace"]


def _bind_micro(lib) -> None:
    """Bind the entry points of probes.cu that another build of it is
    compared on: the two trace micro-benchmarks and the gather probe."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.zrc_micro_trace.restype = i32
    lib.zrc_micro_trace.argtypes = [
        ptr, i32, ptr, i32, i32, ptr, i32, i32, i32, ptr, ptr, i32, i32, ptr,
    ]
    lib.zrc_micro_bf16.restype = i32
    lib.zrc_micro_bf16.argtypes = [ptr, i32, ptr, i32, i32, i32, ptr, i32, ptr]
    # probe_gather: the chunked entry point, or an earlier build's one-block
    # entry point (page, col, row, reps, shfl, out, cycles, device, stream)
    if hasattr(lib, "zrc_probe_gather_chunks"):
        lib.zrc_probe_gather_chunks.restype = i32
        lib.zrc_probe_gather_chunks.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr,
                                                i32, ptr]
    else:
        lib.zrc_probe_gather.restype = i32
        lib.zrc_probe_gather.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, i32, ptr]
    lib.zrc_probes_error_string.restype = ctypes.c_char_p
    lib.zrc_probes_error_string.argtypes = [i32]


def load_probes_library(src: Path, build_dir: Path):
    """Another build of a probes.cu whose ``zrc_micro_trace`` and
    ``zrc_micro_bf16`` take the same arguments (an earlier commit's, to
    compare with): built into ``build_dir`` and loaded, for the ``lib``
    argument of ``launch_micro_trace``, ``launch_micro_bf16`` and
    ``launch_probe_gather``."""
    lib = ctypes.CDLL(str(build("probes_other", Path(src), Path(build_dir))))
    _bind_micro(lib)
    return lib


def load_probes():
    """The loaded library of probes.cu (built at first call)."""
    with _lock:
        if "probes" not in _libs:
            lib = ctypes.CDLL(str(build("probes")))
            _bind_micro(lib)
            _libs["probes"] = lib
        return _libs["probes"]


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


def launch_path_trace_gen(scene, par, meta, gen, max_bounce: int,
                          emit_key: bool, state_out, idx_out, lib=None,
                          counts=None) -> None:
    """Launch path_trace_gen_kernel into ``state_out`` (16, R) and
    ``idx_out`` (R,) int32; from ``lib`` (``load_trace_library``, not
    counted) when given.  ``counts`` (3,) int64 (this build only) gets the
    wave's rays alive at each bounce's trace, tiles swept and boxes tested
    added."""
    counted = lib is None
    lib = load() if lib is None else lib
    dev = scene.device
    R = state_out.shape[1]
    _check(par, "par", torch.float32, (32,), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if counts is not None:
        _check(counts, "counts", torch.int64, (3,), dev)
    if R >= 1 << 23:
        raise ValueError(f"wave of {R} rays: slot math is exact below 2^23")
    sc = _scene_struct(scene, dev)
    g = ZrcGen(par.data_ptr(), int(meta[1]), int(meta[2]), int(meta[4]),
               int(meta[3]) & 0xFFFFFFFF, gen.spp, gen.width, gen.img_w,
               gen.img_h, gen.tiles_x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _call(lib, "zrc_path_trace_gen", [
        ctypes.byref(sc), ctypes.byref(g), int(max_bounce), int(emit_key),
        state_out.data_ptr(), idx_out.data_ptr(), R, dev.index or 0, stream,
    ], counts, counted)
    if _launched(err, lib.zrc_error_string, "path_trace_gen_kernel") and counted:
        _count("path_trace_gen")


def launch_path_trace(scene, state_in, prev, bounce0: int, max_bounce: int,
                      state_out, idx_out, lib=None, counts=None) -> None:
    """Launch path_trace_kernel: ``state_in`` (16, R) → ``state_out``;
    ``prev`` (R,) int32 or None; ``lib`` and ``counts`` as
    ``launch_path_trace_gen``."""
    counted = lib is None
    lib = load() if lib is None else lib
    dev = scene.device
    R = state_in.shape[1]
    _check(state_in, "state_in", torch.float32, (16, R), dev)
    _check(state_out, "state_out", torch.float32, (16, R), dev)
    _check(idx_out, "idx_out", torch.int32, (R,), dev)
    if prev is not None:
        _check(prev, "prev", torch.int32, (R,), dev)
    if counts is not None:
        _check(counts, "counts", torch.int64, (3,), dev)
    sc = _scene_struct(scene, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _call(lib, "zrc_path_trace", [
        ctypes.byref(sc), state_in.data_ptr(),
        None if prev is None else prev.data_ptr(), int(bounce0),
        int(max_bounce), state_out.data_ptr(), idx_out.data_ptr(), R,
        dev.index or 0, stream,
    ], counts, counted)
    if _launched(err, lib.zrc_error_string, "path_trace_kernel") and counted:
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
                  rec_out, lib=None, counts=None) -> None:
    """Launch the walk of ``heap``: trace_stream_kernel when it has group
    boxes, else trace_emit_kernel; from ``lib`` (``load_trace_library``,
    not counted) when given; ``counts`` as ``launch_trace_emit``."""
    counted = lib is None
    lib = load() if lib is None else lib
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
    args = [ctypes.byref(_scene_struct(scene, dev)), ctypes.byref(heap), state.data_ptr(),
            None if prev is None else prev.data_ptr(),
            None if table is None else table.data_ptr(), tp, aux_out.data_ptr(),
            idx_out.data_ptr(), None if table is None else rec_out.data_ptr(), R,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream]
    err = _call(lib, "zrc_trace_emit", args, counts, counted)
    name = "trace_stream" if heap.gbox else "trace_emit"
    if _launched(err, lib.zrc_error_string, f"{name}_kernel") and counted:
        _count(name)


def launch_trace_emit(scene, state, prev, table, aux_out, idx_out, rec_out,
                      lib=None, counts=None) -> None:
    """Launch trace_emit_kernel (the walk of ``scene.tree_bbox``):
    ``state`` (16, R) → ``aux_out`` (8, R), ``idx_out`` (R,) int32 and,
    when ``table`` (24, Tp) is given, ``rec_out`` (24, R); ``prev`` (R,)
    int32 or None; ``lib``: another build (``load_trace_library``);
    ``counts`` (3,) int64 (this build only) gets the sums of aux rows 4-6
    (rays alive, tiles swept, boxes tested) added."""
    heap = _heap(scene.tree_bbox, None, 0, scene.tile_bbox.shape[1], scene.device)
    _launch_trace(scene, heap, state, prev, table, aux_out, idx_out, rec_out, lib, counts)


def launch_trace_stream(scene, state, prev, table, aux_out, idx_out, rec_out,
                        lib=None, counts=None) -> None:
    """Launch trace_stream_kernel (the walk of ``scene.group_tree_bbox``,
    each reached group's tiles culled and swept); arguments as
    ``launch_trace_emit``."""
    ng = scene.group_bbox.shape[1]
    nt = scene.tile_bbox.shape[1]
    if ng != -(-nt // scene.group_tiles):
        raise ValueError(f"{ng} groups of {scene.group_tiles} do not cover {nt} tiles")
    heap = _heap(scene.group_tree_bbox, scene.group_bbox, scene.group_tiles, ng,
                 scene.device)
    _launch_trace(scene, heap, state, prev, table, aux_out, idx_out, rec_out, lib, counts)


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


def launch_ray_sort_key(state, bbox_min, bbox_max, key_out, lib=None) -> None:
    """Launch ray_sort_key_kernel: the host beam-sort key
    (``wavefront.ray_sort_key_ref``) of every column of ``state`` (16, R)
    in the scene box ``bbox_min`` / ``bbox_max`` (3,), into ``key_out``
    (R,) int32; from ``lib`` (``load_trace_library``, not counted) when
    given.  A thread takes two lanes with float2 loads and an int2 store:
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
    counted = lib is None
    lib = load() if lib is None else lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zrc_ray_sort_key(state.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
                               key_out.data_ptr(), R, dev.index or 0, stream)
    if _launched(err, lib.zrc_error_string, "ray_sort_key_kernel") and counted:
        _count("ray_sort_key")


# The most rays one grid walk takes: the warps take positions 32 at a time
# from an int32 counter that may pass R by 32 a warp before they stop
GRID_MAX_RAYS = (1 << 31) - (1 << 24)


def launch_grid_walk(grid, orig, direction, active, exclude, t_out, u_out, v_out,
                     idx_out, iterations, lib=None, it_sum=None) -> None:
    """Launch grid_walk_kernel: the nearest hit of each ray ``orig`` /
    ``direction`` (R, 3) f32 with ``active`` (R,) bool by the walk of
    ``grid`` (``scene.types.GridOperands``), ``exclude`` (R,) int64 (the
    previous hit's unique triangle) or None, into ``t_out``, ``u_out``,
    ``v_out`` (R,) f32 and ``idx_out`` (R,) int64.  ``iterations`` is (2,)
    int32 scratch that must hold zeros: the loop's iteration count goes
    into [0], and [1] is the counter the warps take ray positions from.
    ``it_sum`` (1,) int64 (this build only) gets every ray's iterations
    added.
    From ``lib`` (``load_grid_walk_library``, not counted) when given: a
    build of another source, timed against this one.  Every check runs
    before the library is loaded; CPU tensors raise (the CPU walks with
    ``wavefront.trace_wave_ref``).  Refused: a grid of 2^31 cells or more
    (its int32 indices) and R above GRID_MAX_RAYS."""
    dev = orig.device
    R = orig.shape[0]
    if R > GRID_MAX_RAYS:
        raise ValueError(f"{R} rays: at most {GRID_MAX_RAYS} a walk")
    rx, ry, rz = grid.resolution
    cells = rx * ry * rz
    for name, t, dtype, shape in (
            ("orig", orig, torch.float32, (R, 3)), ("direction", direction, torch.float32, (R, 3)),
            ("active", active, torch.bool, (R,)), ("t_out", t_out, torch.float32, (R,)),
            ("u_out", u_out, torch.float32, (R,)), ("v_out", v_out, torch.float32, (R,)),
            ("idx_out", idx_out, torch.int64, (R,)), ("iterations", iterations, torch.int32, (2,)),
            ("grid.tri", grid.tri, torch.float32, (grid.tri.shape[0], 12)),
            ("grid.cells", grid.cells, torch.int32, (grid.cells.shape[0], 2))):
        _check(t, name, dtype, shape, dev)
    if exclude is not None:
        _check(exclude, "exclude", torch.int64, (R,), dev)
    if it_sum is not None:
        _check(it_sum, "it_sum", torch.int64, (1,), dev)
        if lib is not None:
            raise ValueError("another build's zrc_grid_walk takes no iteration sum")
    if grid.cells.shape[0] != cells or cells >= 1 << 31:
        raise ValueError(f"{grid.cells.shape[0]} cell ranges for a {grid.resolution} grid")
    if grid.tri.shape[0] >= 1 << 31 or grid.tri.shape[0] < 1:
        raise ValueError(f"{grid.tri.shape[0]} references: 1 to 2^31 - 1")
    if dev.type != "cuda":
        raise ValueError(f"grid_walk_kernel needs CUDA tensors, got {dev}")
    counted = lib is None
    lib = load() if lib is None else lib
    g = ZrcGrid(grid.tri.data_ptr(), grid.cells.data_ptr(), (ctypes.c_float * 3)(*grid.bbox_min),
                (ctypes.c_float * 3)(*grid.bbox_max), (ctypes.c_float * 3)(*grid.cell_size),
                (ctypes.c_int * 3)(*grid.resolution), cells)
    args = [ctypes.byref(g), orig.data_ptr(), direction.data_ptr(), active.data_ptr(),
            None if exclude is None else exclude.data_ptr(), t_out.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), idx_out.data_ptr(), iterations.data_ptr(), R, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream]
    err = _call(lib, "zrc_grid_walk", args, it_sum, counted)
    if _launched(err, lib.zrc_error_string, "grid_walk_kernel") and counted:
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
                       extract_uv: bool, threads: int, aux_out, idx_out, lib=None) -> None:
    """Launch micro_trace_kernel: the nearest hit of every column of
    ``state`` (16, R) over the flat loop of the field-major (16, Tp)
    ``tri_data`` in tiles of ``tile`` with boxes ``tile_bbox`` (6, nt), into
    ``aux_out`` (8, R) and ``idx_out`` (1, R) int32; ``cull`` one of
    MICRO_TRACE_CULLS, ``threads`` per block 128, 256 or 512; from ``lib``
    (``load_probes_library``, not counted) when given."""
    counted = lib is None
    lib = load_probes() if lib is None else lib
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
    if _launched(err, lib.zrc_probes_error_string, "micro_trace_kernel") and counted:
        _count(f"micro_trace_{cull}")


def launch_micro_bf16(bank, state, iters: int, best_out, lib=None) -> None:
    """Launch micro_bf16_kernel: ``iters`` sweeps of the (13, nt·128)
    ``bank`` (sweep i over tile i mod nt) against the rays of ``state`` (6,
    L) f32 or bf16 (the transform's working type), each lane's positive hit
    t min-folded into ``best_out`` (1, L) f32, which must hold +inf (or a
    bound) before the launch: the kernel cuts the iterations into chunks
    run by separate blocks, folded with atomicMin on the f32 bits; from
    ``lib`` (``load_probes_library``, not counted) when given."""
    counted = lib is None
    lib = load_probes() if lib is None else lib
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
    if _launched(err, lib.zrc_probes_error_string, "micro_bf16_kernel") and counted:
        _count(f"micro_bf16_{'bf16' if state.dtype == torch.bfloat16 else 'f32'}")


def launch_probe_gather(page, col, row, reps: int, chunks: int, per: int, form: str, out,
                        cycles=None, lib=None) -> None:
    """Launch probe_gather_kernel: ``out`` (8, 128) int32 = the sum over r <
    ``reps`` of take(take(page + r, col, axis=1), row, axis=0) for the (8,
    128) int32 ``page``, ``col`` and ``row``, in ``chunks`` blocks of
    ``per`` reps (``probes.probe_gather.rep_chunks``); ``form`` "smem" (the
    page in shared memory, indexed loads) or "shfl" (a warp a chunk,
    __shfl_sync).  With ``cycles`` (1,) int64, the SM clock cycles of the
    reps loop summed over the chunks.  From ``lib`` (``load_probes_library``,
    not counted) when given; a build without the chunked entry point runs
    the reps in one block whatever the plan."""
    counted = lib is None
    lib = load_probes() if lib is None else lib
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
    args = (page.data_ptr(), col.data_ptr(), row.data_ptr(), int(reps))
    tail = (PROBE_GATHER_FORMS.index(form), out.data_ptr(),
            None if cycles is None else cycles.data_ptr(), dev.index or 0, stream)
    if hasattr(lib, "zrc_probe_gather_chunks"):
        err = lib.zrc_probe_gather_chunks(*args, int(chunks), int(per), *tail)
    else:
        err = lib.zrc_probe_gather(*args, *tail)
    if _launched(err, lib.zrc_probes_error_string, "probe_gather_kernel") and counted:
        _count(f"probe_gather_{form}")
