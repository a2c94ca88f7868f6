"""Build and load the host C++ libraries: the reference-equivalent CPU
tracer (``cpu_tracer.cpp``, bound by ``render/native_cpu.py``) and the
OpenMP grid builder (``grid_builder.cpp``, bound by ``grid/native.py``).

Both sources are copies of the JAX package's ``native/`` files (a test
holds them byte-equal).  At first use each is compiled with
``g++ -O3 -march=native -fopenmp -shared -fPIC`` (the grid builder with
``-ffp-contract=off`` as well: ``EXTRA_FLAGS``) into ``native/_build/``,
keyed on a hash of the source and the flags, and loaded with ``ctypes``.
A compiler that cannot build with OpenMP gets a second build without
``-fopenmp``, which runs on one thread; ``NativeLibrary.openmp`` says
which build was made and a warning is logged.  Builds write to a
temporary name and ``os.replace`` it into place, so processes that build
the same library at once do not see a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

log = logging.getLogger("zig_raytracing_contest_tpu_torch")

_DIR = Path(__file__).resolve().parent
SOURCES = {"cpu_tracer": _DIR / "cpu_tracer.cpp", "grid_builder": _DIR / "grid_builder.cpp"}
BUILD_DIR = _DIR / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
# g++ contracts a*b+c into an FMA by default where -march=native has one;
# that moves the builder's SAT test on triangles that lie on a cell face
# (the Cornell box's walls at an 8³ grid) away from the NumPy builder's,
# which rounds every operation.  The tracer keeps the JAX package's flags,
# so that it renders the JAX tracer's bits.
EXTRA_FLAGS = {"cpu_tracer": [], "grid_builder": ["-ffp-contract=off"]}
OPENMP_FLAG = "-fopenmp"

_lock = threading.Lock()
_libs: dict = {}


@dataclass(frozen=True)
class NativeLibrary:
    lib: ctypes.CDLL
    path: Path
    openmp: bool  # built with -fopenmp (else one thread)


def flags(name: str, openmp: bool) -> list:
    return FLAGS + EXTRA_FLAGS[name] + ([OPENMP_FLAG] if openmp else [])


def library_path(name: str, openmp: bool = True) -> Path:
    """Where the library of source ``name`` is built: keyed on a hash of
    the source and the flags."""
    key = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(flags(name, openmp)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libzrc_{name}_{key}.so"


def build(name: str, openmp: bool = True) -> Path:
    """The library of source ``name``, compiled by g++ if it does not exist
    yet; raises ``subprocess.CalledProcessError`` if g++ fails and
    ``FileNotFoundError`` if there is no g++."""
    out = library_path(name, openmp)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{out.stem}.", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags(name, openmp), str(SOURCES[name]), "-o", tmp]
    log.info("Building %s: %s", name, " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> NativeLibrary:
    """The loaded library of source ``name`` (built at first use): the
    OpenMP build, or the build without OpenMP when g++ cannot make the
    first."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            path, openmp = build(name, openmp=True), True
        except subprocess.CalledProcessError as exc:
            log.warning("g++ cannot build %s with %s (%s); building it without OpenMP, "
                        "on one thread", name, OPENMP_FLAG, exc.stderr.strip()[-500:])
            path, openmp = build(name, openmp=False), False
        lib = NativeLibrary(ctypes.CDLL(str(path)), path, openmp)
        _libs[name] = lib
        return lib
