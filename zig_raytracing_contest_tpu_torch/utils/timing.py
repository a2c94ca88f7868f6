"""Phase wall-clock timing, mirroring the reference's six-phase log, and
the program's host spans.

(src/main.zig:24-27 getDuration; log calls at :106,113,119,127,140,142 —
load / preprocess / compile / render / save / total.)
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import torch
from torch._C._autograd import _profiler_enabled

log = logging.getLogger("zig_raytracing_contest_tpu_torch")
# the prefix of a span's profiler range: a span ``render.plan`` records as
# ``zrc.render.plan``
SPAN_PREFIX = "zrc."


def _fmt(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.3f}ms"
    if seconds < 60.0:
        return f"{seconds:.3f}s"
    m, s = divmod(seconds, 60.0)
    return f"{int(m)}m{s:.3f}s"


class PhaseTimers:
    """Collects named phase durations (``phases``, seconds summed over
    every time a phase ran); emits reference-style log lines.

    A phase is a span of host time.  Spans nest: a child span is opened
    inside its parent and named under it with a dot (``render.plan``
    inside ``render``).  Only a span given a ``message`` is logged.  While
    a ``torch.profiler`` records on this thread, a span also opens the
    profiler range ``zrc.<name>`` (``record_function``), so it lands in the
    profiler's trace beside the device's operations, on the same clock;
    otherwise it costs two clock reads and a dict update."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._start = time.perf_counter()

    @contextmanager
    def phase(self, name: str, message: str | None = None):
        if _profiler_enabled():
            with torch.profiler.record_function(SPAN_PREFIX + name):
                t0 = time.perf_counter()
                yield
                dt = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if message is not None:
            log.info("%s in %s", message, _fmt(dt))

    def done(self) -> float:
        total = time.perf_counter() - self._start
        self.phases["total"] = total
        log.info("Done in %s", _fmt(total))
        return total


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    after one warmup call, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# readings of which best_ms keeps the least
ROUNDS = 5
# SM clock cycles (~10 ms) of the spin that queued_ms puts ahead of its calls
LEAD_CYCLES = 20_000_000


def best_ms(fn, reps: int) -> float:
    """The least of ROUNDS ``cuda_ms`` readings."""
    return min(cuda_ms(fn, reps) for _ in range(ROUNDS))


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls
    after one warmup call, the calls queued behind a spin of LEAD_CYCLES
    SM clock cycles so that they run back to back:
    CUDA events around calls shorter than the host's launch gap would time
    the gap."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
