"""Phase wall-clock timing, mirroring the reference's six-phase log.

(src/main.zig:24-27 getDuration; log calls at :106,113,119,127,140,142 —
load / preprocess / compile / render / save / total.)
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import torch

log = logging.getLogger("zig_raytracing_contest_tpu_torch")


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
    """Collects named phase durations; emits reference-style log lines."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._start = time.perf_counter()

    @contextmanager
    def phase(self, name: str, message: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
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
