"""The traced window: device operations and host activity read from one
``torch.profiler`` trace of the measured frames.

The harness runs the window under the profiler (CPU and CUDA activity)
and exports its Chrome trace into the temporary directory; ``read_trace``
turns it into a ``DeviceTrace``: every device operation (kernels, copies,
memsets) with its start and end in microseconds, the host's operations,
and the window, from the first frame's ``pathbench.frame`` annotation to
the last one's end.  The reduction to numbers (busy time as the union of
device intervals, idle gaps and what the host was doing in each) is here;
the per-layer metrics read the result.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass

FRAME_LABEL = "pathbench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10  # entries of each breakdown list
HOST_LOOKBACK = 2000  # host operations searched back from an idle gap


@dataclass
class DeviceTrace:
    ops: list  # (start_us, end_us, name) of every device operation
    host: list  # (start_us, end_us, name) of every host operation
    start: float  # the window, microseconds
    end: float
    frames: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6


def kernel_base(name: str) -> str:
    """A kernel's name without its signature: ``void f<...>(args)`` → ``f``."""
    base = name.replace("(anonymous namespace)", "anon").split("(", 1)[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base.split("<", 1)[0].strip()


def read_trace(path) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    ops, host, frames = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(span)
        elif cat in HOST_CATS:
            (frames if span[2] == FRAME_LABEL else host).append(span)
    if not frames:
        raise ValueError(f"the trace holds no {FRAME_LABEL} annotation")
    start = min(s for s, _, _ in frames)
    end = max(e for _, e, _ in frames)
    ops = sorted(op for op in ops if op[1] > start and op[0] < end)
    return DeviceTrace(ops, sorted(host), start, end, len(frames))


def busy_intervals(trace: DeviceTrace) -> list:
    """The union of the device's operations, clipped to the window."""
    merged: list = []
    for s, e, _ in trace.ops:
        s, e = max(s, trace.start), min(e, trace.end)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def busy_s(trace: DeviceTrace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) * 1e-6


def idle_gaps(trace: DeviceTrace) -> list:
    """(start, end) of every stretch of the window with no device operation."""
    gaps, t = [], trace.start
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def host_at(trace: DeviceTrace, starts: list, t: float) -> str:
    """The innermost host operation running at time ``t``: of those that
    cover it, the one that started last (``starts``: the host operations'
    starts, in order), or ``host: none traced``."""
    last = bisect.bisect_right(starts, t) - 1
    for i in range(last, max(last - HOST_LOOKBACK, -1), -1):
        s, e, name = trace.host[i]
        if e >= t:
            return name
    return "host: none traced"


def breakdown(trace: DeviceTrace) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing at each gap's middle, in seconds over the window."""
    by_op: dict = defaultdict(float)
    for s, e, name in trace.ops:
        by_op[kernel_base(name) or name] += (e - s) * 1e-6
    by_host: dict = defaultdict(float)
    starts = [s for s, _, _ in trace.host]
    for s, e in idle_gaps(trace):
        by_host[host_at(trace, starts, 0.5 * (s + e))] += (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
