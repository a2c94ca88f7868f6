"""launch_idle_ms: device-idle ms a frame that fall inside the program's
``zrc.render.replay`` spans: the host launching the frame's CUDA graph
(``cudaGraphLaunch``) while the card waits.  The spans are the program's
own (``PhaseTimers`` ranges, ``user_annotation`` events of the trace), on
the profiler's clock; each idle gap counts by how much of it a span
covers.  None where the window holds no device operation or no such span.
Layer: pipeline; moves mrays_s."""

from pathbench.devtrace import idle_gaps

UNIT = "ms/frame"
SPAN = "zrc."  # the prefix of the program's span ranges
REPLAY = "zrc.render.replay"


def spans(trace, keep) -> list:
    """The union of the host spans whose name ``keep`` accepts, as sorted
    disjoint [start, end] intervals in microseconds."""
    merged: list = []
    for s, e, _ in sorted(h for h in trace.host if keep(h[2])):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap_us(a: list, b: list) -> float:
    """Microseconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_frame(trace, keep):
    """Device-idle ms a frame inside the spans ``keep`` accepts, or None
    where the window holds no device operation or no such span."""
    if trace is None or not trace.ops or not trace.frames:
        return None
    covered = spans(trace, keep)
    if not covered:
        return None
    return overlap_us(idle_gaps(trace), covered) * 1e-3 / trace.frames


def read(reading):
    return idle_ms_per_frame(reading.trace, lambda name: name == REPLAY)
