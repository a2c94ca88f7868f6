"""frame_mfu: the whole frame's share of the card's peak: the bound of a
frame's work (``trace_roofline``'s count, with the shading of every
segment) / the wall ms a frame of the traced window.  It bounds every
kernel's share from above, whichever kernels the frame runs.  Layer:
device; moves mrays_s."""

from pathbench.metrics.trace_roofline import FUSED_SHADE, bound_ms

UNIT = "%"


def read(reading):
    t = reading.trace
    if t is None or not t.ops or not t.frames or not reading.segments or t.window_s <= 0:
        return None
    return 100.0 * bound_ms(reading, FUSED_SHADE) / (t.window_s * 1e3 / t.frames)
