"""stream_tiles_per_segment: the tiles of 256 triangles the per-bounce
trace kernels (trace_stream_kernel in the streaming regime) swept, over
the traced segments, summed over the window's frames (aux row 5, summed
inside the kernel; ``kernels.COUNTERS``).  Layer: kernels; moves mrays_s."""

from pathbench.metrics.lane_yield import ratio

UNIT = "tiles/segment"


def read(reading):
    return ratio(reading, "tiles", "segments")
