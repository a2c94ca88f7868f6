"""stream_boxes_per_segment: the boxes the per-bounce trace kernels
tested (heap nodes, a group's re-culls, tile boxes: aux row 6, summed
inside the kernel; ``kernels.COUNTERS``) over the traced segments, summed
over the window's frames.  Layer: kernels; moves mrays_s."""

from pathbench.metrics.lane_yield import ratio

UNIT = "boxes/segment"


def read(reading):
    return ratio(reading, "boxes", "segments")
