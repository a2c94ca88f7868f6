"""walk_iterations_per_segment: the grid walk's iterations (up to four
triangle tests, then a DDA step once the cell is exhausted), summed over
every ray (grid_walk_kernel's warp sums; ``kernels.COUNTERS``), over the
traced segments, over the window's frames.  Layer: kernels; moves
mrays_s."""

from pathbench.metrics.lane_yield import ratio

UNIT = "iters/segment"


def read(reading):
    return ratio(reading, "walk_iterations", "segments")
