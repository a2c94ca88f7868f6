"""flat_sweep_yield: the share of the whole-path kernels' sweep lane-slots
that test a passing ray's triangles, over the window's frames: ``tiles``
(the rays that passed each tile's box, summed over the tiles: one tile
swept for one ray each) over the lane-slots the flat tile loop spent,
32 for each tile a warp swept lane-parallel (``lane_tiles``: each lane
sweeps the tile for its own ray, or waits) and one for each passing ray
the whole warp swept a tile for (``warp_sweeps``).  From the program's
work counters (``kernels.COUNTERS``).  None where the program counts no
such sweeps (a program without the two counters, or a window of no
whole-path frame).  Layer: kernels; moves mrays_s."""

from pathbench.metrics.lane_yield import program_counters

UNIT = "share"


def read(reading):
    c = program_counters(reading)
    if c is None or "lane_tiles" not in c or "warp_sweeps" not in c:
        return None
    slots = 32 * c["lane_tiles"] + c["warp_sweeps"]
    return c.get("tiles", 0) / slots if slots else None
