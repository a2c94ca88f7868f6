"""shadow_boxes_per_ray: the boxes the trace kernels tested for NEE's
shadow rays (heap nodes, a group's re-culls, tile boxes: aux row 6 of
those calls, summed inside the kernel; ``kernels.COUNTERS``) over the
shadow rays traced, summed over the window's frames: the walk that an
occlusion query, which stops at the first hit nearer than the light,
would cut.  0 where the program counts shadow work and traced no shadow
ray (no box was tested), as a counter of work a route does not do reads
0; None where it counts none.  Layer: kernels; moves mrays_s."""

from pathbench.metrics.lane_yield import program_counters

UNIT = "boxes/ray"


def read(reading):
    c = program_counters(reading)
    if c is None or "shadow_boxes" not in c or "shadow_rays" not in c:
        return None
    return c["shadow_boxes"] / c["shadow_rays"] if c["shadow_rays"] else 0.0
