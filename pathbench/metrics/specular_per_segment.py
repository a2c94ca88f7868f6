"""specular_per_segment: the shaded hits that ``pbr`` reflected (a
metallic draw taken, the reflection above the surface; the program's
``specular`` counter, summed once a bounce; ``kernels.COUNTERS``) over
the traced path segments, summed over the window's frames: the share of
the frame that takes the metals' lobe, on which NEE samples no light.  0
where the program counts specular bounces and ``pbr`` took none (``pbr``
off, or no metal hit); None where it counts none.  Layer: extensions;
moves mrays_s."""

from pathbench.metrics.lane_yield import ratio

UNIT = "bounces/segment"


def read(reading):
    return ratio(reading, "specular", "segments")
