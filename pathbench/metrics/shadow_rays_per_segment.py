"""shadow_rays_per_segment: NEE's shadow rays traced (the shaded diffuse
hits whose light sample faces them; the trace kernels' rays alive on
those calls, summed inside the kernel, over every lane of a wave, those
past the image's last pixel too; ``kernels.COUNTERS``) over the traced
path segments, summed over the window's frames.  None where the program
counts no shadow rays.  Layer: extensions; moves mrays_s."""

from pathbench.metrics.lane_yield import ratio

UNIT = "rays/segment"


def read(reading):
    return ratio(reading, "shadow_rays", "segments")
