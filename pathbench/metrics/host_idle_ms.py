"""host_idle_ms: device-idle ms a frame that fall inside the program's
``zrc.*`` spans but outside ``zrc.render.replay``: the frame's plan, the
camera's scalars, the copy to the host and the Python around them, while
the card waits.  With launch_idle_ms it splits the idle time the program
can see; what lies outside every span is the caller's loop between
frames.  None where the window holds no device operation or no span.
Layer: pipeline; moves mrays_s."""

from pathbench.metrics.launch_idle_ms import REPLAY, SPAN, idle_ms_per_frame

UNIT = "ms/frame"


def read(reading):
    t = reading.trace
    inside = idle_ms_per_frame(t, lambda name: name.startswith(SPAN))
    if inside is None:
        return None
    return inside - (idle_ms_per_frame(t, lambda name: name == REPLAY) or 0.0)
