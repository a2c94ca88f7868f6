"""idle_share: 1 - (the union of the device's operations) / the traced
window's wall, from the first frame's start to the last frame's end.
Layer: device; moves mrays_s."""

from pathbench.devtrace import busy_s

UNIT = "share"


def read(reading):
    t = reading.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 1.0 - busy_s(t) / t.window_s
