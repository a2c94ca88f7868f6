"""device_ops_per_frame: device operations (kernels, copies, memsets) in
the traced window, per frame.  Layer: pipeline; moves mrays_s."""

UNIT = "ops/frame"


def read(reading):
    t = reading.trace
    if t is None or not t.frames or not t.ops:
        return None
    return len(t.ops) / t.frames
