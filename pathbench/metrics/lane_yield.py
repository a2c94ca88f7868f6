"""lane_yield: the rays alive at each bounce's trace, summed over the
window's frames and bounces, over the lanes the waves issued (waves x wave
size x bounces): the share of the wave's lanes doing work.  From the
program's work counters (``kernels.COUNTERS``, summed over the window's
frames: the harness resets them after the capture frame).  None where the
window holds no device operation or the program counts no such thing.
Layer: wave; moves mrays_s."""

UNIT = "share"


def program_counters(reading) -> dict | None:
    """The program's work counters over the window's frames, or None where
    the traced window holds no device operation or the program keeps none."""
    t = reading.trace
    if t is None or not t.ops or not t.frames:
        return None
    try:
        from zig_raytracing_contest_tpu_torch import kernels
    except ImportError:
        return None
    counters = getattr(kernels, "COUNTERS", None)
    if not counters or not counters.get("frames"):
        return None
    return dict(counters)


def ratio(reading, num: str, den: str):
    """Counter ``num`` over counter ``den``, or None where either is
    missing or the denominator is 0."""
    c = program_counters(reading)
    if c is None or num not in c or not c.get(den):
        return None
    return c[num] / c[den]


def read(reading):
    return ratio(reading, "alive", "lanes")
