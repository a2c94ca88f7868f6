"""wave_glue_ms: device ms a frame of every operation that is not one of
the cell's kernels of ``kernels/path_trace.cu``: the PyTorch sorts,
gathers, scatters, elementwise ops, copies and memsets.  Layer: wave;
moves mrays_s."""

from pathbench.devtrace import kernel_base

UNIT = "ms/frame"


def read(reading):
    t = reading.trace
    if t is None or not t.frames or not t.ops:
        return None
    own = {f"{k}_kernel" for k in reading.workload.kernels}
    glue = sum(e - s for s, e, n in t.ops if kernel_base(n) not in own)
    return glue * 1e-3 / t.frames
