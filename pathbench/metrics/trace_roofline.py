"""trace_roofline: the share of its bound that the cell's trace kernels
reach: bound ms a frame / device ms a frame of the kernels that the cell's
workload file names under ``trace_kernels``.  Layer: kernels; moves
mrays_s.

The bound is max(operations / PEAK_FLOPS, bytes / PEAK_BYTES) of the work
a frame needs, counted here from the inputs alone, never from a counter
of the program, so the same work reads the same bound whatever does it:

* every traced segment (the reference's count) needs one ray set-up and
  one triangle test, and its shading where the named kernels fuse it;
* every trace pass (a wave's bounce: ceil(rays / wave) x bounces) reads
  each triangle once, and on the grid backend each cell's range and each
  reference (its id and its triangle) once;
* every segment reads its ray once and writes its hit once.

The counts are floors of the real work (one test a segment), so a share
above 100% means the count or the timing is wrong."""

PEAK_FLOPS = 67e12  # H100 SXM5 f32, non-tensor
PEAK_BYTES = 3.35e12  # H100 SXM5 HBM3
TEST_FLOPS = 42  # a triangle test
RAY_SETUP_FLOPS = 50  # a ray's set-up
SHADE_FLOPS = 150  # interpolation, two bilinear textures, alpha, scatter
FUSED_SHADE = ("path_trace_gen", "path_trace")  # kernels that shade too
TRIANGLE_BYTES = 36  # three vertices
CELL_BYTES = 8  # a grid cell's range
REF_BYTES = 4 + TRIANGLE_BYTES  # a reference's id and its triangle
RAY_BYTES = 24 + 16  # origin and direction in, t, u, v and id out

UNIT = "%"


def frame_work(reading, kernels) -> tuple:
    """(operations, bytes) of one frame's work through ``kernels``."""
    tr = reading.workload.traffic
    segs = reading.segments
    flops = segs * (TEST_FLOPS + RAY_SETUP_FLOPS)
    if any(k in FUSED_SHADE for k in kernels):
        flops += segs * SHADE_FLOPS
    rays = reading.rays
    passes = -(-rays // tr.wave) * tr.bounces
    if tr.backend == "grid":
        scene_bytes = reading.grid_cells * CELL_BYTES + reading.grid_refs * REF_BYTES
    else:
        scene_bytes = reading.triangles * TRIANGLE_BYTES
    return flops, passes * scene_bytes + segs * RAY_BYTES


def bound_ms(reading, kernels) -> float:
    flops, nbytes = frame_work(reading, kernels)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def read(reading):
    kernels = reading.workload.trace_kernels
    ms = reading.device_ms_per_frame(kernels)
    if not ms or not reading.segments:
        return None
    return 100.0 * bound_ms(reading, kernels) / ms
