"""Each per-layer metric's arithmetic on a synthetic traced window, the
trace reader, and the roofline count at the cells' shapes."""

import json
import math

import pytest

from pathbench import devtrace, spec
from pathbench.reading import Reading

OPS = [  # (start us, end us, name): two frames over a 10 ms window
    (0.0, 3000.0, "trace_stream_kernel(ZrcScene, ZrcRays, float*)"),
    (3000.0, 4000.0, "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"),
    (4500.0, 5000.0, "Memcpy DtoH (Device -> Pinned)"),
    (5000.0, 8000.0, "trace_stream_kernel(ZrcScene, ZrcRays, float*)"),
]
HOST = [(4100.0, 4400.0, "aten::sort"), (7900.0, 9000.0, "cudaStreamSynchronize")]


def reading(cell="sponza-720p", trace=True, **kw):
    t = devtrace.DeviceTrace(list(OPS), list(HOST), 0.0, 10000.0, 2) if trace else None
    base = dict(frames=2, phases={"load": 1.0, "preprocess": 0.5, "compile": 2.0},
                trace=t, rays=1843200, segments=3064222, triangles=261966,
                grid_cells=0, grid_refs=0)
    base.update(kw)
    return Reading(spec.load_workload(cell), **base)


def value(metric, r):
    return spec.load_metric(metric).read(r)


def test_window_arithmetic():
    r = reading()
    assert value("device_ops_per_frame", r) == 2.0
    assert value("wave_glue_ms", r) == pytest.approx(0.75)
    assert value("idle_share", r) == pytest.approx(0.25)
    assert value("bake_s", r) == pytest.approx(3.5)
    assert devtrace.busy_s(r.trace) == pytest.approx(7.5e-3)
    assert r.device_ms_per_frame(["trace_stream"]) == pytest.approx(3.0)


def test_rooflines_divide_the_frozen_count():
    from pathbench.metrics import trace_roofline as tr

    r = reading()
    flops, nbytes = tr.frame_work(r, ("trace_stream",))
    assert flops == 3064222 * (42 + 50)
    assert nbytes == 3 * 261966 * 36 + 3064222 * 40  # one wave of 2^21, 3 bounces
    bound = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    assert value("trace_roofline", r) == pytest.approx(100 * bound / 3.0)
    fused, fused_bytes = tr.frame_work(r, tr.FUSED_SHADE)  # the whole frame: shading too
    assert fused == 3064222 * (42 + 50 + 150) and fused_bytes == nbytes
    frame_bound = max(fused / 67e12, nbytes / 3.35e12) * 1e3
    assert value("frame_mfu", r) == pytest.approx(100 * frame_bound / 5.0)


def test_untraced_or_empty_windows_read_nothing():
    r = reading(trace=False)
    for metric in ("device_ops_per_frame", "wave_glue_ms", "idle_share", "trace_roofline",
                   "frame_mfu"):
        assert value(metric, r) is None
    empty = reading()
    empty.trace.ops = []
    assert value("trace_roofline", empty) is None and value("idle_share", empty) is None
    assert value("bake_s", reading(phases={})) is None


def test_breakdown_names_ops_and_the_host_in_each_gap():
    b = devtrace.breakdown(reading().trace)
    assert b["device_ops"][0] == ["trace_stream_kernel", pytest.approx(6e-3)]
    assert [g[0] for g in b["idle_gaps"]] == ["cudaStreamSynchronize", "aten::sort"]
    assert sum(g[1] for g in b["idle_gaps"]) == pytest.approx(2.5e-3)


def test_read_trace_keeps_the_frames_window(tmp_path):
    events = [{"ph": "X", "cat": "user_annotation", "name": devtrace.FRAME_LABEL,
               "ts": 100, "dur": 50},
              {"ph": "X", "cat": "user_annotation", "name": devtrace.FRAME_LABEL,
               "ts": 160, "dur": 40},
              {"ph": "X", "cat": "kernel", "name": "grid_walk_kernel(GridOps)", "ts": 110,
               "dur": 30},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 190, "dur": 5},
              {"ph": "X", "cat": "kernel", "name": "warmup_kernel", "ts": 10, "dur": 5},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 105,
               "dur": 3},
              {"ph": "i", "name": "marker", "ts": 120}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = devtrace.read_trace(path)
    assert (t.start, t.end, t.frames) == (100.0, 200.0, 2)
    assert [op[2] for op in t.ops] == ["grid_walk_kernel(GridOps)", "Memcpy DtoH"]
    assert t.host == [(105.0, 108.0, "cudaGraphLaunch")]
    assert devtrace.kernel_base(t.ops[0][2]) == "grid_walk_kernel"


# Device ms a frame of each cell's trace kernels on the H100 (PERF.md §5):
# trace_stream_kernel, and grid_walk_kernel's three bounces, over the cells'
# 261,966 triangles and 1,843,200-ray wave.
CELL_SHAPES = {
    "sponza-720p": dict(ms=19.15, rays=1843200, segments=3062114, triangles=261966),
    "sponza-720p-grid": dict(ms=2.705, rays=1843200, segments=3066693, triangles=261966),
}


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_roofline_stays_under_its_bound_at_the_cells_shapes(cell):
    from pathbench.metrics import trace_roofline as tr

    shape = CELL_SHAPES[cell]
    wl = spec.load_workload(cell)
    cells = math.prod(wl.traffic.grid_resolution) if wl.traffic.backend == "grid" else 0
    r = reading(cell, rays=shape["rays"], segments=shape["segments"],
                triangles=shape["triangles"], grid_cells=cells,
                grid_refs=4_000_000 if cells else 0)
    share = 100 * tr.bound_ms(r, wl.trace_kernels) / shape["ms"]
    assert 0 < share < 100
