"""The readers of the program's spans and work counters, on a synthetic
traced window with ``zrc.*`` host spans and a stand-in for the program's
``kernels.COUNTERS``."""

import pytest

from pathbench import devtrace, spec
from pathbench.reading import Reading

OPS = [  # (start us, end us, name): two frames over a 10 ms window
    (0.0, 3000.0, "trace_stream_kernel(ZrcScene, ZrcRays, float*)"),
    (3000.0, 4000.0, "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"),
    (4500.0, 5000.0, "Memcpy DtoH (Device -> Pinned)"),
    (5000.0, 8000.0, "trace_stream_kernel(ZrcScene, ZrcRays, float*)"),
]  # idle: [4000, 4500] and [8000, 10000]
HOST = [
    (3900.0, 9500.0, "zrc.render"),
    (3950.0, 4300.0, "zrc.render.replay"),  # 300 us of the first gap
    (4100.0, 4400.0, "cudaGraphLaunch"),
    (7900.0, 9200.0, "zrc.render.to_host"),
    (7900.0, 9000.0, "cudaStreamSynchronize"),
]
COUNTERS = {"frames": 2, "segments": 100, "lanes": 300, "alive": 100, "tiles": 250,
            "boxes": 700, "walk_iterations": 1234}
SPAN_METRICS = ("launch_idle_ms", "host_idle_ms")
COUNTER_METRICS = ("lane_yield", "stream_tiles_per_segment", "stream_boxes_per_segment",
                   "walk_iterations_per_segment")


def reading(trace=True, host=HOST, ops=OPS):
    t = devtrace.DeviceTrace(list(ops), list(host), 0.0, 10000.0, 2) if trace else None
    return Reading(spec.load_workload("sponza-720p"), frames=2, phases={}, trace=t,
                   rays=1843200, segments=3064222, triangles=261966, grid_cells=0,
                   grid_refs=0)


def value(metric, r):
    return spec.load_metric(metric).read(r)


@pytest.fixture
def counters(monkeypatch):
    from zig_raytracing_contest_tpu_torch import kernels

    monkeypatch.setattr(kernels, "COUNTERS", dict(COUNTERS))
    return kernels


def test_span_readers_split_the_idle_time():
    r = reading()
    launch, host = value("launch_idle_ms", r), value("host_idle_ms", r)
    assert launch == pytest.approx(0.15)  # 300 us over 2 frames
    # zrc.render covers 500 + 1500 us of idle, of which the replay 300
    assert host == pytest.approx(0.85)
    outside = 0.25  # [9500, 10000]: outside every span
    assert launch + host + outside == pytest.approx(value("idle_share", r) * 10.0 / 2)


def test_span_readers_count_overlap_not_midpoints():
    # the replay covers the gap's first 50 us only: its middle lies outside
    r = reading(host=[(3900.0, 9500.0, "zrc.render"), (3900.0, 4050.0, "zrc.render.replay")])
    assert value("launch_idle_ms", r) == pytest.approx(0.025)
    assert value("host_idle_ms", r) == pytest.approx(1.0 - 0.025)


def test_span_readers_read_nothing_without_spans_or_device_ops():
    for metric in SPAN_METRICS:
        assert value(metric, reading(trace=False)) is None
        assert value(metric, reading(ops=[])) is None
        assert value(metric, reading(host=[h for h in HOST if not h[2].startswith("zrc.")])) \
            is None
    assert value("launch_idle_ms", reading(host=[HOST[0]])) is None
    assert value("host_idle_ms", reading(host=[HOST[0]])) == pytest.approx(1.0)


def test_counter_readers_divide_the_programs_counters(counters):
    r = reading()
    assert value("lane_yield", r) == pytest.approx(1 / 3)
    assert value("stream_tiles_per_segment", r) == pytest.approx(2.5)
    assert value("stream_boxes_per_segment", r) == pytest.approx(7.0)
    assert value("walk_iterations_per_segment", r) == pytest.approx(12.34)


def test_counter_readers_read_nothing_where_nothing_was_counted(counters, monkeypatch):
    for metric in COUNTER_METRICS:
        assert value(metric, reading(trace=False)) is None
        assert value(metric, reading(ops=[])) is None
    counters.COUNTERS = {"frames": 2, "segments": 100}  # a whole-path window
    assert all(value(m, reading()) is None for m in COUNTER_METRICS)
    counters.COUNTERS = {"frames": 0}
    assert all(value(m, reading()) is None for m in COUNTER_METRICS)
    monkeypatch.delattr(counters, "COUNTERS")  # a program that keeps no counters
    assert all(value(m, reading()) is None for m in COUNTER_METRICS)


@pytest.mark.parametrize("metric", SPAN_METRICS + COUNTER_METRICS)
def test_each_reader_is_listed_for_the_cells_it_reads(metric):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == metric)
    assert entry["source"] == ("program_span" if metric in SPAN_METRICS else "program_counter")
    assert spec.load_metric(metric).UNIT == entry["unit"]
