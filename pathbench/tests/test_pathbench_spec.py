"""The benchmark's data files parse, agree with BENCHMARK.json and keep to
its contract; a configuration, a traffic mix, a cell and a metric added as
new files are found by name."""

import json
import re
import shutil

import pytest

from pathbench import spec
from pathbench.scenes import load_writer, scene_file

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pathbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "mrays_s"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.load_workload(cell)
    assert wl.config["name"] == entry["config"] and wl.traffic.name == entry["traffic"]
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"pathbench/configs/{cfg['name']}.json"
    assert cfg["reduced"] == wl.config["reduced"]
    assert set(wl.trace_kernels) <= set(wl.kernels)
    assert set(wl.limits) == {"image_mad", "segments_gap"}
    reported = spec.per_layer_metrics(cell, BENCH)
    assert reported, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    module = spec.load_metric(metric)
    assert module.UNIT == entry["unit"] and callable(module.read)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


WRITER = """from .procedural import bench_scene


def write(path, objects):
    return bench_scene(path, num_objects=objects, seed=7, two_sided=False)
"""


def test_files_added_by_name_are_found(tmp_path, tiny_contest):
    """A configuration with a writer of its own, a traffic mix, a cell and
    a metric, each a new file: found by name, no file there edited."""
    root = tmp_path / "pathbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "scenes" / "fixture_writer.py").write_text(WRITER)
    cfg = dict(tiny_contest, name="fixture_scene", writer="fixture_writer",
               writer_args={"objects": 4}, file="fixture.gltf")
    (root / "configs" / "fixture_scene.json").write_text(json.dumps(cfg))
    (root / "traffic" / "fixture-frame.json").write_text(json.dumps(
        {"width": 32, "height": 18, "spp": 1, "bounces": 2, "wave": 4096,
         "backend": "grid", "grid_resolution": [8, 8, 8], "extensions": []}))
    (root / "workloads" / "fixture-cell.json").write_text(json.dumps(
        {"config": "fixture_scene", "traffic": "fixture-frame", "kernels": ["grid_walk"],
         "trace_kernels": ["grid_walk"], "limits": {"image_mad": 1.0, "segments_gap": 0.01}}))
    (root / "metrics" / "fixture_metric.py").write_text(
        "UNIT = 'frames'\n\ndef read(reading):\n    return float(reading.frames)\n")
    wl = spec.load_workload("fixture-cell", root)
    assert wl.config["writer_args"] == {"objects": 4}
    assert wl.traffic.backend == "grid" and wl.traffic.triangle_test == "mt"
    path = scene_file(wl.config, tmp_path / "cache", root)
    assert path == tmp_path / "cache" / "fixture_scene" / "fixture.gltf" and path.is_file()
    assert len(json.loads(path.read_text())["meshes"]) == 2 + 4  # floor, panel, 4 quads
    assert spec.load_metric("fixture_metric", root).read(type("R", (), {"frames": 3})) == 3.0
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "fixture_metric", "unit": "frames", "better": "higher",
         "source": "program_counter", "layer": "pipeline", "moves": "mrays_s",
         "workloads": ["fixture-cell"]}])
    assert [m["name"] for m in spec.per_layer_metrics("fixture-cell", bench)] == ["fixture_metric"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_missing_files_are_named():
    with pytest.raises(FileNotFoundError, match="no-such-cell"):
        spec.load_workload("no-such-cell")
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        spec.load_metric("no_such_metric")
    with pytest.raises(FileNotFoundError, match="no_such_writer"):
        load_writer("no_such_writer")
