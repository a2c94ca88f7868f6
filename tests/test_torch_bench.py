"""The port's bench (zig_raytracing_contest_tpu_torch/bench.py) on the CPU.

Every row of ``bench.ROWS`` runs at a small frame (64×36, 2 reps, 2
bounces) with the plain twins, its scene cut to a few thousand triangles and
the bake thresholds lowered so that it keeps the regime of the full row: its
JSON line, and its segments against one ``render_scene`` (or ``render_cpu``)
of the same scene and config.  The rows' settings are held to the JAX
harness's sources (``bench.py``, ``scripts/large_sweep.py``), and the port's
Sponza writer (scene/sponza.py) to ``scripts/sponza_builder.py``.
Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bench.py``.
"""

import ast
import contextlib
import dataclasses
import inspect
import io
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jax_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jax_gltf
from zig_raytracing_contest_tpu_torch import bench
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect
from zig_raytracing_contest_tpu_torch.render import wavefront
from zig_raytracing_contest_tpu_torch.render.native_cpu import render_cpu
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu_torch.scene import procedural, types
from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb
from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
from zig_raytracing_contest_tpu_torch.scene.sponza import write_sponza_glb

ROOT = Path(__file__).resolve().parent.parent
W, H, REPS, BOUNCES = 64, 36, 2, 2
LARGE = (1280, 720, 2, 3, 1 << 21)

# The rows as the bench is specified: metric, writer, scene arguments,
# (width, height, spp, bounces, wave), backend, extensions, the kernels
# the card launches (ray_sort_key_kernel wherever the frame beam-sorts on the
# host key: the whole path's mid resort, every sorted per-bounce wave); a
# width of None comes from the camera's aspect ratio.
TABLE = {
    "official": ("Mrays/s", procedural.bench_scene, {}, (1920, 1080, 3, 4, 1 << 19),
                 "auto", (), ("path_trace_gen", "path_trace", "ray_sort_key")),
    "large": ("large_Mrays/s", procedural.large_scene, {"side": 224}, LARGE, "auto", (),
              ("trace_emit", "shade", "ray_sort_key")),
    "cpu": ("cpu_Mrays/s", procedural.bench_scene, {}, (1920, 1080, 3, 4, None), "grid", (),
            ()),
    "500k": ("500k_Mrays/s", procedural.large_scene, {"side": 500}, LARGE, "auto", (),
             ("trace_stream", "shade", "ray_sort_key")),
    "2m": ("2m_Mrays/s", procedural.large_scene, {"side": 1000}, (640, 360, 1, 2, 1 << 21),
           "auto", (), ("trace_stream", "shade", "ray_sort_key")),
    "sponza": ("sponza_Mrays/s", write_sponza_glb, {"detail": 1.25},
               (None, 720, 2, 3, 1 << 21), "auto", (),
               ("trace_stream", "shade", "ray_sort_key")),
    "duck": ("duck_Mrays/s", write_duck_glb, {}, (None, 1080, 3, 4, 1 << 19), "auto", (),
             ("path_trace_gen", "path_trace", "ray_sort_key")),
    "2mtexel": ("2mtexel_Mrays/s", bench.texture_terrain, {}, LARGE, "auto", (),
                ("trace_emit", "shade", "ray_sort_key")),
    "grid_large": ("grid_large_Mrays/s", procedural.large_scene, {"side": 224}, LARGE, "grid",
                   (), ("grid_walk",)),
    "large_ext": ("large_ext_Mrays/s", procedural.large_scene, {"side": 224}, LARGE, "auto",
                  ("nee", "russian_roulette", "pbr"), ("trace_emit",)),
}

# the small scenes, and the thresholds lowered so that each keeps its row's
# regime: per-bounce and sorted past 512 padded triangles, streaming past
# 2048 with the tile doubled (at most 8 tiles of 256), no resident bank
PER_BOUNCE = ((mxu_intersect, "REC_EMIT_MAX_TRIS", 512), (wavefront, "SORT_MIN_TRIS", 512))
STREAMING = PER_BOUNCE + ((mxu_intersect, "VMEM_RESIDENT_MAX_TRIS", 2048),
                          (types, "VMEM_RESIDENT_MAX_TRIS", 2048),
                          (types, "STREAM_MAX_TILES", 8))
SMALL = {
    "official": ({}, ()),
    "large": ({"side": 24}, PER_BOUNCE),
    "cpu": ({}, ()),
    "500k": ({"side": 40}, STREAMING),
    "2m": ({"side": 48}, STREAMING),
    "sponza": ({"detail": 0.25, "tex": 48}, STREAMING),
    "duck": ({"detail": 0.5, "tex_size": 64}, ()),
    "2mtexel": ({"side": 24, "tex_width": 64, "tex_height": 32},
                PER_BOUNCE + ((types, "ONEHOT_MAX_TEXELS", 0), (types, "PAGED_MAX_TEXELS", 0))),
    "grid_large": ({"side": 24}, ()),
    "large_ext": ({"side": 24}, ()),
}
REGIME = {
    "official": "whole path on cpu (resident bank)",
    "large": "per-bounce, sorted on cpu (resident bank)",
    "cpu": "host C++ tracer, grid (128, 128, 128)",
    "500k": "streaming, sorted on cpu (resident bank)",
    "2m": "streaming, sorted on cpu (resident bank)",
    "sponza": "streaming, sorted on cpu (resident bank)",
    "duck": "whole path on cpu (resident bank)",
    "2mtexel": "per-bounce, sorted on cpu (3-stage bank)",
    "grid_large": "XLA shading, grid on cpu (XLA sampler); walk: grid",
    "large_ext": "XLA shading, tile heap on cpu (XLA sampler)",
}
KEYS = {"metric", "value", "unit", "best", "spread_pct", "reps", "segments", "triangles",
        "width", "height", "spp", "bounces", "wave", "regime", "launches", "device_busy_ms",
        "idle_share", "profiled_wall_ms", "top_ops", "load_s", "bake_s", "device", "card",
        "overridden", "graph"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test, beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rows_are_the_table():
    assert [row.name for row in bench.ROWS] == list(TABLE)
    for row in bench.ROWS:
        metric, writer, kw, frame, backend, ext, kern = TABLE[row.name]
        assert (row.metric, row.writer, dict(row.scene_kw)) == (metric, writer, kw), row.name
        assert (row.width, row.height, row.spp, row.bounces, row.wave) == frame, row.name
        assert (row.backend, row.extensions, row.kernels) == (backend, ext, kern), row.name
        assert row.host == (row.name == "cpu")
        cfg = bench.config_of(row)
        assert (cfg.grid_resolution, cfg.seed) == ((128, 128, 128), Config().seed)


def _settings(path: Path, func: str, names=None) -> dict:
    """The frame and the Config keywords that ``func`` of the file at
    ``path`` sets: ``width, height = ...`` / ``w, h = ...`` and the Config
    assigned to ``config`` / ``cfg``, each evaluated with ``names``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)

    def value(node):
        return eval(compile(ast.Expression(node), str(path), "eval"), dict(names or {}))

    out = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Tuple) and [e.id for e in target.elts] in (
                ["width", "height"], ["w", "h"]):
            out["frame"] = value(node.value)
        elif isinstance(target, ast.Name) and target.id in ("config", "cfg"):
            out.update((kw.arg, value(kw.value)) for kw in node.value.keywords)
    return out


@pytest.mark.parametrize("name", ["official", "large"])
def test_row_settings_equal_bench_py(name):
    """official: bench.py main(); large: run_large(); the scenes' defaults."""
    got = _settings(ROOT / "bench.py", "main" if name == "official" else "run_large")
    row = bench.ROW[name]
    assert got == {"frame": (row.width, row.height), "grid_resolution": bench.GRID,
                   "num_samples": row.spp, "max_bounce": row.bounces,
                   "wave_size": row.wave}
    jax_writer = jax_bench.build_bench_scene if name == "official" else \
        jax_bench.build_large_scene
    want = {k: p.default for k, p in inspect.signature(jax_writer).parameters.items()
            if k != "path"}
    have = inspect.signature(row.writer).parameters
    assert {k: have[k].default for k in want} == {**want, **dict(row.scene_kw)}


@pytest.mark.parametrize("name", ["500k", "2m", "sponza"])
def test_row_settings_equal_large_sweep(name):
    """scripts/large_sweep.py main() at the row's --side (or --sponza): the
    frame, samples and bounces (the wave: --large's 2^21, not the script's
    default 2^18); the Sponza writer's detail."""
    path = ROOT / "scripts" / "large_sweep.py"
    row = bench.ROW[name]
    side = dict(row.scene_kw).get("side", 224)
    got = _settings(path, "main", {"huge": side > 500, "wave": row.wave})
    frame = (row.width or got["frame"][0], row.height)
    assert got == {"frame": frame, "grid_resolution": bench.GRID, "num_samples": row.spp,
                   "max_bounce": row.bounces, "wave_size": row.wave}
    if name == "sponza":
        call = next(n for n in ast.walk(ast.parse(path.read_text()))
                    if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "write_sponza_glb")
        assert {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords} == \
            dict(row.scene_kw)


def _small(name: str, monkeypatch) -> bench.Row:
    kw, thresholds = SMALL[name]
    for module, attr, value in thresholds:
        monkeypatch.setattr(module, attr, value)
    row = bench.ROW[name]
    return dataclasses.replace(row, scene_kw=tuple({**dict(row.scene_kw), **kw}.items()),
                               bounces=BOUNCES)


@pytest.mark.parametrize("name", list(TABLE))
def test_row_at_a_small_frame(name, monkeypatch, tmp_path):
    """The row's JSON line on the CPU twins: its keys, the device, the
    regime of the full row, the median of the reps, and segments equal to
    one frame of the same scene and config rendered apart from the bench."""
    row = _small(name, monkeypatch)
    line = bench.measure(row, "cpu", reps=REPS, width=W, height=H)
    assert KEYS <= set(line)
    assert (line["device"], line["card"], line["row"]) == ("cpu", None, name)
    assert line["regime"].startswith(REGIME[name]), line["regime"]
    assert (line["width"], line["height"], line["spp"], line["bounces"]) == (
        W, H, row.spp, BOUNCES)
    assert len(line["reps"]) == REPS and line["value"] == round(
        statistics.median(line["reps"]), 3)
    assert line["best"] == round(max(line["reps"]), 3)
    assert "reps" in line["overridden"] and "height" in line["overridden"]
    assert line["launches"] == {} and line["device_busy_ms"] is None
    assert line["idle_share"] is None and line["top_ops"] is None
    assert line["graph"] is False  # CUDA graphs are the card's

    path = row.writer(tmp_path / row.file, **dict(row.scene_kw))
    cfg = Config(num_samples=row.spp, max_bounce=BOUNCES, backend=row.backend,
                 **{e: True for e in row.extensions})
    if row.wave:
        cfg.wave_size = row.wave
    scene, cam, _ = prepare_scene(str(path), cfg, width=W if row.width else None, height=H,
                                  device="cpu")
    assert line["triangles"] == scene.shade_table.shape[0]
    if row.host:
        _, segments, _ = render_cpu(scene, cam, spp=row.spp, max_bounce=BOUNCES)
    else:
        segments = render_scene(scene, cam, cfg)[1].segments
    assert line["segments"] == segments > 0


def test_streaming_rows_double_the_tile(monkeypatch, tmp_path):
    """The small 2m row bakes tiles of 1024 (doubled twice past 8 tiles of
    256, as the full rows would past 8192 tiles) and streams."""
    row = _small("2m", monkeypatch)
    path, _ = bench.write_scene(row, tmp_path)
    p = bench.prepare(row, "cpu", path, width=W, height=H)
    assert p.scene.tile == 1024 and p.scene.tile_bbox.shape[1] == 5
    assert mxu_intersect.streams_bank(p.scene)


def test_main_prints_one_json_line_per_row(capsys):
    """``--row`` repeated: one line per row in the given order, on stdout
    only; ``value`` is the median of the printed reps."""
    assert bench.main(["--device", "cpu", "--row", "duck", "--row", "official", "--width",
                       str(W), "--height", str(H), "--reps", "3"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["metric"] for line in lines] == ["duck_Mrays/s", "Mrays/s"]
    for line in lines:
        assert KEYS <= set(line) and line["device"] == "cpu"
        assert line["value"] == round(statistics.median(line["reps"]), 3)
        assert line["overridden"] == (["height"] if line["row"] == "duck"
                                      else ["width", "height"]) + ["reps"]


def test_main_without_a_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code != 0
    err = capsys.readouterr()
    assert err.out == "" and "torch.cuda.is_available() is False" in err.err


def test_main_rejects_an_unknown_row(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--row", "nope"])
    assert exc.value.code != 0 and capsys.readouterr().out == ""


def test_stats_is_bench_py_stats():
    for rates in ([3.0], [1.0, 2.0], [5.0, 1.25, 3.5], [2.2, 9.9, 4.4, 1.1, 7.7]):
        assert bench.stats(rates) == jax_bench._stats(rates)


@pytest.mark.parametrize("kw", [dict(detail=0.25, tex=48), dict(detail=1.25)],
                         ids=["small", "full"])
def test_sponza_writer_matches_sponza_builder(kw, tmp_path):
    """The port's Sponza GLB against scripts/sponza_builder.py's: decoded
    texels of all 22 images, positions, normals, texcoords, material ids,
    index arrays, materials and nodes equal (the PNG bytes come from
    another encoder); 160,968 triangles at detail 1.25."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from sponza_builder import write_sponza_glb as write_orig

    with contextlib.redirect_stdout(io.StringIO()):
        a = jax_gltf(str(write_orig(tmp_path / "a.glb", **kw)))
    b = load_gltf(str(write_sponza_glb(tmp_path / "b.glb", **kw)))
    assert len(a.images) == len(b.images) == 22
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x.pixels, y.pixels)
    ga, gb = jax_geometry(a), load_geometry(b)
    for f in ("positions", "normals", "texcoords", "material_idx"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    assert len(a.doc["meshes"]) == len(b.doc["meshes"])
    for ma, mb in zip(a.doc["meshes"], b.doc["meshes"]):
        prim_a, prim_b = ma["primitives"][0], mb["primitives"][0]
        np.testing.assert_array_equal(a.accessor_array(prim_a["indices"]),
                                      b.accessor_array(prim_b["indices"]))
    assert a.doc["materials"] == b.doc["materials"] and a.doc["nodes"] == b.doc["nodes"]
    assert len(b.doc["materials"]) == 25
    if kw["detail"] == 1.25:
        assert gb.num_triangles == 160_968
