"""A whole run of the harness, at a tiny frame on the CPU (the port's
plain twins): its last line, and ``correct`` coming out false when the
timed path is broken underneath.  The look for a card is the command's
and is left out here; the command itself, without a card, exits 2 and
prints nothing, and without the program it fails and prints nothing."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from pathbench import harness, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory, tiny_contest):
    """The benchmark's files plus a tiny cell of the port's small
    procedural scene (64x36, 2 spp, 3 bounces, one wave, the whole-path
    tile kernels), whose BENCHMARK.json lists the per-layer metrics for
    it."""
    base = tmp_path_factory.mktemp("bench")
    root = base / "pathbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (root / "configs" / "tiny_contest.json").write_text(json.dumps(tiny_contest))
    (root / "traffic" / "tiny-frame.json").write_text(json.dumps(
        {"width": 64, "height": 36, "spp": 2, "bounces": 3, "wave": 4096,
         "backend": "auto", "grid_resolution": [8, 8, 8], "extensions": []}))
    (root / "workloads" / "tiny-cell.json").write_text(json.dumps(
        {"config": "tiny_contest", "traffic": "tiny-frame",
         "kernels": ["path_trace_gen", "path_trace", "ray_sort_key"],
         "trace_kernels": ["path_trace_gen", "path_trace"],
         "limits": {"image_mad": 5.0, "segments_gap": 0.001}}))
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        m["workloads"].append("tiny-cell")
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def run(base, trace=False, seed=2**31 + 5):
    torch.set_num_threads(2)
    return harness.run("tiny-cell", seed, 0.3, trace, time.perf_counter(), device="cpu",
                       root=base / "pathbench", checkout=base, cache=base / "cache",
                       log=lambda *a, **k: None)


def test_the_last_line(fixture_root):
    result, lines = run(fixture_root)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result["metrics"]) == ["mrays_s", "frame_ms_p95", "setup_s"]
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == {"image_mad", "segments_gap"}
    assert [line.split(":")[0] for line in lines] == ["check image_mad", "check segments_gap"]
    json.dumps(result)


def test_the_traced_line(fixture_root):
    result, _ = run(fixture_root, trace=True)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert result["correct"] is True
    # no device ops on the CPU: the trace's readers find nothing, bake_s stays
    assert list(result["metrics"]) == ["bake_s"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def _zero_wave(real):
    def wave(*args, **kw):
        rows3, segs = real(*args, **kw)
        return torch.zeros_like(rows3), torch.zeros_like(segs)
    return wave


def _half_batch(real):
    def wave(scene, par, width, height, spp, *args, **kw):
        rows3, segs = real(scene, par, width, height, spp, *args, **kw)
        kept = rows3.reshape(3, -1, spp)[:, :, : spp // 2]
        mean = kept.mean(dim=2, keepdim=True).expand(-1, -1, spp)
        return mean.reshape(3, -1).contiguous(), segs // 2
    return wave


def _altered(real):
    def wave(*args, **kw):
        rows3, segs = real(*args, **kw)
        return rows3 * 1.25, segs
    return wave


@pytest.mark.parametrize("fault", [_zero_wave, _half_batch, _altered],
                         ids=["state-unchanged", "half-batch", "answer-altered"])
def test_a_broken_timed_path_is_not_correct(fixture_root, monkeypatch, fault):
    from zig_raytracing_contest_tpu_torch.render import pipeline

    monkeypatch.setattr(pipeline, "render_wave_rows", fault(pipeline.render_wave_rows))
    result, lines = run(fixture_root)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(fixture_root, card):
    """On the card the window replays the frame's graph, launches exactly
    the cell's kernels and reads every per-layer metric."""
    for trace in (False, True):
        result, _ = harness.run("tiny-cell", 7, 0.5, trace, time.perf_counter(), device=card,
                                root=fixture_root / "pathbench", checkout=fixture_root,
                                cache=fixture_root / "cache", log=lambda *a, **k: None)
        assert result["correct"] is True, result["checks"]
        assert result["checks"]["kernels_unexpected"]["value"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.benchmark()["per_layer"]}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_without_a_card_the_command_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "pathbench.run", "--workload",
                           "sponza-720p", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=spec.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


def test_without_the_program_a_run_prints_nothing(tmp_path):
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "pathbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    code = ("import time, sys\n"
            "sys.path = [p for p in sys.path if 'repo' not in p]\n"
            "from pathbench import harness\n"
            "res, lines = harness.run('sponza-720p', 1, 1.0, False, time.perf_counter(),"
            " device='cpu')\n"
            "harness.emit(res, lines)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "zig_raytracing_contest_tpu_torch" in proc.stderr
