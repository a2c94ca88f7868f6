"""A cell's reference, found by the name in its workload file: a reference
added as a new file is loaded, handed the cell (its traffic's extensions
included) and the scene file, and judges the run's frames; a cell whose
traffic names an extension that its reference does not compute is
refused before set-up; the cells that name none take ``plain``."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from pathbench import harness, spec

FIXTURE_REFERENCE = '''"""A reference that declares NEE, reads the scene file through the
shared reading and renders a black frame of one segment, recording what
it is handed."""

import numpy as np

from .scene import read_scene

EXTENSIONS = ("nee",)
CALLS = []


class Black:
    def __init__(self, scene, camera):
        self.shape = (camera.height, camera.width, 3)
        self.triangles = scene.num_triangles

    def render(self, seed, dtype=None):
        CALLS.append(("render", seed, dtype))
        return np.zeros(self.shape, np.uint8), 1

    def grid_size(self):
        return 0, 0


def prepare(workload, path, device):
    tr = workload.traffic
    CALLS.append(("prepare", workload.name, tr.extensions, path.name, str(device)))
    return Black(*read_scene(path, workload.config["camera"], tr.width, tr.height))
'''


@pytest.fixture
def copy_root(tmp_path, tiny_contest):
    """A copy of the benchmark's files and BENCHMARK.json, with the tiny
    configuration, a traffic naming ``nee``, and two cells of it: one that
    names the fixture reference, one that names none."""
    root = tmp_path / "pathbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    (root / "reference" / "fixture_nee.py").write_text(FIXTURE_REFERENCE)
    (root / "configs" / "tiny_contest.json").write_text(json.dumps(tiny_contest))
    (root / "traffic" / "tiny-nee.json").write_text(json.dumps(
        {"width": 32, "height": 18, "spp": 1, "bounces": 2, "wave": 4096,
         "backend": "auto", "grid_resolution": [8, 8, 8], "extensions": ["nee"]}))
    cell = {"config": "tiny_contest", "traffic": "tiny-nee", "kernels": ["trace_emit"],
            "trace_kernels": ["trace_emit"], "limits": {"image_mad": 0.5, "segments_gap": 1e-3}}
    (root / "workloads" / "tiny-nee-fixture.json").write_text(
        json.dumps(dict(cell, reference="fixture_nee")))
    (root / "workloads" / "tiny-nee-plain.json").write_text(json.dumps(cell))
    yield root
    assert all(p.read_bytes() == b for p, b in before.items()), "a file of the copy changed"


def test_a_reference_added_by_name_is_found_and_used(copy_root, monkeypatch):
    loaded = []
    real = spec.load_reference

    def load_reference(name, root=spec.ROOT):
        loaded.append(real(name, root))
        return loaded[-1]

    monkeypatch.setattr(spec, "load_reference", load_reference)
    wl = spec.load_workload("tiny-nee-fixture", copy_root)
    assert wl.reference == "fixture_nee" and wl.traffic.extensions == ("nee",)
    assert loaded[-1].EXTENSIONS == ("nee",)
    torch.set_num_threads(2)
    seed = 2**31 + 21
    result, _ = harness.run("tiny-nee-fixture", seed, 0.2, False, time.perf_counter(),
                            device="cpu", root=copy_root, checkout=copy_root.parent,
                            cache=copy_root.parent / "cache", log=lambda *a, **k: None)
    used = loaded[-1]
    assert used.__file__ == str(copy_root / "reference" / "fixture_nee.py")
    assert used.CALLS == [("prepare", "tiny-nee-fixture", ("nee",), "bench.gltf", "cpu"),
                          ("render", seed, None)]
    # the frames were judged against the fixture's black frame of one segment
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["image_mad"]["value"] > 0 and checks["segments_gap"]["value"] > 1


def test_an_extension_the_reference_lacks_is_refused(copy_root, monkeypatch):
    """Under ``plain`` a traffic naming ``nee`` is refused when the cell is
    loaded: by the harness before any set-up or frame, and by the
    command, which prints nothing."""
    from zig_raytracing_contest_tpu_torch.render import pipeline

    words = r"tiny-nee-plain.*\bnee\b.*reference plain"
    with pytest.raises(ValueError, match=words):
        spec.load_workload("tiny-nee-plain", copy_root)

    def no_frame(*args, **kwargs):
        raise AssertionError("the program ran")

    monkeypatch.setattr(pipeline, "prepare_scene", no_frame)
    monkeypatch.setattr(pipeline, "render_scene", no_frame)
    with pytest.raises(ValueError, match=words):
        harness.run("tiny-nee-plain", 1, 0.2, False, time.perf_counter(), device="cpu",
                    root=copy_root, checkout=copy_root.parent,
                    cache=copy_root.parent / "cache", log=lambda *a, **k: None)
    proc = subprocess.run([sys.executable, "-m", "pathbench.run", "--workload",
                           "tiny-nee-plain", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=copy_root.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "tiny-nee-plain" in proc.stderr and "reference plain" in proc.stderr


def test_a_missing_or_malformed_reference_is_named(copy_root):
    with pytest.raises(FileNotFoundError, match="no_such_reference"):
        spec.load_reference("no_such_reference", copy_root)
    (copy_root / "reference" / "no_prepare.py").write_text("EXTENSIONS = ()\n")
    with pytest.raises(TypeError, match="no_prepare"):
        spec.load_reference("no_prepare", copy_root)


@pytest.mark.parametrize("cell", ["sponza-720p", "sponza-720p-grid"])
def test_the_cells_take_the_plain_reference(cell):
    wl = spec.load_workload(cell)
    assert wl.reference == spec.PLAIN == "plain"
    assert "reference" not in json.loads((spec.ROOT / "workloads" / f"{cell}.json").read_text())
    module = spec.load_reference(wl.reference)
    assert module.EXTENSIONS == () and callable(module.prepare)
