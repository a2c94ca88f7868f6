"""The frozen scene writers write the bytes the port's writers write on
this tree, and the scene cache writes a configuration's file once."""

import json

from pathbench import spec
from pathbench.scenes import load_writer, scene_file


def test_procedural_scene_equals_the_ports(tmp_path, tiny_contest):
    from zig_raytracing_contest_tpu_torch.scene.procedural import bench_scene

    cfg = dict(tiny_contest, writer_args={"num_objects": 200, "seed": 42, "two_sided": True})
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    load_writer(cfg["writer"])(tmp_path / "a" / cfg["file"], **cfg["writer_args"])
    bench_scene(tmp_path / "b" / cfg["file"], **cfg["writer_args"])
    files = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert files == ["bench.bin", "bench.gltf"]
    for name in files:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


def test_sponza_equals_the_ports(tmp_path):
    from zig_raytracing_contest_tpu_torch.scene.sponza import write_sponza_glb

    cfg = spec.load_config("sponza_interior")
    load_writer(cfg["writer"])(tmp_path / "a.glb", **cfg["writer_args"])
    write_sponza_glb(tmp_path / "b.glb", **cfg["writer_args"])
    assert (tmp_path / "a.glb").read_bytes() == (tmp_path / "b.glb").read_bytes()


def test_scene_cache_writes_once(tmp_path, tiny_contest):
    cfg = tiny_contest
    path = scene_file(cfg, tmp_path)
    assert path == tmp_path / "tiny_contest" / "bench.gltf" and path.is_file()
    stamp = path.stat().st_mtime_ns
    assert scene_file(cfg, tmp_path) == path and path.stat().st_mtime_ns == stamp
    other = dict(cfg, writer_args=dict(cfg["writer_args"], num_objects=3))
    assert scene_file(other, tmp_path) == path and path.stat().st_mtime_ns != stamp
    marker = json.loads((path.parent / "writer.json").read_text())
    assert marker["args"]["num_objects"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tiny_contest"]
