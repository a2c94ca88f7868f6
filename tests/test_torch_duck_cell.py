"""The benchmark's ``duck-1080p`` cell on the CPU: its configuration's
frozen writer against the port's, the whole path its frame takes, the flat
tile loop's sweep counters of the whole-path twins against the NumPy
replay of the kernels' loop (``walk_check.flat_occupancy``), the
``flat_sweep_yield`` reader, and the cell's limits between the port's
twins, the plain reference and its bfloat16 control at a tiny frame."""

import json
import struct

import pytest
import torch

from pathbench import devtrace, spec
from pathbench.reading import Reading
from pathbench.scenes import load_writer, scene_file
from pathbench.tests.test_pathbench_reference import (
    test_the_twins_pass_and_the_control_fails as twins_pass_and_control_fails,
)
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.ops import mxu_intersect
from zig_raytracing_contest_tpu_torch.probes import walk_check
from zig_raytracing_contest_tpu_torch.render import fused, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene.duck import write_duck_glb

CELL = "duck-1080p"
SEED = 2**31 + 2701


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def duck_path(tmp_path_factory):
    return scene_file(spec.load_config("duck_room"), tmp_path_factory.mktemp("cache"))


def _glb_json(path) -> dict:
    data = path.read_bytes()
    (length,) = struct.unpack_from("<I", data, 12)
    return json.loads(data[20:20 + length])


def test_the_frozen_writer_writes_the_ports_duck(tmp_path, duck_path):
    """At the configuration's arguments the frozen writer writes the port's
    bytes, and the duck's own triangles (the meshes under its node) are the
    configuration's count, within 14 of the published 4,212."""
    cfg = spec.load_config("duck_room")
    load_writer(cfg["writer"])(tmp_path / "a.glb", **cfg["writer_args"])
    write_duck_glb(tmp_path / "b.glb", **cfg["writer_args"])
    assert (tmp_path / "a.glb").read_bytes() == (tmp_path / "b.glb").read_bytes()
    assert duck_path.read_bytes() == (tmp_path / "a.glb").read_bytes()
    doc = _glb_json(duck_path)
    (duck,) = [n for n in doc["nodes"] if "children" in n]
    meshes = [doc["nodes"][c]["mesh"] for c in duck["children"]]
    tris = sum(doc["accessors"][doc["meshes"][m]["primitives"][0]["indices"]]["count"] // 3
               for m in meshes)
    assert tris == cfg["triangles"] == 4198 and abs(tris - 4212) == 14
    assert [c["name"] for c in doc["cameras"]] == [cfg["camera"]]


def test_the_cell_takes_the_whole_path(duck_path):
    """The cell's traffic on the configuration's scene: the whole path over
    the flat tile loop, the contest's 1920x1080 in twelve waves of 522,240
    rays, so the frame launches the cell's kernels."""
    wl = spec.load_workload(CELL)
    tr = wl.traffic
    assert (tr.width, tr.height, tr.spp, tr.bounces, tr.wave) == (None, 1080, 3, 4, 2**19)
    assert tr.backend == "auto" and not tr.extensions and wl.reference == spec.PLAIN
    cfg = Config(num_samples=tr.spp, max_bounce=tr.bounces, wave_size=tr.wave,
                 grid_resolution=tr.grid_resolution, backend=tr.backend)
    scene, cam, _ = pipeline.prepare_scene(str(duck_path), cfg, wl.config["camera"], tr.width,
                                           tr.height, device="cpu")
    assert wavefront.regime(scene) == "whole path" and wavefront.trace_walk(scene) == "flat"
    assert scene.bank_resident and scene.tile_bbox.shape[1] == 33
    plan = pipeline.frame_plan(scene, cam, cfg)
    assert (cam.width, cam.height) == (1920, 1080)
    assert (plan.wave_size, plan.num_waves) == (522240, 12)
    assert set(wl.kernels) == {"path_trace_gen", "path_trace", "ray_sort_key"}
    assert set(wl.trace_kernels) == {"path_trace_gen", "path_trace"}


def _duck_wave(path, rays=512, height=36):
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = pipeline.prepare_scene(str(path), cfg, "DuckCam", None, height,
                                           device="cpu")
    par = wavefront.build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(spp=3, width=cam.width, img_w=cam.width, img_h=height, tiles_x=0)
    return scene, par, (0, 0, 0, SEED & 0xFFFFFFFF, 0, 0, 0, 0), rays, gen


def _counts():
    return torch.zeros(3, dtype=torch.int64), torch.zeros(2, dtype=torch.int64)


def test_the_twins_sweep_counts_equal_the_loops_replay(duck_path):
    """On a Duck wave, bounce 0 from the generator and bounce 1 after the
    beam sort: the twins' lane_tiles and warp_sweeps equal the NumPy
    replay of the kernels' loop on every warp, and counting them changes
    neither the other counters nor a bit of the state."""
    assert mxu_intersect.LANE_LOOP_MIN == walk_check.lane_loop_min()
    scene, par, meta, R, gen = _duck_wave(duck_path)
    state0 = fused.gen_rays_ref(par, meta, R, gen)
    counts, sweeps = _counts()
    st1, idx1 = fused.path_trace_gen_ref(scene, par, meta, R, 1, gen, emit_key=True,
                                         emit_idx=True, counts=counts, sweeps=sweeps)
    occ = walk_check.flat_occupancy(scene, state0, None, warps=R // 32)
    assert sweeps.tolist() == [occ["lane_tiles"], occ["warp_sweeps"]]
    assert occ["lane_tiles"] > 0 and occ["warp_sweeps"] > 0
    alone, _ = _counts()
    st1_alone, idx1_alone = fused.path_trace_gen_ref(scene, par, meta, R, 1, gen,
                                                     emit_key=True, emit_idx=True,
                                                     counts=alone)
    assert torch.equal(counts, alone) and torch.equal(idx1, idx1_alone)
    assert torch.equal(st1.view(torch.int32), st1_alone.view(torch.int32))

    _, st1, (idx1,) = wavefront.sort_state_payload(st1[15].contiguous().view(torch.int32),
                                                   st1, (idx1,))
    counts, sweeps = _counts()
    st2 = fused.path_trace_fused_ref(scene, st1, 1, bounce0=1, prev=idx1, counts=counts,
                                     sweeps=sweeps)
    occ = walk_check.flat_occupancy(scene, st1, idx1, warps=R // 32)
    assert sweeps.tolist() == [occ["lane_tiles"], occ["warp_sweeps"]]
    assert sweeps[1] > 0
    alone, _ = _counts()
    st2_alone = fused.path_trace_fused_ref(scene, st1, 1, bounce0=1, prev=idx1, counts=alone)
    assert torch.equal(counts, alone)
    assert torch.equal(st2.view(torch.int32), st2_alone.view(torch.int32))


def test_a_duck_frame_counts_its_sweeps(duck_path):
    """A tiny Duck frame's tally: the flat loop's two counters bound the
    tiles its warps swept (a lane-parallel tile has LANE_LOOP_MIN to 32
    passing lanes, a warp sweep one), and the other counters read as the
    whole path counts them."""
    cfg = Config(num_samples=3, max_bounce=4, wave_size=4096, seed=SEED)
    scene, cam, _ = pipeline.prepare_scene(str(duck_path), cfg, "DuckCam", None, 36,
                                           device="cpu")
    _, stats = pipeline.render_scene(scene, cam, cfg)
    c = stats.counters
    assert set(c) == {"segments", "lanes", *wavefront.WORK_COUNTERS}
    assert wavefront.WORK_COUNTERS[-2:] == ("lane_tiles", "warp_sweeps")
    assert c["alive"] == c["segments"] == stats.segments > 0
    assert c["boxes"] == c["alive"] * scene.tile_bbox.shape[1]
    assert all(c[k] == 0 for k in ("walk_iterations", "shadow_rays", "shadow_tiles",
                                   "shadow_boxes", "specular"))
    lt, ws = c["lane_tiles"], c["warp_sweeps"]
    assert lt > 0 and ws > 0
    assert mxu_intersect.LANE_LOOP_MIN * lt + ws <= c["tiles"] <= 32 * lt + ws


def _reading(trace=True):
    ops = [(0.0, 3000.0, "path_trace_gen_kernel(ZrcScene, ZrcGen, int)")]
    t = devtrace.DeviceTrace(ops, [], 0.0, 4000.0, 1) if trace else None
    return Reading(spec.load_workload(CELL), frames=1, phases={}, trace=t, rays=6220800,
                   segments=14000000, triangles=4208, grid_cells=0, grid_refs=0)


@pytest.mark.parametrize("counters, want", [
    ({"frames": 2, "tiles": 900, "lane_tiles": 20, "warp_sweeps": 260}, 900 / 900),
    ({"frames": 2, "tiles": 700, "lane_tiles": 20, "warp_sweeps": 260}, 700 / 900),
    ({"frames": 1, "tiles": 5, "lane_tiles": 0, "warp_sweeps": 5}, 1.0),
    ({"frames": 1, "tiles": 0, "lane_tiles": 0, "warp_sweeps": 0}, None),
    ({"frames": 2, "tiles": 900}, None),  # a program without the two counters
    ({"frames": 0}, None),
], ids=["full", "partial", "warp-only", "none-swept", "absent", "no-frame"])
def test_the_flat_sweep_yield_reader(monkeypatch, counters, want):
    from zig_raytracing_contest_tpu_torch import kernels

    monkeypatch.setattr(kernels, "COUNTERS", dict(counters))
    module = spec.load_metric("flat_sweep_yield")
    got = module.read(_reading())
    assert got == (None if want is None else pytest.approx(want))
    assert module.read(_reading(trace=False)) is None
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == "flat_sweep_yield")
    assert entry["workloads"] == [CELL] and module.UNIT == entry["unit"] == "share"
    assert (entry["source"], entry["layer"], entry["moves"]) == \
        ("program_counter", "kernels", "mrays_s")


def test_the_cells_twins_pass_and_its_control_fails(tmp_path):
    """The port's whole-path twins at 64x36 meet the cell's limits against
    the plain reference, and that reference in bfloat16 fails them."""
    twins_pass_and_control_fails(tmp_path, CELL)
