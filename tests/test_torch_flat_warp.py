"""The whole-path kernels' flat loop of one warp, replayed on the CPU,
against the flat twin and the JAX package's nearest hit.

``path_trace_gen_kernel`` and ``path_trace_kernel`` (kernels/path_trace.cu,
``trace_nearest_warp``) run the flat tile loop for the 32 rays of a warp
together: each lane culls a tile against its own best, and the tile is
swept lane-parallel (``sweep_tile``) when at least LANE_LOOP_MIN lanes pass
it, else by the whole warp once per passing lane (``warp_sweep``).
``walk_check.flat_warp_ref`` replays that loop in NumPy float32.  Here, for
LANE_LOOP_MIN 0 (always the lane loop), 33 (always the warp) and the
kernel's own value, its t, u, v bits and winner equal the flat twin
``nearest_hit_ref``'s on every lane:

* the 31-tile bank of tests/test_torch_stream.py (512 lanes, 10% dead,
  half excluding a previous hit);
* 1024 lanes of the side-90 terrain's whole-path bounce-0 wave in 32 warps,
  the last of them holding tie lane 94331, where the flat loop keeps 11519;
* tiles of duplicated triangles (exact ties at equal t in one lane, across
  lanes and across tiles), with previous hits, dead lanes and a short last
  warp;

and on a bench-style scene its t, u, v and winner agree with the JAX
package's ``nearest_hit_xla`` to tests/test_torch_trace.py's tolerance.
"""

import numpy as np
import pytest
import torch
from test_torch_stream import streamed  # noqa: F401  (the module's fixture)
from test_torch_trace import _check, _jax, _jax_scene

from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.probes import walk_check
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc

TIE_LANE, TIE_FLAT_IDX = 94331, 11519
LOOP_MINS = [0, 33, walk_check.lane_loop_min()]
LOOP_IDS = ["lane-loop", "warp", "kernel"]


def _twin(tri_data, tile_bbox, tile, state, prev):
    """The flat twin on a (16, R) state: t, idx, u, v as NumPy arrays."""
    t, idx, u, v, _ = tmi.nearest_hit_ref(
        tri_data, tile_bbox, tile, state[0:3], state[3:6], state[12] > 0,
        None if prev is None else prev.long())
    return t.numpy(), idx.numpy(), u.numpy(), v.numpy()


def _assert_lanes_equal(got: dict, want) -> None:
    t, idx, u, v = want
    lanes = got["lanes"]
    for key, ref in (("t", t), ("u", u), ("v", v)):
        np.testing.assert_array_equal(got[key].view(np.int32),
                                      ref[lanes].astype(np.float32).view(np.int32), key)
    np.testing.assert_array_equal(got["idx"], idx[lanes])


def _all_warps(R: int) -> range:
    return range(-(-R // 32))


def test_kernel_constant_is_in_range():
    """The kernel's LANE_LOOP_MIN is one integer in 0 .. 33."""
    assert 0 <= walk_check.lane_loop_min() <= 33


@pytest.mark.parametrize("loop_min", LOOP_MINS, ids=LOOP_IDS)
def test_flat_warp_equals_twin_on_stream_bank(streamed, loop_min):  # noqa: F811
    """Every lane of the 31-tile bank's wave, in 16 warps."""
    ts, state = streamed.ts, torch.from_numpy(streamed.state)
    prev = torch.from_numpy(streamed.prev)
    got = walk_check.flat_warps(ts, state, prev, _all_warps(state.shape[1]), loop_min)
    _assert_lanes_equal(got, _twin(ts.tri_data, ts.tile_bbox, ts.tile, state, prev))
    assert np.isfinite(got["t"]).sum() > state.shape[1] // 5
    if loop_min == 33:
        assert got["lane_tiles"] == 0 and got["warp_sweeps"] == got["passed"].sum()
    if loop_min == 0:
        assert got["warp_sweeps"] == 0 and got["lane_tiles"] == len(got["pops"])


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """The side-90 terrain (127 tiles) and 32 warps of its bounce-0 wave
    spread over the first 94,336 rays, the last the warp of lane 94331."""
    scene, cam = walk_check.load("terrain", walk_check.TERRAIN_SIDE,
                                 tmp_path_factory.mktemp("terrain"), "cpu")
    state = walk_check.bounce0_state(scene, cam, TIE_LANE + 5)[0]
    warps = [k * (TIE_LANE // 32 // 31) for k in range(31)] + [TIE_LANE // 32]
    return scene, state, warps


@pytest.mark.parametrize("loop_min", LOOP_MINS, ids=LOOP_IDS)
def test_flat_warp_equals_twin_on_terrain(terrain, loop_min):
    scene, state, warps = terrain
    assert scene.tile_bbox.shape[1] == 127
    got = walk_check.flat_warps(scene, state, None, warps, loop_min)
    assert got["lanes"].size == 1024 and TIE_LANE in got["lanes"]
    sub = state[:, got["lanes"]].contiguous()
    want = _twin(scene.tri_data, scene.tile_bbox, scene.tile, sub, None)
    got["lanes"] = np.arange(sub.shape[1])
    _assert_lanes_equal(got, want)
    assert np.isfinite(got["t"]).sum() > 100
    assert got["idx"][-32 + TIE_LANE % 32] == TIE_FLAT_IDX


def _duplicate_scene(rng):
    """Four regions 20 apart in x, each a pool of 12 stacked triangles (six
    planes, either winding) repeated 128 times over, baked into tiles of
    128: many triangles are hit at exactly the same t in one tile, and a
    ray over a region passes only that region's tiles."""
    v0, e1, e2 = [], [], []
    for region in range(4):
        for k in rng.integers(0, 12, 128):
            z, flip = np.linspace(-3.0, 3.0, 6)[k // 2], bool(k % 2)
            a, b = np.array([16.0, 0, 0]), np.array([0, 16.0, 0])
            v0.append([20.0 * region - 4.0, -4.0, z])
            e1.append(b if flip else a)
            e2.append(a if flip else b)
    tris = tmi.bake_triangles(np.array(v0, np.float32), np.array(e1, np.float32),
                              np.array(e2, np.float32), tile=128)
    return torch.from_numpy(tris.tri_data), torch.from_numpy(tris.tile_bbox), tris.tile


def _duplicate_rays(rng, R: int):
    """R rays from z = 9 down onto the regions' triangles: warp 0 over
    region 0 alone (every lane passes its tiles), warp 1 spread over all
    four, the rest over region 1 at 60%; every 5th lane dead."""
    region = rng.integers(0, 4, R)
    region[:32] = 0
    region[64:] = np.where(rng.uniform(size=R - 64) < 0.6, 1, region[64:])
    state = np.zeros((16, R), np.float32)
    state[0] = 20.0 * region + rng.uniform(-2.0, 2.0, R)
    state[1], state[2] = rng.uniform(-2.0, 2.0, R), 9.0
    d = np.stack([rng.uniform(-0.1, 0.1, R), rng.uniform(-0.1, 0.1, R), -np.ones(R)])
    state[3:6] = d / np.linalg.norm(d, axis=0)
    state[12] = (np.arange(R) % 5 != 4).astype(np.float32)
    return torch.from_numpy(state)


@pytest.mark.parametrize("loop_min", LOOP_MINS, ids=LOOP_IDS)
def test_flat_warp_on_duplicated_triangles(loop_min):
    """103 lanes (a short last warp of 7), every 5th dead, in two passes:
    no previous hit, then each even lane excluding the lowest-index copy
    of its nearest triangle, so another copy at the same t must win."""
    rng = np.random.default_rng(8)
    tri, bb, tile = _duplicate_scene(rng)
    assert bb.shape[1] == 4
    R = 103
    state = _duplicate_rays(rng, R)
    first = _twin(tri, bb, tile, state, None)
    hit = np.isfinite(first[0])
    assert hit.sum() > 0.7 * R
    prev = torch.from_numpy(np.where(hit & (np.arange(R) % 2 == 0), first[1], -1))
    scene = type("Bank", (), {"tri_data": tri, "tile_bbox": bb, "tile": tile})
    moved = 0
    for pv in (None, prev):
        got = walk_check.flat_warps(scene, state, pv, _all_warps(R), loop_min)
        assert got["lanes"].size == R
        want = _twin(tri, bb, tile, state, pv)
        _assert_lanes_equal(got, want)
        assert (got["passed"][state[12].numpy() == 0] == 0).all()
        if pv is not None:
            moved += int((got["idx"] != first[1])[prev.numpy() >= 0].sum())
        if loop_min == walk_check.lane_loop_min() and 0 < loop_min <= 32:
            assert got["lane_tiles"] > 0 and got["warp_sweeps"] > 0
    assert moved > 10


def test_flat_warp_matches_jax_nearest_hit(tmp_path):
    """8 warps of bench-scene rays (10% dead) through flat_warp_ref at the
    kernel's LANE_LOOP_MIN against the JAX package's nearest_hit_xla, to
    tests/test_torch_trace.py's tolerance."""
    scene = _jax_scene(tproc.bench_scene(tmp_path / "b.gltf", num_objects=20))
    rs = np.random.default_rng(1234)
    R = 256
    orig = rs.uniform(-6.0, 6.0, (R, 3)).astype(np.float32)
    dirs = rs.standard_normal((R, 3))
    dirs[:, 1] = -np.abs(dirs[:, 1])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    active = rs.uniform(size=R) < 0.9
    bank = type("Bank", (), {"tri_data": torch.from_numpy(np.array(scene.mxu.tri_data)),
                             "tile_bbox": torch.from_numpy(np.array(scene.mxu.tile_bbox)),
                             "tile": scene.mxu.tile})
    state = torch.zeros((16, R))
    state[0:3], state[3:6] = torch.from_numpy(orig.T.copy()), torch.from_numpy(dirs.T.copy())
    state[12] = torch.from_numpy(active.astype(np.float32))
    got = walk_check.flat_warps(bank, state, None, _all_warps(R), walk_check.lane_loop_min())
    _check(scene, orig, dirs, active, (got["t"], got["idx"], got["u"], got["v"]),
           _jax(scene, orig, dirs, active), min_hits=R // 4)


def test_flat_occupancy_counts_the_lanes(streamed):  # noqa: F811
    """flat_occupancy on the 31-tile bank: tiles passed per live ray, tiles
    swept per warp and the busy share agree with the replay's own counts;
    the lane loop alone costs swept x tile iterations a warp, and at 33
    (the warp alone) each passing lane costs tile/32 + WARP_SWEEP_EXTRA."""
    ts, state = streamed.ts, torch.from_numpy(streamed.state)
    prev = torch.from_numpy(streamed.prev)
    R = state.shape[1]
    full = walk_check.flat_warps(ts, state, prev, _all_warps(R), 0)
    live = streamed.alive
    for loop_min, cost in ((0, None), (33, ts.tile / 32 + walk_check.WARP_SWEEP_EXTRA)):
        occ = walk_check.flat_occupancy(ts, state, prev, warps=R // 32, loop_min=loop_min)
        assert occ["warps"] == R // 32 and occ["lanes"] == R and occ["live"] == live.sum()
        assert occ["passed"] == pytest.approx(full["passed"][live].mean())
        assert occ["swept"] == pytest.approx(len(full["pops"]) / (R // 32))
        assert occ["busy"] == pytest.approx(full["passed"].sum() / (32 * len(full["pops"])))
        assert 0 < occ["busy"] <= 1
        want = occ["swept"] * ts.tile if cost is None else \
            full["passed"].sum() * cost / (R // 32)
        assert occ["iters"][0] == pytest.approx(occ["swept"] * ts.tile)
        assert occ["iters"][1] == pytest.approx(want)
