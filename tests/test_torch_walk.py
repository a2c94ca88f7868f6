"""The per-bounce traces' walk, replayed on the CPU, against the flat loop,
the JAX streaming kernel and its own lane split.

``trace_emit_kernel`` and ``trace_stream_kernel`` (kernels/path_trace.cu)
walk the tile heap or the group heap, each lane its own ray
(``advance_walk``), and sweep each tile a ray reaches with the whole warp
(``warp_sweep``); ``walk_check.walk_heap_ref`` replays that walk for one
ray in NumPy float32 (the card holds the kernels to it bit for bit,
tests/test_torch_cuda.py and chip_smoke.py).  Here:

* on the 31-tile bank of tests/test_torch_stream.py, in 4 and 16 groups
  (both heaps, with previous hits), and on the side-90 terrain's tile heap
  (bounce 0, 1024 lanes of the whole-path wave and its tie lane 94331), the
  replay's t equals the flat twin ``trace_emit_aux_ref``'s bit for bit on
  every lane; the winners differ only where two triangles are hit at that
  same t (checked alone with ``triangle_hit_ref``);
* the group-heap replay's t equals the JAX streaming kernel's (interpret
  mode) within tests/test_torch_stream.py's tolerance;
* the kernel's lane split of a tile sweep (``walk_check.warp_sweep_ref``:
  32 lanes, then the warp's min of t and, at that t, of the index) picks
  the ascending loop's winner, on tiles of duplicated triangles (exact ties
  at equal t in one lane and across lanes) with and without a previous hit.
"""

import numpy as np
import pytest
import torch
from test_torch_stream import streamed  # noqa: F401  (the module's fixture)

from zig_raytracing_contest_tpu_torch.ops import mxu_intersect as tmi
from zig_raytracing_contest_tpu_torch.probes import walk_check

R = 512
TIE_LANE, TIE_WALK_IDX, TIE_FLAT_IDX = 94331, 11530, 11519


def _check_against_flat(scene, state, prev, want) -> int:
    """The replay ``want`` (walk_lanes on every lane) against the flat twin:
    t bits and the counts' shape on every lane, the winners wherever no tie;
    returns the number of tie lanes."""
    aux, idx, _ = tmi.trace_emit_aux_ref(scene, state, None, prev)
    t_flat = aux[2].numpy()
    np.testing.assert_array_equal(want["t"].view(np.int32), t_flat.view(np.int32))
    live = state[12].numpy() > 0
    assert ((want["tested"] > 0) == live).all() and (want["swept"][~live] == 0).all()
    diff = np.nonzero(want["idx"] != idx.numpy())[0]
    if diff.size:
        o, d = state[0:3, diff], state[3:6, diff]
        for w in (torch.from_numpy(want["idx"][diff]), idx[diff]):
            hit, t, _, _ = tmi.triangle_hit_ref(scene.tri_data, o, d, w)
            assert bool(hit.all())
            assert torch.equal(t, torch.from_numpy(t_flat[diff]))
        if prev is not None:
            assert (want["idx"][diff] != prev[diff].numpy()).all()
    same = want["idx"] == idx.numpy()
    np.testing.assert_array_equal(want["u"][same].view(np.int32),
                                  aux[0].numpy()[same].view(np.int32))
    np.testing.assert_array_equal(want["v"][same].view(np.int32),
                                  aux[1].numpy()[same].view(np.int32))
    return int(diff.size)


@pytest.mark.parametrize("groups", [True, False], ids=["group-heap", "tile-heap"])
def test_walk_replay_equals_flat_twin_on_stream_bank(streamed, groups):  # noqa: F811
    """Both heaps of the 31-tile bank, every lane, half of them excluding a
    previous hit."""
    ts, state = streamed.ts, torch.from_numpy(streamed.state)
    prev = torch.from_numpy(streamed.prev)
    want = walk_check.walk_lanes(ts, state, prev, range(R), groups)
    assert np.isfinite(want["t"]).sum() > R // 5
    _check_against_flat(ts, state, prev, want)


def test_walk_replay_matches_jax_streaming_kernel(streamed):  # noqa: F811
    """The group-heap replay's t against the JAX streaming kernel (interpret
    mode) on the live lanes, to tests/test_torch_stream.py's tolerance: a
    1e-6 relative band for nearly every lane, and a few f32 ULPs of the
    plane test's terms for the rest."""
    ts, state = streamed.ts, torch.from_numpy(streamed.state)
    want = walk_check.walk_lanes(ts, state, torch.from_numpy(streamed.prev), range(R),
                                 True)
    jaux, jidx, _ = streamed.jax
    live = streamed.alive
    t, tj = want["t"][live], jaux[2][live]
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    m = streamed.tris.tri_data[:, jidx[live][hit]]
    o, d = streamed.orig[live][hit].T, streamed.dirs[live][hit].T
    dw = np.abs(m[6] * d[0] + m[7] * d[1] + m[8] * d[2])
    terms = (np.abs(m[6] * o[0]) + np.abs(m[7] * o[1]) + np.abs(m[8] * o[2])
             + np.abs(m[11]) + tj[hit] * (np.abs(m[6] * d[0]) + np.abs(m[7] * d[1])
                                         + np.abs(m[8] * d[2])))
    tol = 1e-6 + 1e-6 * tj[hit] + 4 * np.finfo(np.float32).eps * terms / dw
    assert (np.abs(t[hit] - tj[hit]) <= tol).all()
    assert (np.abs(t[hit] - tj[hit]) <= 1e-6 + 1e-6 * tj[hit]).mean() > 0.99


def test_walk_replay_equals_flat_twin_on_terrain(tmp_path):
    """The side-90 terrain's tile heap (127 tiles), bounce 0 of the
    whole-path wave from pixel tile 920: 1024 lanes spread over its first
    94,332 rays and lane 94331, where the walk keeps 11530 and the flat loop
    11519, both hit at one t (the one tie)."""
    scene, cam = walk_check.load("terrain", walk_check.TERRAIN_SIDE, tmp_path, "cpu")
    assert scene.tile_bbox.shape[1] == 127
    state = walk_check.bounce0_state(scene, cam, TIE_LANE + 1)[0]
    lanes = torch.cat([torch.arange(1023) * (TIE_LANE // 1023), torch.tensor([TIE_LANE])])
    sub = state[:, lanes].contiguous()
    want = walk_check.walk_lanes(scene, sub, None, range(lanes.numel()), False)
    assert np.isfinite(want["t"]).sum() > 100
    assert _check_against_flat(scene, sub, None, want) >= 1
    assert want["idx"][-1] == TIE_WALK_IDX
    assert int(tmi.trace_emit_aux_ref(scene, sub[:, -1:])[1][0]) == TIE_FLAT_IDX


def _duplicate_bank(rng, tile: int):
    """Two tiles whose columns repeat a pool of 12 stacked triangles (six
    planes, either winding), so many triangles are hit at exactly the same
    t in one lane, across lanes and across the two tiles."""
    v0, e1, e2 = [], [], []
    for z in np.linspace(-3.0, 3.0, 6):
        for flip in (False, True):
            a, b = np.array([16.0, 0, 0]), np.array([0, 16.0, 0])
            v0.append([-4.0, -4.0, z])
            e1.append(b if flip else a)
            e2.append(a if flip else b)
    pool = tmi.bake_triangles(np.array(v0), np.array(e1), np.array(e2), tile=128).tri_data
    cols = rng.integers(0, 12, 2 * tile)
    return np.ascontiguousarray(pool[:, cols])


def test_lane_split_picks_the_ascending_winner():
    """warp_sweep_ref against sweep_tile_ref over tile 0, tile 1 and tile 0
    again (equal t across tiles: the first swept stays), per ray, from no
    best and from a best at one of the hits, without and with a previous
    hit (the lowest-index copy of the nearest triangle, so a same-t copy in
    another lane or later in the same lane must win)."""
    rng = np.random.default_rng(11)
    for tile in (128, 256):
        tri = _duplicate_bank(rng, tile)
        checked = moved = 0
        for _ in range(24):
            o = np.array([*rng.uniform(-3, 3, 2), 9.0], np.float32)
            d = np.array([*rng.uniform(-0.2, 0.2, 2), -1.0])
            d = (d / np.linalg.norm(d)).astype(np.float32)
            ok, t, _, _ = walk_check._transform(tri, 0, 2 * tile, o, d, -1)
            assert ok.sum() > tile // 2
            nearest = int(np.nonzero(ok & (t == t[ok].min()))[0][0])
            for prev in (-1, nearest):
                for t0 in (np.inf, float(np.sort(t[ok])[ok.sum() // 2])):
                    seq = {"t": np.float32(t0), "idx": 0, "u": np.float32(0),
                           "v": np.float32(0)}
                    lanes = dict(seq)
                    for j in (0, 1, 0):
                        walk_check.sweep_tile_ref(tri, tile, j, o, d, prev, seq)
                        walk_check.warp_sweep_ref(tri, tile, j, o, d, prev, lanes)
                        assert seq["idx"] == lanes["idx"]
                        for k in ("t", "u", "v"):
                            assert np.float32(seq[k]).view(np.int32) == \
                                np.float32(lanes[k]).view(np.int32), k
                        checked += 1
                    moved += prev >= 0 and seq["idx"] != nearest
        assert checked == 24 * 2 * 2 * 3 and moved >= 24


def test_walk_lanes_of_dead_rays_trace_nothing(streamed):  # noqa: F811
    """A dead lane reads t = +inf and 0 in u, v, idx and both counts, as the
    kernels write it."""
    state = torch.from_numpy(streamed.state)
    dead = np.nonzero(~streamed.alive)[0][:8]
    want = walk_check.walk_lanes(streamed.ts, state, None, dead, True)
    assert np.isinf(want["t"]).all()
    for k in ("u", "v", "idx", "swept", "tested"):
        assert (want[k] == 0).all(), k
    assert want["t"].dtype == np.float32 and want["idx"].dtype == np.int64


def test_lanes_off_walk_counts_every_field(streamed):  # noqa: F811
    """chip_smoke.py's exact check: a trace output built from the replay
    itself is 0 lanes off; a lane whose t, u, v, idx, swept or tested moves
    by one step is counted."""
    state = torch.from_numpy(streamed.state)
    lanes = list(range(0, R, 4))
    want = walk_check.walk_lanes(streamed.ts, state, None, lanes, True)
    aux = torch.zeros((8, R))
    idx = torch.zeros(R, dtype=torch.int32)
    for row, key in ((0, "u"), (1, "v"), (2, "t"), (5, "swept"), (6, "tested")):
        aux[row, lanes] = torch.from_numpy(want[key].astype(np.float32))
    idx[lanes] = torch.from_numpy(want["idx"].astype(np.int32))
    assert walk_check.lanes_off_walk(aux, idx, want, lanes) == 0
    hit = int(np.nonzero(np.isfinite(want["t"]))[0][0]) * 4
    for row in (0, 1, 2):
        moved = aux.clone()
        moved[row, hit] = torch.nextafter(moved[row, hit], torch.tensor(np.inf))
        assert walk_check.lanes_off_walk(moved, idx, want, lanes) == 1, row
    for row in (5, 6):
        moved = aux.clone()
        moved[row, hit] += 1
        assert walk_check.lanes_off_walk(moved, idx, want, lanes) == 1, row
    moved_idx = idx.clone()
    moved_idx[hit] += 1
    assert walk_check.lanes_off_walk(aux, moved_idx, want, lanes) == 1
