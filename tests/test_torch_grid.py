"""The port's grid backend against the JAX package: builder, DDA, grid walk.

* ``build_grid``: ``cell_begin``, ``cell_end`` and ``dup_to_tri`` equal to
  the JAX NumPy builder's, on the random soups of tests/test_grid_builder.py
  and on the Cornell box at (8, 8, 8);
* the DDA: the reference's four walks (tests/test_dda.py: cell sequences
  and ``t_cross`` bits), the miss, the held state of inactive lanes, and
  16,384 random rays walked 40 steps, all bit for bit;
* the grid walk ``trace_wave`` / ``trace_any`` on the Cornell box and the
  four random scenes of tests/test_fuzz_backends.py, both packages on the
  same scene (``from_jax_scene``): against the JAX walk run op by op, t,
  u, v and the triangle bit for bit; against the compiled JAX walk (XLA
  contracts Möller–Trumbore into FMAs) t within 32 ULP, u and v within
  1e-5 and the triangle equal wherever no second triangle lies within
  1e-6·t of the nearest (a tie); misses for inactive rays, the previous-hit
  exclusion, and the grid against the flat twin of the MXU bake.

On the CPU the grid walk is its plain twin ``trace_wave_ref``; on the card
it is grid_walk_kernel (tests/test_torch_cuda.py holds it to the twin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fuzz_backends import _random_scene
from test_grid_builder import random_soup
from test_torch_bake import jax_scene_arrays

from zig_raytracing_contest_tpu.grid.builder import build_grid as jax_build_grid
from zig_raytracing_contest_tpu.ops import dda as jdda
from zig_raytracing_contest_tpu.render.wavefront import FLT_EPSILON
from zig_raytracing_contest_tpu.render.wavefront import trace_any as jax_trace_any
from zig_raytracing_contest_tpu.render.wavefront import trace_wave as jax_trace_wave
from zig_raytracing_contest_tpu.scene import procedural as jproc
from zig_raytracing_contest_tpu.scene.camera import load_camera as jcam
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jgeo
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu_torch.grid.builder import build_grid
from zig_raytracing_contest_tpu_torch.ops import dda
from zig_raytracing_contest_tpu_torch.render import wavefront
from zig_raytracing_contest_tpu_torch.scene.types import from_jax_scene

INF = float("inf")


def jax_xla_arrays(js) -> dict:
    """A JAX DeviceScene's arrays as NumPy, with the grid and what the XLA
    shading path reads (from_jax_scene keys)."""
    arrays = jax_scene_arrays(js) if js.mxu is not None else {
        "grid.bbox_min": np.asarray(js.grid.bbox_min),
        "grid.bbox_max": np.asarray(js.grid.bbox_max)}
    arrays.update({
        "grid.resolution": np.asarray(js.grid.resolution),
        "grid.cell_size": np.asarray(js.grid.cell_size),
        **{k: np.asarray(getattr(js, k)) for k in (
            "cell_begin", "cell_end", "tri_v0", "tri_e1", "tri_e2", "dup_to_tri",
            "shade_table", "color_data")},
        "ext_mr": None if js.ext_mr is None else np.asarray(js.ext_mr),
        "lights": None if js.lights is None else {
            k: np.asarray(v) for k, v in js.lights._asdict().items()},
    })
    return arrays


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _cornell_positions(tmp_path):
    return jgeo(jgltf(str(jproc.cornell_like_box(tmp_path / "box.gltf")))).positions


@pytest.mark.parametrize("case", [
    ("soup", 40, 0, (6, 6, 6)), ("soup", 60, 3, (4, 4, 4)), ("soup", 25, 7, (5, 5, 5)),
    ("soup", 30, 11, (4, 4, 4)), ("cornell", 0, 0, (8, 8, 8)),
], ids=["soup40", "soup60", "soup25", "soup30", "cornell"])
def test_build_grid_equals_jax(case, tmp_path):
    kind, n, seed, res = case
    positions = random_soup(n, seed=seed) if kind == "soup" else _cornell_positions(tmp_path)
    j, t = jax_build_grid(positions, res), build_grid(positions, res)
    for f in ("bbox_min", "bbox_max", "resolution", "cell_size", "cell_begin", "cell_end",
              "dup_to_tri"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert t.stats == j.stats
    assert len(t.dup_to_tri) > 0


# ---------------------------------------------------------------------------
# DDA
# ---------------------------------------------------------------------------

def _walk_both(orig, direction, n):
    """Cells and crossing-t bits of n next() calls, JAX and the port, on the
    reference's 5×5×5 grid (tests/test_dda.py ``walk``)."""
    d = np.asarray([direction], np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.asarray([orig], np.float32)
    je, js = jdda.dda_setup(jdda.make_grid([0, 0, 0], [5, 5, 5], [5, 5, 5]),
                            jnp.asarray(o), jnp.asarray(d))
    te, ts = dda.dda_setup(dda.make_grid([0, 0, 0], [5, 5, 5], [5, 5, 5]),
                           torch.from_numpy(o), torch.from_numpy(d))
    assert bool(je[0]) and bool(te[0])
    out = []
    for state, step in ((js, jdda.dda_next), (ts, dda.dda_next)):
        cells, bits = [tuple(int(c) for c in np.asarray(state.cell[0]))], []
        for _ in range(n):
            t, state = step(state)
            bits.append(int(np.asarray(t, np.float32).view(np.uint32)[0]))
            cells.append(tuple(int(c) for c in np.asarray(state.cell[0])))
        out.append((cells, bits))
    return out


@pytest.mark.parametrize("orig, direction, n, first", [
    ((0.5, 0.5, 0.5), (2, 1, 0), 7, (4, 2, 0)),  # traceRay 1: oblique
    ((0.5, 10.0, 0.5), (0, -1, 0), 6, (0, 0, 0)),  # traceRay 2: from outside, -y
    ((0.5, -5.0, 0.5), (0, 1, 0), 5, (0, 4, 0)),  # traceRay 3: from outside, +y
    ((0.5, 0.5, 0.5), (1, 1, 0), 9, (4, 4, 0)),  # traceRay 4: diagonal tie, y first
], ids=["oblique", "neg_y", "pos_y", "diagonal_tie"])
def test_reference_walks_equal_jax(orig, direction, n, first):
    """The four walks of src/linalg.zig:583-681: every cell and every
    crossing t bit for bit, the last call +inf (a finished walk stays
    finished)."""
    (jc, jb), (tc, tb) = _walk_both(orig, direction, n)
    assert tc == jc and tb == jb
    assert tc[-1] == first
    assert np.asarray(tb[-1], np.uint32).view(np.float32) == INF


def test_dda_miss_linearize_and_held_state():
    """The miss at tests/test_dda.py:124, the x-fastest z-major index, the
    clamped cell of 256 points in and around the grid, and an inactive
    lane's held state (:134), each equal to the JAX value."""
    g = dda.make_grid([0, 0, 0], [5, 5, 5], [5, 5, 5])
    entered, _ = dda.dda_setup(g, torch.tensor([[10.0, 10.0, 10.0]]),
                               torch.tensor([[1.0, 0.0, 0.0]]))
    assert not bool(entered[0])
    assert int(dda.linearize_cell_idx(g, torch.tensor([[1, 2, 3]]))[0]) == 3 * 25 + 2 * 5 + 1
    pts = np.random.default_rng(2).uniform(-1, 6, (256, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        dda.get_cell_idx(g, torch.from_numpy(pts)).numpy(),
        np.asarray(jdda.get_cell_idx(jdda.make_grid([0, 0, 0], [5, 5, 5], [5, 5, 5]),
                                     jnp.asarray(pts))))
    o = np.asarray([[0.5, 0.5, 0.5]] * 2, np.float32)
    d = np.asarray([[1.0, 0, 0]] * 2, np.float32)
    act = np.asarray([True, False])
    _, js = jdda.dda_setup(jdda.make_grid([0, 0, 0], [5, 5, 5], [5, 5, 5]),
                           jnp.asarray(o), jnp.asarray(d))
    jt, jn = jdda.dda_next(js, active=jnp.asarray(act))
    _, ts = dda.dda_setup(g, torch.from_numpy(o), torch.from_numpy(d))
    tt, tn = dda.dda_next(ts, active=torch.from_numpy(act))
    np.testing.assert_array_equal(tt.numpy().view(np.uint32), np.asarray(jt).view(np.uint32))
    assert float(tt[1]) == INF and float(tt[0]) == 0.5
    np.testing.assert_array_equal(tn.cell.numpy(), np.asarray(jn.cell))
    np.testing.assert_array_equal(tn.cell[1].numpy(), ts.cell[1].numpy())
    np.testing.assert_array_equal(tn.t_next_crossing.numpy().view(np.uint32),
                                  np.asarray(jn.t_next_crossing).view(np.uint32))


def test_dda_random_rays_equal_jax():
    """16,384 random rays from inside and around a 13×7×11 grid: the
    entered mask, every field of the set-up and 40 steps of the walk (cells
    and crossing t) bit for bit: 0 differing lanes."""
    rng = np.random.default_rng(0)
    R = 1 << 14
    bmin = np.array([-1.3, -0.7, -2.1], np.float32)
    bmax = np.array([2.2, 1.9, 0.4], np.float32)
    res = [13, 7, 11]
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64, 1] = 0.0  # axis-parallel rays: a +-inf crossing on y
    je, js = jdda.dda_setup(jdda.make_grid(bmin, bmax, res), jnp.asarray(o), jnp.asarray(d))
    te, ts = dda.dda_setup(dda.make_grid(bmin, bmax, res), torch.from_numpy(o),
                           torch.from_numpy(d))
    m = np.asarray(je)
    np.testing.assert_array_equal(te.numpy(), m)
    assert 3000 < m.sum() < R

    def bits(a):
        a = np.asarray(a)[m]
        return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.int64)

    differ = np.zeros(m.sum(), bool)
    for f in ("cell", "exit", "step", "t_delta", "t_next_crossing"):
        differ |= (bits(getattr(js, f)) != bits(getattr(ts, f).numpy())).any(axis=1)
    for _ in range(40):
        jt, js = jdda.dda_next(js)
        tt, ts = dda.dda_next(ts)
        differ |= bits(jt) != bits(tt.numpy())
        differ |= (bits(js.cell) != bits(ts.cell.numpy())).any(axis=1)
    assert differ.sum() == 0


# ---------------------------------------------------------------------------
# grid walk
# ---------------------------------------------------------------------------

def _cornell(tmp_path):
    gltf = jgltf(str(jproc.cornell_like_box(tmp_path / "box.gltf")))
    return jcam(gltf, width=24, height=24), jgeo(gltf), jmat(gltf)


def _scenes(name, tmp_path):
    """(camera, JAX grid scene, JAX MXU scene, port grid scene, port MXU
    scene) of the Cornell box or a random scene, grid (8, 8, 8)."""
    if name == "cornell":
        cam, geo, mats = _cornell(tmp_path)
        grid = jax_build_grid(geo.positions, (8, 8, 8))
    else:
        cam, geo, mats, grid = _random_scene(tmp_path, int(name[4:]))
    jg = build_device_scene(geo, grid, mats, backend="grid")
    jm = build_device_scene(geo, grid, mats, backend="mxu")
    tg = from_jax_scene(jax_xla_arrays(jg), device="cpu")
    tm = from_jax_scene(jax_xla_arrays(jm), device="cpu")
    assert tg.tri_data is None and tm.tri_data is not None and tg.grid.num_refs == len(grid.dup_to_tri)
    return cam, geo, jg, jm, tg, tm


def _rays(cam, n, xo=0.3183, yo=0.618):
    """Primary rays at irrational in-pixel offsets (tests/test_render.py)."""
    xs, ys = np.meshgrid(np.arange(n) + xo, np.arange(n) + yo)
    dirs = (cam.lower_left_corner + cam.right * xs.reshape(-1, 1).astype(np.float32)
            + cam.up * ys.reshape(-1, 1).astype(np.float32))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return np.tile(cam.origin, (n * n, 1)).astype(np.float32), dirs


def mt_two_nearest(positions, orig, dirs, exclude=None):
    """(nearest, second-nearest) valid t per ray over every unique triangle,
    Möller–Trumbore in NumPy f32 (an independent brute force)."""
    v0 = positions[None, :, 0]
    e1 = positions[None, :, 1] - positions[None, :, 0]
    e2 = positions[None, :, 2] - positions[None, :, 0]
    o, d = orig[:, None], dirs[:, None]
    with np.errstate(all="ignore"):
        p = np.cross(d, e2)
        det = (e1 * p).sum(-1)
        tv = o - v0
        u = (tv * p).sum(-1) / det
        q = np.cross(tv, e1)
        v = (d * q).sum(-1) / det
        t = (e2 * q).sum(-1) / det
        ok = (det >= 1e-8) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    if exclude is not None:
        ok &= np.arange(t.shape[1])[None, :] != exclude[:, None]
    t = np.sort(np.where(ok, t, np.inf), axis=1)
    return t[:, 0], t[:, 1]


def _assert_same_hits(positions, orig, dirs, got, want, exact: bool, exclude=None,
                      min_hits=1):
    """Misses equal and the triangle equal wherever t is no tie (a second
    triangle within 1e-6·t of the nearest).  ``exact``: t, u and v bit for
    bit (the JAX walk run op by op); else t within 32 ULP and u/v within
    1e-5 (the compiled JAX walk, whose Möller–Trumbore XLA contracts into
    FMAs: test_moller_trumbore_contraction; measured up to 26 ULP on a
    grazing continuation ray, ROADMAP queue 3)."""
    t, u, v, tri = (np.asarray(x) for x in got)
    tj, uj, vj, trij = (np.asarray(x) for x in want)
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() >= min_hits
    if exact:
        for a, b in ((t, tj), (u, uj), (v, vj)):
            np.testing.assert_array_equal(a[hit].view(np.uint32), b[hit].view(np.uint32))
    else:
        ulp = np.spacing(np.abs(tj[hit]).astype(np.float32))
        assert (np.abs(t[hit] - tj[hit]) <= 32 * ulp).all()
        np.testing.assert_allclose(u[hit], uj[hit], atol=1e-5)
        np.testing.assert_allclose(v[hit], vj[hit], atol=1e-5)
    t1, t2 = mt_two_nearest(positions, orig, dirs, exclude)
    with np.errstate(invalid="ignore"):
        clear = hit & ~(np.abs(t2 - t1) <= 1e-6 * t1)
    assert clear.sum() >= 0.9 * hit.sum()
    np.testing.assert_array_equal(tri[clear], trij[clear])


SCENES = ["cornell", "fuzz101", "fuzz202", "fuzz303", "fuzz404"]


def _jax_trace(scene, orig, dirs, act, exclude=None, op_by_op=False):
    args = (scene, jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(act))
    kw = {} if exclude is None else {"exclude": jnp.asarray(exclude)}
    if op_by_op:
        with jax.disable_jit():
            return jax_trace_any(*args, **kw)
    return jax_trace_any(*args, **kw)


@pytest.mark.parametrize("name", SCENES)
def test_trace_wave_matches_jax(name, tmp_path):
    """The port's grid walk against the JAX one on the same grid, 24×24
    primary rays with every fourth inactive, then the continuation rays
    from each hit with the previous hit excluded (unique space): against
    the JAX walk run op by op (``jax.disable_jit``) t, u, v and the
    triangle bit for bit; against the compiled walk as ``_assert_same_hits``
    says."""
    cam, geo, jg, _, tg, _ = _scenes(name, tmp_path)
    orig, dirs = _rays(cam, 24)
    act = np.arange(len(dirs)) % 4 != 3
    got = wavefront.trace_any(tg, torch.from_numpy(orig), torch.from_numpy(dirs),
                              torch.from_numpy(act))
    for op_by_op in (True, False):
        want = _jax_trace(jg, orig, dirs, act, op_by_op=op_by_op)
        _assert_same_hits(geo.positions, orig, dirs, got[:4], want, op_by_op,
                          min_hits=40)
    assert torch.isinf(got[0][~torch.from_numpy(act)]).all()
    res = wavefront.trace_wave(tg, torch.from_numpy(orig), torch.from_numpy(dirs),
                               torch.from_numpy(act))
    jres = jax_trace_wave(jg, jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(act))
    np.testing.assert_array_equal(res.dup_idx.numpy(), np.asarray(jres.dup_idx))
    assert res.iterations > 0

    t0, tri0 = np.asarray(want[0]), np.asarray(want[3])
    hit = np.isfinite(t0)
    o2 = (orig + dirs * (np.where(hit, t0, 0) + FLT_EPSILON)[:, None]).astype(np.float32)
    got2 = wavefront.trace_any(tg, torch.from_numpy(o2), torch.from_numpy(dirs),
                               torch.from_numpy(hit), exclude=torch.from_numpy(tri0.copy()))
    for op_by_op in (True, False):
        want2 = _jax_trace(jg, o2, dirs, hit, tri0, op_by_op=op_by_op)
        _assert_same_hits(geo.positions, o2, dirs, got2[:4], want2, op_by_op,
                          exclude=np.where(hit, tri0, -1), min_hits=0)


def _fma(a, b, c):
    """f32 fma(a, b, c), through f64 (a·b is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def test_moller_trumbore_contraction():
    """Why the compiled JAX walk's t differs from the port's in the last
    bits: on 200,000 random ray–triangle pairs the port's
    ``moller_trumbore`` equals the JAX function run op by op bit for bit,
    and the compiled JAX function equals Möller–Trumbore with XLA:CPU's
    contractions written out, cross(a, b)_x = fma(a_y, b_z, -(a_z·b_y))
    and dot(a, b) = fma(a_z, b_z, fma(a_y, b_y, a_x·b_x)), bit for bit on
    every hit; the share of hits whose t differs is printed."""
    from zig_raytracing_contest_tpu.ops import linalg as jl
    from zig_raytracing_contest_tpu_torch.ops import linalg

    rng = np.random.default_rng(1)
    R = 200_000
    o = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    v0 = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = (v0 + 0.3 * e1 + 0.3 * e2 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = [jnp.asarray(a) for a in (o, d, v0, e1, e2)]
    eager = [np.asarray(x) for x in jl.moller_trumbore(*args)]
    comp = [np.asarray(x) for x in jax.jit(jl.moller_trumbore)(*args)]
    port = [x.numpy() for x in linalg.moller_trumbore(*(torch.from_numpy(a) for a in (o, d, v0, e1, e2)))]
    hit = eager[0]
    assert hit.sum() > 90_000
    np.testing.assert_array_equal(port[0], eager[0])
    for a, b in zip(port[1:], eager[1:]):
        np.testing.assert_array_equal(a[hit].view(np.uint32), b[hit].view(np.uint32))

    def cross(a, b):
        return np.stack([_fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                         _fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                         _fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], -1)

    def dot(a, b):
        return _fma(a[:, 2], b[:, 2], _fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))

    with np.errstate(all="ignore"):
        p = cross(d, e2)
        det = dot(e1, p)
        inv = np.float32(1) / det
        tv = o - v0
        q = cross(tv, e1)
        fma_tuv = (dot(e2, q) * inv, dot(tv, p) * inv, dot(d, q) * inv)
    np.testing.assert_array_equal(comp[0], hit)
    for a, b in zip(fma_tuv, comp[1:]):
        np.testing.assert_array_equal(a[hit].view(np.uint32), b[hit].view(np.uint32))
    off = hit & (port[1] != comp[1])
    lane = int(np.argmax(off))
    print(f"t differs from the compiled JAX function on {off.sum() / hit.sum():.1%} of "
          f"{hit.sum()} hits; first, pair {lane}: o {o[lane].tolist()}, d "
          f"{d[lane].tolist()}, v0 {v0[lane].tolist()}, e1 {e1[lane].tolist()}, e2 "
          f"{e2[lane].tolist()}: compiled t {comp[1][lane]!r} "
          f"({comp[1][lane:lane + 1].view(np.uint32)[0]:08x}), port and op-by-op t "
          f"{port[1][lane]!r} ({port[1][lane:lane + 1].view(np.uint32)[0]:08x})")
    assert 0 < off.sum() < 0.9 * hit.sum()


def test_inactive_rays_report_miss(tmp_path):
    """Both backends' miss-on-inactive contract (tests/test_render.py:150):
    t = +inf and u = v = 0; the triangle of a miss is 0 with the bake and
    the first reference's triangle on the grid, as in the JAX package."""
    _, _, _, _, tg, tm = _scenes("cornell", tmp_path)
    o = torch.zeros((8, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(8, 1)
    for scene in (tg, tm):
        t, u, v, tri, _ = wavefront.trace_any(scene, o, d, torch.zeros(8, dtype=torch.bool))
        assert torch.isinf(t).all() and (u == 0).all() and (v == 0).all()
        assert (tri == (0 if scene.tri_data is not None else scene.grid.dup_to_tri[0])).all()
    assert wavefront.trace_wave(tg, o, d, torch.zeros(8, dtype=torch.bool)).iterations == 0


def test_previous_hit_exclusion(tmp_path):
    """Continuation rays never re-hit their own triangle, on either backend
    (tests/test_render.py:101-135): re-traced from each hit with the
    winner as ``exclude`` (the id ``trace_any`` hands back), no lane
    returns its triangle again nor a t ~ 0 phantom."""
    cam, _, _, _, tg, tm = _scenes("cornell", tmp_path)
    orig, dirs = _rays(cam, 24)
    o, d = torch.from_numpy(orig), torch.from_numpy(dirs)
    for scene in (tg, tm):
        t, _, _, tri, prev = wavefront.trace_any(scene, o, d, torch.ones(len(d), dtype=torch.bool))
        hit = torch.isfinite(t)
        assert hit.sum() > 500
        o2 = o + d * (t + FLT_EPSILON)[:, None]
        t2, _, _, tri2, _ = wavefront.trace_any(scene, o2, d, hit, exclude=prev)
        hit2 = torch.isfinite(t2) & hit
        assert not (tri2[hit2] == tri[hit2]).any()
        assert (t2[hit2] > 1e-3).all()


@pytest.mark.parametrize("name", SCENES)
def test_grid_matches_flat_twin(name, tmp_path):
    """The port's two backends find the same nearest hit
    (tests/test_render.py:81, tests/test_fuzz_backends.py:70): visibility
    equal but for ULP-edge rays (< 2%), and where both hit, the triangle
    equal or t within 1e-3 (coplanar overlaps)."""
    cam, _, _, _, tg, tm = _scenes(name, tmp_path)
    orig, dirs = _rays(cam, 24, 0.37, 0.61)
    args = (torch.from_numpy(orig), torch.from_numpy(dirs), torch.ones(len(dirs), dtype=torch.bool))
    tgr, ugr, vgr, igr, _ = (x.numpy() for x in wavefront.trace_any(tg, *args))
    tmx, umx, vmx, imx, _ = (x.numpy() for x in wavefront.trace_any(tm, *args))
    both = np.isfinite(tgr) & np.isfinite(tmx)
    assert (np.isfinite(tgr) != np.isfinite(tmx)).mean() < 0.02
    agree = (igr[both] == imx[both]) | (np.abs(tgr[both] - tmx[both]) < 1e-3)
    assert agree.mean() > 0.98
    same = both & (igr == imx)
    np.testing.assert_allclose(tgr[same], tmx[same], atol=1e-3)
    np.testing.assert_allclose(ugr[same], umx[same], atol=1e-3)
    np.testing.assert_allclose(vgr[same], vmx[same], atol=1e-3)
