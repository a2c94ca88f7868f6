"""The port's nearest-hit twin against the JAX package's XLA tile scan.

``nearest_hit_ref`` (flat tile loop, per-ray slab cull, Morton-space
previous-hit exclusion) must find the same hits as ``nearest_hit_xla`` on
the same baked triangles and rays.  XLA:CPU contracts the transform's
multiply-adds into FMAs and PyTorch does not, so t is held to rtol 1e-6,
u/v to 1e-5, and the winner index exactly wherever the nearest and the
second-nearest hit are more than 1e-6·t apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.ops.mxu_intersect import nearest_hit_xla
from zig_raytracing_contest_tpu.scene import procedural as jproc
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf
from zig_raytracing_contest_tpu.scene.materials import load_materials
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu_torch.ops.mxu_intersect import nearest_hit_ref
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc

R = 4096


def _jax_scene(path):
    g = load_gltf(str(path))
    geo = load_geometry(g)
    return build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)),
                              load_materials(g), backend="mxu")


@pytest.fixture(scope="module", params=["cornell", "bench20"])
def scene_and_rays(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    if request.param == "cornell":
        scene = _jax_scene(jproc.cornell_like_box(d / "box.gltf"))
        lo, hi = -0.9, 0.9
    else:
        scene = _jax_scene(tproc.bench_scene(d / "b.gltf", num_objects=20))
        lo, hi = -6.0, 6.0
    rs = np.random.default_rng(1234)
    orig = rs.uniform(lo, hi, (R, 3)).astype(np.float32)
    dirs = rs.standard_normal((R, 3))
    if request.param != "cornell":
        dirs[:, 1] = -np.abs(dirs[:, 1])  # toward the floor and the quads
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    active = rs.uniform(size=R) < 0.9
    return scene, orig, dirs, active


def _port(scene, orig, dirs, active, prev=None):
    t, i, u, v = nearest_hit_ref(
        torch.from_numpy(np.array(scene.mxu.tri_data)),
        torch.from_numpy(np.array(scene.mxu.tile_bbox)),
        scene.mxu.tile,
        torch.from_numpy(orig.T.copy()), torch.from_numpy(dirs.T.copy()),
        torch.from_numpy(active),
        None if prev is None else torch.from_numpy(prev.astype(np.int64)),
    )
    return t.numpy(), i.numpy(), u.numpy(), v.numpy()


def _jax(scene, orig, dirs, active, exclude=None):
    out = nearest_hit_xla(scene.mxu, jnp.asarray(orig), jnp.asarray(dirs),
                          jnp.asarray(active),
                          exclude=None if exclude is None else jnp.asarray(exclude))
    return tuple(np.asarray(a) for a in out)


def _two_nearest(scene, orig, dirs, prev_m=None):
    """(nearest, second-nearest) valid t per ray over every triangle, in
    NumPy f32 (an independent brute force)."""
    m = np.asarray(scene.mxu.tri_data)[:13, None, :]  # (13, 1, Tp)
    o = [orig[:, a : a + 1] for a in range(3)]
    d = [dirs[:, a : a + 1] for a in range(3)]
    with np.errstate(all="ignore"):
        ou = m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[9]
        ov = m[3] * o[0] + m[4] * o[1] + m[5] * o[2] + m[10]
        ow = m[6] * o[0] + m[7] * o[1] + m[8] * o[2] + m[11]
        du = m[0] * d[0] + m[1] * d[1] + m[2] * d[2]
        dv = m[3] * d[0] + m[4] * d[1] + m[5] * d[2]
        dw = m[6] * d[0] + m[7] * d[1] + m[8] * d[2]
        t = -ow / dw
        u, v = ou + t * du, ov + t * dv
        ok = (-dw * m[12] >= np.float32(1e-8)) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    if prev_m is not None:
        ok &= np.arange(t.shape[1])[None, :] != prev_m[:, None]
    t = np.sort(np.where(ok, t, np.inf), axis=1)
    return t[:, 0], t[:, 1]


def _check(scene, orig, dirs, active, got, want, prev_m=None, min_hits=0):
    t, i, u, v = got
    tj, ij, uj, vj = want
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() >= min_hits, "fixture rays must hit the scene"
    # atol: XLA rounds each transform row once less (FMA), an absolute
    # error of about one f32 ULP at the scene's coordinate scale.
    np.testing.assert_allclose(t[hit], tj[hit], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(u[hit], uj[hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], vj[hit], atol=1e-5)
    t1, t2 = _two_nearest(scene, orig, dirs, prev_m)
    np.testing.assert_array_equal(np.isfinite(t1) & active, hit)
    with np.errstate(invalid="ignore"):
        clear = hit & ~(np.abs(t2 - t1) <= 1e-6 * t1)
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(i[clear], ij[clear])
    # misses and inactive rays report t = inf, idx = 0
    np.testing.assert_array_equal(i[~hit], 0)
    assert np.isinf(t[~active]).all()


def test_nearest_hit_matches_xla(scene_and_rays):
    scene, orig, dirs, active = scene_and_rays
    got = _port(scene, orig, dirs, active)
    want = _jax(scene, orig, dirs, active)
    _check(scene, orig, dirs, active, got, want, min_hits=R // 3)


def test_nearest_hit_excludes_previous_hit(scene_and_rays):
    """Previous-hit exclusion: the port masks a Morton index, the XLA scan a
    unique triangle id through ``perm``; excluding each ray's own nearest
    hit must give the same (second) hit in both."""
    scene, orig, dirs, active = scene_and_rays
    first = _port(scene, orig, dirs, active)
    rs = np.random.default_rng(7)
    prev_m = np.where(np.isfinite(first[0]), first[1],
                      rs.integers(0, scene.mxu.perm.shape[0], R))
    perm = np.asarray(scene.mxu.perm)
    got = _port(scene, orig, dirs, active, prev_m)
    want = _jax(scene, orig, dirs, active, perm[prev_m].astype(np.int32))
    assert (got[1][np.isfinite(got[0])] != prev_m[np.isfinite(got[0])]).all()
    _check(scene, orig, dirs, active, got, want, prev_m, min_hits=32)
