"""Primary-ray generation and the beam-sort keys against the JAX package.

``gen_rays_ref`` (the port of ``fused._gen_rays``) in raster slot order is
held against the XLA ray generation of ``wavefront.render_wave``: origin,
RNG streams and alive exactly.  Directions are bit-exact against the same
f32 expression evaluated op by op in NumPy, and within 2^-22 of the XLA
values: XLA:CPU contracts the camera multiply-adds into FMAs, which moves
about 0.3% of the components by one or two ULPs.  The
port's host key ``ray_sort_key`` must equal ``_ray_sort_key`` bit for bit,
and the kernel-variant key ``sort_key_ref`` must too on rays with no zero
direction component (it clamps |d| ≥ 1e-12 where the host key divides by
the raw direction).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.ops import rng
from zig_raytracing_contest_tpu.render.wavefront import _ray_sort_key, wave_pixel_coords
from zig_raytracing_contest_tpu.scene.camera import load_camera
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf
from zig_raytracing_contest_tpu.scene.materials import load_materials
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu_torch.render import fused
from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par, ray_sort_key
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.types import build_torch_scene
from zig_raytracing_contest_tpu_torch.grid.builder import scene_bbox

W, H, SPP = 48, 32, 3


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    g = load_gltf(str(tproc.bench_scene(d / "b.gltf", num_objects=20)))
    cam = load_camera(g, "Camera 1", W, H)
    geo, mats = load_geometry(g), load_materials(g)
    js = build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)), mats,
                            backend="mxu")
    ts = build_torch_scene(geo, mats, scene_bbox(geo.positions))
    return js, ts, cam


@pytest.mark.parametrize("pix_base,seed", [(0, 0), (W * 7 + 5, 12345)])
def test_gen_rays_match_xla_ray_generation(scenes, pix_base, seed):
    js, ts, cam = scenes
    R = (W * H - pix_base) * SPP - SPP * 11  # a ragged wave inside the image
    # --- XLA ray generation (render_wave, wavefront.py:545-556 + :585-589)
    local = jnp.arange(R, dtype=jnp.int32)
    streams = rng.ray_streams(jnp.uint32(seed), pix_base * SPP + local)
    _, x, y = wave_pixel_coords(local, SPP, W, pix_base)
    jx, jy = rng.uniform2_soa(streams, 0)
    sx, sy = x + jx, y + jy
    dr = [cam.lower_left_corner[a] + cam.right[a] * sx + cam.up[a] * sy
          for a in range(3)]
    inv_len = 1.0 / jnp.sqrt(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2])
    want_dir = np.stack([np.asarray(dr[a] * inv_len) for a in range(3)], -1)
    # --- the port (raster slot order, the same wave)
    par = build_gen_par(ts, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    y_base, x_base = divmod(pix_base, W)
    meta = (pix_base, x_base, y_base, seed, 0, 0, 0, 0)
    state = fused.gen_rays_ref(par, meta, R, fused.GenParams(SPP, W, W, H)).numpy()

    np.testing.assert_array_equal(state[0:3].T, np.tile(cam.origin, (R, 1)))
    np.testing.assert_array_equal(state[13].view(np.uint32), np.asarray(streams))
    np.testing.assert_array_equal(state[12], np.ones(R, np.float32))
    assert np.abs(state[3:6].T - want_dir).max() <= 2.0**-22
    # the same expression rounded op by op (no FMA): bit-exact
    sx_np, sy_np = np.asarray(sx), np.asarray(sy)
    dr_np = [cam.lower_left_corner[a] + cam.right[a] * sx_np + cam.up[a] * sy_np
             for a in range(3)]
    inv_np = np.float32(1.0) / np.sqrt(dr_np[0] * dr_np[0] + dr_np[1] * dr_np[1]
                                       + dr_np[2] * dr_np[2])
    np.testing.assert_array_equal(state[3:6], np.stack([d * inv_np for d in dr_np]))
    np.testing.assert_array_equal(state[6:9], 1.0)
    np.testing.assert_array_equal(state[9:12], 0.0)
    np.testing.assert_array_equal(state[14:16], 0.0)


def test_tiled_slots_cover_the_image_once(scenes):
    """32×32-tiled slot order: every real pixel gets spp rays, with the
    same RNG stream as in raster order; padding slots are born dead."""
    js, ts, cam = scenes
    par = build_gen_par(ts, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    tiles_x = -(-W // 32)
    R = tiles_x * (-(-H // 32)) * 1024 * SPP
    tiled = fused.gen_rays_ref(par, (0,) * 8, R, fused.GenParams(SPP, W, W, H, tiles_x))
    raster = fused.gen_rays_ref(par, (0,) * 8, W * H * SPP, fused.GenParams(SPP, W, W, H))
    alive = tiled[12] > 0
    assert int(alive.sum()) == W * H * SPP
    a = tiled[13][alive].view(torch.int32).sort().values
    b = raster[13].view(torch.int32).sort().values
    assert torch.equal(a, b)


def _key_states(js, n, seed, zero_components):
    rs = np.random.default_rng(seed)
    lo, hi = np.asarray(js.grid.bbox_min), np.asarray(js.grid.bbox_max)
    state = np.zeros((16, n), np.float32)
    state[0:3] = rs.uniform(lo - 1, hi + 1, (n, 3)).T
    d = rs.standard_normal((n, 3))
    if zero_components:
        d[rs.uniform(size=(n, 3)) < 0.2] = 0.0
        d[np.all(d == 0, axis=1), 1] = -1.0
    state[3:6] = (d / np.linalg.norm(d, axis=1, keepdims=True)).T
    state[12] = (rs.uniform(size=n) < 0.8).astype(np.float32)
    return state


def test_host_sort_key_bit_exact(scenes):
    js, ts, _ = scenes
    state = _key_states(js, 4096, 3, zero_components=True)
    want = np.asarray(_ray_sort_key(js, jnp.asarray(state)))
    got = ray_sort_key(ts, torch.from_numpy(state)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_sort_key_matches_host_key(scenes):
    js, ts, cam = scenes
    state = _key_states(js, 4096, 4, zero_components=False)
    par = build_gen_par(ts, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    want = np.asarray(_ray_sort_key(js, jnp.asarray(state)))
    got = fused.sort_key_ref(torch.from_numpy(state), par).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[state[12] <= 0] >> 30 == 1).all() and (got[state[12] > 0] >> 30 == 0).all()
