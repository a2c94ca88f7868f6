"""The port's shade twin against the JAX package's XLA shading round.

``shade_ref`` (the port of ``fused._shade_live`` with the non-tiled
``_prep_math``) must update the ray state as ``wavefront.shade_and_scatter``
plus the caller's mask arithmetic does (built as tests/test_fused.py
builds it), from the same hits, streams and state.  Rows 12-14 (alive,
streams, segments) exactly; other rows to rtol 3e-6 / atol 1e-6 (f32
reassociation of the sky and emissive blends); direction rows to 1e-5
(log/cos/sin/rsqrt differ by a few ULP between libm implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bake import jax_scene_arrays

from zig_raytracing_contest_tpu.grid.builder import build_grid
from zig_raytracing_contest_tpu.ops import linalg, rng
from zig_raytracing_contest_tpu.scene.camera import load_camera
from zig_raytracing_contest_tpu.scene.geometry import load_geometry
from zig_raytracing_contest_tpu.scene.gltf import load_gltf
from zig_raytracing_contest_tpu.scene.materials import load_materials
from zig_raytracing_contest_tpu.scene.types import build_device_scene
from zig_raytracing_contest_tpu.render.wavefront import shade_and_scatter, trace_any
from zig_raytracing_contest_tpu_torch.render.fused import shade_ref
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc
from zig_raytracing_contest_tpu_torch.scene.types import from_jax_scene

W, H = 64, 48
R = W * H


@pytest.fixture(scope="module")
def scene_and_rays(tmp_path_factory):
    d = tmp_path_factory.mktemp("shade")
    # bench-style: repeat checker floor, clamp gradient, MASK cutout, light
    g = load_gltf(str(tproc.bench_scene(d / "b.gltf", num_objects=60)))
    cam = load_camera(g, "Camera 1", W, H)
    geo = load_geometry(g)
    js = build_device_scene(geo, build_grid(geo.positions, (8, 8, 8)),
                            load_materials(g), backend="mxu")
    P = js.color_data.shape[0]
    ts = from_jax_scene(jax_scene_arrays(js), device="cpu")
    rs = np.random.default_rng(99)
    xs = (np.arange(R) % W + rs.uniform(size=R)).astype(np.float32)
    ys = (np.arange(R) // W + rs.uniform(size=R)).astype(np.float32)
    dirs = cam.lower_left_corner + cam.right * xs[:, None] + cam.up * ys[:, None]
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    orig = np.tile(cam.origin, (R, 1)).astype(np.float32)
    return js, ts, orig, dirs


@pytest.mark.parametrize("bounce", [0, 2])
def test_shade_matches_xla_round(scene_and_rays, bounce):
    js, ts, orig, dirs = scene_and_rays
    rs = np.random.default_rng(bounce)
    alive = rs.uniform(size=R) < 0.85
    throughput = rs.uniform(0.2, 1.0, (R, 3)).astype(np.float32)
    radiance = rs.uniform(0.0, 0.3, (R, 3)).astype(np.float32)
    streams = rng.ray_streams(jnp.uint32(5 + bounce), jnp.arange(R, dtype=jnp.int32))
    o, d, al = jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(alive)
    t, u, v, tri = trace_any(js, o, d, al)
    assert int(jnp.isfinite(t).sum()) > R // 4

    # --- the XLA round + mask updates (render_wave's loop body)
    new_orig, new_dir, emissive, albedo, pass_through, missed, _ = shade_and_scatter(
        js, o, d, t, u, v, tri, streams, bounce
    )
    tp, rad = jnp.asarray(throughput), jnp.asarray(radiance)
    rad_x = rad + jnp.where((al & missed)[:, None], tp * linalg.env_color(d), 0.0)
    shaded = al & ~missed & ~pass_through
    rad_x = rad_x + jnp.where(shaded[:, None], tp * emissive, 0.0)
    tput_x = jnp.where(shaded[:, None], tp * albedo, tp)
    stepped = al & ~missed
    orig_x = jnp.where(stepped[:, None], new_orig, o)
    dir_x = jnp.where(stepped[:, None], new_dir, d)
    assert int((al & pass_through & ~missed).sum()) > 0, "alpha path unexercised"

    # --- the port, from the same hits (Morton index of each winner)
    inv_perm = np.argsort(np.asarray(js.mxu.perm)[: js.shade_table.shape[0]])
    t_np = np.asarray(t)
    hit = np.isfinite(t_np)
    idx_m = torch.from_numpy(np.where(hit, inv_perm[np.asarray(tri)], 0))
    state = torch.zeros(16, R)
    state[0:3] = torch.from_numpy(orig.T.copy())
    state[3:6] = torch.from_numpy(dirs.T.copy())
    state[6:9] = torch.from_numpy(throughput.T.copy())
    state[9:12] = torch.from_numpy(radiance.T.copy())
    state[12] = torch.from_numpy(alive.astype(np.float32))
    state[13] = torch.from_numpy(
        np.array(jax.lax.bitcast_convert_type(streams, jnp.float32))
    )
    t_t = torch.from_numpy(t_np.copy())
    rec = torch.where(torch.from_numpy(hit)[None, :], ts.rec_table[:, idx_m], 0.0)
    out = shade_ref(state, t_t, torch.from_numpy(np.asarray(u).copy()),
                    torch.from_numpy(np.asarray(v).copy()), rec, ts.bank, bounce,
                    ts.emissive_dummy).numpy()

    np.testing.assert_array_equal(out[12] > 0, np.asarray(stepped))
    np.testing.assert_array_equal(out[13].view(np.uint32), np.asarray(streams))
    np.testing.assert_array_equal(out[14], alive.astype(np.float32))
    np.testing.assert_allclose(out[0:3].T, np.asarray(orig_x), rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(out[3:6].T, np.asarray(dir_x), atol=1e-5)
    np.testing.assert_allclose(out[6:9].T, np.asarray(tput_x), rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(out[9:12].T, np.asarray(rad_x), rtol=3e-6, atol=1e-6)
    # a dead ray's state passes through untouched
    np.testing.assert_array_equal(out[:, ~alive], state.numpy()[:, ~alive])
