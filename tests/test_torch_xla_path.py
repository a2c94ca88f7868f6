"""The port's XLA shading path against the JAX package on the CPU.

* ``sample_texture`` bit for bit, on the textures of the two golden assets
  (repeat and clamp samplers) at uv far outside [0, 1];
* ``shade_and_scatter`` on the alpha asset's traced rays: ``missed`` and
  ``pass_through`` exactly, the albedo, emissive and normal and the new
  origin bit for bit, the new direction within 1e-6 (libm's log, cos and
  sin behind the Gaussian may differ by a few ULP);
* the extensions: ``build_light_set``'s arrays equal, the light selection
  at the CDF's boundaries, ``roulette`` exactly, ``pbr_scatter`` and
  ``sample_direct_light`` within the libm tolerance (1e-5 on directions
  and radiance, the specular choice exact where it is not at the
  surface's horizon);
* frames: the port's XLA path against the JAX package's ``render_scene``
  on the CPU (its XLA path), with ``backend: "grid"`` and, on the MXU
  bake, with each extension on, under the golden gates of
  tests/test_golden.py (opaque: diff > 3 on < 0.5% of pixels, mean < 1.0);
  the alpha asset's grid frame against the JAX one under the alpha-scene
  gate; the grid frame of the duckish asset against its committed golden; the
  PBR mirror's analytic error under 1.0 (tests/test_extensions.py).

Both packages render the same scene: the port's is made from the JAX
scene's arrays (``from_jax_scene``) for the function checks and by its own
loader and builder for the frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_grid import jax_xla_arrays

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.grid.builder import build_grid as jax_build_grid
from zig_raytracing_contest_tpu.ops import rng as jrng
from zig_raytracing_contest_tpu.ops.texture import sample_texture as jax_sample
from zig_raytracing_contest_tpu.render import extensions as jext
from zig_raytracing_contest_tpu.render.pipeline import prepare_scene as jax_prepare
from zig_raytracing_contest_tpu.render.pipeline import render_scene as jax_render
from zig_raytracing_contest_tpu.render.wavefront import shade_and_scatter as jax_shade
from zig_raytracing_contest_tpu.render.wavefront import trace_any as jax_trace_any
from zig_raytracing_contest_tpu.scene import procedural as jproc
from zig_raytracing_contest_tpu.scene.camera import load_camera as jcam
from zig_raytracing_contest_tpu.scene.geometry import load_geometry as jgeo
from zig_raytracing_contest_tpu.scene.gltf import load_gltf as jgltf
from zig_raytracing_contest_tpu.scene.materials import load_materials as jmat
from zig_raytracing_contest_tpu.scene.types import _desc_to_f32, build_device_scene
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.ops.rng import ray_streams
from zig_raytracing_contest_tpu_torch.ops.texture import sample_texture
from zig_raytracing_contest_tpu_torch.render import extensions, pipeline, wavefront
from zig_raytracing_contest_tpu_torch.scene.types import from_jax_scene

ASSETS = __import__("pathlib").Path(__file__).parent / "assets"
DIR_ATOL = 1e-6  # a few ULP of a unit vector: libm log/cos/sin
EXT_ATOL = 1e-5  # NEE radiance and PBR directions: rsqrt, sqrt and libm


def _asset(name, backend, res=(16, 16, 16), **cam):
    gltf = jgltf(str(ASSETS / f"{name}.gltf"))
    geo, mats = jgeo(gltf), jmat(gltf)
    js = build_device_scene(geo, jax_build_grid(geo.positions, res), mats, backend=backend)
    return jcam(gltf, **cam), geo, mats, js, from_jax_scene(jax_xla_arrays(js), device="cpu")


@pytest.mark.parametrize("name", ["duckish", "alpha_modes"])
def test_sample_texture_matches_jax(name):
    """Both samplers on every texture descriptor of the asset (f32-encoded,
    as the shade table holds them) at 4096 random uv in [-3, 4]: bit for
    bit, (P, 4) and (P,) banks."""
    gltf = jgltf(str(ASSETS / f"{name}.gltf"))
    mats = jmat(gltf)
    rng = np.random.default_rng(7)
    desc = _desc_to_f32(mats.color_desc[rng.integers(0, len(mats.color_desc), 4096)])
    u, v = (rng.uniform(-3, 4, 4096).astype(np.float32) for _ in range(2))
    u[:64] = np.round(u[:64] * 4) / 4  # texel edges
    for data in (mats.color_data, mats.color_data[:, 1].copy()):
        want = np.asarray(jax_sample(jnp.asarray(data), jnp.asarray(desc), jnp.asarray(u),
                                     jnp.asarray(v)))
        got = sample_texture(torch.from_numpy(data), torch.from_numpy(desc),
                             torch.from_numpy(u), torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _streams(seed, n):
    g = np.arange(n, dtype=np.int64) * 7 + 11
    js = jrng.ray_streams(jnp.uint32(seed), jnp.asarray(g, jnp.int32))
    ts = ray_streams(seed, torch.from_numpy(g))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    return js, ts


def test_rng_draws_match_jax():
    """The XLA path's draws: ``uniform`` and ``uniform2`` bit for bit,
    ``normal3`` (log, cos, sin) within 1e-6, at the alpha, scatter and
    extension tags."""
    from zig_raytracing_contest_tpu_torch.ops import rng

    jst, tst = _streams(21, 1 << 14)
    for tag in (1, 6, extensions.TAG_NEE + 5, extensions.TAG_PBR + 3):
        np.testing.assert_array_equal(rng.uniform(tst, tag).numpy(),
                                      np.asarray(jrng.uniform(jst, tag)))
        np.testing.assert_array_equal(rng.uniform2(tst, tag).numpy(),
                                      np.asarray(jrng.uniform2(jst, tag)))
        np.testing.assert_allclose(rng.normal3(tst, tag).numpy(),
                                   np.asarray(jrng.normal3(jst, tag)), rtol=0, atol=1e-6)


def _traced(js, cam, n=48):
    """Primary rays of an n×n grid of pixels and the JAX hits."""
    xs, ys = np.meshgrid(np.arange(n) + 0.3183, np.arange(n) + 0.618)
    xs, ys = xs * cam.width / n, ys * cam.height / n
    dirs = (cam.lower_left_corner + cam.right * xs.reshape(-1, 1).astype(np.float32)
            + cam.up * ys.reshape(-1, 1).astype(np.float32))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    orig = np.tile(cam.origin, (n * n, 1)).astype(np.float32)
    hits = [np.asarray(x) for x in jax_trace_any(js, jnp.asarray(orig), jnp.asarray(dirs),
                                                  jnp.ones(n * n, bool))]
    return orig, dirs, hits


def test_shade_and_scatter_matches_jax():
    """The alpha asset (grid backend), bounce 1: every output of the port's
    shade_and_scatter against the JAX one on the same hits and streams."""
    cam, _, _, js, ts = _asset("alpha_modes", "grid", width=64, height=48)
    orig, dirs, (t, u, v, tri) = _traced(js, cam)
    jst, tst = _streams(3, len(t))
    want = [np.asarray(x) for x in jax_shade(js, jnp.asarray(orig), jnp.asarray(dirs),
                                             jnp.asarray(t), jnp.asarray(u), jnp.asarray(v),
                                             jnp.asarray(tri), jst, 1)]
    got = [x.numpy() for x in wavefront.shade_and_scatter(
        ts, *(torch.from_numpy(a) for a in (orig, dirs, t, u, v, tri.astype(np.int64))),
        tst, 1)]
    new_o, new_d, emis, albedo, through, missed, normal = got
    hit = np.isfinite(t)
    assert 0 < (through & hit).sum() < hit.sum() and missed.sum() > 0
    np.testing.assert_array_equal(missed, want[5])
    np.testing.assert_array_equal(through, want[4])
    for a, b in ((emis, want[2]), (albedo, want[3]), (normal, want[6])):
        np.testing.assert_array_equal(a[hit].view(np.uint32), b[hit].view(np.uint32))
    np.testing.assert_array_equal(new_o[hit].view(np.uint32), want[0][hit].view(np.uint32))
    np.testing.assert_allclose(new_d[hit], want[1][hit], rtol=0, atol=DIR_ATOL)
    print(f"new direction: {(new_d[hit] != want[1][hit]).any(axis=1).sum()} of {hit.sum()} "
          f"hits differ, at most {np.abs(new_d[hit] - want[1][hit]).max():.3e}")


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """The Cornell box (its ceiling is the light) as a JAX MXU scene and the
    port's copy, 24×24."""
    path = jproc.cornell_like_box(tmp_path_factory.mktemp("box") / "box.gltf")
    gltf = jgltf(str(path))
    geo, mats = jgeo(gltf), jmat(gltf)
    js = build_device_scene(geo, jax_build_grid(geo.positions, (8, 8, 8)), mats,
                            backend="mxu")
    return path, jcam(gltf, width=24, height=24), geo, mats, js, from_jax_scene(
        jax_xla_arrays(js), device="cpu")


def test_light_set_matches_jax(box):
    """build_light_set: every array equal to the JAX one (the port's built
    from the same geometry, and carried by from_jax_scene)."""
    _, _, geo, mats, js, ts = box
    from zig_raytracing_contest_tpu_torch.scene.geometry import load_geometry
    from zig_raytracing_contest_tpu_torch.scene.gltf import load_gltf
    from zig_raytracing_contest_tpu_torch.scene.materials import load_materials

    path = box[0]
    g = load_gltf(str(path))
    own = extensions.build_light_set(load_geometry(g), load_materials(g))
    assert own is not None and js.lights is not None
    for k in jext.LightSet._fields:
        want = np.asarray(getattr(js.lights, k))
        for got in (getattr(own, k).numpy(), getattr(ts.lights, k).numpy()):
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=k)
    assert float(own.cdf[-1]) == pytest.approx(1.0)


def test_light_selection_at_cdf_boundaries():
    """NEE picks light ``searchsorted(cdf, u)`` (side left, clipped): at
    each CDF value, one f32 ULP either side, 0 and 1, the port's index
    equals jnp.searchsorted's."""
    cdf = np.cumsum(np.asarray([0.1, 0.25, 0.05, 0.3, 0.3], np.float32))
    cdf = (cdf / cdf[-1]).astype(np.float32)
    u = np.concatenate([cdf, np.nextafter(cdf, 0), np.nextafter(cdf, 2),
                        np.asarray([0.0, 1e-8, 1.0], np.float32)]).astype(np.float32)
    want = np.clip(np.asarray(jnp.searchsorted(jnp.asarray(cdf), jnp.asarray(u))), 0, 4)
    got = torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(u)).clamp(0, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:5], np.arange(5))  # u == cdf[i] picks light i


def test_roulette_matches_jax():
    """Russian roulette at bounces 1-3 on random throughput: the survivors
    and the divided throughput exactly."""
    rng = np.random.default_rng(5)
    thr = rng.uniform(0, 1.2, (4096, 3)).astype(np.float32)
    alive = rng.uniform(size=4096) < 0.8
    jst, tst = _streams(9, 4096)
    for bounce in (1, 2, 3):
        jt, ja = jext.roulette(jnp.asarray(thr), jst, bounce, jnp.asarray(alive))
        tt, ta = extensions.roulette(torch.from_numpy(thr), tst, bounce,
                                     torch.from_numpy(alive))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                      np.asarray(jt).view(np.uint32))
    assert (~ta.numpy() & alive).sum() > 0


def test_pbr_scatter_and_direct_light_match_jax(box):
    """pbr_scatter (the box's materials are fully metallic: glTF's default
    metallicFactor 1.0) and sample_direct_light on the box's traced hits:
    directions and radiance within EXT_ATOL; the specular choice exactly
    wherever the specular direction is not within 1e-5 of the horizon."""
    _, cam, _, _, js, ts = box
    orig, dirs, (t, u, v, tri) = _traced(js, cam, 32)
    jst, tst = _streams(4, len(t))
    hit = np.isfinite(t)
    bounce = 1
    jo, jd, _, jalb, jthr, _, jn = jax_shade(js, jnp.asarray(orig), jnp.asarray(dirs),
                                             jnp.asarray(t), jnp.asarray(u), jnp.asarray(v),
                                             jnp.asarray(tri), jst, bounce)
    jspec, jtake = (np.asarray(x) for x in jext.pbr_scatter(
        js, jnp.asarray(tri), jnp.asarray(dirs), jn, jd, jst, bounce))
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tspec, ttake = (x.numpy() for x in extensions.pbr_scatter(
        ts, T(tri.astype(np.int64)), T(dirs), T(jn), T(jd), tst, bounce))
    normal = np.asarray(jn)
    n_hat = normal / np.linalg.norm(normal, axis=1, keepdims=True)
    spec = dirs - 2 * (dirs * n_hat).sum(1, keepdims=True) * n_hat
    clear = hit & (np.abs((spec * n_hat).sum(1)) > 1e-5)
    assert clear.sum() > 0.9 * hit.sum() and jtake[hit].sum() > 0
    np.testing.assert_array_equal(ttake[clear], jtake[clear])
    np.testing.assert_allclose(tspec[clear], jspec[clear], rtol=0, atol=EXT_ATOL)
    print(f"pbr: {hit.sum() - clear.sum()} horizon lanes of {hit.sum()} hits, choice differs "
          f"on {(ttake[hit] != jtake[hit]).sum()}; directions differ on "
          f"{(tspec[clear] != jspec[clear]).any(axis=1).sum()}, at most "
          f"{np.abs(tspec[clear] - jspec[clear]).max():.3e}")

    thr = np.ones((len(t), 3), np.float32)
    shaded = jnp.asarray(hit)
    want = np.asarray(jext.sample_direct_light(js, jo, jn, jalb, jnp.asarray(thr), jst,
                                               bounce, shaded))
    got = extensions.sample_direct_light(ts, T(jo), T(jn), T(jalb), T(thr), tst, bounce,
                                         T(hit)).numpy()
    lit = (want > 0).any(axis=1)
    assert lit.sum() > 0.3 * hit.sum()
    np.testing.assert_array_equal((got > 0).any(axis=1), lit)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=EXT_ATOL)
    print(f"NEE: {(got != want).any(axis=1).sum()} of {lit.sum()} lit lanes differ, at most "
          f"{np.abs(got - want).max():.3e}")


def _gate(img, ref, over=3, frac=0.005, mean=1.0):
    diff = np.abs(img.astype(int) - ref.astype(int))
    assert img.shape == ref.shape
    assert (diff > over).mean() < frac, f"{(diff > over).mean():.4%} channels off"
    assert diff.mean() < mean, f"mean |diff| {diff.mean():.3f}"


@pytest.mark.parametrize("kw", [dict(backend="grid"), dict(nee=True),
                                dict(russian_roulette=True), dict(pbr=True)],
                         ids=["grid", "nee", "rr", "pbr"])
def test_frame_matches_jax(box, kw):
    """A 24×24, 4 spp, 4-bounce Cornell frame through the port's XLA path
    (its own loader and builder, waves of 2^12 rays so the last runs past
    the image) against the JAX package's on the CPU, under the opaque
    golden gate; equal segment counts."""
    path = box[0]
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=4, max_bounce=4, seed=3, **kw)
    jsc, jc, _ = jax_prepare(str(path), jcfg, width=24, height=24)
    want, jst = jax_render(jsc, jc, jcfg)
    cfg = Config(grid_resolution=(8, 8, 8), num_samples=4, max_bounce=4, seed=3,
                 wave_size=1 << 12, **kw)
    scene, cam, _ = pipeline.prepare_scene(str(path), cfg, width=24, height=24, device="cpu")
    assert wavefront.regime(scene, cfg.ext_flags).startswith("XLA shading, ")
    assert wavefront.regime(scene, cfg.ext_flags).endswith(
        "grid" if kw.get("backend") == "grid" else "tile heap")
    img, st = pipeline.render_scene(scene, cam, cfg)
    _gate(img, np.asarray(want))
    assert st.segments == jst.segments


def test_alpha_grid_frame_matches_jax():
    """The alpha asset (OPAQUE, MASK and BLEND, clamp samplers) through both
    packages' grid backends at the golden run's settings: the alpha-scene
    gate (diff > 2 on < 6% of channels, mean < 1.5; stochastic alpha
    decorrelates a path on a last-bit difference) and segments within
    0.5%."""
    path = str(ASSETS / "alpha_modes.gltf")
    kw = dict(grid_resolution=(16, 16, 16), num_samples=4, max_bounce=3, seed=12345,
              backend="grid")
    jcfg = JConfig(**kw)
    jsc, jc, _ = jax_prepare(path, jcfg, width=128, height=96)
    want, jst = jax_render(jsc, jc, jcfg)
    cfg = Config(**kw)
    scene, cam, _ = pipeline.prepare_scene(path, cfg, width=128, height=96, device="cpu")
    img, st = pipeline.render_scene(scene, cam, cfg)
    _gate(img, np.asarray(want), over=2, frac=0.06, mean=1.5)
    assert abs(st.segments - jst.segments) <= 0.005 * jst.segments


def test_grid_frame_matches_golden():
    """The duckish asset through the port's grid backend, at the golden
    run's settings (tests/test_golden.py), against the committed golden
    (rendered by the JAX MXU path): the opaque golden gate."""
    cfg = Config(grid_resolution=(16, 16, 16), num_samples=4, max_bounce=3, seed=12345,
                 backend="grid")
    scene, cam, _ = pipeline.prepare_scene(str(ASSETS / "duckish.gltf"), cfg, height=96,
                                           device="cpu")
    assert scene.tri_data is None
    img, _ = pipeline.render_scene(scene, cam, cfg)
    _gate(img, np.asarray(Image.open(ASSETS / "golden_duckish.png")))


def test_pbr_metallic_mirror(tmp_path):
    """roughness 0, metallic 1: the specular path is deterministic, so a
    floor pixel equals albedo × sky(reflect(dir)) (tests/test_extensions.py
    :91-133): the port's pbr frame within 1.0 of it on average, the
    Lambertian frame at least 3× further."""
    b = jproc.SceneBuilder()
    metal = b.add_material(base_color_factor=(0.9, 0.9, 0.9, 1.0), metallic=1.0,
                           roughness=0.0)
    p, i, n, t = jproc.quad((0, -1, 0), (8, 0, 0), (0, 0, -8))
    b.add_mesh_node(p, i, metal, normals=n, texcoords=t)
    b.add_camera_node((0, 1.5, 5), (0, -0.5, 0), yfov=0.8, name="c")
    path = b.write_gltf(tmp_path / "m.gltf")

    def render(**kw):
        cfg = Config(grid_resolution=(4, 4, 4), num_samples=4, max_bounce=3, seed=1, **kw)
        scene, cam, _ = pipeline.prepare_scene(str(path), cfg, width=32, height=32,
                                               device="cpu")
        return pipeline.render_scene(scene, cam, cfg)[0].astype(np.float64), cam

    pbr, cam = render(pbr=True)
    plain, _ = render()
    xs, ys = np.meshgrid(np.arange(32) + 0.5, np.arange(32) + 0.5)
    dirs = (cam.lower_left_corner + cam.right * xs[..., None].astype(np.float32)
            + cam.up * ys[..., None].astype(np.float32))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t_sky = 0.5 * (-dirs[..., 1] + 1.0)
    sky = np.stack([1 - 0.5 * t_sky, 1 - 0.3 * t_sky, np.ones_like(t_sky)], -1)
    expect = np.clip((0.9 * sky) ** (1 / 2.2), 0, 0.999999) * 256.0
    sel = (dirs[..., 1] < -0.05) & (ys > 24)
    err_pbr = np.abs(pbr[sel] - expect[sel]).mean()
    err_plain = np.abs(plain[sel] - expect[sel]).mean()
    assert err_pbr < 1.0, f"mirror prediction off by {err_pbr}"
    assert err_plain > err_pbr * 3


def test_render_file_and_cli_take_the_xla_path(tmp_path, monkeypatch):
    """``auto`` past MXU_BACKEND_MAX_TRIANGLES (lowered here) renders the
    grid through ``render_file``; the CLI renders ``backend: "grid"`` with
    all three extensions on with ``--device cpu`` and names the path."""
    import subprocess
    import sys

    from zig_raytracing_contest_tpu_torch.scene import types as ttypes

    path = jproc.cornell_like_box(tmp_path / "box.gltf")
    monkeypatch.setattr(ttypes, "MXU_BACKEND_MAX_TRIANGLES", 4)
    cfg = Config(grid_resolution=(4, 4, 4), num_samples=1, max_bounce=2)
    stats = pipeline.render_file(str(path), str(tmp_path / "a.png"), cfg, width=16,
                                 height=8, device="cpu")
    assert stats.segments > 0 and (tmp_path / "a.png").stat().st_size > 0
    monkeypatch.undo()
    (tmp_path / "config.json").write_text(
        '{"grid_resolution": [4, 4, 4], "num_threads": null, "num_samples": 1, '
        '"max_bounce": 2, "backend": "grid", "nee": true, "russian_roulette": true, '
        '"pbr": true}')
    res = subprocess.run(
        [sys.executable, "-m", "zig_raytracing_contest_tpu_torch", "--in", str(path),
         "--out", str(tmp_path / "b.png"), "--width", "16", "--height", "8",
         "--config", str(tmp_path / "config.json"), "--device", "cpu"],
        cwd=ASSETS.parent.parent, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Intersection backend: XLA shading, grid on cpu" in res.stderr
    assert (tmp_path / "b.png").stat().st_size > 0
