"""The port's whole-path frame against the JAX package and the goldens.

The port renders through its main path (path_trace_gen, beam sort,
path_trace_fused, resort, path_trace_fused, unsort; the plain PyTorch
twins on the CPU) and is held against the JAX package's ``render_scene``
on the CPU (the XLA path) and against the committed goldens, with the
gates of tests/test_golden.py:

* opaque scenes: |diff| > 3 on under 0.5% of channels, mean under 1.0;
* scenes with stochastic alpha: |diff| > 2 on under 6%, mean under 1.5.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from zig_raytracing_contest_tpu.config import Config as JConfig
from zig_raytracing_contest_tpu.render.pipeline import (
    prepare_scene as jax_prepare,
    render_scene as jax_render,
)
from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene, render_scene
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc

ASSETS = Path(__file__).parent / "assets"
REPO = Path(__file__).resolve().parent.parent


def _gate(img, ref, opaque: bool, name: str):
    assert img.shape == ref.shape
    diff = np.abs(img.astype(int) - ref.astype(int))
    if opaque:
        assert (diff > 3).mean() < 0.005, f"{name}: {(diff > 3).mean():.4%} off"
        assert diff.mean() < 1.0, f"{name}: mean |diff| {diff.mean():.3f}"
    else:
        assert (diff > 2).mean() < 0.06, f"{name}: {(diff > 2).mean():.4%} off"
        assert diff.mean() < 1.5, f"{name}: mean |diff| {diff.mean():.3f}"


def _both(path, cam_kw, spp=3, max_bounce=4, seed=0):
    cfg = Config(num_samples=spp, max_bounce=max_bounce, seed=seed, wave_size=1 << 14)
    scene, cam, _ = prepare_scene(str(path), cfg, device="cpu", **cam_kw)
    img, stats = render_scene(scene, cam, cfg)
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=spp,
                   max_bounce=max_bounce, seed=seed)
    js, jcam, _ = jax_prepare(str(path), jcfg, **cam_kw)
    jimg, jstats = jax_render(js, jcam, jcfg, use_fused=False)
    return img, stats, jimg, jstats


def test_cornell_box_matches_jax(tmp_path):
    """Opaque closed box: equal segment counts, opaque gate; several waves
    (wave_size 2^14) so the wave loop and tiled-slot padding are exercised."""
    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    img, st, jimg, jst = _both(path, dict(camera_name="Camera 1", width=48, height=40),
                               spp=4, seed=3)
    assert st.segments == jst.segments
    _gate(img, jimg, True, "cornell")


def test_bench_style_scene_with_alpha_matches_jax(tmp_path):
    """Bench-style scene (repeat checker floor, clamp gradient, MASK
    cutouts, emissive panel) with single-sided quads: a back-to-back quad
    pair makes every bounce off it a rounding coin flip, which decorrelates
    any two implementations (see procedural.bench_scene)."""
    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=20, two_sided=False)
    img, st, jimg, jst = _both(path, dict(camera_name="Camera 1", width=48, height=32))
    assert abs(st.segments - jst.segments) <= 0.005 * jst.segments
    _gate(img, jimg, False, "bench-style")


GOLDEN_CASES = {
    "duckish": dict(height=96),  # aspectRatio camera: width derived
    "alpha_modes": dict(width=128, height=96),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden(name):
    """The committed goldens, at tests/test_golden.py's settings and gate
    (the opaque gate for both, as there; alpha_modes's 3075-texel bank is
    past the JAX package's one-hot budget, so this also covers banks the
    JAX package pages)."""
    cam_kw = GOLDEN_CASES[name]
    cfg = Config(grid_resolution=(16, 16, 16), num_samples=4, max_bounce=3, seed=12345)
    scene, cam, _ = prepare_scene(str(ASSETS / f"{name}.gltf"), cfg, device="cpu",
                                  **cam_kw)
    img, _ = render_scene(scene, cam, cfg)
    golden = np.asarray(Image.open(ASSETS / f"golden_{name}.png"))
    _gate(img, golden, True, name)


def test_port_imports_neither_jax_nor_pillow():
    code = (
        "import sys\n"
        "import zig_raytracing_contest_tpu_torch\n"
        "import zig_raytracing_contest_tpu_torch.render.pipeline\n"
        "import zig_raytracing_contest_tpu_torch.cli\n"
        "import zig_raytracing_contest_tpu_torch.kernels\n"
        "import zig_raytracing_contest_tpu_torch.probes.check_fetch\n"
        "import zig_raytracing_contest_tpu_torch.probes.sort_key\n"
        "import zig_raytracing_contest_tpu_torch.probes.micro_trace\n"
        "import zig_raytracing_contest_tpu_torch.probes.micro_bf16\n"
        "import zig_raytracing_contest_tpu_torch.probes.probe_gather\n"
        "import zig_raytracing_contest_tpu_torch.probes.walk_check\n"
        "import zig_raytracing_contest_tpu_torch.scene.duck\n"
        "import zig_raytracing_contest_tpu_torch.parallel.sharding\n"
        "import zig_raytracing_contest_tpu_torch.graft_entry\n"
        "import zig_raytracing_contest_tpu_torch.render.native_cpu\n"
        "import zig_raytracing_contest_tpu_torch.grid.native\n"
        "import zig_raytracing_contest_tpu_torch.bench\n"
        "import zig_raytracing_contest_tpu_torch.scene.sponza\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL'"
        ", 'zig_raytracing_contest_tpu', 'bench', 'scripts', 'sponza_builder'"
        ", 'duck_builder', 'large_sweep'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cuda_render_raises_without_cuda(tmp_path):
    """An explicit CUDA device never falls back to the CPU twins."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is for CUDA-less hosts")
    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    cfg = Config(num_samples=1, max_bounce=1)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=8, height=8,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        render_scene(scene, cam, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_scene(str(path), cfg, camera_name="Camera 1", width=8, height=8,
                      device="cuda")


def test_cli_renders_a_png(tmp_path):
    """``python -m zig_raytracing_contest_tpu_torch`` with the reference
    flags: the six phase log lines, a PNG of the requested size, and the
    ``--profile`` trace; a bad camera name fails cleanly."""
    path = tproc.cornell_like_box(tmp_path / "box.glb", glb=True)
    (tmp_path / "config.json").write_text(json.dumps(
        {"grid_resolution": [4, 4, 4], "num_threads": None, "num_samples": 2,
         "max_bounce": 3}))
    out = tmp_path / "out.png"

    def cli(*extra):
        return subprocess.run(
            [sys.executable, "-m", "zig_raytracing_contest_tpu_torch", "--in",
             str(path), "--out", str(out), "--width", "24", "--height", "16",
             "--config", str(tmp_path / "config.json"), "--device", "cpu", *extra],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )

    res = cli("--camera", "Camera 1", "--profile", str(tmp_path / "prof"))
    assert res.returncode == 0, res.stderr
    for phase in ("Loaded", "Preprocessed", "Compiled", "Rendered", "Saved", "Done"):
        assert f"{phase} in" in res.stderr
    assert "Traced" in res.stderr
    img = np.asarray(Image.open(out))
    assert img.shape == (16, 24, 3) and img.mean() > 10
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    res = cli("--camera", "Nope")
    assert res.returncode != 0 and "CameraNotFound" in res.stderr


def test_progressive_dumps_and_debug_checks(tmp_path):
    """``progressive_every`` writes a partial PNG between waves (slots not
    yet reached stay dark); ``debug_checks`` passes a finite frame."""
    path = tproc.cornell_like_box(tmp_path / "box.gltf")
    cfg = Config(num_samples=2, max_bounce=2, wave_size=2048, progressive_every=1,
                 debug_checks=True)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=40,
                                  height=40, device="cpu")
    dump = tmp_path / "partial.png"
    img, stats = render_scene(scene, cam, cfg, progressive_path=str(dump))
    partial = np.asarray(Image.open(dump))
    assert partial.shape == img.shape == (40, 40, 3)
    # the last dump precedes the last wave: some slots still dark there
    assert (partial.sum(axis=2) == 0).sum() > (img.sum(axis=2) == 0).sum()
    full, _ = render_scene(scene, cam, Config(num_samples=2, max_bounce=2))
    np.testing.assert_array_equal(img, full)  # wave size does not change the image


@pytest.mark.slow
def test_gen_twin_matches_pallas_kernel_lane_by_lane(tmp_path):
    """The port's twin of path_trace_gen against the JAX package's Pallas
    kernel in interpret mode, lane by lane, on one 1024-ray wave: rows
    12-15 (alive, streams, segments, sort key) and the winner index on
    lanes alive before the bounce exactly, value rows to f32 rounding and
    direction rows to 1e-5."""
    import jax.numpy as jnp

    from zig_raytracing_contest_tpu.render.fused import GenParams as JGen
    from zig_raytracing_contest_tpu.render.fused import path_trace_gen as jax_gen
    from zig_raytracing_contest_tpu.render.wavefront import build_gen_par as jax_par
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import build_gen_par

    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=20)
    jcfg = JConfig(grid_resolution=(8, 8, 8), num_samples=1, max_bounce=1)
    js, jcam, _ = jax_prepare(str(path), jcfg, camera_name="Camera 1", width=64,
                              height=32)
    cfg = Config(num_samples=1, max_bounce=1)
    ts, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1", width=64,
                               height=32, device="cpu")
    R = 1024
    meta = (1024, 0, 0, 9, 1, 0, 0, 0)
    jpar = jax_par(js, *(jnp.asarray(v) for v in (jcam.origin, jcam.lower_left_corner,
                                                  jcam.right, jcam.up)))
    jstate, jidx = jax_gen(
        js.mxu, jpar, jnp.asarray(meta, jnp.int32), js.shade_table_t, js.color_u16f_t,
        R, 1, js.emissive_all_dummy is not None, JGen(1, 64, 64, 32, tiles_x=2),
        emit_key=True, emit_idx=True, interpret=True,
    )
    par = build_gen_par(ts, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    state, idx = fused.path_trace_gen_ref(ts, par, meta, R, 1,
                                          fused.GenParams(1, 64, 64, 32, tiles_x=2),
                                          emit_key=True, emit_idx=True)
    a, b = state.numpy(), np.asarray(jstate)
    np.testing.assert_array_equal(a[12:16].view(np.uint32), b[12:16].view(np.uint32))
    born = fused.gen_rays_ref(par, meta, R, fused.GenParams(1, 64, 64, 32, 2))[12] > 0
    np.testing.assert_array_equal(idx.numpy()[born.numpy()],
                                  np.asarray(jidx)[0][born.numpy()])
    # Origins o + d·t cancel terms as large as the camera's z = 14 (one f32
    # ULP there is 9.5e-7) and interpret mode compiles through XLA, which
    # contracts multiply-adds into FMAs: 4 ULPs at that scale.
    for rows, tol in ((slice(0, 3), dict(rtol=3e-6, atol=4e-6)),
                      (slice(3, 6), dict(atol=1e-5)),  # libm ULPs of the scatter
                      (slice(6, 12), dict(rtol=3e-6, atol=1e-6))):
        np.testing.assert_allclose(a[rows], b[rows], **tol)
