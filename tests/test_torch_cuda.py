"""The CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only CUDA PyTorch and nvcc.  There, from the repository root
(tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Elsewhere the test skips: a CUDA kernel has no CPU mode.
chip_smoke.py runs the same comparison at the official frame's shapes.
"""

import pytest
import torch

from zig_raytracing_contest_tpu_torch.config import Config
from zig_raytracing_contest_tpu_torch.render.pipeline import prepare_scene
from zig_raytracing_contest_tpu_torch.scene import procedural as tproc


@pytest.mark.cuda
def test_kernels_match_twins_on_cuda(tmp_path):
    """Rows 12-15 and the winner index exactly; value rows to f32 rounding
    (direction rows carry the libm ULPs of rsqrt/log/sin/cos: 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from zig_raytracing_contest_tpu_torch.render import fused
    from zig_raytracing_contest_tpu_torch.render.wavefront import (
        build_gen_par,
        sort_state_payload,
    )

    path = tproc.bench_scene(tmp_path / "b.gltf", num_objects=60)
    cfg = Config(num_samples=3, max_bounce=4)
    scene, cam, _ = prepare_scene(str(path), cfg, camera_name="Camera 1",
                                  width=160, height=96, device="cuda")
    par = build_gen_par(scene, cam.origin, cam.lower_left_corner, cam.right, cam.up)
    gen = fused.GenParams(3, 160, 160, 96, tiles_x=5)
    R = 15 * 1024 * 3
    args = (scene, par, (0,) * 8, R, 1, gen)
    k, ki = fused.path_trace_gen(*args, emit_key=True, emit_idx=True)
    t, ti = fused.path_trace_gen_ref(*args, emit_key=True, emit_idx=True)
    assert torch.equal(k[12:16].view(torch.int32), t[12:16].view(torch.int32))
    assert torch.equal(ki, ti)
    torch.testing.assert_close(k[0:12], t[0:12], rtol=3e-6, atol=1e-5)
    _, st, (idx,) = sort_state_payload(k[15].contiguous().view(torch.int32), k, (ki,))
    k2 = fused.path_trace_fused(scene, st, 3, bounce0=1, prev=idx)
    t2 = fused.path_trace_fused_ref(scene, st, 3, bounce0=1, prev=idx)
    # (row 13 holds RNG streams as f32 bit patterns, some of them NaN)
    assert torch.equal(k2[12:16].view(torch.int32), t2[12:16].view(torch.int32))
    torch.testing.assert_close(k2[0:12], t2[0:12], rtol=3e-6, atol=1e-5)
