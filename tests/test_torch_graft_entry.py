"""The port's entry points (graft_entry.py) against the JAX package's
top-level ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``'s step against the JAX ``entry()`` step on the
  same tiny Cornell box (one wave of 32×32×1 rays, 2 bounces): per-pixel
  radiance, gamma-encoded, under the opaque golden gate of
  tests/test_golden.py (diff > 3 on under 0.5% of channels, mean under
  1.0), segments within 0.5%;
* ``dryrun_multichip`` over 3 CPU tiles, and the entry points' default:
  the card.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from zig_raytracing_contest_tpu_torch import graft_entry
from zig_raytracing_contest_tpu_torch.ops.linalg import vec3_to_rgb


def test_entry_step_matches_jax():
    step, args = graft_entry.entry(device="cpu")
    rows3, segs = step(*args)
    assert rows3.shape == (3, 1024) and rows3.device.type == "cpu"
    jstep, jargs = jax_graft.entry()
    pixel, radiance, jsegs = jax.jit(jstep)(*jargs)
    # one 32×32 pixel tile: the tiled slot order is the raster order
    np.testing.assert_array_equal(np.asarray(pixel), np.arange(1024))
    got = vec3_to_rgb(rows3.T).numpy().astype(int)
    want = vec3_to_rgb(torch.from_numpy(np.array(radiance))).numpy().astype(int)
    diff = np.abs(got - want)
    assert (diff > 3).mean() < 0.005, f"{(diff > 3).mean():.4%} channels off"
    assert diff.mean() < 1.0
    want_segs = int(np.asarray(jsegs).sum())
    assert abs(int(segs) - want_segs) <= 0.005 * want_segs


def test_dryrun_multichip_on_cpu_tiles():
    graft_entry.dryrun_multichip(3, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)
