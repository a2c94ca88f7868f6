"""The port's counter RNG is bit-exact against the JAX package's ops/rng.py.

The port holds uint32 values in int64 tensors masked to 32 bits (PyTorch's
CPU backend has no uint32 right shift); every draw must equal the JAX
hash bit for bit, and the uniforms must be the same f32 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_raytracing_contest_tpu.ops import rng as jrng
from zig_raytracing_contest_tpu_torch.ops import rng as trng


def _ids(seed, n=4096):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 2**31 - 1, size=n, dtype=np.int64)
    ids[:4] = [0, 1, 2**31 - 2, 2**24 + 1]
    return ids


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**32 - 1])
def test_ray_streams_bit_exact(seed):
    ids = _ids(seed % 1000)
    want = np.asarray(jrng.ray_streams(jnp.uint32(seed), jnp.asarray(ids, jnp.int32)))
    got = trng.ray_streams(seed, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("tag,word", [(0, 0), (0, 1), (3, 0), (4, 2), (9, 3)])
def test_bits_and_u01_bit_exact(tag, word):
    ids = _ids(tag * 7 + word)
    streams_j = jrng.ray_streams(jnp.uint32(3), jnp.asarray(ids, jnp.int32))
    streams_t = trng.ray_streams(3, torch.from_numpy(ids))
    bits_j = jrng._bits(streams_j, tag, word)
    bits_t = trng._bits(streams_t, tag, word)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j).astype(np.int64))
    u_j = np.asarray(jrng._u01(bits_j))
    u_t = trng._u01(bits_t).numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t.view(np.uint32), u_j.view(np.uint32))
    assert (u_t > 0).all() and (u_t < 1).all()


def test_streams_f32_round_trip():
    """State row 13 carries the streams as an f32 bit pattern."""
    ids = _ids(5)
    s = trng.ray_streams(11, torch.from_numpy(ids))
    row = trng.streams_to_f32(s)
    assert row.dtype == torch.float32
    np.testing.assert_array_equal(trng.f32_to_streams(row).numpy(), s.numpy())
    np.testing.assert_array_equal(
        row.numpy().view(np.uint32), s.numpy().astype(np.uint32)
    )
