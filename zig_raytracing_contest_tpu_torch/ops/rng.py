"""Stateless counter-based RNG: the hash of ``zig_raytracing_contest_tpu/ops/rng.py``.

Every random draw is a pure function of (seed, global ray id, stream tag),
so a render does not depend on wave size, pixel order or device.  The
CUDA kernels (kernels/path_trace.cu) compute the same hash in uint32.

Here the uint32 values live in int64 tensors masked to 32 bits: PyTorch's
CPU backend has no right shift for uint32.  Products are split so that no
intermediate leaves the int64 range; the masked result equals the uint32
wraparound product bit for bit.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64), c a uint32 constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style avalanche finalizer on uint32 values held in int64."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def ray_streams(seed: int, global_ray_ids: torch.Tensor) -> torch.Tensor:
    """Per-ray stream state from (seed, global ray id): (R,) int64 in [0, 2^32)."""
    gid = global_ray_ids.to(torch.int64) & MASK32
    s = (int(seed) & MASK32) * 0x9E3779B9 & MASK32
    return _mix(gid ^ s ^ 0x85EBCA6B)


def _bits(streams: torch.Tensor, tag: int, word: int) -> torch.Tensor:
    """One 32-bit word of the (stream, tag) draw sequence."""
    t = (int(tag) * 2 + 1) & MASK32
    w = (word * 0x9E3779B9 + 0x6A09E667) & MASK32
    return _mix(streams ^ ((t * 0xB5297A4D) & MASK32) ^ w)


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in (0, 1): 24-bit mantissa, never exactly 0."""
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def streams_to_f32(streams: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 streams → their f32 bit pattern (state row 13)."""
    signed = torch.where(streams >= 1 << 31, streams - (1 << 32), streams)
    return signed.to(torch.int32).view(torch.float32)


def f32_to_streams(row: torch.Tensor) -> torch.Tensor:
    """State row 13 (f32 bit pattern) → int64-held uint32 streams."""
    return row.contiguous().view(torch.int32).to(torch.int64) & MASK32
