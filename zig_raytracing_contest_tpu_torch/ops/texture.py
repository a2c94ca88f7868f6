"""Batched bilinear sampling from the flat f32 texel bank.

The port of ``zig_raytracing_contest_tpu/ops/texture.py``: the XLA shading
path's sampler over the (P, 4) ``color_data`` and the 7-float descriptors
``[offset, w, h, u_min, u_max, v_min, v_max]`` of the shade table.  The
reference's semantics (src/stage3.zig:82-123) are kept with their quirks:

* texel coordinates ``floor(w·u)`` / ``floor(h·v)``, clamped to the
  texture's bounds, or wrapped when the bounds are the repeat sentinels;
* the bilinear weights are ``frac(u) = |u - trunc(u)|`` of the RAW uv
  (src/stage3.zig:94-96,118-120), not of the scaled texel coordinate;
* the clamp path first clips uv to int32-safe bounds.

The texel indices are computed in f32, as in the JAX package.  A bank
index is clipped to ``[0, P - 1]`` before the load, as XLA clamps a gather;
every index a hit produces is in range already.
"""

from __future__ import annotations

import torch

_I32_SAFE_LO = -(2**31) + 2
_I32_SAFE_HI = 2**31 - 2


def _frac(v: torch.Tensor) -> torch.Tensor:
    return torch.abs(v - torch.trunc(v))


def _texel_pair(u, wf, lo_f, hi_f, is_repeat):
    """Texel indices (x1, x2) of one axis, in f32 (ops/texture.py
    ``_texel_pair``): repeat wraps the floored fraction, x2 = x1 + 1 mod w;
    clamp clamps floor(w·u) and floor(w·u) + 1 to [lo, hi]."""
    fu = u - torch.floor(u)
    rx1 = torch.minimum(torch.floor(wf * fu), wf - 1.0)
    rx2 = rx1 + 1.0
    rx2 = torch.where(rx2 >= wf, rx2 - wf, rx2)
    cu = torch.floor(wf * torch.clamp(u, -float(_I32_SAFE_HI), float(_I32_SAFE_HI)))
    cx1 = torch.minimum(torch.maximum(cu, lo_f), hi_f)
    cx2 = torch.minimum(torch.maximum(cu + 1.0, lo_f), hi_f)
    x1 = torch.where(is_repeat, rx1, cx1)
    x2 = torch.where(is_repeat, rx2, cx2)
    return x1.to(torch.int32), x2.to(torch.int32)


def sample_texture(data: torch.Tensor, desc_rows: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Sample a bank of textures bilinearly.

    data: (P, C) or (P,) f32 texel bank; desc_rows: (R, 7) descriptor per
    ray, int or f32-encoded (exact up to 2^24, repeat sentinels ±2^30);
    u, v: (R,) f32.  Returns (R, C) or (R,)."""
    desc_f = desc_rows.to(torch.float32)
    offset = desc_rows[:, 0].to(torch.int32)
    w = desc_rows[:, 1].to(torch.int32)
    wf = desc_f[:, 1]
    hf = desc_f[:, 2]
    # repeat mode is encoded as sentinel bounds (a negative lower bound)
    u_repeat = desc_f[:, 3] < 0.0
    v_repeat = desc_f[:, 5] < 0.0
    x1, x2 = _texel_pair(u, wf, desc_f[:, 3], desc_f[:, 4], u_repeat)
    y1, y2 = _texel_pair(v, hf, desc_f[:, 5], desc_f[:, 6], v_repeat)
    last = data.shape[0] - 1

    def pixel(x, y):
        return data[(offset + y * w + x).to(torch.int64).clamp(0, last)]

    fu = _frac(u)
    fv = _frac(v)
    if data.dim() == 2:
        fu = fu[:, None]
        fv = fv[:, None]
    r1 = pixel(x1, y1) * (1.0 - fu) + pixel(x2, y1) * fu
    r2 = pixel(x1, y2) * (1.0 - fu) + pixel(x2, y2) * fu
    return r1 * (1.0 - fv) + r2 * fv
