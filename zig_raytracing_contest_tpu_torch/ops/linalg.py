"""Gamma encode of the final image.

The port of ``vec3_to_rgb`` (zig_raytracing_contest_tpu/ops/linalg.py:118,
src/linalg.zig:150-159).
"""

from __future__ import annotations

import torch

GAMMA = 2.2


def vec3_to_rgb(color: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 encode a float color to u8, reference-exact for valid inputs.

    ``pow(1/2.2)``, upper-clamp at 0.999999 (the reference's ``clamp`` never
    applies its lower bound), scale by 256, truncate.  Negative and NaN
    inputs are clipped to 0 first so they cannot wrap the u8 cast.
    """
    encoded = torch.pow(torch.clamp_min(color, 0.0), 1.0 / GAMMA)
    encoded = torch.nan_to_num(encoded, nan=0.0)
    encoded = torch.clamp(encoded, 0.0, 0.999999) * 256.0
    return encoded.to(torch.uint8)
