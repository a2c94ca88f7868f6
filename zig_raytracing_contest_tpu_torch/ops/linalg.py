"""Batched vector and geometry math over (..., 3) tensors.

The port of ``zig_raytracing_contest_tpu/ops/linalg.py`` (src/linalg.zig):
``dot``, ``cross``, ``length``, ``normalize``, ``ray_at``, the slab test
``ray_bbox_intersection``, Möller–Trumbore with back-face culling, the sky
``env_color`` and the gamma encode ``vec3_to_rgb``.  The XLA shading path
and the grid walk (render/wavefront.py, ops/dda.py) read them.

Every op rounds once, in the order written: a dot product is
``(a0·b0 + a1·b1) + a2·b2`` and nothing is fused into an FMA.  XLA:CPU may
contract some of these multiply-adds, so results can differ from the JAX
package's in the last bit (ROADMAP, "Parity rules").  ``length`` takes a
correctly rounded square root on every device (``sqrt_rn``).
"""

from __future__ import annotations

import torch

MT_EPSILON = 1e-8  # reference: src/linalg.zig:701
GAMMA = 2.2


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on every device: PyTorch's CPU sqrt of
    long f32 vectors is not (it misrounds ~0.7% of values), an f64 sqrt
    rounded to f32 is."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (src/linalg.zig:190-192)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product (src/linalg.zig:172-180)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the trailing axis (src/linalg.zig:119-121)."""
    return sqrt_rn(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Scale by the reciprocal length, with no epsilon, as the reference does
    (src/linalg.zig:123-125): a zero vector gives inf/NaN."""
    return a * (1.0 / length(a))[..., None]


def ray_at(orig: torch.Tensor, direction: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Point along a ray: ``orig + dir * t`` (src/linalg.zig:280-287)."""
    return orig + direction * t[..., None]


def ray_bbox_intersection(orig, direction, bbox_min, bbox_max):
    """Branchless-sign slab test → ``(hit, t_entry)`` (src/linalg.zig:324-349),
    with its sequential narrowing comparisons (y then z), so NaNs behave as
    there.  ``t_entry`` is negative when the origin is inside the box and
    is whatever the math gives on a miss: callers gate on ``hit``."""
    sign = direction < 0.0
    near = (torch.where(sign, bbox_max, bbox_min) - orig) / direction
    far = (torch.where(sign, bbox_min, bbox_max) - orig) / direction
    tmin = near[..., 0]
    tmax = far[..., 0]
    miss = (tmin > far[..., 1]) | (tmax < near[..., 1])
    tmin = torch.maximum(tmin, near[..., 1])
    tmax = torch.minimum(tmax, far[..., 1])
    miss = miss | (tmin > far[..., 2]) | (tmax < near[..., 2])
    tmin = torch.maximum(tmin, near[..., 2])
    return ~miss, tmin


def moller_trumbore(orig, direction, v0, e1, e2):
    """Batched Möller–Trumbore with back-face culling → ``(valid, t, u, v)``.

    ``valid`` is False when ``det < 1e-8`` (back-facing or parallel: the
    reference's triangles are single-sided, src/linalg.zig:705) or when
    the barycentrics leave the triangle.  ``t`` may be anything where
    ``valid`` is False, and ``t > 0`` is the caller's test
    (src/stage3.zig:174)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / det
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (det >= MT_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return valid, t, u, v


def make_mt_triangles(p0, p1, p2):
    """Möller–Trumbore form ``(v0, e1, e2)`` (src/linalg.zig:688-694)."""
    return p0, p1 - p0, p2 - p0


def env_color(direction: torch.Tensor) -> torch.Tensor:
    """Sky gradient: lerp(white → (0.5, 0.7, 1.0)) on dir.y
    (src/stage3.zig:144-150)."""
    t = 0.5 * (direction[..., 1] + 1.0)
    white = torch.ones(3, dtype=direction.dtype, device=direction.device)
    # filled on the device, not copied from the host: a CUDA graph capture
    # refuses a copy from pageable host memory
    blue = torch.full((3,), 0.5, dtype=direction.dtype, device=direction.device)
    blue[1:2].fill_(0.7)
    blue[2:3].fill_(1.0)
    return white * (1.0 - t)[..., None] + blue * t[..., None]


def vec3_to_rgb(color: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 encode a float color to u8, reference-exact for valid inputs.

    ``pow(1/2.2)``, upper-clamp at 0.999999 (the reference's ``clamp`` never
    applies its lower bound), scale by 256, truncate.  Negative and NaN
    inputs are clipped to 0 first so they cannot wrap the u8 cast."""
    encoded = torch.pow(torch.clamp_min(color, 0.0), 1.0 / GAMMA)
    encoded = torch.nan_to_num(encoded, nan=0.0)
    encoded = torch.clamp(encoded, 0.0, 0.999999) * 256.0
    return encoded.to(torch.uint8)
