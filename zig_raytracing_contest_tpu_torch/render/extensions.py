"""Opt-in rendering extensions: NEE, Russian roulette, metallic-roughness.

The port of ``zig_raytracing_contest_tpu/render/extensions.py``.  The
reference has none of them (plain recursive path tracing,
src/stage3.zig:188-220; metallic and roughness parsed and ignored,
src/stage1.zig:471-483), so they are off by default (config keys ``nee``,
``russian_roulette``, ``pbr``) and run only on the XLA shading path
(render/wavefront.py ``render_wave_xla``; on the card's bake inside the
trace, ``render_wave_shaded_trace``, whose kernels compute these functions
bit for bit).

The reference's scatter ``normalize(normal + unit_vector)`` is cosine-
weighted hemisphere sampling, so its implicit BRDF is Lambertian
``albedo/π`` and the plain estimator's weight per bounce is ``albedo``.
NEE samples the emissive triangles' area (pdf 1/total_area), and the
indirect ray then skips emissive on its next hit, so both estimators aim
at the same integral.  Russian roulette divides a survivor's throughput by
its survival probability.  Draws use the JAX package's tags, far above the
core tags (0 jitter, 2b+1 alpha, 2b+2 scatter Gaussian).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import linalg, rng
from ..ops.texture import sample_texture
from ..scene.types import COL_EMIS_DESC, COL_UV

TAG_RR = 1 << 20
TAG_NEE = 1 << 21
TAG_PBR = 1 << 22


class LightSet(NamedTuple):
    """Emissive-triangle sampling table (tensors on one device).

    tri:        (L,) int64 unique triangle ids (emissive texture and uv)
    v0/e1/e2:   (L, 3) f32 positions, v0 + e1·b1 + e2·b2
    normal:     (L, 3) f32 unit geometric normal (the side MT can hit)
    cdf:        (L,) f32 area-weighted cumulative distribution (ends at 1)
    total_area: (1,) f32
    """

    tri: torch.Tensor
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    cdf: torch.Tensor
    total_area: torch.Tensor

    def to(self, device) -> "LightSet":
        return LightSet(*(t.to(device) for t in self))


def build_light_set(geometry, materials) -> LightSet | None:
    """The triangles whose material emits (any emissive texel > 0), on the
    CPU; None when there are none."""
    if geometry.num_triangles == 0:
        return None
    emis_desc = materials.color_desc[materials.mat_emissive]  # (M, 7)
    mat_emits = np.zeros(len(emis_desc), bool)
    for m, d in enumerate(emis_desc):
        texels = materials.color_data[d[0]: d[0] + d[1] * d[2], :3]
        mat_emits[m] = bool((texels > 0).any())
    tri_ids = np.nonzero(mat_emits[geometry.material_idx])[0]
    if len(tri_ids) == 0:
        return None
    p = geometry.positions[tri_ids]  # (L, 3, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=1)  # 2 * area
    unit_n = n / np.maximum(area2[:, None], 1e-30)
    areas = area2 / 2.0
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-30)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return LightSet(
        tri=torch.from_numpy(tri_ids.astype(np.int64)),
        v0=f32(p[:, 0]), e1=f32(e1), e2=f32(e2), normal=f32(unit_n), cdf=f32(cdf),
        total_area=f32([total]),
    )


def sample_direct_light(scene, x, n, albedo, throughput, streams, bounce: int,
                        shaded, plain: bool = False, counts=None) -> torch.Tensor:
    """One NEE sample per shaded ray → its radiance contribution (R, 3):
    zero where ``shaded`` is False, the light faces away or the shadow ray
    is blocked.  ``plain`` traces the shadow rays with the twin.
    ``counts`` (3,) int64 (shadow rays, tiles, boxes): the bake's trace
    adds its rays alive (the facing lanes), tiles swept and boxes tested,
    with no operation of its own; on the grid, whose walk counts no rays,
    the facing lanes are summed (two operations) and the walk's iterations
    are not counted."""
    from .wavefront import trace_any  # wavefront imports this module

    lights = scene.lights
    u_sel = rng.uniform(streams, TAG_NEE + 4 * bounce)
    u_a = rng.uniform(streams, TAG_NEE + 4 * bounce + 1)
    u_b = rng.uniform(streams, TAG_NEE + 4 * bounce + 2)
    li = torch.searchsorted(lights.cdf, u_sel)  # side="left", as jnp's
    li = li.clamp(0, lights.cdf.shape[0] - 1)

    # a uniform point on the triangle (sqrt warp)
    su = linalg.sqrt_rn(u_a)
    b1 = (su * (1.0 - u_b))[:, None]
    b2 = (su * u_b)[:, None]
    y = lights.v0[li] + lights.e1[li] * b1 + lights.e2[li] * b2

    wi = y - x
    dist_sq = (wi * wi).sum(dim=-1)
    dist = linalg.sqrt_rn(dist_sq)
    wi = wi / torch.clamp_min(dist, 1e-20)[:, None]

    # unit shading normal: barycentric interpolation shrinks vertex normals
    n = n * torch.rsqrt((n * n).sum(dim=-1))[:, None]
    cos_x = (n * wi).sum(dim=-1)
    cos_y = (lights.normal[li] * -wi).sum(dim=-1)
    facing = shaded & (cos_x > 0.0) & (cos_y > 0.0) & (dist_sq > 1e-12)

    # shadow origin lifted along the shading normal (``x`` arrived ε below
    # the surface, where a two-sided twin quad would occlude every ray)
    x = x + n * 1e-4

    # the light's emissive texture at the interpolated uv
    lrec = scene.shade_table[lights.tri[li]]  # (R, 32)
    uv = lrec[:, COL_UV: COL_UV + 6].reshape(-1, 3, 2)
    w0 = 1.0 - b1 - b2
    tc = uv[:, 0] * w0 + uv[:, 1] * b1 + uv[:, 2] * b2
    le = sample_texture(scene.color_data, lrec[:, COL_EMIS_DESC: COL_EMIS_DESC + 7],
                        tc[:, 0], tc[:, 1])[:, :3]
    del lrec

    # any hit nearer than the light occludes (the nearest hit is the light
    # triangle itself when it is visible)
    t_sh = trace_any(scene, x, wi, facing, plain=plain, counts=counts)[0]
    if counts is not None and scene.tri_data is None:
        counts[0].add_(facing.sum())
    visible = facing & (t_sh >= dist * (1.0 - 1e-3))

    # Lambertian albedo/π × Le × G / pdf_area, pdf_area = 1/total_area
    g_term = cos_x * cos_y / torch.clamp_min(dist_sq, 1e-12)
    scale = (g_term * lights.total_area[0] / math.pi)[:, None]
    contrib = throughput * albedo * le * scale
    return torch.where(visible[:, None], contrib, 0.0)


def pbr_scatter(scene, tri, direction, normal, diffuse_dir, streams, bounce: int):
    """Metallic-roughness scatter: with probability ``metallic`` a specular
    reflection perturbed by ``roughness``, else the reference's diffuse
    direction; a specular direction below the surface is re-diffused.
    Returns (direction, take_spec)."""
    mr = scene.ext_mr[tri]  # (R, 2): metallic, roughness
    metallic = mr[:, 0]
    roughness = mr[:, 1]
    spec = direction - 2.0 * (direction * normal).sum(dim=-1)[:, None] * normal
    jitter = rng.normal3(streams, TAG_PBR + 2 * bounce)
    spec = linalg.normalize(spec + roughness[:, None] * linalg.normalize(jitter))
    below = (spec * normal).sum(dim=-1) <= 0.0
    u = rng.uniform(streams, TAG_PBR + 2 * bounce + 1)
    take_spec = (u < metallic) & ~below
    return torch.where(take_spec[:, None], spec, diffuse_dir), take_spec


def roulette(throughput, streams, bounce: int, alive):
    """Russian roulette from bounce 2 on: survive with p = clamp(max T,
    0.05, 1); survivors' throughput divides by p."""
    if bounce < 2:
        return throughput, alive
    p = torch.clamp(throughput.max(dim=-1).values, 0.05, 1.0)
    u = rng.uniform(streams, TAG_RR + bounce)
    return throughput / p[:, None], alive & (u < p)
