"""The extensions reference: upstream's estimator (``render``'s docstring)
with the traffic's extensions, next-event estimation (``nee``), Russian
roulette (``russian_roulette``) and metallic-roughness scattering
(``pbr``), over the reference's own reading of the scene file.  It
imports nothing of the program.  Each extension draws on its own tags of
the hash (``render.uniform``), far above upstream's (0 jitter, 2b+1
alpha, 2b+2 scatter), so a path's other draws do not move:

* ``russian_roulette``, tag ``TAG_RR + b``: from bounce 2 on, before the
  bounce's trace, a live ray survives with p = clamp(max of its
  throughput's channels, 0.05, 1) when its draw is below p, and a
  survivor's throughput divides by p; a ray that does not survive traces
  no more segments;
* ``pbr``, tags ``TAG_PBR + 2b`` and ``+ 1``: at a shaded hit (not missed,
  not passed through) the mirror reflection of the ray about the
  interpolated normal, plus roughness times the normalised Gaussian of
  the first tag (Box–Muller as the diffuse scatter's), normalised, is
  taken when the second tag's draw is below the material's
  ``metallicFactor`` and the reflection does not point below the surface
  (its dot with the normal > 0); else the diffuse scatter.  The
  throughput takes the albedo either way.  Factors absent from a
  material read glTF's defaults, 1 and 1;
* ``nee``, tags ``TAG_NEE + 4b + {0, 1, 2}``: the emissive triangles (a
  material whose emissive texture has a texel above 0 in a colour
  channel), in the file's triangle order, make a table of areas and
  their cumulative distribution, normalised by the total.  Every shaded
  hit whose bounce was not specular picks a light triangle (the first
  whose cumulative share is not below the draw) and a point on it by the
  square-root warp (b1 = sqrt(u)·(1 - v), b2 = sqrt(u)·v).  The light
  faces the hit when both cosines (the unit shading normal's with the
  direction to the point, the light's unit geometric normal's with the
  reverse) are positive and the point is not at the hit.  Then a shadow
  ray leaves the hit lifted 1e-4 along the unit shading normal, excludes
  no triangle, and sees the light when its nearest hit t is at least
  dist·(1 - 1e-3).  A visible sample adds the throughput × albedo / π ×
  the light's emissive texture at the point's texcoords × cos·cos / dist²
  × the lights' total area.  An emissive hit then counts only where the
  previous shaded segment sampled a light: a ray that a specular bounce
  or an alpha pass-through brought there counts it, one that NEE sampled
  does not.

``render`` returns (image, path segments): shadow rays are not segments,
as the system counts them apart from its segments; the last frame's
shadow rays (the facing samples, which trace) are kept in
``shadow_rays``, its specular bounces in ``specular``.

Departures, each where the system's documented model departs from a
physical one, which the reference follows so that both compute one
estimator: the reflection takes the interpolated normal as it is,
neither normalised nor flipped toward the ray; a dielectric has no
specular lobe (``metallicFactor`` between 0 and 1 mixes a mirror metal
with a Lambertian base, and roughness only blurs the metal); NEE's
Lambertian weight applies to every shaded hit that is not specular,
metallic or not; roulette divides the throughput, and the radiance it
carries on, by p; the light table's areas are float32 sums of float32
cross products; the light pick and the hash are exact in every
precision (``dtype`` sets the precision of the rest, as in ``render``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import render as ref_render
from .plain import PlainReference
from .render import FLT_EPSILON, GAMMA, TWO_PI, _dot, _normalize, nearest_hit, sample, uniform
from .scene import Document

EXTENSIONS = ("nee", "russian_roulette", "pbr")
TAG_RR = 1 << 20
TAG_NEE = 1 << 21
TAG_PBR = 1 << 22
RR_FROM = 2  # the first bounce that rolls
RR_FLOOR = 0.05  # the least survival probability
SHADOW_LIFT = 1e-4  # the shadow ray's origin, along the unit shading normal
VISIBLE_SLACK = 1e-3  # a hit at t >= dist·(1 - slack) is the light itself


@dataclass
class LightTable:
    """The emissive triangles: ids in the file's order, their vertices,
    unit geometric normals, areas and cumulative distribution (float32,
    ending at 1), and the total area; arrays on the host, or tensors on
    the device (``to``)."""

    tri: np.ndarray  # (L,) int64
    v0: np.ndarray  # (L, 3)
    e1: np.ndarray
    e2: np.ndarray
    normal: np.ndarray
    area: np.ndarray  # (L,)
    cdf: np.ndarray  # (L,)
    total_area: float

    def to(self, device) -> "LightTable":
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self) if f.name != "total_area"})


def light_table(scene) -> LightTable | None:
    """The table of ``scene``'s emissive triangles, or None where none emits."""
    emits = np.asarray([bool((scene.textures[t].texels[:, :3] > 0).any())
                        for t in scene.mat_emissive], bool)
    tri = np.nonzero(emits[scene.material])[0].astype(np.int64)
    if tri.size == 0:
        return None
    p = scene.positions[tri]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    n = np.cross(e1, e2)
    twice = np.linalg.norm(n, axis=1)
    area = twice / np.float32(2.0)
    total = float(area.sum())
    return LightTable(tri, p[:, 0], e1, e2, n / np.maximum(twice[:, None], np.float32(1e-30)),
                      area, (np.cumsum(area) / max(total, 1e-30)).astype(np.float32), total)


def material_factors(path) -> tuple[np.ndarray, np.ndarray]:
    """(metallic, roughness) of every material of the file, float32, glTF's
    default 1 where a factor is absent."""
    pbr = [m.get("pbrMetallicRoughness", {})
           for m in Document(Path(path)).doc.get("materials", [])]
    return (np.asarray([p.get("metallicFactor", 1.0) for p in pbr] or [1.0], np.float32),
            np.asarray([p.get("roughnessFactor", 1.0) for p in pbr] or [1.0], np.float32))


def _gauss(streams, tag: int, dtype):
    u1, u2, u3, u4 = (uniform(streams, tag, w).to(dtype) for w in range(4))
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    return torch.stack([r1 * torch.cos(TWO_PI * u2), r1 * torch.sin(TWO_PI * u2),
                        r2 * torch.cos(TWO_PI * u4)], dim=-1)


class ExtReference(PlainReference):
    """The cell's scene as ``plain`` reads it, with its light table and
    its materials' factors on the device, and the traffic's extensions."""

    def __init__(self, workload, path, device):
        super().__init__(workload, path, device)
        flags = set(workload.traffic.extensions)
        unknown = flags - set(EXTENSIONS)
        if unknown:
            raise ValueError(f"reference ext computes no {sorted(unknown)}")
        self.nee = "nee" in flags
        self.rr = "russian_roulette" in flags
        self.pbr = "pbr" in flags
        dev = self.device_scene.tri.device
        self.material = torch.as_tensor(self.scene.material, device=dev)
        metallic, roughness = material_factors(path)
        self.metallic = torch.as_tensor(metallic, device=dev)
        self.roughness = torch.as_tensor(roughness, device=dev)
        table = light_table(self.scene)
        self.lights = None if table is None else table.to(dev)
        self.shadow_rays = self.specular = 0

    def render(self, seed: int, dtype=None):
        """(image, segments) of the cell's frame at ``seed``, in float32 or
        in ``dtype``; the frame's shadow rays and specular bounces in
        ``shadow_rays`` and ``specular``."""
        dtype = dtype or torch.float32
        tr = self.traffic
        ds, cam = self.device_scene, self.camera
        dev = ds.tri.device
        w, h, spp = cam.width, cam.height, tr.spp
        num_pixels = w * h
        vec = [torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in (cam.origin, cam.lower_left, cam.right, cam.up)]
        image = torch.empty((num_pixels, 3), dtype=torch.uint8, device=dev)
        segments, self.shadow_rays, self.specular = 0, 0, 0
        pixels_per_chunk = max(1, ref_render.CHUNK_RAYS // spp)
        for p0 in range(0, num_pixels, pixels_per_chunk):
            p1 = min(p0 + pixels_per_chunk, num_pixels)
            ids = torch.arange(p0 * spp, p1 * spp, dtype=torch.int64, device=dev)
            pix = ids // spp
            streams = ref_render.streams_of(seed, ids)
            sx = (pix % w).to(torch.float32) + uniform(streams, 0, 0)
            sy = (pix // w).to(torch.float32) + uniform(streams, 0, 1)
            d = _normalize((vec[1] + vec[2] * sx[:, None] + vec[3] * sy[:, None]).to(dtype))
            o = vec[0].expand_as(d).to(dtype).float()
            rad, segs = self.trace_paths(o, d.float(), streams, tr.bounces, dtype)
            segments += int(segs.sum())
            color = rad.reshape(-1, spp, 3).sum(dim=1) / spp
            encoded = torch.pow(color.float().clamp_min(0.0), 1.0 / GAMMA).nan_to_num(0.0)
            image[p0:p1] = (encoded.clamp(0.0, 0.999999) * 256.0).to(torch.uint8)
        return image.reshape(h, w, 3).cpu().numpy(), segments

    def trace_paths(self, o, d, streams, max_bounce: int, dtype):
        """Radiance (R, 3) and traced segments (R,) of the paths from (o, d)."""
        ds = self.device_scene
        n = o.shape[0]
        dev = o.device
        radiance = torch.zeros((n, 3), dtype=dtype, device=dev)
        throughput = torch.ones((n, 3), dtype=dtype, device=dev)
        segments = torch.zeros(n, dtype=torch.int64, device=dev)
        prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
        count_emissive = torch.ones(n, dtype=torch.bool, device=dev)
        live = torch.arange(n, device=dev)
        sky = torch.tensor([0.5, 0.7, 1.0], dtype=dtype, device=dev)
        nee = self.nee and self.lights is not None
        for bounce in range(max_bounce):
            if self.rr and bounce >= RR_FROM and live.numel():
                thr = throughput[live]
                p = thr.max(dim=1).values.clamp(RR_FLOOR, 1.0)
                survive = uniform(streams[live], TAG_RR + bounce).to(dtype) < p
                throughput[live] = thr / p[:, None]
                live, o, d = live[survive], o[survive], d[survive]
            if live.numel() == 0:
                break
            segments[live] += 1
            t, u, v, tri = nearest_hit(ds, o, d, prev[live], dtype)
            miss = tri < 0
            rows = live[miss]
            s = (0.5 * (d[miss, 1].to(dtype) + 1.0))[:, None]
            radiance[rows] += throughput[rows] * ((1.0 - s) + sky * s)
            hit = ~miss
            live, o, d, t, u, v, tri = (x[hit] for x in (live, o, d, t, u, v, tri))
            if live.numel() == 0:
                break
            u_, v_ = u.to(dtype)[:, None], v.to(dtype)[:, None]
            w0 = 1.0 - u_ - v_
            uv = ds.texcoords[tri].to(dtype)
            tc = uv[:, 0] * w0 + uv[:, 1] * u_ + uv[:, 2] * v_
            nv = ds.normals[tri].to(dtype)
            normal = nv[:, 0] * w0 + nv[:, 1] * u_ + nv[:, 2] * v_
            tu, tv = tc[:, 0].float(), tc[:, 1].float()
            base = sample(ds, ds.base[tri], tu, tv, dtype)
            emis = sample(ds, ds.emissive[tri], tu, tv, dtype)[:, :3]
            st = streams[live]
            shaded = ~(uniform(st, 2 * bounce + 1).to(dtype) > base[:, 3])
            new_d = _normalize(normal + _normalize(_gauss(st, 2 * bounce + 2, dtype)))
            specular = torch.zeros_like(shaded)
            if self.pbr:
                dd = d.to(dtype)
                mat = self.material[tri]
                mirror = dd - 2.0 * _dot(dd, normal)[:, None] * normal
                rough = self.roughness[mat].to(dtype)[:, None]
                spec = _normalize(mirror + rough * _normalize(_gauss(st, TAG_PBR + 2 * bounce,
                                                                     dtype)))
                below = _dot(spec, normal) <= 0.0
                draw = uniform(st, TAG_PBR + 2 * bounce + 1).to(dtype)
                specular = (draw < self.metallic[mat].to(dtype)) & ~below
                self.specular += int((shaded & specular).sum())
                new_d = torch.where(specular[:, None], spec, new_d)
            o = (o.to(dtype) + d.to(dtype) * (t.to(dtype) + FLT_EPSILON)[:, None]).float()
            counted = shaded & count_emissive[live] if nee else shaded
            rows = live[counted]
            radiance[rows] += throughput[rows] * emis[counted]
            if nee:
                sampled = shaded & ~specular
                radiance[live] += self.direct_light(o, normal, base[:, :3], throughput[live],
                                                    st, bounce, sampled, dtype)
                count_emissive[live] = torch.where(shaded, ~sampled, count_emissive[live])
            rows = live[shaded]
            throughput[rows] = throughput[rows] * base[shaded, :3]
            d = torch.where(shaded[:, None], new_d.float(), d)
            prev[live] = tri
        return radiance, segments

    def direct_light(self, x, normal, albedo, throughput, streams, bounce: int, lanes, dtype):
        """One light sample at each of ``lanes``' hits ``x`` → (R, 3) radiance:
        zero where the lane does not sample, the light faces away or the
        shadow ray is blocked."""
        ds, lt = self.device_scene, self.lights
        u_sel, u_a, u_b = (uniform(streams, TAG_NEE + 4 * bounce + k) for k in range(3))
        li = torch.searchsorted(lt.cdf, u_sel).clamp(0, lt.cdf.shape[0] - 1)
        su = torch.sqrt(u_a.to(dtype))
        b1 = (su * (1.0 - u_b.to(dtype)))[:, None]
        b2 = (su * u_b.to(dtype))[:, None]
        point = lt.v0[li].to(dtype) + lt.e1[li].to(dtype) * b1 + lt.e2[li].to(dtype) * b2
        x = x.to(dtype)
        wi = point - x
        dist_sq = _dot(wi, wi)
        dist = torch.sqrt(dist_sq)
        wi = wi / dist.clamp_min(1e-20)[:, None]
        n = normal * torch.rsqrt(_dot(normal, normal))[:, None]
        cos_x = _dot(n, wi)
        cos_y = _dot(lt.normal[li].to(dtype), -wi)
        facing = lanes & (cos_x > 0.0) & (cos_y > 0.0) & (dist_sq > 1e-12)
        light = lt.tri[li]
        uv = ds.texcoords[light].to(dtype)
        tc = uv[:, 0] * (1.0 - b1 - b2) + uv[:, 1] * b1 + uv[:, 2] * b2
        le = sample(ds, ds.emissive[light], tc[:, 0].float(), tc[:, 1].float(), dtype)[:, :3]
        rays = facing.nonzero()[:, 0]
        self.shadow_rays += int(rays.numel())
        t_shadow = torch.full_like(dist_sq, math.inf, dtype=torch.float32)
        if rays.numel():
            origin = (x + n * SHADOW_LIFT)[rays].float()
            none = torch.full((rays.numel(),), -1, dtype=torch.int64, device=x.device)
            t_shadow[rays] = nearest_hit(ds, origin, wi[rays].float(), none, dtype)[0]
        visible = facing & (t_shadow.to(dtype) >= dist * (1.0 - VISIBLE_SLACK))
        scale = (cos_x * cos_y / dist_sq.clamp_min(1e-12) * lt.total_area / math.pi)[:, None]
        return torch.where(visible[:, None], throughput * albedo * le * scale, 0.0)


prepare = ExtReference
