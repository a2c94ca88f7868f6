"""The Sponza stand-in as a lit interior with metallic-roughness
materials: the frozen Sponza writer (``sponza.write``) at the arguments it
is handed, writing through ``PbrWriter`` in place of its ``GlbWriter``.
The geometry's vertices, the textures and the camera are the Sponza
writer's; three things differ, each from a public statement:

* **Fronts.** The glTF 2.0 specification makes a triangle's
  counter-clockwise side its front, and the renderer culls back faces.
  The Sponza writer winds its triangles clockwise about the normals it
  gives their vertices, so its hall shell ("interior faces only; normals
  point inward") is culled from inside: a camera in the hall sees the sky
  through the floor, the walls and the ceiling.  Every triangle whose
  winding disagrees with its vertices' normal is rewound; the door, whose
  normals point into its wall, then faces the wall.
* **The light.** Crytek's Sponza is an atrium open to the sky, and
  upstream's renderer lights a scene by its sky,
  ``lerp(white, (0.5, 0.7, 1.0), (dir.y + 1) / 2)``
  (tigrazone/zig_raytracing_contest, ``src/stage3.zig``).  The skylight
  strip becomes that opening: stretched to the hall's 30 x 12 m roof,
  facing the hall, emitting the sky's cosine-weighted mean over the upper
  hemisphere, ``SKY`` = (7/12, 3/4, 1): the radiance by which a level
  opening gives the floor the irradiance the open sky gives it.  The
  sconces' made-up emission is dropped.  The lights NEE samples are then
  the light that lights the hall.
* **Factors.** Every material states ``metallicFactor``: 1 for the
  writer's two materials of metal (``METALS``: the window grilles' bars
  and the gold trim), 0 for the rest, glTF's two ends of metal and
  dielectric.  No public source states Sponza's roughness as a factor
  (Khronos' file keeps it in ``metallicRoughnessTexture``, which the port
  does not read), so ``roughnessFactor`` keeps glTF's default, 1.
"""

from __future__ import annotations

from unittest import mock

import numpy as np

from . import sponza
from .glb import GlbWriter

HALL_HALF_X, HALL_HALF_Z = 15.0, 6.0  # the Sponza writer's HX, HZ
SKYLIGHT, SCONCE = 22, 23  # the Sponza writer's material indices
METALS = (18, 19)  # the window grilles, the gold trim
SKY = (7.0 / 12.0, 0.75, 1.0)


class PbrWriter(GlbWriter):
    """A ``GlbWriter`` that writes the Sponza writer's calls with fronts
    counter-clockwise, the roof's opening for its skylight and a metallic
    factor on every material (the module's docstring)."""

    def add_material(self, *args, **kwargs):
        index = super().add_material(*args, **kwargs)
        mat = self.materials[index]
        mat["pbrMetallicRoughness"]["metallicFactor"] = float(index in METALS)
        if index == SKYLIGHT:
            mat["emissiveFactor"] = list(SKY)
        elif index == SCONCE:
            del mat["emissiveFactor"]
        return index

    def add_mesh(self, pos, nrm, uv, indices, material):
        if material == SKYLIGHT:
            pos = pos * np.asarray([HALL_HALF_X / np.abs(pos[:, 0]).max(), 1.0,
                                    HALL_HALF_Z / np.abs(pos[:, 2]).max()], np.float32)
        tri = np.asarray(indices).reshape(-1, 3)
        p = pos[tri].astype(np.float64)
        front = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        back = (front * nrm[tri].sum(axis=1)).sum(axis=1) < 0
        tri = np.where(back[:, None], tri[:, ::-1], tri)
        return super().add_mesh(pos, nrm, uv, tri.ravel(), material)


def write(path, detail: float = 1.0, tex: int = 192):
    """The Sponza writer's scene at ``path``, written through ``PbrWriter``."""
    with mock.patch.object(sponza, "GlbWriter", PbrWriter):
        return sponza.write(path, detail=detail, tex=tex)
