"""The Sponza writer's GLB container: a frozen copy of the port's
``GlbWriter`` and ``uv_sphere``
(``zig_raytracing_contest_tpu_torch/scene/duck.py``)."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from .png import encode_srgb_png_bytes

WRAP_REPEAT = 10497
WRAP_CLAMP = 33071


class GlbWriter:
    """Accumulates meshes/materials/images and writes a single-buffer GLB."""

    def __init__(self):
        self.bin = bytearray()
        self.buffer_views = []
        self.accessors = []
        self.meshes = []
        self.nodes = []
        self.materials = []
        self.images = []
        self.textures = []
        self.samplers = []
        self.cameras = []
        self.scene_roots = []

    def _align(self, n=4):
        while len(self.bin) % n:
            self.bin.append(0)

    def add_view(self, data: bytes, stride: int | None = None, target=None):
        self._align()
        view = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride is not None:
            view["byteStride"] = stride
        if target is not None:
            view["target"] = target
        self.bin.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def add_accessor(self, view, comp_type, count, type_, offset=0, minmax=None):
        acc = {
            "bufferView": view,
            "byteOffset": offset,
            "componentType": comp_type,
            "count": count,
            "type": type_,
        }
        if minmax is not None:
            acc["min"], acc["max"] = minmax
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_mesh(self, pos, nrm, uv, indices, material):
        """One primitive from an INTERLEAVED vertex buffer (stride 32:
        3f position + 3f normal + 2f texcoord) and u16 indices."""
        n = pos.shape[0]
        inter = np.empty((n, 8), np.float32)
        inter[:, 0:3] = pos
        inter[:, 3:6] = nrm
        inter[:, 6:8] = uv
        vview = self.add_view(inter.tobytes(), stride=32, target=34962)
        iview = self.add_view(np.asarray(indices, np.uint16).tobytes(), target=34963)
        a_pos = self.add_accessor(vview, 5126, n, "VEC3", 0,
                                  minmax=(pos.min(0).tolist(), pos.max(0).tolist()))
        a_nrm = self.add_accessor(vview, 5126, n, "VEC3", 12)
        a_uv = self.add_accessor(vview, 5126, n, "VEC2", 24)
        a_idx = self.add_accessor(iview, 5123, len(indices), "SCALAR")
        self.meshes.append({"primitives": [{
            "attributes": {"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv},
            "indices": a_idx,
            "material": material,
            "mode": 4,
        }]})
        return len(self.meshes) - 1

    def add_node(self, mesh=None, camera=None, translation=None, rotation=None,
                 scale=None, children=None, root=True):
        node = {}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if translation is not None:
            node["translation"] = list(map(float, translation))
        if rotation is not None:
            node["rotation"] = list(map(float, rotation))  # xyzw quaternion
        if scale is not None:
            node["scale"] = list(map(float, scale))
        if children is not None:
            node["children"] = children
        self.nodes.append(node)
        idx = len(self.nodes) - 1
        if root:
            self.scene_roots.append(idx)
        return idx

    def add_png_texture(self, rgba: np.ndarray, wrap=WRAP_REPEAT):
        view = self.add_view(encode_srgb_png_bytes(rgba))
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.samplers.append({"wrapS": wrap, "wrapT": wrap})
        self.textures.append({"source": len(self.images) - 1,
                              "sampler": len(self.samplers) - 1})
        return len(self.textures) - 1

    def add_material(self, base_factor=None, base_texture=None, emissive=None,
                     alpha_mode=None, alpha_cutoff=None):
        pbr = {}
        if base_factor is not None:
            pbr["baseColorFactor"] = list(map(float, base_factor))
        if base_texture is not None:
            pbr["baseColorTexture"] = {"index": base_texture}
        mat = {"pbrMetallicRoughness": pbr}
        if emissive is not None:
            mat["emissiveFactor"] = list(map(float, emissive))
        if alpha_mode is not None:
            mat["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            mat["alphaCutoff"] = float(alpha_cutoff)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_camera(self, yfov, aspect, znear=0.01, name="DuckCam"):
        self.cameras.append({
            "type": "perspective",
            "perspective": {"yfov": float(yfov), "aspectRatio": float(aspect),
                            "znear": float(znear)},
            "name": name,
        })
        return len(self.cameras) - 1

    def write(self, path: Path):
        self._align()
        doc = {
            "asset": {"version": "2.0", "generator": "duck_builder (spec-direct)"},
            "scene": 0,
            "scenes": [{"nodes": self.scene_roots}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self.bin)}],
            "materials": self.materials,
        }
        if self.images:
            doc["images"] = self.images
            doc["samplers"] = self.samplers
            doc["textures"] = self.textures
        if self.cameras:
            doc["cameras"] = self.cameras
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        total = 12 + 8 + len(js) + 8 + len(self.bin)
        out = bytearray()
        out += struct.pack("<III", 0x46546C67, 2, total)
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin)
        Path(path).write_bytes(out)
        return Path(path)


# ---------------------------------------------------------------------------
# Parametric duck geometry
# ---------------------------------------------------------------------------


def uv_sphere(nu=48, nv=32, radii=(1, 1, 1), squash=None):
    """Lat-long sphere: positions, normals, uvs, u16 indices."""
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v)
    x = np.cos(uu) * np.sin(vv)
    y = np.cos(vv)
    z = np.sin(uu) * np.sin(vv)
    p = np.stack([x, y, z], -1)
    if squash is not None:
        p = squash(p)
    pos = (p * np.asarray(radii)).reshape(-1, 3).astype(np.float32)
    # Normals of the scaled sphere: n ∝ p / radii² (gradient of the
    # implicit ellipsoid); close enough for the squashed variants too.
    nrm = (p / np.square(np.asarray(radii))).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    uvs = np.stack([uu / (2 * np.pi), vv / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + nu + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return pos, nrm, uvs, np.asarray(idx, np.uint16)
