"""The reference's own reading of a glTF 2.0 / GLB scene, in NumPy.

Written for the benchmark and independent of the program: the document,
its buffers and accessors, node transforms, the perspective camera, the
triangles with their world normals and texcoords, and the materials'
textures decoded from PNG.  It follows the semantics of the upstream
renderer (tigrazone/zig_raytracing_contest, src/stage1.zig):

* a node's world transform is its parent chain of matrix or TRS
  transforms; positions take the whole transform, normals its 3x3 part,
  renormalized;
* the camera's basis is ``fwd = -z`` of its node, ``right =
  normalize(fwd x world_up)``, ``up = fwd x right`` (pointing world-down,
  so image row 0 is the top), with the focal length from ``yfov``; a
  camera with an aspect ratio takes one of width and height;
* PNG texels load as stb's ``loadf``: colour channels ``(x/255)^2.2``,
  alpha ``x/255``;
* a material's base texture is the base image times ``baseColorFactor``
  with its opacity in channel 3: the alpha channel thresholded by
  ``alphaCutoff`` in MASK mode, the alpha itself in BLEND mode, where the
  image has alpha, and 1 otherwise; the emissive texture is the emissive
  image times ``emissiveFactor``; a missing texture is its factor.
  A CLAMP_TO_EDGE sampler clamps an axis, anything else repeats.

Every array is float32 and computed in the order written, so the camera
and the texels are the ones the upstream loader makes.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from urllib.parse import unquote

import numpy as np

_COMPONENTS = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
               5125: np.uint32, 5126: np.float32}
_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
CLAMP_TO_EDGE = 33071
LDR_GAMMA = 2.2


@dataclass
class Texture:
    """RGBA float32 texels, row-major from the top, and the wrap per axis."""

    width: int
    height: int
    texels: np.ndarray  # (height * width, 4) float32
    repeat_u: bool
    repeat_v: bool


@dataclass
class RefCamera:
    width: int
    height: int
    origin: np.ndarray
    lower_left: np.ndarray
    right: np.ndarray
    up: np.ndarray


@dataclass
class RefScene:
    """Triangles (T, 3, 3) positions and normals, (T, 3, 2) texcoords and
    (T,) material ids; per material its base and emissive texture ids into
    ``textures``."""

    positions: np.ndarray
    normals: np.ndarray
    texcoords: np.ndarray
    material: np.ndarray
    mat_base: np.ndarray
    mat_emissive: np.ndarray
    textures: list

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


# --------------------------------------------------------------------------
# PNG


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if kind == 0:
            out = line
        elif kind == 2:
            out = (line + prev) & 255
        else:
            out = line.copy()
            for i in range(stride):
                left = out[i - bpp] if i >= bpp else 0
                if kind == 1:
                    out[i] = (out[i] + left) & 255
                elif kind == 3:
                    out[i] = (out[i] + ((left + prev[i]) >> 1)) & 255
                elif kind == 4:
                    up_left = prev[i - bpp] if i >= bpp else 0
                    out[i] = (out[i] + _paeth(left, prev[i], up_left)) & 255
                else:
                    raise ValueError(f"PNG: unknown filter {kind}")
        rows[y] = out
        prev = out
    return rows


def decode_png(data: bytes) -> tuple[np.ndarray, int]:
    """8-bit grey, grey+alpha, RGB or RGBA PNG → ((h, w, 4) uint8, the
    source's channel count)."""
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError("only PNG images are read")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    width, height, depth, ctype, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG: colour type {ctype} at depth {depth} is not read")
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    px = rows.reshape(height, width, channels)
    opaque = np.full((height, width, 1), 255, np.uint8)
    if channels == 1:
        px = np.concatenate([px, px, px, opaque], -1)
    elif channels == 2:
        px = np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], -1)
    elif channels == 3:
        px = np.concatenate([px, opaque], -1)
    return px, channels


def load_texels(data: bytes) -> tuple[int, int, int, np.ndarray]:
    """(width, height, channels, (h·w, 4) float32 as stb's loadf)."""
    rgba, channels = decode_png(data)
    f = rgba.astype(np.float32) / 255.0
    out = np.empty_like(f)
    out[..., :3] = f[..., :3] ** LDR_GAMMA
    out[..., 3] = f[..., 3]
    h, w = f.shape[:2]
    return w, h, channels, out.reshape(h * w, 4).astype(np.float32)


# --------------------------------------------------------------------------
# glTF


class Document:
    def __init__(self, path: Path):
        raw = path.read_bytes()
        binary = None
        if raw[:4] == b"glTF":
            pos = 12
            while pos + 8 <= len(raw):
                length, kind = struct.unpack_from("<II", raw, pos)
                chunk = raw[pos + 8:pos + 8 + length]
                if kind == 0x4E4F534A:
                    self.doc = json.loads(chunk)
                elif kind == 0x004E4942:
                    binary = bytes(chunk)
                pos += 8 + length + (-length % 4)
        else:
            self.doc = json.loads(raw)
        self.base = path.parent
        self.buffers = [binary if i == 0 and "uri" not in b else self._uri(b["uri"])
                        for i, b in enumerate(self.doc.get("buffers", []))]

    def _uri(self, uri: str) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        return (self.base / unquote(uri)).read_bytes()

    def view_bytes(self, index: int) -> bytes:
        view = self.doc["bufferViews"][index]
        start = view.get("byteOffset", 0)
        return self.buffers[view["buffer"]][start:start + view["byteLength"]]

    def accessor(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        n, comps = acc["count"], _COUNTS[acc["type"]]
        dtype = np.dtype(_COMPONENTS[acc["componentType"]])
        view = self.doc["bufferViews"][acc["bufferView"]]
        size = dtype.itemsize * comps
        stride = view.get("byteStride", size)
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        buf = np.frombuffer(self.buffers[view["buffer"]], np.uint8,
                            stride * (n - 1) + size, start)
        rows = np.lib.stride_tricks.as_strided(buf, (n, size), (stride, 1))
        return np.ascontiguousarray(rows).view(dtype).reshape(n, comps)

    def local(self, index: int) -> np.ndarray:
        node = self.doc["nodes"][index]
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
        x, y, z, w = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
        s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
        rot = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot * s[None, :]
        m[:3, 3] = t
        return m

    def world(self, index: int) -> np.ndarray:
        parent = {c: i for i, n in enumerate(self.doc.get("nodes", []))
                  for c in n.get("children", [])}
        m = self.local(index)
        while index in parent:
            index = parent[index]
            m = self.local(index) @ m
        return m


def read_camera(doc: Document, name: str | None, width: int | None,
                height: int | None) -> RefCamera:
    cams = doc.doc["cameras"]
    ci = 0 if name is None else next(i for i, c in enumerate(cams) if c.get("name") == name)
    node = next(i for i, n in enumerate(doc.doc["nodes"]) if n.get("camera") == ci)
    persp = cams[ci]["perspective"]
    aspect = persp.get("aspectRatio")
    if width is None:
        width = int(np.float32(height) * np.float32(aspect))
    if height is None:
        height = int(np.float32(width) / np.float32(aspect))
    m = doc.world(node).astype(np.float32)
    origin = m[:3, 3]
    fwd = -m[:3, 2]
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(fwd, right)
    focal = (np.float32(height) / 2) / np.tan(np.float32(persp["yfov"]) / 2)
    lower_left = fwd * focal - right * (np.float32(width) / 2) - up * (np.float32(height) / 2)
    f32 = np.float32
    return RefCamera(width, height, origin.astype(f32), lower_left.astype(f32),
                     right.astype(f32), up.astype(f32))


def _texture(doc: Document, images: dict, info, factor, opacity_rule) -> Texture:
    if info is None:
        texel = np.asarray([*factor[:3], 1.0], np.float32)[None]
        return Texture(1, 1, texel, False, False)
    tex = doc.doc["textures"][info["index"]]
    src = tex["source"]
    if src not in images:
        image = doc.doc["images"][src]
        data = doc.view_bytes(image["bufferView"]) if "bufferView" in image \
            else doc._uri(image["uri"])
        images[src] = load_texels(data)
    w, h, channels, px = images[src]
    texels = np.empty((w * h, 4), np.float32)
    texels[:, :3] = px[:, :3] * np.asarray(factor[:3], np.float32)
    texels[:, 3] = opacity_rule(px[:, 3], channels)
    sampler = doc.doc["samplers"][tex["sampler"]] if "sampler" in tex else {}
    return Texture(w, h, texels, sampler.get("wrapS") != CLAMP_TO_EDGE,
                   sampler.get("wrapT") != CLAMP_TO_EDGE)


def read_scene(path, camera: str | None = "Camera 1", width=None, height=None):
    """(RefScene, RefCamera) of the scene file at ``path``."""
    doc = Document(Path(path))
    pos, nrm, uv, mat = [], [], [], []
    for ni, node in enumerate(doc.doc.get("nodes", [])):
        if "mesh" not in node:
            continue
        m = doc.world(ni)
        rot = m[:3, :3]
        for prim in doc.doc["meshes"][node["mesh"]]["primitives"]:
            attrs = prim["attributes"]
            idx = doc.accessor(prim["indices"]).reshape(-1).astype(np.int64)
            idx = idx[: idx.size // 3 * 3].reshape(-1, 3)
            p = doc.accessor(attrs["POSITION"]).astype(np.float32)
            pos.append((p @ rot.T + m[:3, 3])[idx])
            if "NORMAL" in attrs:
                n = doc.accessor(attrs["NORMAL"]).astype(np.float32) @ rot.T
                nrm.append((n / np.linalg.norm(n, axis=-1, keepdims=True))[idx])
            else:
                nrm.append(np.zeros((len(idx), 3, 3), np.float32))
            if "TEXCOORD_0" in attrs:
                uv.append(doc.accessor(attrs["TEXCOORD_0"]).astype(np.float32)[idx])
            else:
                uv.append(np.zeros((len(idx), 3, 2), np.float32))
            mat.append(np.full(len(idx), prim["material"], np.int64))

    images: dict = {}
    textures, mat_base, mat_emis = [], [], []
    for material in doc.doc.get("materials", []):
        pbr = material.get("pbrMetallicRoughness", {})
        mode = material.get("alphaMode", "OPAQUE")
        cutoff = np.float32(material.get("alphaCutoff", 0.5))

        def opacity(alpha, channels, mode=mode, cutoff=cutoff):
            if mode == "OPAQUE" or channels not in (2, 4):
                return np.float32(1.0)
            return (alpha > cutoff).astype(np.float32) if mode == "MASK" else alpha

        mat_base.append(len(textures))
        textures.append(_texture(doc, images, pbr.get("baseColorTexture"),
                                 pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), opacity))
        mat_emis.append(len(textures))
        textures.append(_texture(doc, images, material.get("emissiveTexture"),
                                 material.get("emissiveFactor", [0.0, 0.0, 0.0]),
                                 lambda alpha, channels: np.float32(1.0)))
    scene = RefScene(
        np.concatenate(pos).astype(np.float32), np.concatenate(nrm).astype(np.float32),
        np.concatenate(uv).astype(np.float32), np.concatenate(mat),
        np.asarray(mat_base, np.int64), np.asarray(mat_emis, np.int64), textures)
    return scene, read_camera(doc, camera, width, height)
