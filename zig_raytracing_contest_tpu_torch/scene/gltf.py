"""Pure-Python glTF 2.0 / GLB document parser.

A copy of ``zig_raytracing_contest_tpu/scene/gltf.py`` that decodes images
with the port's own zlib + NumPy PNG codec (utils/image_io.py).

Replacement for the reference's zgltf submodule + loader stage1
(src/stage1.zig:75-110).  Host-side by design: the reference also parses on
the CPU outside the render timer.  Supported surface mirrors the subset the
reference consumes (SURVEY.md C5-C9) plus safe supersets:

* .gltf JSON and .glb containers; buffer 0 may be GLB-embedded
  (src/stage1.zig:86-95); external buffers/images by URI; base64 data URIs
  (superset — the reference would fail on them).
* Strided accessors for VEC3/VEC2 float and SCALAR u8/u16/u32 indices
  (reference supports only u16, src/stage1.zig:159-162 — superset).
* Node global transforms (matrix or TRS, parent-chain composition) like
  zgltf's getGlobalTransform.
* Perspective cameras, materials (pbrMetallicRoughness base color, emissive,
  alphaMode/alphaCutoff), samplers (wrap modes), textures, images.

Image decode fans out across a host thread pool, mirroring the reference's
round-robin image decode workers (src/stage1.zig:30-66) — it is I/O/zlib-bound
host work, so OS threads are the right tool.
"""

from __future__ import annotations

import base64
import json
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.image_io import DecodedImage, decode_image

GLB_MAGIC = 0x46546C67
GLB_CHUNK_JSON = 0x4E4F534A
GLB_CHUNK_BIN = 0x004E4942

COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

WRAP_CLAMP_TO_EDGE = 33071
WRAP_REPEAT = 10497


class GltfError(ValueError):
    pass


@dataclass
class Gltf:
    """Parsed document: raw JSON dict + resolved binary payloads."""

    doc: dict
    buffers: list[bytes]
    images: list[DecodedImage] = field(default_factory=list)
    base_dir: Path = Path(".")

    # ---- node graph -------------------------------------------------------

    def _parent_map(self) -> dict[int, int]:
        parents: dict[int, int] = {}
        for i, node in enumerate(self.doc.get("nodes", [])):
            for child in node.get("children", []):
                parents[child] = i
        return parents

    def local_transform(self, node_idx: int) -> np.ndarray:
        """Node local transform as a (4, 4) float32 matrix (M[row, col])."""
        node = self.doc["nodes"][node_idx]
        if "matrix" in node:
            # glTF stores column-major.
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
        q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
        s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
        x, y, z, w = q
        rot = np.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot * s[None, :]
        m[:3, 3] = t
        return m

    def global_transform(self, node_idx: int) -> np.ndarray:
        """World = parent chain composition (zgltf getGlobalTransform)."""
        parents = self._parent_map()
        m = self.local_transform(node_idx)
        cur = node_idx
        seen = {cur}
        while cur in parents:
            cur = parents[cur]
            if cur in seen:
                raise GltfError("node graph cycle")
            seen.add(cur)
            m = self.local_transform(cur) @ m
        return m

    # ---- accessors --------------------------------------------------------

    def accessor_array(self, accessor_idx: int) -> np.ndarray:
        """Read an accessor to a contiguous (count, components) array.

        Handles bufferView byteStride (strided interleaved vertex data) like
        the reference's Accessor(T) (src/stage1.zig:131-201).  Sparse
        accessors and missing bufferViews read as zeros (glTF spec default).
        """
        acc = self.doc["accessors"][accessor_idx]
        count = acc["count"]
        ncomp = TYPE_COUNTS[acc["type"]]
        dtype = np.dtype(COMPONENT_DTYPES[acc["componentType"]])
        if "bufferView" not in acc:
            return np.zeros((count, ncomp), dtype)
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        elem_size = dtype.itemsize * ncomp
        stride = view.get("byteStride", elem_size)
        base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        raw = np.frombuffer(
            buf, dtype=np.uint8, count=stride * (count - 1) + elem_size, offset=base
        )
        strided = np.lib.stride_tricks.as_strided(
            raw.view(np.uint8), shape=(count, elem_size), strides=(stride, 1)
        )
        return np.ascontiguousarray(strided).view(dtype).reshape(count, ncomp)


def _resolve_uri(uri: str, base_dir: Path) -> bytes:
    if uri.startswith("data:"):
        header, b64 = uri.split(",", 1)
        if ";base64" not in header:
            raise GltfError(f"unsupported data URI encoding: {header}")
        return base64.b64decode(b64)
    from urllib.parse import unquote

    return (base_dir / unquote(uri)).read_bytes()


def _parse_glb(data: bytes) -> tuple[dict, bytes | None]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise GltfError("bad GLB magic")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset = 12
    doc = None
    binary = None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len + (-chunk_len % 4)
        if chunk_type == GLB_CHUNK_JSON:
            doc = json.loads(chunk)
        elif chunk_type == GLB_CHUNK_BIN:
            binary = bytes(chunk)
    if doc is None:
        raise GltfError("GLB missing JSON chunk")
    return doc, binary


def load_gltf(path: str | Path, num_threads: int = 8) -> Gltf:
    """Parse a .gltf/.glb file, resolve buffers, decode all images.

    Mirrors stage1.loadGltfFile (src/stage1.zig:75-110): buffer 0 without a
    URI binds to the GLB-embedded chunk; image decode runs on a host thread
    pool (the reference forks OS threads round-robin over images).
    """
    path = Path(path)
    base_dir = path.parent
    raw = path.read_bytes()

    if raw[:4] == b"glTF":
        doc, glb_binary = _parse_glb(raw)
    else:
        doc, glb_binary = json.loads(raw), None

    buffers: list[bytes] = []
    for i, buffer in enumerate(doc.get("buffers", [])):
        if i == 0 and "uri" not in buffer:
            if glb_binary is None:
                raise GltfError("buffer 0 has no URI and no GLB binary chunk")
            buffers.append(glb_binary)
        else:
            buffers.append(_resolve_uri(buffer["uri"], base_dir))

    gltf = Gltf(doc=doc, buffers=buffers, base_dir=base_dir)

    def decode_one(image: dict) -> DecodedImage:
        if "bufferView" in image:
            view = doc["bufferViews"][image["bufferView"]]
            begin = view.get("byteOffset", 0)
            data = buffers[view["buffer"]][begin : begin + view["byteLength"]]
        else:
            data = _resolve_uri(image["uri"], base_dir)
        return decode_image(data)

    images = doc.get("images", [])
    if images:
        with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
            gltf.images = list(pool.map(decode_one, images))
    return gltf
