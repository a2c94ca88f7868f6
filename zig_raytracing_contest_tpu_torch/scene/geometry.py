"""Triangle extraction: glTF primitives → flat SoA numpy arrays.

Mirrors stage1.loadGeometry/loadTriangles (src/stage1.zig:203-272): for every
node with a mesh, for every primitive (triangles mode, indexed — enforced
like the reference asserts), apply the node's global transform to positions
and its (non-inverse-transpose) 3x3 to normals, then normalize
(src/stage1.zig:246 — the reference's TODO'd shortcut is part of the spec).

Where the reference writes AoS into a MultiArrayList, we emit SoA numpy
arrays shaped for device upload: positions (T, 3, 3), normals (T, 3, 3),
texcoords (T, 3, 2), material index (T,).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gltf import Gltf, GltfError

MODE_TRIANGLES = 4


@dataclass
class GeometryArrays:
    positions: np.ndarray  # (T, 3, 3) f32 — world-space vertices
    normals: np.ndarray  # (T, 3, 3) f32 — world-space, normalized
    texcoords: np.ndarray  # (T, 3, 2) f32
    material_idx: np.ndarray  # (T,) int32

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]


def load_geometry(gltf: Gltf) -> GeometryArrays:
    pos_chunks: list[np.ndarray] = []
    nrm_chunks: list[np.ndarray] = []
    uv_chunks: list[np.ndarray] = []
    mat_chunks: list[np.ndarray] = []

    for node_idx, node in enumerate(gltf.doc.get("nodes", [])):
        if "mesh" not in node:
            continue
        mesh = gltf.doc["meshes"][node["mesh"]]
        matrix = gltf.global_transform(node_idx)
        rot = matrix[:3, :3]
        for primitive in mesh.get("primitives", []):
            if primitive.get("mode", MODE_TRIANGLES) != MODE_TRIANGLES:
                raise GltfError("only triangles-mode primitives are supported")
            if "indices" not in primitive:
                raise GltfError("only indexed primitives are supported")
            if "material" not in primitive:
                # The reference unwraps primitive.material (src/stage1.zig:239)
                raise GltfError("primitive has no material")

            attrs = primitive.get("attributes", {})
            if "POSITION" not in attrs:
                # The reference maps a missing accessor to a zero-length
                # read over a sentinel base (src/stage1.zig:122-147) and
                # then reads UNDEFINED memory when the primitive is indexed;
                # we pin the malformed case to a typed error instead.
                raise GltfError("primitive has no POSITION attribute")
            indices = gltf.accessor_array(primitive["indices"]).reshape(-1)
            ntri = indices.shape[0] // 3
            if ntri == 0:
                continue
            idx = indices[: ntri * 3].astype(np.int64).reshape(ntri, 3)

            positions = gltf.accessor_array(attrs["POSITION"]).astype(np.float32)
            world_pos = positions @ rot.T + matrix[:3, 3]
            pos_chunks.append(world_pos[idx])

            if "NORMAL" in attrs:
                normals = gltf.accessor_array(attrs["NORMAL"]).astype(np.float32)
                world_nrm = normals @ rot.T
                norms = np.linalg.norm(world_nrm, axis=-1, keepdims=True)
                world_nrm = world_nrm / norms
                nrm_chunks.append(world_nrm[idx])
            else:
                # Reference reads undefined memory here; we pin zeros.
                nrm_chunks.append(np.zeros((ntri, 3, 3), np.float32))

            if "TEXCOORD_0" in attrs:
                uv = gltf.accessor_array(attrs["TEXCOORD_0"]).astype(np.float32)
                uv_chunks.append(uv[idx])
            else:
                uv_chunks.append(np.zeros((ntri, 3, 2), np.float32))

            mat_chunks.append(
                np.full((ntri,), primitive["material"], dtype=np.int32)
            )

    if not pos_chunks:
        raise GltfError("scene has no triangles")

    return GeometryArrays(
        positions=np.concatenate(pos_chunks, axis=0),
        normals=np.concatenate(nrm_chunks, axis=0),
        texcoords=np.concatenate(uv_chunks, axis=0),
        material_idx=np.concatenate(mat_chunks, axis=0),
    )
