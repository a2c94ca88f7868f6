"""The port's small procedural scene: a frozen copy of its
``SceneBuilder``, ``quad`` and ``bench_scene``
(``zig_raytracing_contest_tpu_torch/scene/procedural.py``), which the
benchmark's tests render at tiny frames; ``write`` is ``bench_scene``.  A
later change to the port's writers cannot change these copies;
``tests/test_pathbench_scenes.py`` holds them to the port's bytes."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from .png import encode_srgb_png_bytes


class SceneBuilder:
    def __init__(self):
        self.blob = bytearray()
        self.buffer_views: list[dict] = []
        self.accessors: list[dict] = []
        self.meshes: list[dict] = []
        self.nodes: list[dict] = []
        self.cameras: list[dict] = []
        self.materials: list[dict] = []
        self.samplers: list[dict] = []
        self.textures: list[dict] = []
        self.images: list[dict] = []

    # ---- low-level --------------------------------------------------------

    def _append(self, data: bytes, stride: int | None = None) -> int:
        while len(self.blob) % 4:
            self.blob.append(0)
        view = {"buffer": 0, "byteOffset": len(self.blob), "byteLength": len(data)}
        if stride is not None:
            view["byteStride"] = stride
        self.blob.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def _accessor(self, view: int, ctype: int, count: int, type_: str, offset=0) -> int:
        self.accessors.append(
            {
                "bufferView": view,
                "byteOffset": offset,
                "componentType": ctype,
                "count": count,
                "type": type_,
            }
        )
        return len(self.accessors) - 1

    # ---- content ----------------------------------------------------------

    def add_image_png(self, rgba_u8: np.ndarray) -> int:
        png = encode_srgb_png_bytes(rgba_u8)
        view = self._append(png)
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        return len(self.images) - 1

    def add_sampler(self, wrap_s: int = 10497, wrap_t: int = 10497) -> int:
        self.samplers.append({"wrapS": wrap_s, "wrapT": wrap_t})
        return len(self.samplers) - 1

    def add_texture(self, image: int, sampler: int | None = None) -> int:
        tex = {"source": image}
        if sampler is not None:
            tex["sampler"] = sampler
        self.textures.append(tex)
        return len(self.textures) - 1

    def add_material(
        self,
        base_color_factor=(1, 1, 1, 1),
        base_color_texture: int | None = None,
        emissive_factor=(0, 0, 0),
        emissive_texture: int | None = None,
        alpha_mode: str = "OPAQUE",
        alpha_cutoff: float | None = None,
        metallic: float | None = None,
        roughness: float | None = None,
    ) -> int:
        pbr: dict = {"baseColorFactor": list(base_color_factor)}
        if base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": base_color_texture}
        if metallic is not None:
            pbr["metallicFactor"] = float(metallic)
        if roughness is not None:
            pbr["roughnessFactor"] = float(roughness)
        mat: dict = {"pbrMetallicRoughness": pbr, "emissiveFactor": list(emissive_factor)}
        if emissive_texture is not None:
            mat["emissiveTexture"] = {"index": emissive_texture}
        if alpha_mode != "OPAQUE":
            mat["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            mat["alphaCutoff"] = alpha_cutoff
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_mesh_node(
        self,
        positions: np.ndarray,  # (V, 3) f32
        indices: np.ndarray,  # (I,) ints
        material: int,
        normals: np.ndarray | None = None,
        texcoords: np.ndarray | None = None,
        matrix: np.ndarray | None = None,  # (4, 4) M[row, col]
        translation=None,
        rotation=None,
        scale=None,
        index_dtype=np.uint16,
        interleave: bool = False,
    ) -> int:
        positions = np.ascontiguousarray(positions, np.float32)
        nv = len(positions)

        if interleave and normals is not None:
            # Strided accessor coverage: pos+normal interleaved, 24B stride.
            inter = np.concatenate(
                [positions, np.ascontiguousarray(normals, np.float32)], axis=1
            ).astype(np.float32)
            view = self._append(inter.tobytes(), stride=24)
            pos_acc = self._accessor(view, 5126, nv, "VEC3", offset=0)
            nrm_acc = self._accessor(view, 5126, nv, "VEC3", offset=12)
        else:
            pos_acc = self._accessor(
                self._append(positions.tobytes()), 5126, nv, "VEC3"
            )
            nrm_acc = None
            if normals is not None:
                nrm_acc = self._accessor(
                    self._append(np.ascontiguousarray(normals, np.float32).tobytes()),
                    5126,
                    nv,
                    "VEC3",
                )

        attrs = {"POSITION": pos_acc}
        if nrm_acc is not None:
            attrs["NORMAL"] = nrm_acc
        if texcoords is not None:
            attrs["TEXCOORD_0"] = self._accessor(
                self._append(np.ascontiguousarray(texcoords, np.float32).tobytes()),
                5126,
                nv,
                "VEC2",
            )

        indices = np.ascontiguousarray(indices, index_dtype)
        ctype = {np.uint16: 5123, np.uint32: 5125, np.uint8: 5121}[index_dtype]
        idx_acc = self._accessor(
            self._append(indices.tobytes()), ctype, len(indices), "SCALAR"
        )

        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": attrs,
                        "indices": idx_acc,
                        "material": material,
                        "mode": 4,
                    }
                ]
            }
        )
        node: dict = {"mesh": len(self.meshes) - 1}
        if matrix is not None:
            node["matrix"] = np.asarray(matrix, np.float32).T.reshape(-1).tolist()
        if translation is not None:
            node["translation"] = list(translation)
        if rotation is not None:
            node["rotation"] = list(rotation)
        if scale is not None:
            node["scale"] = list(scale)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def add_camera_node(
        self,
        position,
        look_at,
        yfov: float,
        aspect_ratio: float | None = None,
        name: str | None = None,
        world_up=(0, 1, 0),
    ) -> int:
        persp: dict = {"yfov": float(yfov), "znear": 0.01}
        if aspect_ratio is not None:
            persp["aspectRatio"] = float(aspect_ratio)
        cam: dict = {"type": "perspective", "perspective": persp}
        if name is not None:
            cam["name"] = name
        self.cameras.append(cam)

        position = np.asarray(position, np.float64)
        fwd = np.asarray(look_at, np.float64) - position
        fwd /= np.linalg.norm(fwd)
        back = -fwd  # glTF camera looks along its node's -Z
        right = np.cross(np.asarray(world_up, np.float64), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, back, position
        self.nodes.append(
            {
                "camera": len(self.cameras) - 1,
                "matrix": m.T.reshape(-1).tolist(),
            }
        )
        return len(self.nodes) - 1

    # ---- serialization ----------------------------------------------------

    def _doc(self, buffer_entry: dict) -> dict:
        doc = {
            "asset": {"version": "2.0"},
            "buffers": [buffer_entry],
            "bufferViews": self.buffer_views,
            "accessors": self.accessors,
            "meshes": self.meshes,
            "nodes": self.nodes,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "scene": 0,
        }
        for key, val in [
            ("cameras", self.cameras),
            ("materials", self.materials),
            ("samplers", self.samplers),
            ("textures", self.textures),
            ("images", self.images),
        ]:
            if val:
                doc[key] = val
        return doc

    def write_gltf(self, path: str | Path) -> Path:
        """External .bin flavor (reference: loadFile by URI, stage1.zig:92-94)."""
        path = Path(path)
        bin_name = path.stem + ".bin"
        (path.parent / bin_name).write_bytes(bytes(self.blob))
        doc = self._doc({"uri": bin_name, "byteLength": len(self.blob)})
        path.write_text(json.dumps(doc))
        return path

    def write_glb(self, path: str | Path) -> Path:
        """GLB container (reference: glb_binary buffer 0, stage1.zig:87-89)."""
        path = Path(path)
        doc = self._doc({"byteLength": len(self.blob)})
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bin_chunk = bytes(self.blob) + b"\x00" * (-len(self.blob) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        out = struct.pack("<III", 0x46546C67, 2, total)
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
        path.write_bytes(out)
        return path


def quad(center, u_axis, v_axis):
    """Two CCW triangles for a quad: returns (positions (4,3), indices (6,),
    normals (4,3), texcoords (4,2)).  Winding: normal = cross(e1, e2) of the
    first triangle — single-sided, visible from the normal side (back-face
    culling in MT, src/linalg.zig:705)."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u_axis, np.float32)
    v = np.asarray(v_axis, np.float32)
    positions = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    indices = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    texcoords = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return positions, indices, normals, texcoords


def bench_scene(path: str | Path, num_objects: int = 200, seed: int = 42,
                two_sided: bool = True):
    """The official bench scene: a copy of ``bench.py::build_bench_scene``
    (which imports the JAX package).  A textured floor, an emissive panel
    and ``num_objects`` randomly oriented two-sided quads with a clamp
    gradient, an alpha-cutout (MASK) texture or a plain color; one camera,
    "Camera 1".  The same ``seed`` gives the same scene as bench.py.

    ``two_sided=False`` keeps only the front quad of each pair.  A ray
    leaving one quad of a back-to-back pair meets the other quad's plane at
    t ≈ 0, and whether that counts as a hit is decided by the last bit of
    the re-origin — so two implementations that differ by one rounding
    anywhere decorrelate there.  Single-sided quads keep frames of two
    pipelines comparable pixel by pixel."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # checker texture (repeat), a clamp texture, an alpha-cutout texture
    checker = np.zeros((8, 8, 4), np.uint8)
    checker[::2, ::2] = checker[1::2, 1::2] = [230, 230, 230, 255]
    checker[::2, 1::2] = checker[1::2, ::2] = [40, 40, 40, 255]
    img_checker = b.add_image_png(checker)
    tex_checker = b.add_texture(img_checker, b.add_sampler(10497, 10497))

    grad = np.linspace(30, 220, 16).astype(np.uint8)
    grad_img = np.stack([grad, 255 - grad, np.full(16, 128, np.uint8)], -1)[None]
    tex_grad = b.add_texture(
        b.add_image_png(np.ascontiguousarray(grad_img)), b.add_sampler(33071, 33071)
    )

    holes = np.full((8, 8, 4), 255, np.uint8)
    holes[2:6, 2:6, 3] = 0
    tex_holes = b.add_texture(b.add_image_png(holes))

    floor_mat = b.add_material(base_color_texture=tex_checker)
    grad_mat = b.add_material(base_color_texture=tex_grad)
    cut_mat = b.add_material(
        base_color_texture=tex_holes, alpha_mode="MASK", alpha_cutoff=0.5
    )
    light = b.add_material(base_color_factor=(0, 0, 0, 1), emissive_factor=(6, 6, 6))
    plain = [
        b.add_material(base_color_factor=(rng.uniform(0.2, 0.9, 3).tolist() + [1.0]))
        for _ in range(8)
    ]

    S = 12.0
    p, i, n, t = quad((0, -2, 0), (S, 0, 0), (0, 0, -S))
    b.add_mesh_node(p, i, floor_mat, normals=n, texcoords=t * 6)
    p, i, n, t = quad((0, 8, 0), (4, 0, 0), (0, 0, 4))
    b.add_mesh_node(p, i, light, normals=n, texcoords=t)

    for k in range(num_objects):
        c = rng.uniform([-8, -1.5, -8], [8, 3, 8])
        size = rng.uniform(0.2, 0.7)
        mat = [grad_mat, cut_mat, *plain][k % (len(plain) + 2)]
        # random oriented quad pair (two-sided via two quads back to back)
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        v = rng.standard_normal(3)
        v -= u * (v @ u)
        v /= np.linalg.norm(v)
        for flip in (1, -1) if two_sided else (1,):
            p, i, n, t = quad(c, u * size, v * size * flip)
            b.add_mesh_node(p, i, mat, normals=n, texcoords=t)

    b.add_camera_node((0, 2.5, 14), (0, 0.5, 0), yfov=0.8, name="Camera 1")
    return b.write_gltf(path)


write = bench_scene  # the entry that scenes.load_writer finds
