"""Device-side scene of the whole-path renderer.

The port of the parts of ``zig_raytracing_contest_tpu/scene/types.py`` that
the whole-path regime reads: the shade table (``build_shade_table``), the
packed 24-column record (``build_packed_record``, non-tiled texel offsets),
the texel bank as u16-valued f32 RGBA rows, and the ``emissive_all_dummy``
flag.  A ``TorchScene`` holds these as tensors on one device.

The JAX package's one-hot (4, Pp) bank, paged corner-expanded bank and
u16×2-packed bank exist because a TPU has no gather unit.  Here every texel
is a direct load from the row-major (P, 4) bank, so one layout serves every
bank size the whole-path regime admits.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.mxu_intersect import (
    REC_EMIT_MAX_TRIS,
    TRI_TILE_SMALL,
    VMEM_RESIDENT_MAX_TRIS,
    MXUTriangles,
    bake_triangles,
)
from .geometry import GeometryArrays
from .materials import MaterialBank

# Banks past this many texels leave the JAX package's whole-path regime
# (scene/types.py PAGED_MAX_TEXELS).
PAGED_MAX_TEXELS = 1 << 20

# shade_table column layout
COL_NRM = 0  # 9 cols: 3 vertices × xyz (world, normalized)
COL_UV = 9  # 6 cols: 3 vertices × uv
COL_BASE_DESC = 15  # 8 cols: base-color descriptor (f32-encoded) + dequant scale
COL_EMIS_DESC = 23  # 8 cols: emissive descriptor + dequant scale
DESC_SCALE = 7  # descriptor col: u16 dequant multiplier
SHADE_COLS = 32

_DESC_SENTINEL = float(1 << 30)

# Packed per-triangle record (24 columns): descriptors compress to
# [offset, ±w, ±h, dequant scale], a negative w/h meaning repeat wrap on
# that axis (clamp bounds are always [0, size-1]).
PCOL_NRM = 0  # 9
PCOL_UV = 9  # 6
PCOL_BASE = 15  # 4: off, ±w, ±h, scale
PCOL_EMIS = 19  # 4
PACKED_COLS = 24


def _desc_to_f32(desc_rows: np.ndarray) -> np.ndarray:
    d = desc_rows.astype(np.float64)
    return np.clip(d, -_DESC_SENTINEL, _DESC_SENTINEL).astype(np.float32)


def build_shade_table(geometry: GeometryArrays, materials: MaterialBank) -> np.ndarray:
    """(T, 32) f32 record per unique triangle: normals, uvs, descriptors."""
    if materials.color_data.shape[0] > 1 << 24:
        raise ValueError(
            f"texel bank has {materials.color_data.shape[0]} texels; f32 "
            f"descriptor offsets are exact only below 2^24 (~two 4K×4K "
            f"textures). Reduce texture resolution."
        )
    T = geometry.num_triangles
    table = np.zeros((T, SHADE_COLS), np.float32)
    table[:, COL_NRM : COL_NRM + 9] = geometry.normals.reshape(T, 9)
    table[:, COL_UV : COL_UV + 6] = geometry.texcoords.reshape(T, 6)
    mat = geometry.material_idx
    base = materials.mat_base[mat]
    emis = materials.mat_emissive[mat]
    table[:, COL_BASE_DESC : COL_BASE_DESC + 7] = _desc_to_f32(
        materials.color_desc[base]
    )
    table[:, COL_EMIS_DESC : COL_EMIS_DESC + 7] = _desc_to_f32(
        materials.color_desc[emis]
    )
    if materials.color_scale is not None:
        table[:, COL_BASE_DESC + DESC_SCALE] = materials.color_scale[base]
        table[:, COL_EMIS_DESC + DESC_SCALE] = materials.color_scale[emis]
    return table


def build_packed_record(shade_np: np.ndarray) -> np.ndarray:
    """(T, 32) shade table → (T, 24) packed record (row-major texel offsets)."""
    T = shade_np.shape[0]
    packed = np.zeros((T, PACKED_COLS), np.float32)
    packed[:, PCOL_NRM : PCOL_NRM + 15] = shade_np[:, COL_NRM : COL_NRM + 15]
    for src, dst in ((COL_BASE_DESC, PCOL_BASE), (COL_EMIS_DESC, PCOL_EMIS)):
        w = shade_np[:, src + 1]
        h = shade_np[:, src + 2]
        u_repeat = shade_np[:, src + 3] < 0  # sentinel lower bound = repeat
        v_repeat = shade_np[:, src + 5] < 0
        packed[:, dst + 0] = shade_np[:, src + 0]
        packed[:, dst + 1] = np.where(u_repeat, -w, w)
        packed[:, dst + 2] = np.where(v_repeat, -h, h)
        packed[:, dst + 3] = shade_np[:, src + DESC_SCALE]
    return packed


def emissive_all_dummy(materials: MaterialBank) -> bool:
    """Every material's emissive entry is a 1×1 dummy (a factor only): the
    shade then reads one emissive texel instead of four corners."""
    desc = materials.color_desc[materials.mat_emissive]
    return bool(np.all(desc[:, 1] * desc[:, 2] == 1))


@dataclass
class TorchScene:
    """The whole-path renderer's scene, as tensors on one device.

    tri_data   (16, Tp) f32 — transform bank in Morton order (rows 0-12)
    tile_bbox  (6, nt) f32 — per-real-tile boxes, the flat loop's bounds
    perm       (Tp,) int64 — Morton position → original triangle id
    rec_table  (24, Tp) f32 — packed shade records in Morton order
    bank       (P, 4) f32 — u16-valued RGBA texels (dequantized in-shade)
    bbox_min / bbox_max (3,) f32 — scene box, for the beam-sort key
    tile       triangles per tile (static)
    emissive_dummy  every emissive entry is 1×1 (static)
    """

    tri_data: torch.Tensor
    tile_bbox: torch.Tensor
    perm: torch.Tensor
    rec_table: torch.Tensor
    bank: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    tile: int
    emissive_dummy: bool

    @property
    def device(self) -> torch.device:
        return self.tri_data.device

    def to(self, device) -> "TorchScene":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; render on device='cpu' explicitly"
            )
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return TorchScene(**kw)

    def kernel_operands(self):
        """Ray-major copies for the CUDA kernels: one triangle's 16 transform
        floats and 24 record floats each contiguous (float4 loads)."""
        cached = getattr(self, "_kernel_operands", None)
        if cached is None:
            cached = (
                self.tri_data.t().contiguous(),
                self.rec_table.t().contiguous(),
                self.tile_bbox.contiguous(),
                self.bank.contiguous(),
            )
            self._kernel_operands = cached
        return cached


def check_whole_path(num_padded_tris: int, num_texels: int) -> None:
    """Raise for scenes outside the port's whole-path slice."""
    if num_padded_tris > REC_EMIT_MAX_TRIS:
        raise NotImplementedError(
            f"{num_padded_tris} padded triangles exceed REC_EMIT_MAX_TRIS = "
            f"{REC_EMIT_MAX_TRIS}: the per-bounce pipeline is ROADMAP queue 1 "
            f"item 10 (queue 2 items 7-9)"
        )
    if num_texels > PAGED_MAX_TEXELS:
        raise NotImplementedError(
            f"{num_texels} texels exceed PAGED_MAX_TEXELS = {PAGED_MAX_TEXELS}: "
            f"the per-bounce texel-gather pipeline is ROADMAP queue 1 item 10"
        )


def bake_scene_triangles(geometry: GeometryArrays) -> MXUTriangles:
    """The JAX package's bake of a resident scene (128-triangle tiles)."""
    if geometry.num_triangles > VMEM_RESIDENT_MAX_TRIS:
        raise NotImplementedError(
            f"{geometry.num_triangles} triangles: HBM-streaming scenes are "
            f"ROADMAP queue 1 item 10 (queue 2 item 8)"
        )
    pos = geometry.positions
    return bake_triangles(pos[:, 0], pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0],
                          tile=TRI_TILE_SMALL)


def build_torch_scene(
    geometry: GeometryArrays,
    materials: MaterialBank,
    bbox: tuple[np.ndarray, np.ndarray],
    device="cpu",
    backend: str = "auto",
) -> TorchScene:
    """Host bake → TorchScene on ``device``."""
    if backend not in ("auto", "mxu", "grid"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "grid":
        raise NotImplementedError(
            "backend='grid' (grid/DDA fallback) is ROADMAP queue 1 item 11"
        )
    mxu = bake_scene_triangles(geometry)
    check_whole_path(mxu.tri_data.shape[1], materials.color_u16.shape[0])
    record = build_packed_record(build_shade_table(geometry, materials))
    return TorchScene(
        tri_data=torch.from_numpy(mxu.tri_data),
        tile_bbox=torch.from_numpy(mxu.tile_bbox),
        perm=torch.from_numpy(mxu.perm.astype(np.int64)),
        rec_table=torch.from_numpy(np.ascontiguousarray(record[mxu.perm].T)),
        bank=torch.from_numpy(materials.color_u16.astype(np.float32)),
        bbox_min=torch.from_numpy(np.asarray(bbox[0], np.float32)),
        bbox_max=torch.from_numpy(np.asarray(bbox[1], np.float32)),
        tile=mxu.tile,
        emissive_dummy=emissive_all_dummy(materials),
    ).to(device)


def from_jax_scene(arrays: dict, device="cpu") -> TorchScene:
    """TorchScene from a JAX ``DeviceScene``'s arrays taken as NumPy.

    Keys: ``mxu.tri_data``, ``mxu.tile_bbox``, ``mxu.perm``, ``mxu.tile``,
    ``shade_table_t``, ``color_u16f_t`` (the (4, P) one-hot bank cut back to
    its P real texels), ``grid.bbox_min``, ``grid.bbox_max`` and
    ``emissive_all_dummy`` (bool).  Both packages then trace and shade
    identical state."""
    def f32(key):
        return torch.from_numpy(np.array(arrays[key], np.float32))

    tri = f32("mxu.tri_data")
    bank = f32("color_u16f_t")
    check_whole_path(tri.shape[1], bank.shape[1])
    return TorchScene(
        tri_data=tri,
        tile_bbox=f32("mxu.tile_bbox"),
        perm=torch.from_numpy(np.array(arrays["mxu.perm"], np.int64)),
        rec_table=f32("shade_table_t"),
        bank=bank.T.contiguous(),
        bbox_min=f32("grid.bbox_min"),
        bbox_max=f32("grid.bbox_max"),
        tile=int(arrays["mxu.tile"]),
        emissive_dummy=bool(arrays["emissive_all_dummy"]),
    ).to(device)
