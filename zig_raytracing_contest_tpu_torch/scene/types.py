"""Device-side scene of the renderer.

The port of ``zig_raytracing_contest_tpu/scene/types.py``.  A
``TorchScene`` holds, as tensors on one device:

* the MXU bake, up to MXU_BACKEND_MAX_TRIANGLES: the triangle transforms
  with their tile and group heaps (128-triangle tiles for resident scenes,
  ``_stream_tile`` past VMEM_RESIDENT_MAX_TRIS), the packed 24-column record
  (``build_packed_record``, non-tiled texel offsets), the texel bank as
  u16-valued f32 RGBA rows and the ``emissive_all_dummy`` flag;
* or, for the grid backend (``backend="grid"``, or ``auto`` past
  MXU_BACKEND_MAX_TRIANGLES), the uniform grid in place of the bake
  (``GridScene``: the grid parameters, each cell's ``[begin, end)`` and the
  per-reference Möller–Trumbore triangles, as the JAX ``DeviceScene``
  holds them);
* for every scene, what the XLA shading path reads: the unique-space
  (T, 32) ``shade_table`` (``build_shade_table``), the f32 (P, 4)
  ``color_data`` bank, and the extensions' data, the emissive-triangle
  ``lights`` (render/extensions.LightSet) and the per-triangle (metallic,
  roughness) ``ext_mr``.

One class serves both backends, with the bake's tensors None on a grid
scene, because the XLA shading path reads one scene object whatever its
backend: ``render/wavefront.trace_any`` dispatches on ``tri_data is None``
as the JAX package's dispatches on ``scene.mxu is None``, and the shade
table, the bank and the extension data are the same on both.

The JAX package's one-hot (4, Pp) bank, paged corner-expanded bank and
u16×2-packed bank exist because a TPU has no gather unit.  Here every texel
is a direct load from the row-major (P, 4) bank, so one layout serves every
bank up to 2^24 texels; ``bank_resident`` only records which shade the JAX
package would take (its single-kernel shade or its 3-stage shade), which
decides the regime.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from ..grid.builder import GridBuild
from ..ops.dda import GridParams
from ..ops.linalg import make_mt_triangles
from ..ops.mxu_intersect import (
    TRI_TILE,
    TRI_TILE_SMALL,
    VMEM_RESIDENT_MAX_TRIS,
    MXUTriangles,
    bake_triangles,
)
from .geometry import GeometryArrays
from .materials import MaterialBank

# Past this many triangles the auto backend takes the grid (the JAX
# package's MXU_BACKEND_MAX_TRIANGLES).  Read at call time, so a test can
# lower it.
MXU_BACKEND_MAX_TRIANGLES = 1 << 24


def scene_backend(num_triangles: int, backend: str = "auto") -> str:
    """The intersection backend a scene of ``num_triangles`` takes: "mxu"
    or "grid" (``auto``: the MXU bake up to MXU_BACKEND_MAX_TRIANGLES, as
    the JAX package's ``build_device_scene`` decides)."""
    if backend not in ("auto", "mxu", "grid"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return "mxu" if num_triangles <= MXU_BACKEND_MAX_TRIANGLES else "grid"
    return backend

# Streaming bakes keep at most this many tiles: bigger scenes double the
# tile instead (scene/types.py STREAM_MAX_TILES, _stream_tile).  Read at
# call time, so a test can lower it.
STREAM_MAX_TILES = 8192


def _stream_tile(num_triangles: int) -> int:
    tile = TRI_TILE
    while num_triangles > tile * STREAM_MAX_TILES:
        tile *= 2
    return tile


# A bank has a resident form in the JAX package (its single-kernel shade)
# when it holds at most ONEHOT_MAX_TEXELS texels (the one-hot bank) or when
# its padded tiled capacity is at most PAGED_MAX_TEXELS (the paged bank);
# past both it takes the 3-stage shade.  Read at call time.
ONEHOT_MAX_TEXELS = 1024
PAGED_MAX_TEXELS = 1 << 20
# The paged bank's 2-D tiling (scene/types.py PAGE_TEXELS, PAGE_TILE_*).
PAGE_TEXELS = 2048
PAGE_TILE_W = 64
PAGE_TILE_H = PAGE_TEXELS // PAGE_TILE_W  # 32


def tiled_texel_map(num_texels: int, color_desc: np.ndarray):
    """Row-major texel index → position in the JAX package's tiled page
    layout (a copy of its ``_tiled_texel_map``).  Returns ``(q, off_map,
    padded_total)``: q (P,) int64 the tiled position of each row-major
    texel, off_map (T,) int64 each texture's tiled base, and the layout's
    texel capacity."""
    desc = np.asarray(color_desc, np.int64)
    offs, ws, hs = desc[:, 0], desc[:, 1], desc[:, 2]
    small = (ws <= PAGE_TILE_W) & (hs <= PAGE_TILE_H)
    off_map = np.zeros(len(offs), np.int64)
    pos = 0
    for i in np.nonzero(small)[0]:
        off_map[i] = pos
        pos += ws[i] * hs[i]
    pos = -(-pos // PAGE_TEXELS) * PAGE_TEXELS
    tiles_x = -(-ws // PAGE_TILE_W)
    for i in np.nonzero(~small)[0]:
        off_map[i] = pos
        pos += tiles_x[i] * (-(-hs[i] // PAGE_TILE_H)) * PAGE_TEXELS
    padded_total = int(-(-pos // PAGE_TEXELS) * PAGE_TEXELS)

    p = np.arange(num_texels, dtype=np.int64)
    t = np.searchsorted(offs, p, side="right") - 1
    local = p - offs[t]
    y, x = np.divmod(local, ws[t])
    q_big = (
        off_map[t]
        + ((y // PAGE_TILE_H) * tiles_x[t] + x // PAGE_TILE_W) * PAGE_TEXELS
        + (y % PAGE_TILE_H) * PAGE_TILE_W
        + x % PAGE_TILE_W
    )
    q = np.where(small[t], off_map[t] + local, q_big)
    return q, off_map, padded_total


def bank_is_resident(num_texels: int, color_desc: np.ndarray) -> bool:
    """True when the JAX package bakes a resident (one-hot or paged) bank:
    at most ONEHOT_MAX_TEXELS texels, or a tiled capacity within
    PAGED_MAX_TEXELS (build_device_scene's paged-bank decision)."""
    if num_texels <= ONEHOT_MAX_TEXELS:
        return True
    return tiled_texel_map(0, color_desc)[2] <= PAGED_MAX_TEXELS


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


class GridOperands(NamedTuple):
    """The grid as grid_walk_kernel reads it (``GridScene.kernel_operands``):
    ``tri`` (D + 1, 12) f32 rows, ``cells`` (C, 2) int32 ranges, and the
    box, cell size and resolution as Python numbers (f32 values)."""

    tri: torch.Tensor
    cells: torch.Tensor
    bbox_min: tuple
    bbox_max: tuple
    cell_size: tuple
    resolution: tuple


@dataclass
class GridScene:
    """The grid backend's tensors (the JAX ``DeviceScene``'s grid side).

    params      GridParams of the grid (box, resolution, cell size)
    cell_begin / cell_end  (C,) int64 — each cell's range of references,
                C = rx·ry·rz cells, x-fastest, z-major
    tri_v0 / tri_e1 / tri_e2  (D + 1, 3) f32 — Möller–Trumbore triangles,
                one per (cell, triangle) reference in cell order, padded
                by one unreachable row so D is never 0
    dup_to_tri  (D + 1,) int64 — each reference's unique triangle id
    """

    params: GridParams
    cell_begin: torch.Tensor
    cell_end: torch.Tensor
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    dup_to_tri: torch.Tensor

    def to(self, device) -> "GridScene":
        return GridScene(*(v.to(device) for v in (
            self.params, self.cell_begin, self.cell_end, self.tri_v0, self.tri_e1,
            self.tri_e2, self.dup_to_tri)))

    def kernel_operands(self) -> "GridOperands":
        """What grid_walk_kernel reads (``kernels.launch_grid_walk``), made
        on the grid's device at the first call and kept: the references'
        rows (D + 1, 12) f32 (v0, e1, e2, then ``dup_to_tri`` as int32 bits
        and two zeros: three 16-byte loads a test), the cell ranges (C, 2)
        int32 and the grid's parameters as Python numbers.  The same values
        as the int64 and (D + 1, 3) arrays, in fewer bytes; reading the
        parameters synchronises once, so the first call is made eagerly (a
        frame's first run, before any capture).  ``kernels.launch_grid_walk``
        refuses a grid whose int32 indices would not hold."""
        ops = getattr(self, "_kernel_operands", None)
        if ops is None:
            dup = self.dup_to_tri.to(torch.int32).view(torch.float32)[:, None]
            tri = torch.cat([self.tri_v0, self.tri_e1, self.tri_e2, dup,
                             torch.zeros_like(dup), torch.zeros_like(dup)], dim=1)
            cells = torch.stack([self.cell_begin, self.cell_end], dim=1).to(torch.int32)
            p = self.params
            ops = self._kernel_operands = GridOperands(
                tri.contiguous(), cells.contiguous(), tuple(p.bbox_min.tolist()),
                tuple(p.bbox_max.tolist()), tuple(p.cell_size.tolist()),
                tuple(int(r) for r in p.resolution.tolist()))
        return ops

    @property
    def num_refs(self) -> int:
        """D: the duplicated references, without the pad row."""
        return self.dup_to_tri.shape[0] - 1

    @property
    def num_cells(self) -> int:
        return self.cell_begin.shape[0]


def grid_scene(grid: GridBuild, positions: np.ndarray) -> GridScene:
    """A host grid build → GridScene (CPU tensors); positions (T, 3, 3)."""
    dup = grid.dup_to_tri.astype(np.int64)
    p = np.asarray(positions, np.float32)[dup]  # (D, 3, 3)

    def pad1(a):
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)], axis=0)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(pad1(a), np.float32))

    v0, e1, e2 = make_mt_triangles(p[:, 0], p[:, 1], p[:, 2])
    return GridScene(
        params=GridParams(
            torch.from_numpy(np.asarray(grid.bbox_min, np.float32)),
            torch.from_numpy(np.asarray(grid.bbox_max, np.float32)),
            torch.from_numpy(np.asarray(grid.resolution, np.int64)),
            torch.from_numpy(np.asarray(grid.cell_size, np.float32)),
        ),
        cell_begin=torch.from_numpy(grid.cell_begin.astype(np.int64)),
        cell_end=torch.from_numpy(grid.cell_end.astype(np.int64)),
        tri_v0=f32(v0),
        tri_e1=f32(e1),
        tri_e2=f32(e2),
        dup_to_tri=torch.from_numpy(pad1(dup)),
    )


def ext_mr_table(geometry: GeometryArrays, materials: MaterialBank):
    """(T, 2) f32 (metallic, roughness) per unique triangle, or None."""
    if materials.mat_metallic is None or geometry.num_triangles == 0:
        return None
    return np.stack([materials.mat_metallic[geometry.material_idx],
                     materials.mat_roughness[geometry.material_idx]],
                    axis=-1).astype(np.float32)


@dataclass
class TorchScene:
    """The renderer's scene, as tensors on one device.  The bake's fields
    (tri_data to bank) are None on a grid scene.

    tri_data   (16, Tp) f32 — transform bank in Morton order (rows 0-12)
    tile_bbox  (6, nt) f32 — per-real-tile boxes, the flat loop's bounds
    tree_bbox  (6, 2·p2) f32 — implicit binary heap over the tile boxes,
               the resident per-bounce trace's tree
    group_bbox (6, ng) f32 — boxes of ``group_tiles``-tile groups
    group_tree_bbox (6, 2·p2g) f32 — implicit binary heap over the group
               boxes, the streaming trace's tree
    perm       (Tp,) int64 — Morton position → original triangle id
    rec_table  (24, Tp) f32 — packed shade records in Morton order
    bank       (P, 4) f32 — u16-valued RGBA texels (dequantized in-shade)
    bbox_min / bbox_max (3,) f32 — scene box, for the beam-sort key
    tile       triangles per tile (static)
    emissive_dummy  every emissive entry is 1×1 (static)
    group_tiles     tiles per cull group (static)
    bank_resident   the JAX package would bake a resident (one-hot or
                    paged) bank, so the whole path may take the scene
                    (static); else its shade is the 3-stage one
    grid       GridScene of the grid backend, or None
    shade_table (T, 32) f32 — the XLA shading path's records, unique order
    color_data  (P, 4) f32 — the XLA shading path's dequantized texel bank
    lights     LightSet of the emissive triangles (NEE), or None
    ext_mr     (T, 2) f32 — (metallic, roughness) per triangle (pbr), or None
    """

    tri_data: torch.Tensor
    tile_bbox: torch.Tensor
    tree_bbox: torch.Tensor
    group_bbox: torch.Tensor
    group_tree_bbox: torch.Tensor
    perm: torch.Tensor
    rec_table: torch.Tensor
    bank: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    tile: int
    emissive_dummy: bool
    group_tiles: int
    bank_resident: bool
    grid: GridScene | None = None
    shade_table: torch.Tensor | None = None
    color_data: torch.Tensor | None = None
    lights: object | None = None
    ext_mr: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.bbox_min.device

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
            kw[f.name] = v if v is None or isinstance(v, (int, bool)) else v.to(device)
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

    def frame_cache(self) -> dict:
        """What ``render.pipeline`` keeps per frame of this scene: the
        device slot maps and the frames' CUDA graphs, which bake this
        scene's tensors' addresses, so they live and die with it."""
        cache = getattr(self, "_frame_cache", None)
        if cache is None:
            cache = self._frame_cache = {}
        return cache


def bake_tile(num_triangles: int) -> int:
    """Triangles per tile of the bake (build_device_scene's rule, on the raw
    count): 128 for resident scenes, else ``_stream_tile``."""
    if num_triangles <= VMEM_RESIDENT_MAX_TRIS:
        return TRI_TILE_SMALL
    return _stream_tile(num_triangles)


def bake_scene_triangles(geometry: GeometryArrays) -> MXUTriangles:
    """The JAX package's triangle bake: 128-triangle tiles while the raw
    count is within VMEM_RESIDENT_MAX_TRIS, else ``_stream_tile`` (256·2^k,
    at most STREAM_MAX_TILES tiles).  The kernels decide streaming on the
    padded count (ops/mxu_intersect.trace_emit_aux)."""
    pos = geometry.positions
    return bake_triangles(pos[:, 0], pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0],
                          tile=bake_tile(geometry.num_triangles))


def build_torch_scene(
    geometry: GeometryArrays,
    materials: MaterialBank,
    bbox: tuple[np.ndarray, np.ndarray],
    device="cuda",
    backend: str = "auto",
    grid: GridBuild | None = None,
) -> TorchScene:
    """Host bake → TorchScene on ``device`` (the CPU only when asked).

    ``backend`` as ``scene_backend``; the grid backend needs ``grid``, the
    host build of the scene's grid (``grid.builder.build_grid``)."""
    from ..render.extensions import build_light_set

    shade_np = build_shade_table(geometry, materials)
    mr = ext_mr_table(geometry, materials)
    common = dict(
        bbox_min=torch.from_numpy(np.asarray(bbox[0], np.float32)),
        bbox_max=torch.from_numpy(np.asarray(bbox[1], np.float32)),
        shade_table=torch.from_numpy(shade_np),
        color_data=torch.from_numpy(np.asarray(materials.color_data, np.float32)),
        lights=build_light_set(geometry, materials),
        ext_mr=None if mr is None else torch.from_numpy(mr),
    )
    if scene_backend(geometry.num_triangles, backend) == "grid":
        if grid is None:
            raise ValueError("the grid backend needs the scene's grid (build_grid)")
        return TorchScene(
            tri_data=None, tile_bbox=None, tree_bbox=None, group_bbox=None,
            group_tree_bbox=None, perm=None, rec_table=None, bank=None, tile=0,
            emissive_dummy=False, group_tiles=0, bank_resident=False,
            grid=grid_scene(grid, geometry.positions), **common,
        ).to(device)
    mxu = bake_scene_triangles(geometry)
    record = build_packed_record(shade_np)
    return TorchScene(
        tri_data=torch.from_numpy(mxu.tri_data),
        tile_bbox=torch.from_numpy(mxu.tile_bbox),
        tree_bbox=torch.from_numpy(mxu.tree_bbox),
        group_bbox=torch.from_numpy(mxu.group_bbox),
        group_tree_bbox=torch.from_numpy(mxu.group_tree_bbox),
        perm=torch.from_numpy(mxu.perm.astype(np.int64)),
        rec_table=torch.from_numpy(np.ascontiguousarray(record[mxu.perm].T)),
        bank=torch.from_numpy(materials.color_u16.astype(np.float32)),
        tile=mxu.tile,
        emissive_dummy=emissive_all_dummy(materials),
        group_tiles=mxu.group_tiles,
        bank_resident=bank_is_resident(materials.color_u16.shape[0],
                                       materials.color_desc),
        **common,
    ).to(device)


def _unpack_color_bank(packed: np.ndarray) -> np.ndarray:
    """(2, P) int32 u16×2-packed bank (R|G<<16, B|A<<16) → (P, 4) f32 of
    the u16 values."""
    w = np.asarray(packed).view(np.uint32)
    return np.stack([w[0] & 0xFFFF, w[0] >> 16, w[1] & 0xFFFF, w[1] >> 16],
                    axis=1).astype(np.float32)


def _row_major_records(rec: np.ndarray, color_desc: np.ndarray,
                       off_map: np.ndarray) -> np.ndarray:
    """(24, Tp) packed records whose descriptor offsets are tiled bank
    bases (``off_map``) → the same records with row-major offsets (the
    inverse of the JAX package's ``build_packed_record`` remap)."""
    desc = np.asarray(color_desc, np.int64)
    order = np.argsort(off_map, kind="stable")
    out = rec.copy()
    for col in (PCOL_BASE, PCOL_EMIS):
        tiled = rec[col].astype(np.int64)
        k = np.searchsorted(off_map[order], tiled)
        t = order[np.minimum(k, len(order) - 1)]
        if not np.array_equal(off_map[t], tiled):
            raise ValueError("a record's descriptor offset is no texture's tiled base")
        out[col] = desc[t, 0].astype(np.float32)
    return out


def from_jax_scene(arrays: dict, device="cuda") -> TorchScene:
    """TorchScene on ``device`` (the CPU only when asked) from a JAX
    ``DeviceScene``'s arrays taken as NumPy.

    The MXU bake's keys: ``mxu.tri_data``, ``mxu.tile_bbox``,
    ``mxu.tree_bbox``, ``mxu.group_bbox``, ``mxu.group_tree_bbox``,
    ``mxu.perm``, ``mxu.tile``, ``mxu.group_tiles``, ``shade_table_t``,
    ``color_u16f_t`` (the (4, P) one-hot bank cut back to its P real
    texels, or None past ONEHOT_MAX_TEXELS), ``color_packed_t`` (the (2, P)
    u16×2-packed bank), ``tiled_layout`` (bool: the bake chose the tiled
    page layout), ``color_desc`` (the materials' (T, 7) texture
    descriptors; read only with ``tiled_layout``) and
    ``emissive_all_dummy`` (bool).  Without ``mxu.tri_data`` the scene is a
    grid scene (the JAX scene's ``mxu`` is None).  Always:
    ``grid.bbox_min`` and ``grid.bbox_max``.  Optional: the grid,
    ``grid.resolution``, ``grid.cell_size``, ``cell_begin``, ``cell_end``,
    ``tri_v0``, ``tri_e1``, ``tri_e2`` and ``dup_to_tri`` (required for a
    grid scene); the XLA shading path's ``shade_table`` and ``color_data``;
    the extensions' ``ext_mr`` and ``lights`` (a dict of the LightSet's
    fields, or None).  Both packages then trace and shade identical state.

    The bank is the one-hot bank when there is one, else the unpacked
    u16×2 bank.  A paged bake (``tiled_layout``) keeps its packed bank and
    its records' descriptor offsets in the tiled page layout: the layout
    is mapped back to row-major (``tiled_texel_map``) for the bank, and
    each record's base and emissive offsets from their texture's tiled
    base to its row-major one.  A one-hot or paged bank is resident."""
    from ..render.extensions import LightSet

    def f32(key):
        return torch.from_numpy(np.array(arrays[key], np.float32))

    def opt(key, dtype=np.float32):
        v = arrays.get(key)
        return None if v is None else torch.from_numpy(np.array(v, dtype))

    grid = None
    if arrays.get("cell_begin") is not None:
        grid = GridScene(
            params=GridParams(f32("grid.bbox_min"), f32("grid.bbox_max"),
                              opt("grid.resolution", np.int64), f32("grid.cell_size")),
            cell_begin=opt("cell_begin", np.int64),
            cell_end=opt("cell_end", np.int64),
            tri_v0=f32("tri_v0"),
            tri_e1=f32("tri_e1"),
            tri_e2=f32("tri_e2"),
            dup_to_tri=opt("dup_to_tri", np.int64),
        )
    lights = arrays.get("lights")
    common = dict(
        bbox_min=f32("grid.bbox_min"),
        bbox_max=f32("grid.bbox_max"),
        grid=grid,
        shade_table=opt("shade_table"),
        color_data=opt("color_data"),
        lights=None if lights is None else LightSet(
            tri=torch.from_numpy(np.array(lights["tri"], np.int64)),
            **{k: torch.from_numpy(np.array(lights[k], np.float32))
               for k in LightSet._fields if k != "tri"}),
        ext_mr=opt("ext_mr"),
    )
    if arrays.get("mxu.tri_data") is None:
        if grid is None:
            raise ValueError("a scene without the MXU bake needs the grid's arrays")
        return TorchScene(
            tri_data=None, tile_bbox=None, tree_bbox=None, group_bbox=None,
            group_tree_bbox=None, perm=None, rec_table=None, bank=None, tile=0,
            emissive_dummy=False, group_tiles=0, bank_resident=False, **common,
        ).to(device)
    onehot = arrays.get("color_u16f_t")
    tiled = bool(arrays.get("tiled_layout"))
    rec = np.array(arrays["shade_table_t"], np.float32)
    if onehot is not None:
        bank = np.array(onehot, np.float32).T.copy()
    else:
        bank = _unpack_color_bank(arrays["color_packed_t"])
    if tiled:
        desc = np.asarray(arrays["color_desc"], np.int64)
        num_texels = int((desc[:, 0] + desc[:, 1] * desc[:, 2]).max())
        q, off_map, _ = tiled_texel_map(num_texels, desc)
        bank = bank[q]
        rec = _row_major_records(rec, desc, off_map)
    return TorchScene(
        tri_data=f32("mxu.tri_data"),
        tile_bbox=f32("mxu.tile_bbox"),
        tree_bbox=f32("mxu.tree_bbox"),
        group_bbox=f32("mxu.group_bbox"),
        group_tree_bbox=f32("mxu.group_tree_bbox"),
        perm=torch.from_numpy(np.array(arrays["mxu.perm"], np.int64)),
        rec_table=torch.from_numpy(rec),
        bank=torch.from_numpy(bank),
        tile=int(arrays["mxu.tile"]),
        emissive_dummy=bool(arrays["emissive_all_dummy"]),
        group_tiles=int(arrays["mxu.group_tiles"]),
        bank_resident=onehot is not None or tiled,
        **common,
    ).to(device)
