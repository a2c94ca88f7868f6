"""Material/texture baking into flat texture banks.

A copy of ``zig_raytracing_contest_tpu/scene/materials.py`` (NumPy only):
the bank, descriptors and u16 quantization are bit-identical by
construction, which tests/test_torch_bake.py pins.

Mirrors stage1.loadMaterials (src/stage1.zig:381-496): per material, three
logical textures — base_color (RGB × baseColorFactor), emissive (RGB ×
emissiveFactor) and "transparency" (actually opacity: the base-color alpha
channel for non-opaque materials whose source image really has alpha,
thresholded by alphaCutoff in MASK mode).  Absent textures become 1×1
dummies holding the factor (src/stage1.zig:411-425).  Sampler clamp_to_edge
sets per-axis clamp ranges; anything else is repeat encoded as the full
int32 range (src/stage1.zig:381-409).

Design: all texels concatenate into ONE flat (P, 4) RGBA bank with
per-texture descriptor rows [offset, w, h, u_min, u_max, v_min, v_max]
(int32).  The reference's separate transparency texture is, by construction,
the alpha channel of the very same base-color image (src/stage1.zig:449-452)
— so opacity rides in channel 3 of the base-color entry and one bilinear
sample yields albedo AND opacity (per-texel MASK thresholding is baked, then
bilinear, exactly like the reference's order).  This halves the texel
gathers in the shading hot path.
Emissive entries carry 1.0 in channel 3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gltf import WRAP_CLAMP_TO_EDGE

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

# Descriptor column layout (int32):
DESC_OFFSET = 0
DESC_W = 1
DESC_H = 2
DESC_U_MIN = 3
DESC_U_MAX = 4
DESC_V_MIN = 5
DESC_V_MAX = 6
DESC_COLS = 7


@dataclass
class MaterialBank:
    color_data: np.ndarray  # (P, 4) f32 — RGBA texels (A = opacity semantics)
    color_desc: np.ndarray  # (N, 7) int32
    mat_base: np.ndarray  # (M,) int32 → color_desc row (albedo + opacity)
    mat_emissive: np.ndarray  # (M,) int32 → color_desc row
    # u16 quantization twins (see _quantize_bank): color_data ==
    # color_u16 * color_scale[desc] exactly, in f32 arithmetic.
    color_u16: np.ndarray | None = None  # (P, 4) uint16
    color_scale: np.ndarray | None = None  # (N,) f32 dequant multiplier
    # Metallic/roughness factors — the reference ignores them
    # (src/stage1.zig:471-483); parsed for the opt-in pbr extension only.
    mat_metallic: np.ndarray | None = None  # (M,) f32
    mat_roughness: np.ndarray | None = None  # (M,) f32

    @property
    def num_materials(self) -> int:
        return self.mat_base.shape[0]


def _quantize_bank(color_data: np.ndarray, color_desc: np.ndarray):
    """Quantize every texture entry to u16 × per-entry scale, in place.

    The fused pipelines read texels as u16 values times a per-texture
    scale; the f32 bank is rewritten to the dequantized
    values so every backend (XLA, Pallas, native C++) samples bit-identical
    texels.  Sources are 8-bit LDR (stb loadf semantics), so 16-bit
    relative-to-max quantization is far below the source's own precision.
    Texels are clamped at 0 (glTF factors and decoded colors are
    non-negative).
    """
    color_u16 = np.zeros(color_data.shape, np.uint16)
    color_scale = np.ones(len(color_desc), np.float32)
    for i, d in enumerate(color_desc):
        sl = slice(int(d[0]), int(d[0]) + int(d[1]) * int(d[2]))
        texels = np.maximum(color_data[sl], 0.0).astype(np.float32)
        peak = float(texels.max()) if texels.size else 0.0
        qs = np.float32(peak if peak > 0 else 1.0) / np.float32(65535.0)
        halfs = np.clip(np.rint(texels / qs), 0, 65535).astype(np.uint16)
        color_u16[sl] = halfs
        # EXACTLY the dequant the fused kernel performs: f32(u16) * qs.
        color_data[sl] = halfs.astype(np.float32) * qs
        color_scale[i] = qs
    return color_u16, color_scale


def _wrap_ranges(gltf, texture: dict, w: int, h: int) -> tuple[int, int, int, int]:
    u_min, u_max = INT32_MIN, INT32_MAX
    v_min, v_max = INT32_MIN, INT32_MAX
    if "sampler" in texture:
        sampler = gltf.doc["samplers"][texture["sampler"]]
        if sampler.get("wrapS") == WRAP_CLAMP_TO_EDGE:
            u_min, u_max = 0, w - 1
        if sampler.get("wrapT") == WRAP_CLAMP_TO_EDGE:
            v_min, v_max = 0, h - 1
    return u_min, u_max, v_min, v_max


class _Bank:
    """Accumulates RGBA texel blobs + descriptors with dedup by cache key."""

    def __init__(self):
        self.blobs: list[np.ndarray] = []
        self.descs: list[list[int]] = []
        self.offset = 0
        self.cache: dict = {}

    def add(self, key, texels: np.ndarray, w: int, h: int, wrap) -> int:
        if key in self.cache:
            return self.cache[key]
        idx = len(self.descs)
        self.blobs.append(texels.reshape(-1, 4).astype(np.float32))
        self.descs.append([self.offset, w, h, *wrap])
        self.offset += w * h
        self.cache[key] = idx
        return idx

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.blobs:
            self.blobs.append(np.ones((1, 4), np.float32))
            self.descs.append([0, 1, 1, 0, 0, 0, 0])
        return np.concatenate(self.blobs, axis=0), np.asarray(self.descs, np.int32)


def _opacity_channel(gltf, material: dict, image) -> tuple:
    """Per-texel opacity for a textured base color, or a constant.

    Reference semantics (src/stage1.zig:447-469): only non-opaque materials
    whose source image really has alpha (actual_c 4 or 2) get the alpha
    channel; MASK mode thresholds per-texel by alphaCutoff; everything else
    is constant 1.0.  Returns (key_part, (P,) array or None for constant 1).
    """
    alpha_mode = material.get("alphaMode", "OPAQUE")
    if alpha_mode != "OPAQUE" and image.actual_c in (4, 2):
        alpha = image.pixels[:, 3]
        if alpha_mode == "MASK":
            cutoff = np.float32(material.get("alphaCutoff", 0.5))
            return ("mask", float(cutoff)), (alpha > cutoff).astype(np.float32)
        return ("blend",), alpha
    return ("opaque",), None


def _base_color_entry(bank: _Bank, gltf, material: dict) -> int:
    """Base color + opacity as one RGBA entry (src/stage1.zig:427-469)."""
    pbr = material.get("pbrMetallicRoughness", {})
    info = pbr.get("baseColorTexture")
    factor = np.asarray(
        pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3], np.float32
    )
    if info is not None:
        tex_idx = info["index"]
        texture = gltf.doc["textures"][tex_idx]
        image = gltf.images[texture["source"]]
        akey, opacity = _opacity_channel(gltf, material, image)
        key = ("base", tex_idx, tuple(np.round(factor, 7)), akey)
        if key in bank.cache:
            return bank.cache[key]
        texels = np.empty((image.pixels.shape[0], 4), np.float32)
        texels[:, :3] = image.pixels[:, :3] * factor
        texels[:, 3] = 1.0 if opacity is None else opacity
        wrap = _wrap_ranges(gltf, texture, image.width, image.height)
        return bank.add(key, texels, image.width, image.height, wrap)
    key = ("dummy", tuple(np.round(factor, 7)), 1.0)
    texel = np.concatenate([factor, [1.0]]).astype(np.float32)
    return bank.add(key, texel.reshape(1, 4), 1, 1, (0, 0, 0, 0))


def _emissive_entry(bank: _Bank, gltf, material: dict) -> int:
    """Emissive RGB × factor, alpha channel unused (1).
    (src/stage1.zig:477-479)."""
    info = material.get("emissiveTexture")
    factor = np.asarray(material.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float32)
    if info is not None:
        tex_idx = info["index"]
        texture = gltf.doc["textures"][tex_idx]
        image = gltf.images[texture["source"]]
        key = ("emis", tex_idx, tuple(np.round(factor, 7)))
        if key in bank.cache:
            return bank.cache[key]
        texels = np.empty((image.pixels.shape[0], 4), np.float32)
        texels[:, :3] = image.pixels[:, :3] * factor
        texels[:, 3] = 1.0
        wrap = _wrap_ranges(gltf, texture, image.width, image.height)
        return bank.add(key, texels, image.width, image.height, wrap)
    key = ("dummy", tuple(np.round(factor, 7)), 1.0)
    texel = np.concatenate([factor, [1.0]]).astype(np.float32)
    return bank.add(key, texel.reshape(1, 4), 1, 1, (0, 0, 0, 0))


def load_materials(gltf) -> MaterialBank:
    bank = _Bank()
    mat_base: list[int] = []
    mat_emissive: list[int] = []
    metallic: list[float] = []
    roughness: list[float] = []
    for material in gltf.doc.get("materials", []):
        mat_base.append(_base_color_entry(bank, gltf, material))
        mat_emissive.append(_emissive_entry(bank, gltf, material))
        pbr = material.get("pbrMetallicRoughness", {})
        metallic.append(float(pbr.get("metallicFactor", 1.0)))
        roughness.append(float(pbr.get("roughnessFactor", 1.0)))

    color_data, color_desc = bank.finish()
    color_u16, color_scale = _quantize_bank(color_data, color_desc)
    return MaterialBank(
        color_data=color_data,
        color_desc=color_desc,
        mat_base=np.asarray(mat_base or [0], np.int32),
        mat_emissive=np.asarray(mat_emissive or [0], np.int32),
        color_u16=color_u16,
        color_scale=color_scale,
        mat_metallic=np.asarray(metallic or [1.0], np.float32),
        mat_roughness=np.asarray(roughness or [1.0], np.float32),
    )
