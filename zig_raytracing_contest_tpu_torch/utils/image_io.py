"""Host-side PNG decode/encode with stb-compatible semantics, zlib + NumPy.

The port of ``zig_raytracing_contest_tpu/utils/image_io.py`` without
Pillow: the machine that runs the port has no Pillow, so this module
carries its own PNG codec on the standard library's ``zlib``.

The reference decodes textures with ``stbi_loadf_from_memory(..., 4)``
(src/stage1.zig:58-64): every image becomes float RGBA where 8-bit color
channels are linearized as ``(x/255)^2.2`` (stb's ldr_to_hdr, gamma 2.2,
scale 1.0) and alpha stays linear ``a/255``; 16-bit sources are reduced to
8-bit first.  ``actual_c`` is the source channel count before forcing RGBA —
the alpha-texture path keys off it (src/stage1.zig:452).

Decode covers non-interlaced PNG: 8-bit gray, gray+alpha, RGB and RGBA;
palette images (1/2/4/8-bit) with and without ``tRNS``; 16-bit gray, reduced
to 8 bits by 257 as the JAX package does.  Anything else (interlaced PNG,
JPEG, 16-bit color, color-key ``tRNS``) raises ``ValueError``.  Encode writes
8-bit L/LA/RGB/RGBA, non-interlaced, filter type 0.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

LDR_GAMMA = 2.2  # stb default stbi_ldr_to_hdr_gamma

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PNG color type → samples per pixel
_COLOR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ENCODE_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → PNG color type


@dataclass
class DecodedImage:
    """f32 RGBA pixels, gamma-linearized, plus the source channel count."""

    width: int
    height: int
    actual_c: int  # channels in the source file (1/2/3/4)
    pixels: np.ndarray  # (height * width, 4) float32, row-major from the top


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: missing IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters → (height, stride) uint8."""
    if raw.size != height * (stride + 1):
        raise ValueError("PNG: image data size does not match the header")
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane of a pixel
            pad = -(-stride // bpp) * bpp
            tmp = np.zeros(pad, np.int32)
            tmp[:stride] = line
            cur = (np.cumsum(tmp.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
            cur = cur[:stride]
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential per pixel
            cur = np.zeros(stride, np.int32)
            zero = np.zeros(bpp, np.int32)
            for x0 in range(0, stride, bpp):
                sl = slice(x0, min(x0 + bpp, stride))
                n = sl.stop - sl.start
                left = cur[x0 - bpp : x0 - bpp + n] if x0 >= bpp else zero[:n]
                up = prior[sl]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = (
                        prior[x0 - bpp : x0 - bpp + n] if x0 >= bpp else zero[:n]
                    )
                    pred = _paeth(left, up, upleft)
                cur[sl] = (line[sl] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, stride) uint8 of packed sub-byte samples → (h, width) uint8."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)  # MSB first, as PNG packs them
    h = rows.shape[0]
    bits = bits[:, : width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2).astype(np.uint8)


def _decode_png_rgba8(data: bytes):
    """PNG bytes → ((h, w, 4) uint8 RGBA, actual_c)."""
    header = None
    palette = None
    trns = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: missing IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if comp != 0 or filt != 0:
        raise ValueError("PNG: unknown compression or filter method")
    if interlace != 0:
        raise ValueError("PNG: interlaced images are not supported")
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"PNG: unknown color type {ctype}")
    supported = (
        (ctype == 3 and depth in (1, 2, 4, 8))
        or (ctype == 0 and depth in (8, 16))
        or (ctype in (2, 4, 6) and depth == 8)
    )
    if not supported:
        raise ValueError(
            f"PNG: color type {ctype} at bit depth {depth} is not supported"
        )
    if trns is not None and ctype != 3:
        raise ValueError("PNG: color-key transparency (tRNS) is not supported")
    channels = _COLOR_TYPES[ctype]
    bits_pp = channels * depth
    stride = -(-width * bits_pp // 8)
    bpp = max(1, bits_pp // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw, height, stride, bpp)

    if ctype == 0 and depth == 16:
        # Reduced to 8 bits exactly like the JAX package's Pillow path:
        # f32(value) / 257, clipped, truncated.
        v16 = rows.reshape(height, width * 2).view(">u2").astype(np.float32)
        gray = np.clip(v16 / 257.0, 0, 255).astype(np.uint8)
        return np.stack([gray, gray, gray, np.full_like(gray, 255)], -1), 1
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        index = _unpack_bits(rows, width, depth)
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            n = min(len(trns), len(palette))
            alpha[:n] = trns[:n]
        rgba = np.concatenate([palette, alpha[:, None]], axis=1)
        return rgba[index], (4 if trns is not None else 3)
    px = rows.reshape(height, width, channels)
    opaque = np.full((height, width, 1), 255, np.uint8)
    if channels == 1:
        return np.concatenate([px, px, px, opaque], -1), 1
    if channels == 2:
        g = px[..., :1]
        return np.concatenate([g, g, g, px[..., 1:]], -1), 2
    if channels == 3:
        return np.concatenate([px, opaque], -1), 3
    return np.ascontiguousarray(px), 4


def decode_image(data: bytes) -> DecodedImage:
    """Decode PNG bytes to stb-loadf-style f32 RGBA."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("unsupported image format: only PNG is decoded")
    rgba, actual_c = _decode_png_rgba8(data)
    u8 = rgba.astype(np.float32) / 255.0  # (h, w, 4)
    out = np.empty_like(u8)
    out[..., :3] = u8[..., :3] ** LDR_GAMMA
    out[..., 3] = u8[..., 3]
    h, w = out.shape[:2]
    return DecodedImage(w, h, actual_c, out.reshape(h * w, 4).astype(np.float32))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def _encode_png(pixels: np.ndarray) -> bytes:
    """(h, w, c) uint8, c in 1..4 → PNG bytes (8-bit, filter 0)."""
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] not in _ENCODE_TYPES:
        raise ValueError(
            f"expected (h, w, 1..4) uint8, got {pixels.shape} {pixels.dtype}"
        )
    h, w, c = pixels.shape
    rows = np.zeros((h, w * c + 1), np.uint8)
    rows[:, 1:] = pixels.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _ENCODE_TYPES[c], 0, 0, 0)
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (h, w, 3) uint8 rows top-first, like stbi_write_png."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {rgb.shape} {rgb.dtype}")
    with open(path, "wb") as f:
        f.write(_encode_png(rgb))


def encode_srgb_png_bytes(rgba_u8: np.ndarray) -> bytes:
    """Encode (h, w, c) uint8 to PNG bytes — used by procedural test scenes."""
    return _encode_png(np.ascontiguousarray(rgba_u8))
