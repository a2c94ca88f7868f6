"""PNG encoding for the scene writers: a frozen copy of the port's encoder
(``zig_raytracing_contest_tpu_torch/utils/image_io.py``), zlib + NumPy, 8-bit
L/LA/RGB/RGBA, non-interlaced, filter type 0.  Kept here so that a change
to the port's encoder cannot change the benchmark's scenes."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ENCODE_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → PNG color type


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


def encode_srgb_png_bytes(rgba_u8: np.ndarray) -> bytes:
    """Encode (h, w, c) uint8 to PNG bytes — used by procedural test scenes."""
    return _encode_png(np.ascontiguousarray(rgba_u8))
