"""The port's zlib + NumPy PNG codec against Pillow and the JAX package.

Decoding a PNG must give what the JAX package's Pillow decoder gives (the
same f32 RGBA and source channel count), and the port's encoder must write
PNGs that Pillow reads back unchanged.
"""

import io

import numpy as np
import pytest
from PIL import Image

from zig_raytracing_contest_tpu.utils import image_io as jio
from zig_raytracing_contest_tpu_torch.utils import image_io as tio


def _pillow_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _sample(mode, seed=0, h=13, w=17):
    r = np.random.default_rng(seed)
    if mode == "L":
        return Image.fromarray(r.integers(0, 256, (h, w), dtype=np.uint8), mode="L")
    if mode == "LA":
        return Image.fromarray(r.integers(0, 256, (h, w, 2), dtype=np.uint8), mode="LA")
    if mode == "RGB":
        return Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8), mode="RGB")
    if mode == "RGBA":
        return Image.fromarray(r.integers(0, 256, (h, w, 4), dtype=np.uint8), mode="RGBA")
    if mode == "I;16":
        return Image.fromarray(r.integers(0, 65536, (h, w), dtype=np.uint16))
    raise ValueError(mode)


def _palette(seed, colors, transparency):
    r = np.random.default_rng(seed)
    img = Image.fromarray(r.integers(0, colors, (11, 19), dtype=np.uint8), mode="P")
    pal = r.integers(0, 256, (colors, 3), dtype=np.uint8)
    img.putpalette(pal.reshape(-1).tolist())
    kw = {}
    if transparency:
        kw["transparency"] = bytes(r.integers(0, 256, colors // 2, dtype=np.uint8))
    return img, kw


CASES = ["L", "LA", "RGB", "RGBA", "I;16", "P", "P+tRNS", "P4+tRNS"]


def _png(case):
    if case.startswith("P"):
        colors = 16 if case.startswith("P4") else 200
        img, kw = _palette(3, colors, "tRNS" in case)
        if colors == 16:
            kw["bits"] = 4
        return _pillow_png(img, **kw)
    return _pillow_png(_sample(case))


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_jax_pillow_decoder(case):
    data = _png(case)
    want = jio.decode_image(data)
    got = tio.decode_image(data)
    assert (got.width, got.height, got.actual_c) == (want.width, want.height, want.actual_c)
    np.testing.assert_array_equal(got.pixels, want.pixels)


def test_decode_all_filter_types():
    """Pillow's optimizer picks per-row filters; a large noisy-gradient image
    exercises Sub, Up, Average and Paeth rows."""
    y, x = np.mgrid[0:64, 0:96]
    r = np.random.default_rng(1)
    arr = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y) % 256,
                    r.integers(200, 256, x.shape)], -1).astype(np.uint8)
    data = _pillow_png(Image.fromarray(arr, mode="RGBA"), optimize=True)
    got = tio._decode_png_rgba8(data)[0]
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_round_trips_through_pillow(channels, tmp_path):
    r = np.random.default_rng(channels)
    arr = r.integers(0, 256, (9, 14, channels), dtype=np.uint8)
    data = tio.encode_srgb_png_bytes(arr)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    # and through the port's own decoder: same f32 as the JAX decoder
    np.testing.assert_array_equal(
        tio.decode_image(data).pixels, jio.decode_image(data).pixels
    )
    if channels == 3:
        tio.write_png(str(tmp_path / "o.png"), arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")), arr)


def test_rejects_what_it_cannot_decode():
    with pytest.raises(ValueError, match="only PNG"):
        tio.decode_image(b"\xff\xd8\xff\xe0" + b"\0" * 32)  # JPEG
    # Pillow does not write Adam7; flip the IHDR interlace byte of a valid
    # PNG (the decoder must refuse before reading pixel data).
    import struct

    plain = tio.encode_srgb_png_bytes(np.zeros((4, 4, 3), np.uint8))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    interlaced = (
        tio.PNG_SIGNATURE + tio._chunk(b"IHDR", ihdr) + plain[8 + 25 :]
    )
    with pytest.raises(ValueError, match="interlaced"):
        tio.decode_image(interlaced)
    with pytest.raises(ValueError):
        tio.write_png("unused.png", np.zeros((2, 2, 4), np.uint8))
