"""The built-in PNG codec (utils/image.py) and the Pillow-free render path.

The decoder is checked against PNGs that this test filters and packs itself
(an independent, straightforward implementation of the five row filters,
PNG spec section 9), so a filter bug cannot cancel out between encoder and
decoder."""

import struct
import sys
import zlib

import numpy as np
import pytest

from rayfinder_tpu.utils.image import decode_png, encode_png, read_png, write_png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(img: np.ndarray, kinds) -> bytes:
    """Forward PNG filtering, one filter type per row, in plain Python."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(int).tolist()
    out = bytearray()
    prev = [0] * (w * c)
    for y, row in enumerate(rows):
        kind = kinds[y % len(kinds)]
        out.append(kind)
        for i, x in enumerate(row):
            a = row[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][kind]
            out.append((x - pred) % 256)
        prev = row
    return bytes(out)


def _png(width, height, color_type, filtered: bytes, extra=(), depth=8, interlace=0) -> bytes:
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, interlace)
    body = b"".join(chunk(k, d) for k, d in extra)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + body
        + chunk(b"IDAT", zlib.compress(filtered)) + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("channels, color_type", [(1, 0), (2, 4), (3, 2), (4, 6)])
def test_decoder_handles_all_five_filters(channels, color_type):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(13, 17, channels), dtype=np.uint8)
    img[4:9] = img[3]  # flat runs exercise the Up / Average predictors
    data = _png(17, 13, color_type, _filter_rows(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(decode_png(data), img)


def test_decoder_expands_palette_with_transparency():
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, size=(7, 3), dtype=np.uint8)
    alpha = np.asarray([255, 0, 128], np.uint8)  # tRNS may be shorter than PLTE
    index = rng.integers(0, 7, size=(9, 11, 1), dtype=np.uint8)
    extra = [(b"PLTE", palette.tobytes())]
    plain = decode_png(_png(11, 9, 3, _filter_rows(index, [4, 1]), extra))
    np.testing.assert_array_equal(plain, palette[index[..., 0]])
    extra.append((b"tRNS", alpha.tobytes()))
    rgba = decode_png(_png(11, 9, 3, _filter_rows(index, [3, 2]), extra))
    full_alpha = np.concatenate([alpha, np.full(4, 255, np.uint8)])
    np.testing.assert_array_equal(rgba[..., :3], palette[index[..., 0]])
    np.testing.assert_array_equal(rgba[..., 3], full_alpha[index[..., 0]])


def test_decoder_rejects_malformed_and_unsupported():
    good = encode_png(np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])
    corrupt = bytearray(good)
    corrupt[20] ^= 0xFF  # inside IHDR: the chunk CRC no longer matches
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        decode_png(bytes(corrupt))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(_png(1, 1, 2, b"\x00" * 7, depth=16))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(_png(1, 1, 2, b"\x00" * 4, interlace=1))


def test_render_path_needs_no_pillow(monkeypatch, tmp_path):
    """With Pillow unimportable, the textured courtyard (14 PNG-decoded
    textures) builds, write_png/read_png round-trip exactly, and only a
    non-PNG texture asks for Pillow, with a clear error."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu.scene.texture import Texture

    flat, textures = courtyard_scene(2, textured=True)
    assert len(textures) == 14
    scene = build_device_scene(flat, textures=textures)
    assert scene.num_triangles == flat.num_triangles

    img = np.random.default_rng(1).integers(0, 256, size=(31, 29, 3), dtype=np.uint8)
    write_png(tmp_path / "rt.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "rt.png"), img)
    grey = img[..., 0]
    write_png(tmp_path / "grey.png", grey)
    np.testing.assert_array_equal(read_png(tmp_path / "grey.png"), grey)

    with pytest.raises(ImportError, match="non-PNG texture"):
        Texture.from_memory(b"\xff\xd8\xff\xe0" + b"\x00" * 16)  # a JPEG header
