"""PNG I/O and image-comparison helpers.

The PNG codec is numpy plus the standard library's zlib, so the render path
(textures, goldens, tool output) needs no imaging package. It reads 8-bit,
non-interlaced grey, grey+alpha, RGB, RGBA and palette images with any of
the five row filters, and writes grey/RGB/RGBA with filter 0.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PNG colour type -> channels of its 8-bit samples.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8 with C in 1..4 -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8 samples, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png needs (H, W) or (H, W, 1..4), got {image.shape}")
    h, w, c = image.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1
    )  # filter byte 0 (None) on every row
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9): (h, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    data = data.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = data[y, 0], data[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: cumulative sum along each channel, mod 256
            padded = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            padded[:stride] = line
            cur = np.cumsum(padded.reshape(-1, bpp), axis=0, dtype=np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            acc = bytearray(stride)
            up = prev.tolist()
            for i, f in enumerate(line.tolist()):
                a = acc[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                acc[i] = (f + pred) & 0xFF
            cur = np.frombuffer(bytes(acc), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8. Palette images come back as RGB, or RGBA
    when they carry transparency; other colour types keep their channels
    (grey 1, grey+alpha 2, RGB 3, RGBA 4). Raises ValueError for a malformed
    file or one outside the supported subset (8-bit, non-interlaced)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    header = None
    palette = trns = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no image data")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); only 8-bit non-interlaced images are read"
        )
    channels = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    pixels = pixels.reshape(h, w, channels)
    if color != 3:
        return pixels
    if palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    index = pixels[:, :, 0]
    if index.max(initial=0) >= palette.shape[0]:
        raise ValueError("PNG palette index out of range")
    rgb = palette[index]
    if trns is None:
        return rgb
    alpha = np.full(palette.shape[0], 255, np.uint8)
    alpha[: min(trns.size, alpha.size)] = trns[: alpha.size]
    return np.concatenate([rgb, alpha[index][:, :, None]], axis=-1)


def write_png(path, image: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 or float [0,1] image to PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
    pathlib.Path(path).write_bytes(encode_png(image))


def read_png(path) -> np.ndarray:
    """Read a PNG: (H, W) for grey, else (H, W, C) uint8 (see decode_png)."""
    pixels = decode_png(pathlib.Path(path).read_bytes())
    return pixels[:, :, 0] if pixels.shape[2] == 1 else pixels


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error over all channels, inputs in [0, 1]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.sqrt(np.mean((a - b) ** 2)))
