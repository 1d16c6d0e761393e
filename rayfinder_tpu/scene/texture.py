"""CPU-side texture representation.

Textures are stored as packed BGRA uint32 pixels — the same in-memory layout
the reference uploads to the GPU (src/common/texture.{hpp,cpp}), so that the
`.pt` scene format round-trips bit-exactly and the renderer's texel unpack
(b | g<<8 | r<<16 | a<<24) matches the reference's WGSL `textureLookup`
(src/pt/reference_path_tracer.wgsl:552-565).
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from ..utils.image import PNG_SIGNATURE, decode_png


@dataclasses.dataclass(frozen=True)
class Texture:
    """An RGBA image packed as row-major BGRA uint32 pixels.

    pixels: (height * width,) uint32, top-left pixel first.
    """

    pixels: np.ndarray
    width: int
    height: int

    def __post_init__(self):
        assert self.pixels.dtype == np.uint32
        assert self.pixels.size == self.width * self.height

    @staticmethod
    def from_memory(data: bytes) -> "Texture":
        """Decode PNG/JPEG bytes into a BGRA texture.

        Matches Texture::fromMemory (src/common/texture.cpp:12-54): output is
        always 4-channel with alpha forced to 255 (stb fills alpha for 3-channel
        sources; the reference then overwrites alpha with 255 for all sources).
        PNGs go through the built-in decoder (utils/image.decode_png); only
        other formats, such as JPEG, need Pillow.
        """
        if data[:8] == PNG_SIGNATURE:
            rgba = decode_png(data)
            if rgba.shape[2] <= 2:  # grey (+alpha): replicate into RGB
                rgba = np.repeat(rgba[:, :, :1], 3, axis=2)
        else:
            rgba = _decode_with_pillow(data)
        rgba = rgba.astype(np.uint32)
        h, w = rgba.shape[:2]
        r, g, b = rgba[..., 0], rgba[..., 1], rgba[..., 2]
        bgra = b | (g << np.uint32(8)) | (r << np.uint32(16)) | np.uint32(255 << 24)
        return Texture(bgra.reshape(-1).astype(np.uint32), width=w, height=h)

    @staticmethod
    def from_pixel(r: float, g: float, b: float, a: float) -> "Texture":
        """1x1 solid-color texture (src/common/texture.cpp:56-65)."""
        r8, g8, b8, a8 = (np.uint32(int(c * 255.0)) for c in (r, g, b, a))
        px = b8 | (g8 << np.uint32(8)) | (r8 << np.uint32(16)) | (a8 << np.uint32(24))
        return Texture(np.asarray([px], dtype=np.uint32), width=1, height=1)

    def to_rgba(self) -> np.ndarray:
        """Unpack to (height, width, 4) uint8 RGBA."""
        px = self.pixels.reshape(self.height, self.width)
        b = px & np.uint32(0xFF)
        g = (px >> np.uint32(8)) & np.uint32(0xFF)
        r = (px >> np.uint32(16)) & np.uint32(0xFF)
        a = (px >> np.uint32(24)) & np.uint32(0xFF)
        return np.stack([r, g, b, a], axis=-1).astype(np.uint8)


def _decode_with_pillow(data: bytes) -> np.ndarray:
    """Non-PNG image bytes -> (H, W, 4) uint8 RGBA through Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding a non-PNG texture (for example JPEG) needs Pillow, "
            "which is not installed; convert the texture to PNG or install Pillow"
        ) from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), dtype=np.uint8)
