"""CLI: bake a 2-channel blue-noise PNG into the runtime noise asset.

Parity with the reference's Rust codegen tool (tools/blue_noise/src/main.rs:
1-58, PNG -> blue_noise.{h,c} C arrays): reads an RG blue-noise texture
(e.g. momentsingraphics 128_128_LDR_RG01_0.png) and writes blue_noise.npz
consumed by render/rng.py.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from ..utils.image import read_png


def bake_png(png_path, out_path) -> None:
    img = read_png(png_path)
    assert img.ndim == 3 and img.shape[2] >= 2, "need an RG(BA) texture"
    tile = img[:, :, :2].astype(np.uint8)
    np.savez_compressed(out_path, tile=tile)
    print(f"wrote {out_path} ({tile.shape[0]}x{tile.shape[1]} RG tile)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("png", type=pathlib.Path)
    parser.add_argument(
        "-o",
        "--output",
        type=pathlib.Path,
        default=pathlib.Path(__file__).resolve().parent.parent / "assets" / "blue_noise.npz",
    )
    args = parser.parse_args(argv)
    bake_png(args.png, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
