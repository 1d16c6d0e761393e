"""Showcase-scale configurations, and the quality golden of the courtyard.

The committed thumbnail goldens (tests/test_goldens.py, 64x48 @ 2spp) pin
semantics but nothing pins image quality at real resolution. This module
holds the two smoke configurations that chip_smoke.py and bench.py render —
the small open scene (800x600) and the 254K-triangle courtyard (512x512),
both loaded through the production asset paths — and renders the
courtyard's golden with the XLA wavefront engine, an independent traversal
that agrees tri-for-tri with the lockstep oracle (tests/test_wavefront.py).
The golden is the tonemapped mean image, stored as float16 NPZ.

Budget: identical deterministic sample sequences (same blue-noise streams),
so true engine agreement is at accumulation-order ulps (~1e-6); the f16
quantization adds ~1.4e-4 RMSE; the gate is 1e-3. Regenerate ONLY when the
sampling sequence intentionally changes (rng streams, bounce logic), never
to paper over a traversal/shading diff.

Run on the GPU (the wavefront engine is slow on the CPU at this size):
    python -u tools/make_quality_goldens.py
"""
import pathlib
import sys
import tempfile

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[1] / "tests" / "goldens"
COURTYARD_GOLDEN = GOLDEN_DIR / "quality_courtyard_512x512_32spp.npz"


def quality_image(scene, sky, camera, *, width, height, num_frames, engine,
                  num_bounces=4, exposure=0.25):
    """Two num_frames regen steps with exact ray counting, as a tonemapped
    mean image — shared by golden generation, chip_smoke.py and bench.py."""
    from rayfinder_tpu.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu.render.rng import blue_noise_tile
    from rayfinder_tpu.render.tonemap import tonemap

    tile = jnp.asarray(blue_noise_tile())
    accum = jnp.zeros((width * height, 3), jnp.float32)
    for base in (0, num_frames):
        accum, _ = accumulate_samples_regen(
            scene, sky, camera, tile, jnp.int32(base), accum,
            width=width, height=height, num_bounces=num_bounces, spp=256,
            num_frames=num_frames, engine=engine, count_rays=True)
    mean = accum / jnp.float32(2 * num_frames)
    img = tonemap(mean, jnp.float32(exposure))
    return np.asarray(img, np.float32).reshape(height, width, 3)


def small_config(width=800, height=600):
    """The seeded small open scene, written as a GLB and loaded through
    load_device_scene (the glTF path), with its camera and sky."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.scene import load_device_scene
    from rayfinder_tpu.scene.procedural import write_small_open_glb
    from rayfinder_tpu.sky.model import sky_state_from_ui

    with tempfile.TemporaryDirectory() as tmp:
        scene = load_device_scene(write_small_open_glb(pathlib.Path(tmp) / "small.glb"))
    camera = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0,
                           width / height)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    return scene, sky, camera, dict(width=width, height=height)


def courtyard_config(width=512, height=512):
    """The textured 254K-triangle courtyard through the production asset
    path (GLB -> .pt -> device scene), with its camera and sky."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu.sky.model import sky_state_from_ui
    from rayfinder_tpu.tools.export_glb import device_scene_via_pt

    flat, textures = courtyard_scene(26, textured=True)
    with tempfile.TemporaryDirectory() as tmp:
        scene = device_scene_via_pt(flat, textures, tmp)
    camera = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0,
                           70.0, width / height)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    return scene, sky, camera, dict(width=width, height=height, num_frames=16)


def main():
    scene, sky, camera, kw = courtyard_config()
    img = quality_image(scene, sky, camera, engine="wavefront", **kw)
    np.savez_compressed(COURTYARD_GOLDEN, image=img.astype(np.float16))
    print(f"wrote {COURTYARD_GOLDEN} ({COURTYARD_GOLDEN.stat().st_size/1e6:.2f} MB, "
          f"mean {img.mean():.4f})", flush=True)


if __name__ == "__main__":
    main()
