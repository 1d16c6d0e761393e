"""Benchmark: path-tracing throughput on one GPU.

Two configurations run in this one process with the default traversal
engine (render/pathtracer.DEFAULT_ENGINE):

* small: the seeded small open scene (scene/procedural.small_open_scene,
  loaded through its GLB) at 800x600, 4 bounces;
* courtyard: the textured 254K-triangle courtyard at 512x512, 4 bounces,
  loaded through the production asset path (GLB -> .pt -> device scene) and
  RMSE-gated against its quality golden (tools/make_quality_goldens.py).

Rays are counted exactly by the regen loop (pathtracer count_rays: one
closest-hit segment per bounce-loop iteration plus one NEE shadow ray per
surface hit, the accounting of reference_path_tracer.wgsl:180-234). Each
configuration runs one step of TIMED_SAMPLES samples to compile and warm up,
then one timed step of as many samples ended by `block_until_ready`, and
prints one JSON line that names the device. Without a GPU it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BOUNCES = 4
TIMED_SAMPLES = 16
_QUALITY_RMSE_BUDGET = 1e-3


def measure(name, scene, sky, camera, width, height, device, golden=None) -> dict:
    import jax.numpy as jnp

    from rayfinder_tpu.render.pathtracer import DEFAULT_ENGINE, accumulate_samples_regen
    from rayfinder_tpu.render.rng import blue_noise_tile
    from rayfinder_tpu.render.tonemap import tonemap

    tile = jnp.asarray(blue_noise_tile())

    def step(frame_base, accum):
        return accumulate_samples_regen(
            scene, sky, camera, tile, jnp.int32(frame_base), accum,
            width=width, height=height, num_bounces=BOUNCES, spp=256,
            num_frames=TIMED_SAMPLES, engine=DEFAULT_ENGINE, count_rays=True,
        )

    accum = jnp.zeros((width * height, 3), jnp.float32)
    t0 = time.perf_counter()
    accum, _ = step(0, accum)
    accum.block_until_ready()
    warmup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    accum, rays = step(TIMED_SAMPLES, accum)
    accum.block_until_ready()
    dt = time.perf_counter() - t0

    closest, shadow = (int(x) for x in np.asarray(rays))
    line = {
        "metric": f"{name}_{width}x{height}_{BOUNCES}bounce_path_trace",
        "value": (closest + shadow) / dt / 1e6,
        "unit": "Mrays/s",
        "engine": DEFAULT_ENGINE,
        "seconds": dt,
        "warmup_seconds": warmup_s,
        "closest_rays": closest,
        "shadow_rays": shadow,
        **device,
    }
    if golden is not None:
        ref = np.load(golden)["image"].astype(np.float32)
        img = tonemap(accum / jnp.float32(2 * TIMED_SAMPLES), jnp.float32(0.25))
        img = np.asarray(img, np.float32).reshape(height, width, 3)
        line["quality_rmse"] = float(np.sqrt(np.mean((img - ref) ** 2)))
        line["quality_ok"] = line["quality_rmse"] < _QUALITY_RMSE_BUDGET
    return line


def main() -> int:
    from rayfinder_tpu.utils.profiling import gpu_record

    try:
        device = gpu_record()
    except RuntimeError as e:
        print(f"bench.py: {e}; this benchmark measures the GPU only", file=sys.stderr)
        return 1

    from tools.make_quality_goldens import COURTYARD_GOLDEN, courtyard_config, small_config

    scene, sky, camera, kw = small_config()
    print(json.dumps(measure("small", scene, sky, camera, kw["width"], kw["height"], device)),
          flush=True)
    scene, sky, camera, kw = courtyard_config()
    print(json.dumps(measure("courtyard", scene, sky, camera, kw["width"], kw["height"],
                             device, golden=COURTYARD_GOLDEN)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
