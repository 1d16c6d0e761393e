"""Smoke test of the path tracer on NVIDIA GPUs: the quickest proof that the
system still starts and renders correctly on the card.

    python chip_smoke.py             # one card: all phases below
    python chip_smoke.py --cards 4   # four cards: the sharded render only

It runs in one process (plus one pytest child that exits before this process
first touches JAX) and stops at the first error. With one card, the phases:

1. Device: the card's name and power limit (nvidia-smi); JAX must see a GPU.
2. Card-only tests: `pytest -m gpu tests/` with JAX_PLATFORMS=cuda.
3. The walk against the lockstep oracle on the card, on the textured
   courtyard_scene(26) (254K triangles): 512x512 primary rays, one cosine
   bounce population from their hits, and shadow rays toward the sun.
4. The seeded small open scene, written as a GLB and loaded through
   load_device_scene: render_image at 800x600, 4 bounces, 16 spp with the
   default engine against the same render with engine="wavefront".
5. The courtyard through the production asset path (GLB -> .pt -> device
   scene): the 32-spp quality image against its golden, four progressive
   1920x1080 Renderer frames and four 1920x1080 DeferredRenderer frames,
   and the regen step's compiled memory analysis.
6. Timing: render_image end to end with engine="walk" and
   engine="wavefront" on both scenes.

With --cards 4 it renders the courtyard with render_image_sharded_regen on
(4,1) and (2,2) meshes and compares each with the single-card render_image.
The last line of output is one JSON object naming the device; on any
failure the script exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

# Phase 3 tolerances. nvcc and XLA may round the Möller-Trumbore arithmetic
# differently (the walk is built with -fmad=false, but XLA may contract to
# FMA), so a ray that grazes an edge may be accepted by one and not the
# other. No jnp matrix product is on the render path, so TF32 does not enter.
HIT_AGREEMENT = 0.9999
T_RTOL = 1e-5
RMSE_BUDGET = 1e-3
SHARDED_RTOL, SHARDED_ATOL = 2e-4, 2e-3


def phase(title: str) -> None:
    print(f"\n== {title} ==", flush=True)


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q", "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    print(proc.stdout[-4000:], proc.stderr[-2000:], sep="", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pytest -m gpu failed with exit code {proc.returncode}")


def rmse(a, b) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def check_walk_against_oracle(scene, sky, camera) -> None:
    """Phase 3: closest hit on primary and bounce rays, any hit on bounce
    and shadow rays, walk against the lockstep oracle."""
    import numpy as np
    import jax.numpy as jnp

    from rayfinder_tpu.ops.walk import walk_any, walk_closest
    from rayfinder_tpu.render.camera import generate_camera_ray
    from rayfinder_tpu.render.intersect import T_MAX, ray_triangle
    from rayfinder_tpu.render.pathtracer import _surface_interaction
    from rayfinder_tpu.render.sampling import sample_cosine_hemisphere
    from rayfinder_tpu.render.traverse import intersect_any, intersect_closest

    n = 512
    js, is_ = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    u = (js.reshape(-1) + 0.5).astype(np.float32) / n
    v = 1.0 - (is_.reshape(-1) + 0.5).astype(np.float32) / n
    o, d = generate_camera_ray(camera, jnp.asarray(u), jnp.asarray(v))

    def tri_t(tri, o, d):
        """t of each ray against a given triangle (for tie detection)."""
        verts = scene.tri_positions[jnp.maximum(tri, 0)]
        _, t, _, _ = ray_triangle(o, d, verts[:, 0], verts[:, 1], verts[:, 2], jnp.float32(np.inf))
        return np.asarray(t)

    def compare_closest(tag, o, d):
        hit, t, tri = (np.asarray(x) for x in walk_closest(scene, o, d, T_MAX))
        r_hit, r_t, r_tri, _ = (np.asarray(x) for x in intersect_closest(scene, o, d, T_MAX))
        agree = float((hit == r_hit).mean())
        both = hit & r_hit
        rel = np.abs(t - r_t)[both] / r_t[both]
        t_bad = int((rel > T_RTOL).sum())
        differ = both & (tri != r_tri)
        t_w, t_r = tri_t(jnp.asarray(tri), o, d), tri_t(jnp.asarray(r_tri), o, d)
        tie = np.abs(t_w - t_r) <= T_RTOL * np.abs(t_r)
        tri_bad = int((differ & ~tie).sum())
        print(f"closest {tag}: {hit.size} rays, hit agreement {agree:.6f}, "
              f"both hit {int(both.sum())}, |dt|/t max {rel.max(initial=0.0):.3e} "
              f"(> {T_RTOL}: {t_bad}), tri differs {int(differ.sum())} "
              f"(ties {int((differ & tie).sum())}, not ties {tri_bad})", flush=True)
        limit = (1.0 - HIT_AGREEMENT) * both.sum()
        if agree < HIT_AGREEMENT or t_bad > limit or tri_bad > limit:
            raise AssertionError(f"walk disagrees with the oracle on {tag} rays")
        return r_hit, r_tri

    def compare_any(tag, o, d):
        occ = np.asarray(walk_any(scene, o, d, T_MAX))
        r_occ = np.asarray(intersect_any(scene, o, d, T_MAX))
        agree = float((occ == r_occ).mean())
        print(f"any-hit {tag}: {occ.size} rays, occluded {float(r_occ.mean()):.4f}, "
              f"agreement {agree:.6f}", flush=True)
        if agree < HIT_AGREEMENT:
            raise AssertionError(f"walk any-hit disagrees with the oracle on {tag} rays")

    hit, tri = compare_closest("primary", o, d)
    p, nrm, _, _, _ = _surface_interaction(scene, o, d, jnp.asarray(np.maximum(tri, 0)))
    noise = jnp.asarray(np.random.default_rng(7).uniform(size=(o.shape[0], 2)).astype(np.float32))
    wi = sample_cosine_hemisphere(noise, nrm)
    park = jnp.float32(1e30)
    ok = jnp.asarray(hit) & jnp.all(jnp.isfinite(wi), axis=-1) & jnp.all(jnp.isfinite(p), axis=-1)
    bo = jnp.where(ok[:, None], p, park)
    bd = jnp.where(ok[:, None], wi, d)
    compare_closest("bounce", bo, bd)
    compare_any("bounce", bo, bd)
    sun = jnp.broadcast_to(jnp.asarray(sky.sun_direction), bo.shape)
    compare_any("shadow", bo, sun)


def check_small_scene(default_engine):
    from rayfinder_tpu.render.pathtracer import SamplingParams, render_image
    from tools.make_quality_goldens import small_config

    scene, sky, camera, kw = small_config(800, 600)
    print(f"small scene: {scene.num_triangles} triangles (loaded from its GLB)", flush=True)
    images = {}
    for engine in (default_engine, "wavefront"):
        images[engine] = render_image(scene, sky, camera, sampling=SamplingParams(16, 4),
                                      exposure=0.25, engine=engine, **kw)
    err = rmse(images[default_engine], images["wavefront"])
    print(f"small 800x600 16spp 4 bounces: RMSE {default_engine} vs wavefront {err:.3e} "
          f"(budget {RMSE_BUDGET})", flush=True)
    if not err < RMSE_BUDGET:
        raise AssertionError("small-scene render disagrees with the wavefront engine")
    return scene, sky, camera


def check_courtyard(scene, sky, camera, default_engine) -> None:
    import numpy as np
    import jax.numpy as jnp

    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.deferred import DeferredRenderer
    from rayfinder_tpu.render.pathtracer import SamplingParams, accumulate_samples_regen
    from rayfinder_tpu.render.renderer import Renderer, RenderParameters, Sky
    from rayfinder_tpu.render.rng import blue_noise_tile
    from tools.make_quality_goldens import COURTYARD_GOLDEN, quality_image

    img = quality_image(scene, sky, camera, width=512, height=512, num_frames=16,
                        engine=default_engine)
    err = rmse(img, np.load(COURTYARD_GOLDEN)["image"].astype(np.float32))
    print(f"courtyard 512x512 32spp: RMSE vs {COURTYARD_GOLDEN.name} {err:.3e} "
          f"(budget {RMSE_BUDGET})", flush=True)
    if not err < RMSE_BUDGET:
        raise AssertionError("courtyard drifted from its quality golden")

    lowered = accumulate_samples_regen.lower(
        scene, sky, camera, jnp.asarray(blue_noise_tile()), jnp.int32(0),
        jnp.zeros((512 * 512, 3), jnp.float32), width=512, height=512, num_bounces=4,
        spp=256, num_frames=16, engine=default_engine, count_rays=True,
    )
    print(f"regen step memory analysis: {lowered.compile().memory_analysis()}", flush=True)

    w, h = 1920, 1080
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    ui_sky = Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    renderer = Renderer(scene, RenderParameters(w, h, cam, SamplingParams(64, 4), ui_sky, 0.25))
    for frame in range(4):
        t0 = time.perf_counter()
        renderer.render(1)
        img8 = renderer.image_u8()
        dt = time.perf_counter() - t0
        print(f"Renderer 1920x1080 frame {frame}: {dt:.3f} s, mean {img8.mean():.2f}/255",
              flush=True)
        if img8.shape != (h, w, 3) or img8.max() == 0:
            raise AssertionError("progressive frame is black or misshapen")
    deferred = DeferredRenderer(scene, w, h)
    for frame in range(4):
        t0 = time.perf_counter()
        out = deferred.render(cam, ui_sky.state(), exposure=0.25)
        dt = time.perf_counter() - t0
        print(f"DeferredRenderer 1920x1080 frame {frame}: {dt:.3f} s, mean {out.mean():.4f}",
              flush=True)
        if out.shape != (h, w, 3) or not np.isfinite(out).all() or out.max() == 0:
            raise AssertionError("deferred frame is black, non-finite or misshapen")


def time_engines(scenes, card: str) -> None:
    """render_image end to end per engine: one call to compile, then a timed
    call. Rays are counted by the regen loop for the same samples (the
    count does not depend on the engine or the accumulator)."""
    import numpy as np
    import jax.numpy as jnp

    from rayfinder_tpu.render.pathtracer import SamplingParams, accumulate_samples_regen, render_image
    from rayfinder_tpu.render.rng import blue_noise_tile

    for name, (scene, sky, camera, w, h, spp) in scenes.items():
        _, rays = accumulate_samples_regen(
            scene, sky, camera, jnp.asarray(blue_noise_tile()), jnp.int32(0),
            jnp.zeros((w * h, 3), jnp.float32), width=w, height=h, num_bounces=4,
            spp=spp, num_frames=spp, count_rays=True,
        )
        total = int(np.asarray(rays, np.int64).sum())
        for engine in ("walk", "wavefront"):
            kw = dict(width=w, height=h, sampling=SamplingParams(spp, 4), exposure=0.25,
                      engine=engine)
            t0 = time.perf_counter()
            render_image(scene, sky, camera, **kw)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            render_image(scene, sky, camera, **kw)  # returns a host array: synced
            dt = time.perf_counter() - t0
            print(f"timing {name} {w}x{h} {spp}spp 4 bounces engine={engine}: "
                  f"{dt:.4f} s, {total / dt / 1e6:.3f} Mrays/s ({total} rays; first call "
                  f"with compile {first:.2f} s) on {card}", flush=True)


def check_sharded(scene, sky, camera, card: str) -> None:
    import numpy as np
    import jax

    from rayfinder_tpu.parallel.sharding import make_render_mesh, render_image_sharded_regen
    from rayfinder_tpu.render.pathtracer import SamplingParams, render_image

    w = h = 512
    spp = 8
    t0 = time.perf_counter()
    single = render_image(scene, sky, camera, width=w, height=h,
                          sampling=SamplingParams(spp, 4), exposure=0.25)
    print(f"single card render_image 512x512 8spp: {time.perf_counter() - t0:.2f} s", flush=True)
    for tiles, samples in ((4, 1), (2, 2)):
        mesh = make_render_mesh(jax.devices()[:4], sample_parallel=samples)
        t0 = time.perf_counter()
        sharded = render_image_sharded_regen(scene, sky, camera, mesh=mesh, width=w, height=h,
                                             spp=spp, num_bounces=4, exposure=0.25)
        dt = time.perf_counter() - t0
        diff = np.abs(sharded - single)
        print(f"mesh (tiles={tiles}, samples={samples}): {dt:.2f} s, max |diff| "
              f"{diff.max():.3e}, on {card}", flush=True)
        np.testing.assert_allclose(sharded, single, rtol=SHARDED_RTOL, atol=SHARDED_ATOL)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)
    if not (REPO / "rayfinder_tpu").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from rayfinder_tpu.utils.profiling import card_description

    phase("phase 1: device")
    card = card_description()
    print(f"card: {card}", flush=True)
    if args.cards == 1:
        phase("phase 2: card-only tests (pytest -m gpu, JAX_PLATFORMS=cuda)")
        run_gpu_tests()

    import jax

    devices = jax.devices()
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
          f"({devices[0].platform})", flush=True)
    if devices[0].platform != "gpu":
        raise RuntimeError(f"JAX found no GPU (platform {devices[0].platform!r})")
    if len(devices) < args.cards:
        raise RuntimeError(f"--cards {args.cards} needs {args.cards} GPUs, JAX sees {len(devices)}")

    from rayfinder_tpu.render.pathtracer import DEFAULT_ENGINE
    from tools.make_quality_goldens import courtyard_config

    t0 = time.perf_counter()
    court, csky, ccam, _ = courtyard_config()
    print(f"courtyard: {court.num_triangles} triangles via GLB -> .pt -> device scene "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    if args.cards == 4:
        phase("sharded render on 4 cards")
        check_sharded(court, csky, ccam, card)
    else:
        phase("phase 3: walk vs lockstep oracle, courtyard at 512x512")
        check_walk_against_oracle(court, csky, ccam)
        phase("phase 4: small open scene, default engine vs wavefront")
        small = check_small_scene(DEFAULT_ENGINE)
        phase("phase 5: courtyard through the production asset path")
        check_courtyard(court, csky, ccam, DEFAULT_ENGINE)
        phase("phase 6: timing, walk vs wavefront")
        time_engines({
            "small": (*small, 800, 600, 16),
            "courtyard": (court, csky, ccam, 512, 512, 8),
        }, card)

    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
