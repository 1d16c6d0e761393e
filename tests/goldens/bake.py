"""Regenerate every golden in this directory, on the CPU.

Run from the repo root after an INTENTIONAL behavior change, then review the
diffs visually before committing:

    python tests/goldens/bake.py

Each golden pins one user-visible pipeline (the reference validates these
visually, SURVEY.md §4; here they are automated with RMSE budgets in
tests/test_goldens.py). The small open scene is generated from its seed and
loaded through the GLB path, as the test fixtures do.
"""

import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

GOLDENS = pathlib.Path(__file__).resolve().parent


def main() -> None:
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.deferred import DeferredRenderer
    from rayfinder_tpu.render.pathtracer import SamplingParams, render_image
    from rayfinder_tpu.render.scene import build_device_scene, load_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene, write_small_open_glb
    from rayfinder_tpu.sky.model import sky_state_from_ui
    from rayfinder_tpu.tools.bvh_visualizer import visualize
    from rayfinder_tpu.tools.sky_demo import render_sky_dome
    from rayfinder_tpu.utils.image import write_png

    with tempfile.TemporaryDirectory() as tmp:
        glb = write_small_open_glb(pathlib.Path(tmp) / "small_open.glb")
        small = load_device_scene(glb)
        write_png(GOLDENS / "bvh_heatmap_64x48.png", visualize(glb, width=64, height=48))

    scam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 64 / 48)
    ssky = sky_state_from_ui(1.0, (1, 1, 1), 30.0, 0.0)
    img = render_image(
        small, ssky, scam, width=64, height=48,
        sampling=SamplingParams(2, 2), exposure=0.25, engine="reference",
    )
    write_png(GOLDENS / "small_64x48_2spp.png", img)

    flat, textures = courtyard_scene(4, textured=True)
    court = build_device_scene(flat, textures=textures)
    ccam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 64 / 48)
    csky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    img = render_image(
        court, csky, ccam, width=64, height=48,
        sampling=SamplingParams(2, 3), exposure=1.0, engine="reference",
    )
    write_png(GOLDENS / "courtyard_textured_64x48_2spp.png", img)

    dr = DeferredRenderer(small, 64, 48, engine="wavefront")
    for _ in range(3):
        out = dr.render(scam, ssky, exposure=0.25)
    write_png(GOLDENS / "small_deferred_64x48_f3.png", out)
    write_png(GOLDENS / "small_deferred_debug_64x48.png", dr.render_debug(scam))

    write_png(GOLDENS / "sky_dome_64.png", render_sky_dome(size=64))

    bake_hit_sets(small)
    print("baked", len(list(GOLDENS.glob("*.png"))), "goldens")


def hit_set_rays(name: str):
    """The pinned rays of a hit-set golden: 256 rays per scene, from seeds."""
    import numpy as np

    if name == "small":
        # Aimed at jittered points around the blob so most rays hit (random
        # directions from the box almost all miss a small model).
        rng = np.random.default_rng(2025)
        o = rng.uniform([-2.5, -0.5, -2.5], [2.5, 3.0, 2.5], size=(256, 3))
        d = np.asarray([0.0, 0.85, 0.0]) + 0.4 * rng.normal(size=(256, 3)) - o
    else:
        rng = np.random.default_rng(2024)
        o = rng.uniform([-18, 1, -8], [18, 10, 8], size=(256, 3))
        d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def bake_hit_sets(small) -> None:
    """Pin the accepted-hit set (closest t and triangle, any-hit occlusion)
    of the lockstep oracle on the small scene and on the enclosed
    courtyard(8). Every engine must reproduce them (tests/test_goldens.py):
    engine-agreement tests alone miss a semantic change that lands in all
    engines at once."""
    import jax.numpy as jnp
    import numpy as np

    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.render.traverse import intersect_any, intersect_closest
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(8)
    scenes = {"small": small, "courtyard8": build_device_scene(flat, textures=textures)}
    t_max = jnp.float32(1e4)
    for name, scene in scenes.items():
        o, d = hit_set_rays(name)
        _, t, tri, _ = intersect_closest(scene, jnp.asarray(o), jnp.asarray(d), t_max)
        occ = intersect_any(scene, jnp.asarray(o), jnp.asarray(d), t_max)
        np.savez(
            GOLDENS / f"hits_{name}.npz", origins=o, directions=d,
            t=np.asarray(t), tri=np.asarray(tri), occ=np.asarray(occ),
        )


if __name__ == "__main__":
    main()
