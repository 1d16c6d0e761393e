"""Golden-image regression tests.

The reference validates its renderers by eye against showcase images
(SURVEY.md §4); here the three visual tools are pinned against committed
goldens with an RMSE budget (regenerate with `python tests/goldens/bake.py`
if behavior intentionally changes, and review the diffs visually).
"""

import pathlib

import numpy as np
import pytest

from rayfinder_tpu.utils.image import read_png, rmse

GOLDENS = pathlib.Path(__file__).parent / "goldens"


def _golden(name):
    return read_png(GOLDENS / name).astype(np.float32) / 255.0


@pytest.mark.parametrize(
    "engine, budget", [("reference", 5e-3), ("walk", 5e-3), ("wavefront", 5e-3)]
)
def test_small_render_matches_golden(small_device_scene, engine, budget):
    """Small open scene 64x48 @ 2spp/2bounce, deterministic noise: every
    engine lands on the golden baked with the lockstep oracle."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.pathtracer import SamplingParams, render_image
    from rayfinder_tpu.sky.model import sky_state_from_ui

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 64 / 48)
    sky = sky_state_from_ui(1.0, (1, 1, 1), 30.0, 0.0)
    img = render_image(
        small_device_scene,
        sky,
        cam,
        width=64,
        height=48,
        sampling=SamplingParams(2, 2),
        exposure=0.25,
        engine=engine,
    )
    assert rmse(img, _golden("small_64x48_2spp.png")) < budget


def test_sky_dome_matches_golden():
    from rayfinder_tpu.tools.sky_demo import render_sky_dome

    dome = render_sky_dome(size=64)
    assert rmse(dome, _golden("sky_dome_64.png")) < 5e-3


def test_bvh_heatmap_matches_golden(small_glb):
    """Node-visit counts are integers: the heatmap must match exactly."""
    from rayfinder_tpu.tools.bvh_visualizer import visualize

    heat = visualize(small_glb, width=64, height=48)
    np.testing.assert_array_equal(heat, read_png(GOLDENS / "bvh_heatmap_64x48.png"))


def test_blue_noise_tool_roundtrip(tmp_path):
    """PNG -> npz baking (the Rust codegen analog) round-trips the tile."""
    from rayfinder_tpu.render.rng import blue_noise_tile
    from rayfinder_tpu.tools.blue_noise_tool import bake_png
    from rayfinder_tpu.utils.image import write_png

    tile = (blue_noise_tile() * 255.0).astype(np.uint8)  # (128, 128, 2)
    rgba = np.concatenate(
        [tile, np.zeros_like(tile[..., :1]), np.full_like(tile[..., :1], 255)], axis=-1
    )
    png = tmp_path / "noise.png"
    write_png(png, rgba)
    out = tmp_path / "noise.npz"
    bake_png(png, out)
    with np.load(out) as data:
        np.testing.assert_array_equal(data["tile"], tile)


def test_textured_courtyard_matches_golden():
    """The multi-texture courtyard (14 mixed-size PNG-decoded images through
    the packed atlas) pinned at 64x48 @ 2spp/3bounce, reference engine.
    Bake: python tests/goldens/bake.py."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.pathtracer import SamplingParams, render_image
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(4, textured=True)
    scene = build_device_scene(flat, textures=textures)
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 64 / 48)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    img = render_image(
        scene, sky, cam, width=64, height=48,
        sampling=SamplingParams(2, 3), exposure=1.0, engine="reference",
    )
    assert rmse(img, _golden("courtyard_textured_64x48_2spp.png")) < 5e-3


def test_deferred_renderer_matches_golden(small_device_scene):
    """DeferredRenderer output pinned: 3 TAA frames (gbuffer->lighting->
    resolve) and the debug triptych, small scene 64x48, wavefront engine."""
    from rayfinder_tpu.render.camera import create_camera
    from rayfinder_tpu.render.deferred import DeferredRenderer
    from rayfinder_tpu.sky.model import sky_state_from_ui

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 64 / 48)
    sky = sky_state_from_ui(1.0, (1, 1, 1), 30.0, 0.0)
    dr = DeferredRenderer(small_device_scene, 64, 48, engine="wavefront")
    for _ in range(3):
        out = dr.render(cam, sky, exposure=0.25)
    assert rmse(out, _golden("small_deferred_64x48_f3.png")) < 5e-3
    debug = dr.render_debug(cam)
    assert rmse(debug, _golden("small_deferred_debug_64x48.png")) < 5e-3


@pytest.fixture(scope="module")
def courtyard8():
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(8)
    return build_device_scene(flat, textures=textures)


@pytest.mark.parametrize("engine", ["walk", "wavefront", "reference"])
@pytest.mark.parametrize("name", ["small", "courtyard8"])
def test_hit_set_golden(name, engine, request):
    """Every engine reproduces the pinned accepted-hit set of the lockstep
    oracle (tests/goldens/bake.py: closest triangle and any-hit occlusion
    exactly, t to a few float32 ulps, 256 rays) on the small open scene and
    on the enclosed courtyard(8) — red if traversal semantics change, even
    in a way that lands in all engines at once and keeps them agreeing. The
    t budget covers rounding only: the compilers may order or contract the
    Möller-Trumbore arithmetic differently."""
    import jax.numpy as jnp

    from rayfinder_tpu.render.pathtracer import get_engine

    scene = request.getfixturevalue(
        "small_device_scene" if name == "small" else "courtyard8"
    )
    data = np.load(GOLDENS / f"hits_{name}.npz")
    closest, any_hit = get_engine(engine)
    o, d = jnp.asarray(data["origins"]), jnp.asarray(data["directions"])
    t_max = jnp.float32(1e4)
    hit, t, tri, _ = closest(scene, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(tri), data["tri"])
    np.testing.assert_array_equal(np.asarray(hit), data["tri"] >= 0)
    np.testing.assert_allclose(np.asarray(t), data["t"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(any_hit(scene, o, d, t_max)), data["occ"])
