"""Multi-device sharding: the (tiles, samples) mesh render must match the
single-device progressive render (same noise sequence per sample). Runs on
the 8 virtual CPU devices that conftest.py sets up."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rayfinder_tpu.parallel.sharding import make_render_mesh, render_image_sharded
from rayfinder_tpu.render.camera import create_camera
from rayfinder_tpu.render.pathtracer import SamplingParams, render_image
from rayfinder_tpu.sky.model import sky_state_from_ui



@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def test_sharded_matches_single_chip(small_device_scene):
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    w, h, spp = 16, 12, 4

    single = render_image(
        small_device_scene,
        sky,
        cam,
        width=w,
        height=h,
        sampling=SamplingParams(spp, 2),
        exposure=0.25,
        engine="reference",
    )

    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=2)
    assert mesh.shape == {"tiles": 4, "samples": 2}
    sharded = render_image_sharded(
        small_device_scene,
        sky,
        cam,
        mesh=mesh,
        width=w,
        height=h,
        spp=spp,
        num_bounces=2,
        exposure=0.25,
        engine="reference",
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_mesh_shapes():
    mesh = make_render_mesh(jax.devices()[:8])
    assert mesh.shape["tiles"] * mesh.shape["samples"] == 8
    mesh1 = make_render_mesh(jax.devices()[:1])
    assert mesh1.shape == {"tiles": 1, "samples": 1}


def test_sharded_walk_engine_matches_wavefront(small_device_scene):
    """The walk's FFI calls run per shard under shard_map with the varying-
    axes checker on, and match the XLA wavefront engine."""
    from rayfinder_tpu.parallel.sharding import render_step_sharded
    from rayfinder_tpu.render.rng import blue_noise_tile

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    w, h = 16, 12
    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=2)
    tiles = mesh.shape["tiles"]
    padded = -(-w * h // tiles) * tiles
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(mesh=mesh, width=w, height=h, num_bounces=2, spp=4)

    def zeros():  # accum is donated; each call needs its own buffer
        return jnp.zeros((padded, 3), jnp.float32)

    out_p = render_step_sharded(
        small_device_scene, sky, cam, tile, jnp.int32(0), zeros(), engine="walk", **kw
    )
    out_w = render_step_sharded(
        small_device_scene, sky, cam, tile, jnp.int32(0), zeros(), engine="wavefront", **kw
    )
    np.testing.assert_allclose(
        np.asarray(out_p), np.asarray(out_w), rtol=1e-5, atol=1e-6
    )


def test_sharded_regen_matches_single_chip(small_device_scene):
    """The FAST multi-device path — per-shard regen accumulation +
    psum over the samples axis (render_image_sharded_regen) — must match
    the single-chip progressive render within the f32 psum-regrouping
    budget."""
    from rayfinder_tpu.parallel.sharding import render_image_sharded_regen

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    w, h, spp = 32, 16, 4

    single = render_image(
        small_device_scene, sky, cam,
        width=w, height=h, sampling=SamplingParams(spp, 2),
        exposure=0.25, engine="walk",
    )
    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=2)
    sharded = render_image_sharded_regen(
        small_device_scene, sky, cam,
        mesh=mesh, width=w, height=h, spp=spp, num_bounces=2,
        exposure=0.25, engine="walk",
    )
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-3)


def test_sharded_regen_wavefront_engine(small_device_scene):
    """The XLA wavefront engine under shard_map (accumulate_lanes_regen —
    what `tools/render.py --mesh --engine wavefront` runs). Regression for
    the while_loop varying-axis typing:
    every carry must derive from the sharded inputs (u is tiles-varying,
    frame_base samples-varying)."""
    from rayfinder_tpu.parallel.sharding import render_image_sharded_regen

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 2.0)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    w, h, spp = 32, 16, 4

    single = render_image(
        small_device_scene, sky, cam,
        width=w, height=h, sampling=SamplingParams(spp, 2),
        exposure=0.25, engine="wavefront",
    )
    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=2)
    sharded = render_image_sharded_regen(
        small_device_scene, sky, cam,
        mesh=mesh, width=w, height=h, spp=spp, num_bounces=2,
        exposure=0.25, engine="wavefront",
    )
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-3)


def test_render_cli_mesh_flag(small_glb, tmp_path):
    """`tools/render.py --mesh TxS` renders through the sharded pipeline."""
    from rayfinder_tpu.tools.render import main as render_main

    out = tmp_path / "mesh.png"
    rc = render_main([
        str(small_glb), "-o", str(out),
        "--width", "32", "--height", "16", "--spp", "4", "--bounces", "2",
        "--engine", "wavefront", "--mesh", "2x2",
        "--camera-origin", "2", "1.5", "2",
        "--camera-look-at", "0.1", "0.8", "0",
    ])
    assert rc == 0 and out.exists()


def test_sharded_regen_tile_only_mesh(small_device_scene):
    """samples axis 1: pure pixel sharding, no psum contribution mixing."""
    from rayfinder_tpu.parallel.sharding import render_image_sharded_regen

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 2.0)
    sky = sky_state_from_ui(2.0, (0.5, 0.5, 0.5), 45.0, 10.0)
    w, h, spp = 32, 16, 2

    single = render_image(
        small_device_scene, sky, cam,
        width=w, height=h, sampling=SamplingParams(spp, 3),
        exposure=0.25, engine="walk",
    )
    mesh = make_render_mesh(jax.devices()[:4], sample_parallel=1)
    sharded = render_image_sharded_regen(
        small_device_scene, sky, cam,
        mesh=mesh, width=w, height=h, spp=spp, num_bounces=3,
        exposure=0.25, engine="walk",
    )
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-3)


@pytest.fixture(scope="module")
def small_courtyard():
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(3)  # courtyard-class: enclosed, ~3K tris
    return build_device_scene(flat, textures=textures)


@pytest.mark.parametrize("sample_parallel", [1, 4])
def test_sharded_regen_courtyard_meshes(small_courtyard, sample_parallel):
    """Courtyard-class scene through the regen path on the walk engine, on
    (8,1) and (2,4) meshes at a size whose pixel shards are NOT whole
    32x16-block multiples (64x32 over 8 tiles = half-block shards): must
    match single-device within the psum-regrouping budget."""
    from rayfinder_tpu.parallel.sharding import render_image_sharded_regen

    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 2.0)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    w, h, spp = 64, 32, 4

    single = render_image(
        small_courtyard, sky, cam,
        width=w, height=h, sampling=SamplingParams(spp, 2),
        exposure=1.0, engine="walk",
    )
    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=sample_parallel)
    sharded = render_image_sharded_regen(
        small_courtyard, sky, cam,
        mesh=mesh, width=w, height=h, spp=spp, num_bounces=2,
        exposure=1.0, engine="walk",
    )
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-3)


def test_sharded_regen_samples_only_mesh(small_device_scene):
    """(1, 8) mesh: pure sample parallelism — unsharded pixels, 8-way psum."""
    from rayfinder_tpu.parallel.sharding import render_image_sharded_regen

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 2.0)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    w, h, spp = 32, 16, 8

    single = render_image(
        small_device_scene, sky, cam,
        width=w, height=h, sampling=SamplingParams(spp, 2),
        exposure=0.25, engine="walk",
    )
    mesh = make_render_mesh(jax.devices()[:8], sample_parallel=8)
    assert mesh.shape["tiles"] == 1 and mesh.shape["samples"] == 8
    sharded = render_image_sharded_regen(
        small_device_scene, sky, cam,
        mesh=mesh, width=w, height=h, spp=spp, num_bounces=2,
        exposure=0.25, engine="walk",
    )
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-3)
