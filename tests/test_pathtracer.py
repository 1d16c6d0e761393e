"""Path-tracer physics and engine-equivalence tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayfinder_tpu.render.camera import create_camera, generate_camera_ray
from rayfinder_tpu.render.pathtracer import (
    SOLAR_COS_THETA_MAX,
    SOLAR_INV_PDF,
    FRAC_1_PI,
    trace_radiance,
)
from rayfinder_tpu.render.sampling import sample_solar_disk_direction
from rayfinder_tpu.render.scene import build_device_scene
from rayfinder_tpu.scene import FlattenedScene
from rayfinder_tpu.sky.model import sky_state_from_ui, sky_radiance_dist


@pytest.fixture(scope="module")
def sky():
    return sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)


@pytest.fixture(scope="module")
def ground_scene():
    """A large ground quad at y=0 with a default white texture."""
    # Winding chosen so cross(e1, e2) points +y (the geometric normal drives
    # the self-intersection offset, ray_intersection.cpp:80-82).
    quad = np.asarray(
        [
            [[-100, 0, -100], [100, 0, 100], [100, 0, -100]],
            [[-100, 0, -100], [-100, 0, 100], [100, 0, 100]],
        ],
        dtype=np.float32,
    )
    n = np.tile(np.asarray([0, 1, 0], np.float32), (2, 3, 1))
    uv = np.zeros((2, 3, 2), np.float32)
    flat = FlattenedScene(
        positions=quad, normals=n, tex_coords=uv,
        texture_indices=np.zeros(2, np.uint32),
    )
    return build_device_scene(flat)


def test_miss_rays_return_sky_radiance(ground_scene, sky):
    """Rays that hit nothing must return exactly the analytic sky dome
    (rayColor miss branch, wgsl:212-227 — solar disk NOT included)."""
    d = np.asarray([[0.0, 1.0, 0.0], [0.3, 0.8, 0.1]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.full((2, 3), 5.0, np.float32)
    noise = jnp.asarray([[0.3, 0.7], [0.9, 0.1]], jnp.float32)

    out = trace_radiance(
        ground_scene, sky, jnp.asarray(o), jnp.asarray(d), noise, 4, "reference"
    )
    theta = np.arccos(np.clip(d[:, 1], -1, 1))
    gamma = np.arccos(np.clip(d @ np.asarray(sky.sun_direction), -1, 1))
    expected = np.asarray(sky_radiance_dist(sky, theta, gamma))
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5)


def test_single_bounce_nee_matches_analytic(ground_scene, sky):
    """One bounce on a lit white Lambertian ground: radiance must equal
    solar_radiance * (albedo/pi) * cos(theta_l) * SOLAR_INV_PDF
    (rayColor NEE, wgsl:193-203)."""
    o = jnp.asarray([[0.0, 2.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    noise = jnp.asarray([[0.4, 0.6]], jnp.float32)

    out = np.asarray(
        trace_radiance(ground_scene, sky, o, d, noise, 1, "reference")
    )[0]

    sun = jnp.asarray(sky.sun_direction)
    light_dir = np.asarray(sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun))[0]
    cos_l = light_dir[1]  # ground normal is +y
    albedo = 1.0  # default white texel
    expected = np.asarray(sky.solar_radiances) * (albedo * float(FRAC_1_PI)) * cos_l * float(
        SOLAR_INV_PDF
    )
    np.testing.assert_allclose(out, expected, rtol=1e-4)


@pytest.mark.parametrize("engine", ["walk", "wavefront"])
def test_engines_agree(small_device_scene, sky, engine):
    """Each traversal engine produces the lockstep oracle's radiance."""
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 1.0)
    n = 32
    js, is_ = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    u = js.reshape(-1).astype(np.float32) / n
    v = 1.0 - (is_.reshape(-1) + 1.0).astype(np.float32) / n
    o, d = generate_camera_ray(cam, u, v)
    rng = np.random.default_rng(5)
    noise = jnp.asarray(rng.uniform(size=(n * n, 2)).astype(np.float32))

    ref = np.asarray(trace_radiance(small_device_scene, sky, o, d, noise, 2, "reference"))
    out = np.asarray(trace_radiance(small_device_scene, sky, o, d, noise, 2, engine))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_unknown_engine_raises(small_device_scene, sky):
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (4, 1))
    noise = jnp.zeros((4, 2), jnp.float32)
    with pytest.raises(ValueError, match="unknown traversal engine"):
        trace_radiance(small_device_scene, sky, o, d, noise, 1, "bogus")


def test_accumulation_batching_equivalence(small_device_scene, sky):
    """accumulate_samples(k) in one dispatch == k single-sample dispatches."""
    from rayfinder_tpu.render.pathtracer import accumulate_sample, accumulate_samples
    from rayfinder_tpu.render.rng import blue_noise_tile

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 1.0)
    tile = jnp.asarray(blue_noise_tile())
    w = h = 16

    a = jnp.zeros((w * h, 3), jnp.float32)
    for k in range(3):
        a = accumulate_sample(
            small_device_scene, sky, cam, tile, jnp.int32(k), a,
            width=w, height=h, num_bounces=2, spp=8, engine="reference",
        )
    b = jnp.zeros((w * h, 3), jnp.float32)
    b = accumulate_samples(
        small_device_scene, sky, cam, tile, jnp.int32(0), b,
        width=w, height=h, num_bounces=2, spp=8, num_frames=3, engine="reference",
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_tiled_render_matches_untiled(small_device_scene, sky):
    """render_image_tiled must reproduce render_image exactly (same noise per
    pixel regardless of windowing)."""
    from rayfinder_tpu.render.pathtracer import (
        SamplingParams,
        render_image,
        render_image_tiled,
    )

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 48 / 32)
    kwargs = dict(width=48, height=32, sampling=SamplingParams(2, 2),
                  exposure=0.25, engine="reference")
    whole = render_image(small_device_scene, sky, cam, **kwargs)
    tiled = render_image_tiled(small_device_scene, sky, cam, tile_w=32, tile_h=32, **kwargs)
    np.testing.assert_allclose(tiled, whole, rtol=1e-5, atol=1e-6)
