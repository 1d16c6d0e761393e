"""Progressive Renderer and DeferredRenderer API tests."""

import dataclasses

import numpy as np
import pytest

from rayfinder_tpu.render.camera import create_camera
from rayfinder_tpu.render.deferred import DeferredRenderer
from rayfinder_tpu.render.pathtracer import SamplingParams
from rayfinder_tpu.render.renderer import Renderer, RenderParameters, Sky


@pytest.fixture(scope="module")
def params():
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    return RenderParameters(
        width=16, height=12, camera=cam, sampling=SamplingParams(4, 2), exposure=0.25
    )


def test_progressive_accumulation(small_device_scene, params):
    r = Renderer(small_device_scene, params, engine="reference")
    assert r.render_progress_percentage() == 0.0
    r.render()
    assert r.accumulated_sample_count == 1
    assert r.render_progress_percentage() == 25.0
    r.render(num_frames=3)
    assert r.render_progress_percentage() == 100.0
    # Past the target: frame counter advances, accumulation does not.
    r.render()
    assert r.accumulated_sample_count == 4
    assert r.frame_count == 5
    img = r.image()
    assert img.shape == (12, 16, 3)
    assert np.isfinite(img).all() and img.max() <= 1.0
    assert r.average_render_pass_duration_ms() > 0.0


def test_param_change_resets_accumulation(small_device_scene, params):
    r = Renderer(small_device_scene, params, engine="reference")
    r.render()
    assert r.accumulated_sample_count == 1
    # Same params: no reset (reference_path_tracer.cpp:557-563).
    r.set_render_parameters(params)
    assert r.accumulated_sample_count == 1
    # Changed exposure: reset, but the frame counter keeps running.
    r.set_render_parameters(dataclasses.replace(params, exposure=0.5))
    assert r.accumulated_sample_count == 0
    assert r.frame_count == 1


def test_deferred_renderer_frames(small_device_scene, params):
    d = DeferredRenderer(small_device_scene, width=16, height=12, engine="reference")
    cam = params.camera
    sky = Sky().state()
    img0 = d.render(cam, sky, exposure=0.25)
    assert img0.shape == (12, 16, 3)
    assert d.frame_count == 1
    img1 = d.render(cam, sky, exposure=0.25)
    # TAA: the second frame is a blend, not a copy.
    assert not np.array_equal(img0, img1)
    d.invalidate_temporal_accumulation()
    assert d.frame_count == 0

    debug = d.render_debug(cam)
    assert debug.shape == (12, 16, 3)
    assert np.isfinite(debug).all()


def test_deferred_sky_includes_sun(small_device_scene):
    """Lighting-pass miss branch adds the solar disk (lighting_pass.wgsl:203-236),
    unlike the path tracer's miss branch."""
    from rayfinder_tpu.render.deferred import gbuffer_pass, lighting_pass
    import jax.numpy as jnp

    # Camera staring straight at the sun (zenith 30°, azimuth 0).
    sun = Sky().state()
    sun_dir = np.asarray(sun.sun_direction, np.float64)
    origin = np.asarray([0.0, 50.0, 0.0])  # far above the scene: all rays miss
    cam = create_camera(origin, origin + sun_dir, 0.0, 1.0, 10.0, 1.0)

    # Odd dimensions put the center pixel exactly at (u, v) = (0.5, 0.5), so
    # its ray points straight into the 0.255-degree solar disk.
    gbuf = gbuffer_pass(
        small_device_scene, cam, jnp.int32(0), width=9, height=9, engine="reference"
    )
    sample = np.asarray(
        lighting_pass(
            small_device_scene, sun, gbuf, jnp.int32(0), width=9, height=9, engine="reference"
        )
    )
    # The center pixel looks into the solar disk: radiance must include the
    # huge constant solar term (~1e5), not just the sky dome (~1e1).
    assert sample.max() > 1e4


def test_checkpoint_roundtrip(small_device_scene, params, tmp_path):
    r = Renderer(small_device_scene, params, engine="reference")
    r.render(num_frames=2)
    ckpt = tmp_path / "render.ckpt.npz"
    r.save_checkpoint(ckpt)
    img_before = r.image()

    r2 = Renderer(small_device_scene, params, engine="reference")
    r2.load_checkpoint(ckpt)
    assert r2.accumulated_sample_count == 2
    assert r2.frame_count == 2
    np.testing.assert_array_equal(r2.image(), img_before)

    # Mismatched params must refuse to resume.
    import dataclasses as dc
    r3 = Renderer(small_device_scene, dc.replace(params, exposure=0.5), engine="reference")
    with pytest.raises(ValueError, match="different render parameters"):
        r3.load_checkpoint(ckpt)


def test_image_u8_matches_image(small_device_scene):
    """The 8-bit display fetch must equal the exact f32 surface quantized
    (on-device tonemap+round vs host round of image())."""
    import numpy as np
    import jax.numpy as jnp

    import rayfinder_tpu.render.renderer as rr
    from rayfinder_tpu.render.camera import create_camera

    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0,
                        64 / 48)
    params = rr.RenderParameters(width=64, height=48, camera=cam,
                                 sampling=rr.SamplingParams(2, 2),
                                 exposure=0.25)
    r = rr.Renderer(small_device_scene, params)
    r.render(2)
    f32 = r.image()
    u8 = r.image_u8()
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(
        u8, np.clip(np.round(f32 * 255.0), 0, 255).astype(np.uint8))
