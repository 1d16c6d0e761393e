"""Focus-distance pick (main.cpp:198-227 parity) and the headless viewer
session (the reference's interactive loop, scripted)."""

import numpy as np
import pytest

from rayfinder_tpu.render.fly_camera import (
    FlyCameraController,
    pick_focus_distance,
)


def _small_controller(scene, size=(64, 48)):
    c = FlyCameraController(size)
    c.position = np.asarray([2.0, 1.5, 2.0], np.float32)
    c.look_at([0.1, 0.8, 0.0])
    c.vfov_degrees = 70.0
    return c


def test_pick_center_sets_focus_to_forward_projection(small_device_scene):
    """Picking the window center (ray straight down the camera forward axis
    onto the blob) must set focus = dot(hit - position, forward) = hit t."""
    c = _small_controller(small_device_scene)
    before = c.focus_distance
    focus = pick_focus_distance(small_device_scene, c, 32.0, 24.0)
    assert focus is not None and focus == c.focus_distance != before
    # Independent oracle: brute-force nearest intersection along the ray.
    import jax.numpy as jnp

    from rayfinder_tpu.render.camera import generate_camera_ray
    from rayfinder_tpu.render.intersect import ray_triangle

    o, d = generate_camera_ray(c.camera(), np.asarray([0.5]), np.asarray([0.5]))
    tris = np.asarray(small_device_scene.tri_positions)
    hit, t, _, _ = ray_triangle(
        jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tris[:, 0]), jnp.asarray(tris[:, 1]), jnp.asarray(tris[:, 2]),
        jnp.float32(1000.0),
    )
    t_best = float(np.where(np.asarray(hit), np.asarray(t), np.inf).min())
    p = np.asarray(o)[0] + t_best * np.asarray(d)[0]
    forward, _, _ = c.orientation()
    assert focus == pytest.approx(float(np.dot(p - c.position, forward)), rel=1e-5)


def test_pick_miss_and_out_of_window_leave_focus(small_device_scene):
    c = _small_controller(small_device_scene)
    before = c.focus_distance
    # Top-left corner ray points at the sky.
    assert pick_focus_distance(small_device_scene, c, 0.0, 0.0) is None
    # Out-of-window coordinates are rejected before tracing (main.cpp:207-210).
    assert pick_focus_distance(small_device_scene, c, -1.0, 10.0) is None
    assert pick_focus_distance(small_device_scene, c, 64.0, 10.0) is None
    assert c.focus_distance == before


def test_viewer_session_scripted(small_device_scene, tmp_path):
    """A scripted session: progressive PNG rewriting, camera motion resetting
    accumulation, pick wiring, and the live Mrays/s readout."""
    from rayfinder_tpu.render.renderer import Sky
    from rayfinder_tpu.tools.viewer import ViewerSession
    from rayfinder_tpu.utils.image import read_png

    out = tmp_path / "view.png"
    s = ViewerSession(
        small_device_scene, out, width=64, height=48, spp=4, bounces=2,
        sky=Sky(), exposure=0.25, engine="wavefront", batch=2,
    )
    s.controller.position = np.asarray([2.0, 1.5, 2.0], np.float32)
    s.controller.look_at([0.1, 0.8, 0.0])
    s.handle("frames 2")
    assert s.renderer.accumulated_sample_count == 2
    assert out.exists()
    first = read_png(out)
    assert s.renderer.total_rays > 0
    assert "Mrays/s" in s.status()

    # Camera motion resets accumulation (param-change reset parity).
    assert s.handle("w 0.25")
    s.handle("frames 1")
    assert s.renderer.accumulated_sample_count == 1

    # Pick at the blob re-focuses; pick at the sky does not.
    before = s.controller.focus_distance
    s.handle("pick 32 24")
    assert s.controller.focus_distance != before

    # `wait` runs to the spp target and keeps rewriting the PNG.
    s.handle("wait")
    assert s.renderer.accumulated_sample_count == 4
    assert s.renderer.render_progress_percentage() == 100.0
    assert not np.array_equal(read_png(out), first)

    assert s.handle("status")
    assert not s.handle("quit")


def test_viewer_renderer_modes(small_device_scene, tmp_path):
    """The ImGui renderer radio (main.cpp:235-247): pt <-> deferred <-> debug
    switching renders through the right pipeline and keeps writing the PNG."""
    from rayfinder_tpu.render.renderer import Sky
    from rayfinder_tpu.tools.viewer import ViewerSession
    from rayfinder_tpu.utils.image import read_png

    out = tmp_path / "view.png"
    s = ViewerSession(
        small_device_scene, out, width=48, height=36, spp=2, bounces=2,
        sky=Sky(), exposure=0.25, engine="wavefront", batch=1,
    )
    s.controller.position = np.asarray([2.0, 1.5, 2.0], np.float32)
    s.controller.look_at([0.1, 0.8, 0.0])

    s.handle("renderer deferred")
    s.handle("frames 2")
    assert s._deferred is not None and s._deferred.frame_count == 2
    deferred_img = read_png(out)
    assert "deferred" in s.status()

    s.handle("renderer debug")
    s.handle("frames 1")
    debug_img = read_png(out)
    assert not np.array_equal(debug_img, deferred_img)

    s.handle("renderer pt")
    s.handle("wait")
    assert s.renderer.accumulated_sample_count == 2


def test_viewer_deferred_taa_resets_on_move(small_device_scene, tmp_path):
    """Camera motion must invalidate the deferred renderer's TAA history —
    the reference resets accumulation on any camera change; blending 90%
    stale-viewpoint history would ghost the old view. Also: `frames 0` in
    deferred mode must render one frame instead of crashing."""
    from rayfinder_tpu.render.renderer import Sky
    from rayfinder_tpu.tools.viewer import ViewerSession

    out = tmp_path / "view.png"
    s = ViewerSession(
        small_device_scene, out, width=48, height=36, spp=2, bounces=2,
        sky=Sky(), exposure=0.25, engine="wavefront", batch=1,
    )
    s.controller.position = np.asarray([2.0, 1.5, 2.0], np.float32)
    s.controller.look_at([0.1, 0.8, 0.0])

    s.handle("renderer deferred")
    s.handle("frames 2")
    assert s._deferred.frame_count == 2
    s.handle("w 0.5")  # camera move -> TAA history reset
    assert s._deferred.frame_count == 0
    s.handle("frames 0")  # n<=0 still renders one frame (no UnboundLocalError)
    assert s._deferred.frame_count == 1
    assert out.exists()
