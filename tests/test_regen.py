"""Path-regeneration accumulator vs the scan form: same physics, same noise
stream, near-identical f32 accumulation (residual = XLA fusion variance)."""

import numpy as np
import jax.numpy as jnp

from rayfinder_tpu.render.camera import create_camera
from rayfinder_tpu.render.pathtracer import (
    accumulate_samples,
    accumulate_samples_regen,
)
from rayfinder_tpu.render.rng import blue_noise_tile
from rayfinder_tpu.sky.model import sky_state_from_ui


def test_regen_matches_scan(small_device_scene):
    w, h, spp, nb = 64, 48, 4, 3
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.3, 2.5, 70.0, w / h)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(width=w, height=h, num_bounces=nb, spp=spp, num_frames=spp,
              engine="wavefront")

    scan = accumulate_samples(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), **kw,
    )
    regen = accumulate_samples_regen(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), **kw,
    )
    np.testing.assert_allclose(
        np.asarray(regen), np.asarray(scan), rtol=1e-5, atol=1e-6
    )


def test_regen_compaction_matches_uncompacted(small_device_scene):
    """Forcing lane compaction (tiny compact_floor) must not change a single
    pixel's accumulation order: results are identical to the single-phase
    loop (same adds in the same order, so exact equality modulo XLA fusion)."""
    w, h, spp, nb = 64, 48, 6, 4
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.3, 2.5, 70.0, w / h)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(width=w, height=h, num_bounces=nb, spp=spp, num_frames=spp,
              engine="wavefront")

    one = accumulate_samples_regen(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), compact_floor=w * h, **kw,
    )
    compacted = accumulate_samples_regen(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), compact_floor=16, **kw,
    )
    np.testing.assert_allclose(
        np.asarray(compacted), np.asarray(one), rtol=1e-5, atol=1e-6
    )


def test_regen_respects_frame_base(small_device_scene):
    """Two regen dispatches of spp/2 frames == one dispatch of spp frames."""
    w, h, spp = 32, 24, 4
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.0, (0.5, 0.5, 0.5), 45.0, 90.0)
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(width=w, height=h, num_bounces=2, spp=spp, engine="wavefront")

    one = accumulate_samples_regen(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), num_frames=spp, **kw,
    )
    two = jnp.zeros((w * h, 3), jnp.float32)
    for base in (0, spp // 2):
        two = accumulate_samples_regen(
            small_device_scene, sky, cam, tile, jnp.int32(base), two,
            num_frames=spp // 2, **kw,
        )
    np.testing.assert_allclose(np.asarray(two), np.asarray(one), rtol=1e-5, atol=1e-6)


def test_count_rays_exact_and_engine_agnostic(small_device_scene):
    """Exact ray accounting (bench.py instrumentation): the walk and the
    wavefront engine must yield the SAME segment counts — the per-sample
    path structure is engine-invariant. Also: counting must not perturb the
    radiance (bit-identical), every sample traces >= 1 closest segment, and
    forced compaction must not change the counts (phases re-partition lanes,
    not work)."""
    w, h, spp, nb = 64, 48, 4, 3
    cam = create_camera([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    tile = jnp.asarray(blue_noise_tile())
    kw = dict(width=w, height=h, num_bounces=nb, spp=spp, num_frames=spp)

    counts = {}
    for eng in ("walk", "wavefront"):
        plain = accumulate_samples_regen(
            small_device_scene, sky, cam, tile, jnp.int32(0),
            jnp.zeros((w * h, 3), jnp.float32), engine=eng, **kw,
        )
        img, cnt = accumulate_samples_regen(
            small_device_scene, sky, cam, tile, jnp.int32(0),
            jnp.zeros((w * h, 3), jnp.float32), engine=eng, count_rays=True,
            **kw,
        )
        assert np.array_equal(np.asarray(img), np.asarray(plain)), eng
        counts[eng] = np.asarray(cnt)

    closest, shadow = (int(x) for x in counts["walk"])
    assert np.array_equal(counts["walk"], counts["wavefront"])
    total_samples = w * h * spp
    assert closest >= total_samples  # every sample has >= 1 segment
    assert 0 < shadow <= closest - 0  # hits happened; shadow = hit count
    assert closest <= total_samples * nb  # <= num_bounces segments/sample

    _, cnt2 = accumulate_samples_regen(
        small_device_scene, sky, cam, tile, jnp.int32(0),
        jnp.zeros((w * h, 3), jnp.float32), engine="walk", count_rays=True,
        compact_floor=16, **kw,
    )
    assert np.array_equal(np.asarray(cnt2), counts["walk"])
