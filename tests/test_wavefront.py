"""Wavefront engine vs lockstep reference traversal: exact agreement on
hit/miss, distance, and triangle, for camera rays and random scattered rays."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayfinder_tpu.render.traverse import intersect_closest, intersect_any
from rayfinder_tpu.render.wavefront import (
    intersect_any_wavefront,
    intersect_closest_wavefront,
)


def _camera_rays(scene, n=64):
    from rayfinder_tpu.render.camera import create_camera, generate_camera_ray

    lo = np.asarray(scene.bvh_aabb_min[0])
    hi = np.asarray(scene.bvh_aabb_max[0])
    diag = hi - lo
    centroid = 0.5 * (lo + hi)
    max_dim = int(np.argmax(diag))
    origin = centroid - np.asarray([-0.8 * diag[max_dim], 0.0, 0.8 * diag[max_dim]])
    cam = create_camera(origin, centroid, 0.0, 1.0, 70.0, 1.0)
    js, is_ = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    u = js.reshape(-1).astype(np.float32) / n
    v = 1.0 - (is_.reshape(-1) + 1.0).astype(np.float32) / n
    return generate_camera_ray(cam, u, v)


def test_closest_matches_reference_on_camera_rays(small_device_scene):
    scene = small_device_scene
    o, d = _camera_rays(scene)
    t_max = jnp.float32(1e4)

    ref_hit, ref_t, ref_tri, _ = intersect_closest(scene, o, d, t_max)
    wf_hit, wf_t, wf_tri, overflow = intersect_closest_wavefront(scene, o, d, t_max)

    assert int(overflow) == 0, "top-k cluster capacity exceeded"
    np.testing.assert_array_equal(np.asarray(wf_hit), np.asarray(ref_hit))
    hits = np.asarray(ref_hit)
    # Same formula, different fusion: XLA's FMA contraction differs between
    # the two compiled kernels, so t agrees to last-ulp, not bit-exactly.
    np.testing.assert_allclose(
        np.asarray(wf_t)[hits], np.asarray(ref_t)[hits], rtol=2e-6, atol=1e-6
    )
    # Triangles agree except where two triangles tie on t exactly.
    tie_free = hits & (np.asarray(wf_tri) == np.asarray(ref_tri))
    assert tie_free.sum() >= 0.999 * hits.sum()


def test_closest_matches_reference_on_random_rays(small_device_scene, rng):
    scene = small_device_scene
    lo = np.asarray(scene.bvh_aabb_min[0])
    hi = np.asarray(scene.bvh_aabb_max[0])
    n = 512
    o = rng.uniform(lo - 0.5, hi + 0.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = jnp.float32(1e4)

    ref_hit, ref_t, _, _ = intersect_closest(scene, jnp.asarray(o), jnp.asarray(d), t_max)
    wf_hit, wf_t, _, overflow = intersect_closest_wavefront(
        scene, jnp.asarray(o), jnp.asarray(d), t_max
    )
    assert int(overflow) == 0
    np.testing.assert_array_equal(np.asarray(wf_hit), np.asarray(ref_hit))
    hits = np.asarray(ref_hit)
    np.testing.assert_allclose(
        np.asarray(wf_t)[hits], np.asarray(ref_t)[hits], rtol=2e-6, atol=1e-6
    )


def test_any_hit_matches_reference(small_device_scene, rng):
    scene = small_device_scene
    lo = np.asarray(scene.bvh_aabb_min[0])
    hi = np.asarray(scene.bvh_aabb_max[0])
    n = 512
    o = rng.uniform(lo - 0.5, hi + 0.5, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = jnp.float32(1e4)

    ref = intersect_any(scene, jnp.asarray(o), jnp.asarray(d), t_max)
    wf, _ = intersect_any_wavefront(scene, jnp.asarray(o), jnp.asarray(d), t_max)
    np.testing.assert_array_equal(np.asarray(wf), np.asarray(ref))


def test_cluster_tri_map_roundtrip(small_device_scene):
    """Clusters are treelet-aligned leaf-order ranges: every real slot of
    cluster c holds triangle start[c] + slot, every real triangle appears
    exactly once, and padded slots are degenerate (all-zero)."""
    scene = small_device_scene
    c, l = scene.cluster_tris.shape[:2]
    tri_map = np.asarray(scene.cluster_tri_map).reshape(c, l)
    start = np.asarray(scene.cluster_start)
    n_real = scene.num_triangles
    assert np.all(tri_map < n_real)

    positions = np.asarray(scene.tri_positions)
    blocks = np.asarray(scene.cluster_tris)
    covered = np.zeros(n_real, bool)
    for ci in range(c):
        real = blocks[ci].reshape(l, 9).any(axis=1)  # degenerate padding = 0
        slots = np.flatnonzero(real)
        # Real slots are a contiguous prefix mapping to start + slot.
        np.testing.assert_array_equal(slots, np.arange(slots.size))
        np.testing.assert_array_equal(tri_map[ci, slots], start[ci] + slots)
        np.testing.assert_array_equal(blocks[ci, slots], positions[start[ci] + slots])
        covered[start[ci] + slots] = True
    assert covered.all()


@pytest.fixture(scope="module")
def courtyard_device_scene():
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(8)  # ~24K tris, enclosed, many clusters
    return build_device_scene(flat, textures=textures)


def test_overflow_escalation_matches_reference(courtyard_device_scene, rng):
    """Overflow HANDLING (not just reporting): interior rays in the enclosed
    courtyard overlap far more cluster AABBs than a deliberately tiny top_k,
    so many rays take the full-capacity escalation walk — results must still
    agree exactly with the lockstep reference engine. Guards the round-1
    hazard where overflowed rays could silently miss far clusters."""
    scene = courtyard_device_scene
    n = 512
    o = rng.uniform([-18, 0.5, -9], [18, 10.0, 9], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = jnp.float32(1e4)

    ref_hit, ref_t, ref_tri, _ = intersect_closest(
        scene, jnp.asarray(o), jnp.asarray(d), t_max
    )
    wf_hit, wf_t, wf_tri, escalated = intersect_closest_wavefront(
        scene, jnp.asarray(o), jnp.asarray(d), t_max, top_k=4
    )
    assert int(escalated) > 0, "test scene failed to trigger escalation"
    np.testing.assert_array_equal(np.asarray(wf_hit), np.asarray(ref_hit))
    hits = np.asarray(ref_hit)
    np.testing.assert_allclose(
        np.asarray(wf_t)[hits], np.asarray(ref_t)[hits], rtol=2e-6, atol=1e-6
    )
    # Triangle ids may differ only where two surfaces race within float
    # fusion variance (adjacent coplanar quads; |t| already asserted equal
    # within tolerance above) — never from a dropped cluster, which would
    # show up as a large t difference or a hit/miss flip.
    mismatch = hits & (np.asarray(wf_tri) != np.asarray(ref_tri))
    assert mismatch.sum() <= 0.01 * hits.sum()

    ref_occ = intersect_any(scene, jnp.asarray(o), jnp.asarray(d), t_max)
    wf_occ, esc_any = intersect_any_wavefront(
        scene, jnp.asarray(o), jnp.asarray(d), t_max, top_k=4
    )
    np.testing.assert_array_equal(np.asarray(wf_occ), np.asarray(ref_occ))


def test_default_capacity_rarely_escalates_at_scale(courtyard_device_scene, rng):
    """At the production top_k the enclosed scene should resolve nearly all
    rays without escalation (the near-first prune proof does the work); a
    large escalated fraction would flag a perf regression."""
    scene = courtyard_device_scene
    n = 2048
    o = rng.uniform([-18, 0.5, -9], [18, 10.0, 9], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, _, _, escalated = intersect_closest_wavefront(
        scene, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e4)
    )
    assert int(escalated) <= 0.05 * n
