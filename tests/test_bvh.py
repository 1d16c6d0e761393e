"""BVH structural invariants and the traversal-vs-brute-force oracle
(pattern of src/tests/bvh.cpp:16-101)."""

import numpy as np
import jax.numpy as jnp

from rayfinder_tpu.bvh import build_bvh, reorder_attributes
from rayfinder_tpu.bvh.build import LEAF_SPLIT_AXIS
from rayfinder_tpu.render.camera import create_camera, generate_camera_ray
from rayfinder_tpu.render.intersect import brute_force_closest_hit
from rayfinder_tpu.render.traverse import intersect_closest


def test_bvh_structure(small_flat, small_bvh):
    bvh = small_bvh
    n = bvh.num_nodes
    leaf = bvh.triangle_count > 0
    interior = ~leaf

    # Leaves: splitAxis sentinel, no second child (bvh.cpp:31-42).
    assert np.all(bvh.split_axis[leaf] == LEAF_SPLIT_AXIS)
    assert np.all(bvh.second_child_offset[leaf] == 0)
    # Interiors: valid axis, second child in range and after the first child.
    assert np.all(bvh.split_axis[interior] <= 2)
    idx = np.arange(n)
    assert np.all(bvh.second_child_offset[interior] > idx[interior] + 1)
    assert np.all(bvh.second_child_offset[interior] < n)

    # Leaves cover all triangles exactly once, contiguously.
    order = np.argsort(bvh.triangles_offset[leaf])
    offsets = bvh.triangles_offset[leaf][order]
    counts = bvh.triangle_count[leaf][order]
    assert offsets[0] == 0
    assert np.all(offsets[1:] == offsets[:-1] + counts[:-1])
    assert offsets[-1] + counts[-1] == small_flat.num_triangles

    # The reorder map is a permutation.
    assert sorted(bvh.triangle_indices.tolist()) == list(range(small_flat.num_triangles))


def test_child_aabbs_inside_parent(small_bvh):
    bvh = small_bvh
    interior = np.where(bvh.triangle_count == 0)[0]
    first = interior + 1
    second = bvh.second_child_offset[interior]
    eps = 1e-5
    for child in (first, second):
        assert np.all(bvh.aabb_min[child] >= bvh.aabb_min[interior] - eps)
        assert np.all(bvh.aabb_max[child] <= bvh.aabb_max[interior] + eps)


def test_leaf_aabbs_contain_triangles(small_flat, small_bvh):
    bvh = small_bvh
    tris = reorder_attributes(small_flat.positions, bvh.triangle_indices)
    leaf_idx = np.where(bvh.triangle_count > 0)[0]
    for li in leaf_idx[:: max(1, leaf_idx.size // 64)]:
        o, c = int(bvh.triangles_offset[li]), int(bvh.triangle_count[li])
        chunk = tris[o : o + c]
        assert np.all(chunk.min(axis=(0, 1)) >= bvh.aabb_min[li] - 1e-5)
        assert np.all(chunk.max(axis=(0, 1)) <= bvh.aabb_max[li] + 1e-5)


def _camera_rays_for_oracle(bvh, width=64, height=64):
    """Auto-framed camera over the root AABB (bvh-visualizer/main.cpp:36-55)."""
    root_lo, root_hi = bvh.aabb_min[0], bvh.aabb_max[0]
    diag = root_hi - root_lo
    centroid = 0.5 * (root_lo + root_hi)
    max_dim = int(np.argmax(diag))
    # centroid - vec3(-0.8*d, 0, 0.8*d) == centroid + (0.8d, 0, -0.8d)
    origin = centroid - np.asarray(
        [-0.8 * diag[max_dim], 0.0, 0.8 * diag[max_dim]], dtype=np.float32
    )
    camera = create_camera(origin, centroid, 0.0, 1.0, 70.0, width / height)
    js, is_ = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    u = js.reshape(-1).astype(np.float32) / width
    v = 1.0 - (is_.reshape(-1) + 1.0).astype(np.float32) / height
    return generate_camera_ray(camera, u, v)


def test_traversal_matches_brute_force_oracle(small_flat, small_bvh):
    """Keystone oracle (src/tests/bvh.cpp:34-101): BVH traversal and the
    all-triangles reference must agree on hit/miss and hit distance for a
    64x64 grid of camera rays."""
    bvh = small_bvh
    tris = reorder_attributes(small_flat.positions, bvh.triangle_indices)
    origin, direction = _camera_rays_for_oracle(bvh)

    tris_j = jnp.asarray(tris)
    t_max = jnp.float32(np.finfo(np.float32).max)
    bf_hit, bf_t, _ = brute_force_closest_hit(origin, direction, tris_j, t_max)

    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene import FlattenedScene

    scene = build_device_scene(small_flat, bvh=bvh)
    hit, t, tri_idx, visited = intersect_closest(scene, origin, direction, t_max)

    bf_hit = np.asarray(bf_hit)
    hit = np.asarray(hit)
    assert np.any(hit), "camera should see the blob"
    np.testing.assert_array_equal(hit, bf_hit)
    np.testing.assert_allclose(
        np.asarray(t)[hit], np.asarray(bf_t)[bf_hit], rtol=1e-5, atol=1e-6
    )
    assert np.all(np.asarray(visited) >= 1)
