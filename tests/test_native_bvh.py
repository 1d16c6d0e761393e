"""Native C++ BVH builder: topology must match the Python builder exactly."""

import numpy as np
import pytest

from rayfinder_tpu.bvh import build_bvh
from rayfinder_tpu.bvh.native import build_bvh_fast, build_bvh_native, native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native builder unavailable (no g++?)"
)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.aabb_min, b.aabb_min)
    np.testing.assert_array_equal(a.aabb_max, b.aabb_max)
    np.testing.assert_array_equal(a.triangles_offset, b.triangles_offset)
    np.testing.assert_array_equal(a.second_child_offset, b.second_child_offset)
    np.testing.assert_array_equal(a.triangle_count, b.triangle_count)
    np.testing.assert_array_equal(a.split_axis, b.split_axis)
    np.testing.assert_array_equal(a.triangle_indices, b.triangle_indices)


def test_native_matches_python_on_small_scene(small_flat, small_bvh):
    native = build_bvh_native(small_flat.positions)
    _assert_same(native, small_bvh)


def test_native_matches_python_on_random_soup(rng):
    centers = rng.uniform(-5, 5, size=(2000, 1, 3))
    tris = (centers + rng.normal(scale=0.3, size=(2000, 3, 3))).astype(np.float32)
    _assert_same(build_bvh_native(tris), build_bvh(tris))


def test_native_single_triangle():
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    bvh = build_bvh_native(tri)
    assert bvh.num_nodes == 1
    assert bvh.triangle_count[0] == 1


def test_fast_builder_dispatches():
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    assert build_bvh_fast(tri).num_nodes == 1
