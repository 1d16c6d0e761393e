"""PTFORMAT3 round-trip and error-path tests
(pattern of src/tests/pt_format.cpp:18-213)."""

import numpy as np
import pytest

from rayfinder_tpu.io import PtScene, read_pt, write_pt


@pytest.fixture(scope="module")
def small_pt(tmp_path_factory, small_glb):
    scene = PtScene.from_gltf(small_glb)
    path = tmp_path_factory.mktemp("pt") / "small.pt"
    write_pt(scene, path)
    return scene, path


def test_roundtrip_arrays_equal(small_pt):
    scene, path = small_pt
    loaded = read_pt(path)

    np.testing.assert_array_equal(loaded.bvh.aabb_min, scene.bvh.aabb_min)
    np.testing.assert_array_equal(loaded.bvh.aabb_max, scene.bvh.aabb_max)
    np.testing.assert_array_equal(loaded.bvh.triangles_offset, scene.bvh.triangles_offset)
    np.testing.assert_array_equal(
        loaded.bvh.second_child_offset, scene.bvh.second_child_offset
    )
    np.testing.assert_array_equal(loaded.bvh.triangle_count, scene.bvh.triangle_count)
    np.testing.assert_array_equal(loaded.bvh.split_axis, scene.bvh.split_axis)

    np.testing.assert_array_equal(loaded.bvh_positions, scene.bvh_positions)
    np.testing.assert_array_equal(loaded.tri_positions, scene.tri_positions)
    np.testing.assert_array_equal(loaded.tri_normals, scene.tri_normals)
    np.testing.assert_array_equal(loaded.tri_uvs, scene.tri_uvs)
    np.testing.assert_array_equal(loaded.tri_texture, scene.tri_texture)

    np.testing.assert_array_equal(loaded.vertex_positions, scene.vertex_positions)
    np.testing.assert_array_equal(loaded.vertex_normals, scene.vertex_normals)
    np.testing.assert_array_equal(loaded.vertex_tex_coords, scene.vertex_tex_coords)
    np.testing.assert_array_equal(loaded.vertex_indices, scene.vertex_indices)
    np.testing.assert_array_equal(loaded.mesh_vertex_slices, scene.mesh_vertex_slices)
    np.testing.assert_array_equal(loaded.mesh_index_slices, scene.mesh_index_slices)
    np.testing.assert_array_equal(
        loaded.mesh_texture_indices, scene.mesh_texture_indices
    )

    assert len(loaded.textures) == len(scene.textures)
    for a, b in zip(loaded.textures, scene.textures):
        assert (a.width, a.height) == (b.width, b.height)
        np.testing.assert_array_equal(a.pixels, b.pixels)


def test_vertex_positions_homogeneous(small_pt):
    scene, _ = small_pt
    # vec4 packing: positions w=1, normals w=0 (pt_format.cpp:115-128).
    assert np.all(scene.vertex_positions[:, 3] == 1.0)
    assert np.all(scene.vertex_normals[:, 3] == 0.0)


def test_version_mismatch_error(tmp_path, small_pt):
    _, path = small_pt
    data = bytearray(path.read_bytes())
    data[: len(b"PTFORMAT2")] = b"PTFORMAT2"
    bad = tmp_path / "old.pt"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Mismatching PtFormat file version"):
        read_pt(bad)


def test_invalid_format_error(tmp_path):
    bad = tmp_path / "junk.pt"
    bad.write_bytes(b"NOTAPTFILE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="Invalid file format"):
        read_pt(bad)


def test_device_scene_from_pt(small_pt, small_flat):
    scene, path = small_pt
    device = read_pt(path).to_device_scene()
    assert device.num_triangles == small_flat.num_triangles
    assert device.num_nodes == scene.bvh.num_nodes
