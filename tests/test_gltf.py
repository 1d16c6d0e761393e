"""glTF loading invariants (pattern of src/tests/gltf.cpp:5-18), on the seeded
small open scene written as a GLB (scene/procedural.small_open_scene)."""

import numpy as np


def test_small_scene_loads_nonempty(small_scene):
    # One mesh (a single texture), 4096 triangles, one 256x256 PNG texture.
    assert len(small_scene.meshes) == 1
    assert small_scene.meshes[0].indices.size == 3 * 4096
    assert len(small_scene.base_color_textures) == 1
    tex = small_scene.base_color_textures[0]
    assert (tex.width, tex.height) == (256, 256)


def test_small_scene_attribute_counts_match(small_scene):
    for mesh in small_scene.meshes:
        v = mesh.positions.shape[0]
        assert mesh.normals.shape == (v, 3)
        assert mesh.tex_coords.shape == (v, 2)
        assert mesh.indices.size % 3 == 0
        assert mesh.indices.max() < v


def test_small_scene_texture_indices_in_bounds(small_scene):
    for mesh in small_scene.meshes:
        assert 0 <= mesh.base_color_texture_index < len(small_scene.base_color_textures)


def test_small_scene_normals_unit_length(small_scene):
    for mesh in small_scene.meshes:
        norms = np.linalg.norm(mesh.normals, axis=-1)
        assert np.allclose(norms, 1.0, atol=1e-4)


def test_flattened_counts(small_scene, small_flat):
    expected = sum(m.indices.size // 3 for m in small_scene.meshes)
    assert small_flat.num_triangles == expected
    assert small_flat.normals.shape == small_flat.positions.shape
    assert small_flat.tex_coords.shape == (expected, 3, 2)
    assert small_flat.texture_indices.shape == (expected,)
    assert expected == 4096


def test_texture_bgra_roundtrip(small_scene):
    tex = small_scene.base_color_textures[0]
    rgba = tex.to_rgba()
    assert rgba.shape == (tex.height, tex.width, 4)
    assert np.all(rgba[..., 3] == 255)  # alpha forced opaque (texture.cpp:40-46)
