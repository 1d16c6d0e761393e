"""Full-pipeline test on a Sponza-shaped GLB: multi-mesh TRS hierarchy,
non-uniform-scale normal matrices, texture/factor dedup, shared meshes,
glb -> .pt -> device scene -> render with engine agreement.

A single-mesh, single-texture asset with a trivial hierarchy never exercises
these loader paths (reference: src/common/gltf_model.cpp:266-465); the generated
GLB (rayfinder_tpu/tools/make_test_glb.py) does.
"""

import numpy as np
import pytest

from rayfinder_tpu.scene.gltf import load_gltf
from rayfinder_tpu.tools.make_test_glb import build_test_glb, _box


@pytest.fixture(scope="module")
def glb_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("glb") / "test_scene.glb"
    build_test_glb(path)
    return path


@pytest.fixture(scope="module")
def gltf_scene(glb_path):
    return load_gltf(glb_path)


def test_mesh_and_texture_counts(gltf_scene):
    # 10 meshes (the shared mesh is emitted once: the reference indexes
    # transforms by MESH, gltf_model.cpp:56-64); 8 textures = 6 images
    # (image 3 referenced by two materials dedups) + red factor (two
    # identical factors FNV-1a-dedup) + blue factor.
    assert len(gltf_scene.meshes) == 10
    assert len(gltf_scene.base_color_textures) == 8


def test_meshes_sorted_by_texture_with_dedup(gltf_scene):
    idx = [m.base_color_texture_index for m in gltf_scene.meshes]
    assert idx == sorted(idx), "meshes must be sorted by texture index"
    # Image dedup: two meshes share texture 4 (glTF image 3); factor
    # dedup: two meshes share texture 2 (the red factor).
    assert idx.count(4) == 2
    assert idx.count(2) == 2
    # All 8 textures are referenced.
    assert sorted(set(idx)) == list(range(8))


def test_factor_texture_is_1x1(gltf_scene):
    counts = {}
    for m in gltf_scene.meshes:
        counts[m.base_color_texture_index] = (
            counts.get(m.base_color_texture_index, 0) + 1
        )
    red = gltf_scene.base_color_textures[2]
    assert red.width == 1 and red.height == 1
    # Image-backed textures keep their PNG sizes (mixed, atlas-realistic).
    sizes = {
        (t.width, t.height) for t in gltf_scene.base_color_textures
    }
    assert (16, 16) in sizes and (32, 16) in sizes and (8, 8) in sizes


def test_shared_mesh_takes_last_node_transform(gltf_scene):
    """mesh0 is referenced by node 2 (under a deep TRS chain) AND node 12;
    node 12 is traversed last, so its transform must win — the parity quirk
    of transforms-by-mesh indexing (gltf_model.cpp:56-64)."""
    pos, nrm, _, _ = _box()
    # node 12 world = root(scale [1,2,1]) @ (T [0,3,0], S [0.5,1,3])
    world = np.diag([1.0, 2.0, 1.0, 1.0]).astype(np.float32)
    local = np.eye(4, dtype=np.float32)
    local[:3, 3] = [0.0, 3.0, 0.0]
    local[:3, :3] = np.diag([0.5, 1.0, 3.0])
    world = world @ local
    expected = pos @ world[:3, :3].T + world[:3, 3]

    # mesh0 uses texture 0 and is the only mesh with it.
    (m,) = [m for m in gltf_scene.meshes if m.base_color_texture_index == 0]
    np.testing.assert_allclose(m.positions, expected, rtol=1e-6, atol=1e-6)

    # Non-uniform scale: normals transform by the inverse-transpose, not
    # the world matrix. For a diagonal world the normal dir scales by 1/s.
    nm = np.linalg.inv(world).T[:3, :3]
    exp_n = nrm @ nm.T
    exp_n /= np.linalg.norm(exp_n, axis=1, keepdims=True)
    np.testing.assert_allclose(m.normals, exp_n, rtol=1e-5, atol=1e-6)


def test_normal_matrix_differs_from_naive(gltf_scene):
    """mesh1 sits under root(scale [1,2,1]) -> a(T, R_y30) -> a2(T) ->
    a2x(R_x45): tilted normals under a non-uniform ancestor scale, where
    the inverse-transpose visibly differs from naively world-transformed
    normals (the bug this path guards against)."""
    from rayfinder_tpu.tools.make_test_glb import _xrot, _yrot
    from rayfinder_tpu.scene.gltf import _quat_to_matrix

    pos, nrm, _, _ = _box()
    root = np.diag([1.0, 2.0, 1.0, 1.0]).astype(np.float32)
    a = _quat_to_matrix(_yrot(30.0))
    a[:3, 3] = [2.0, 0.0, 0.0]
    a2 = np.eye(4, dtype=np.float32)
    a2[:3, 3] = [0.0, 1.0, 0.0]
    a2x = _quat_to_matrix(_xrot(45.0))
    world = root @ a @ a2 @ a2x

    (m,) = [m for m in gltf_scene.meshes if m.base_color_texture_index == 1]
    expected = pos @ world[:3, :3].T + world[:3, 3]
    np.testing.assert_allclose(m.positions, expected, rtol=1e-5, atol=1e-5)

    nm = np.linalg.inv(world).T[:3, :3]
    exp_n = nrm @ nm.T
    exp_n /= np.linalg.norm(exp_n, axis=1, keepdims=True)
    np.testing.assert_allclose(m.normals, exp_n, rtol=1e-5, atol=1e-5)
    naive = nrm @ world[:3, :3].T
    naive /= np.linalg.norm(naive, axis=1, keepdims=True)
    assert np.abs(exp_n - naive).max() > 0.1


def test_matrix_node_transform(gltf_scene):
    """Node 5 uses a raw column-major matrix; b1 (mesh3, texture 3) hangs
    under it with an extra translation."""
    pos, _, _, _ = _box()
    root = np.diag([1.0, 2.0, 1.0, 1.0]).astype(np.float32)
    b = np.array(
        [[0.5, 0.0, 0.0, -3.0],
         [0.0, 2.0, 0.0, 0.5],
         [0.0, 0.0, 1.5, 0.0],
         [0.0, 0.0, 0.0, 1.0]], np.float32
    )
    b1 = np.eye(4, dtype=np.float32)
    b1[:3, 3] = [0.0, 0.0, 2.0]
    world = root @ b @ b1
    expected = pos @ world[:3, :3].T + world[:3, 3]
    (m,) = [m for m in gltf_scene.meshes if m.base_color_texture_index == 3]
    np.testing.assert_allclose(m.positions, expected, rtol=1e-6, atol=1e-5)


def test_pt_roundtrip_per_mesh_arrays(glb_path, tmp_path):
    """glb -> PtScene -> .pt bytes -> read_pt preserves the per-mesh
    rasterizer arrays (pt_format.cpp:84-148) on real multi-mesh input."""
    from rayfinder_tpu.io.ptformat import PtScene, read_pt, write_pt

    scene = PtScene.from_gltf(glb_path)
    out = tmp_path / "scene.pt"
    write_pt(scene, out)
    back = read_pt(out)

    assert back.mesh_vertex_slices.shape == (10, 2)
    np.testing.assert_array_equal(back.mesh_vertex_slices,
                                  scene.mesh_vertex_slices)
    np.testing.assert_array_equal(back.mesh_index_slices,
                                  scene.mesh_index_slices)
    np.testing.assert_array_equal(back.mesh_texture_indices,
                                  scene.mesh_texture_indices)
    # Mesh sort survives the round trip: texture indices non-decreasing.
    mt = back.mesh_texture_indices.tolist()
    assert mt == sorted(mt)
    np.testing.assert_array_equal(back.vertex_positions,
                                  scene.vertex_positions)
    np.testing.assert_array_equal(back.vertex_normals, scene.vertex_normals)
    np.testing.assert_array_equal(back.vertex_tex_coords,
                                  scene.vertex_tex_coords)
    np.testing.assert_array_equal(back.vertex_indices, scene.vertex_indices)
    np.testing.assert_array_equal(back.tri_texture, scene.tri_texture)
    assert len(back.textures) == 8
    for a, b in zip(back.textures, scene.textures):
        assert a.width == b.width and a.height == b.height
        np.testing.assert_array_equal(a.pixels, b.pixels)


def test_render_engine_agreement(gltf_scene):
    """The full render path on the multi-mesh scene: wavefront vs the
    lockstep reference engine must agree on primary hits and a small
    path-traced image."""
    import jax.numpy as jnp

    from rayfinder_tpu.render.camera import create_camera, generate_camera_ray
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.render.traverse import intersect_closest
    from rayfinder_tpu.render.wavefront import intersect_closest_wavefront
    from rayfinder_tpu.scene.flatten import FlattenedScene

    flat = FlattenedScene.from_scene(gltf_scene)
    assert flat.num_triangles == 80
    scene = build_device_scene(flat, textures=gltf_scene.base_color_textures)

    camera = create_camera(
        [6.0, 6.0, 8.0], [-1.0, 1.5, 0.0], 0.0, 1.0, 60.0, 4 / 3
    )
    n = 48
    js, is_ = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    u = (js.reshape(-1) + 0.5).astype(np.float32) / n
    v = 1.0 - (is_.reshape(-1) + 0.5).astype(np.float32) / n
    o, d = generate_camera_ray(camera, jnp.asarray(u), jnp.asarray(v))
    t_max = jnp.float32(1e4)

    wh, wt, wtri, _ = intersect_closest_wavefront(scene, o, d, t_max)
    rh, rt, rtri, _ = intersect_closest(scene, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(wh), np.asarray(rh))
    hit = np.asarray(wh)
    assert hit.mean() > 0.08, "camera should see the scene"
    np.testing.assert_allclose(
        np.asarray(wt)[hit], np.asarray(rt)[hit], rtol=2e-6, atol=1e-6
    )
    # Box scenes have exact-t ties on shared edges/coplanar faces that the
    # two traversal orders may break differently; t equality is asserted
    # above, so only require near-total triangle agreement.
    agree = (np.asarray(wtri)[hit] == np.asarray(rtri)[hit]).mean()
    assert agree >= 0.99
