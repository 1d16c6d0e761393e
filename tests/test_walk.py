"""The walk engine (ops/walk.py): its CPU build runs the same walk as the
CUDA build (native/walk.h), so these tests check on the CPU what the card
runs — against the lockstep oracle (render/traverse.py), on the edge cases
its wrapper and kernel must handle, and the keyed, locked library build.
The CUDA build itself is checked by the gpu-marked test at the end."""

import ctypes
import shutil
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rayfinder_tpu.ops import walk
from rayfinder_tpu.render.traverse import intersect_any, intersect_closest
from rayfinder_tpu.utils.native_build import build_library, library_path


@pytest.fixture(scope="module")
def courtyard4():
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(4)
    return build_device_scene(flat, textures=textures)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-18, 1, -8], [18, 10, 8], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_matches_oracle(scene, o, d, t_max):
    hit, t, tri = walk.walk_closest(scene, o, d, t_max)
    r_hit, r_t, r_tri, _ = intersect_closest(scene, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(r_tri))
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(r_hit))
    np.testing.assert_allclose(np.asarray(t), np.asarray(r_t), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        np.asarray(walk.walk_any(scene, o, d, t_max)),
        np.asarray(intersect_any(scene, o, d, t_max)),
    )
    return np.asarray(hit)


@pytest.mark.parametrize("num_rays", [1, 127, 129, 1000])
def test_walk_matches_oracle_at_any_ray_count(courtyard4, num_rays):
    """No padding is needed: ray counts that are not a multiple of the GPU
    block size (128) come back whole and equal to the oracle."""
    o, d = _random_rays(num_rays, seed=num_rays)
    hit = _assert_matches_oracle(courtyard4, o, d, jnp.float32(1e4))
    assert hit.shape == (num_rays,)


def test_walk_broadcasts_scalar_and_per_ray_t_max(courtyard4):
    o, d = _random_rays(512, seed=3)
    full = _assert_matches_oracle(courtyard4, o, d, 1e4)  # python scalar
    per_ray = jnp.asarray(np.linspace(0.5, 30.0, 512, dtype=np.float32))
    cut = _assert_matches_oracle(courtyard4, o, d, per_ray)
    assert cut.sum() < full.sum()  # short rays stop before far geometry
    _, t, _ = walk.walk_closest(courtyard4, o, d, per_ray)
    assert np.all(np.asarray(t) <= np.asarray(per_ray))


def test_walk_parked_nan_and_empty_rays(courtyard4):
    """Parked lanes (origin 1e30, as the path tracer parks dead rays) and
    NaN rays miss without touching memory out of bounds; t stays t_max. An
    empty batch is a valid call."""
    o = np.zeros((6, 3), np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (6, 1))
    o[0:2] = 1e30
    o[2, 0] = np.nan
    d[3] = np.nan
    o[4:6] = [[0.3, 5.0, 0.7], [0.3, 5.0, -0.7]]  # straight down onto the floor
    hit, t, tri = walk.walk_closest(courtyard4, jnp.asarray(o), jnp.asarray(d), 1e4)
    np.testing.assert_array_equal(np.asarray(hit), [False] * 4 + [True] * 2)
    np.testing.assert_array_equal(np.asarray(tri)[:4], -1)
    np.testing.assert_array_equal(np.asarray(t)[:4], np.float32(1e4))
    np.testing.assert_allclose(np.asarray(t)[4:], 5.0, rtol=1e-6)
    occ = walk.walk_any(courtyard4, jnp.asarray(o), jnp.asarray(d), 1e4)
    np.testing.assert_array_equal(np.asarray(occ), [False] * 4 + [True] * 2)

    empty = jnp.zeros((0, 3), jnp.float32)
    hit, t, tri = walk.walk_closest(courtyard4, empty, empty, 1e4)
    assert hit.shape == t.shape == tri.shape == (0,)


def test_walk_under_jit_matches_eager(courtyard4):
    o, d = _random_rays(300, seed=9)
    eager = walk.walk_closest(courtyard4, o, d, 1e4)
    jitted = jax.jit(lambda s, o, d: walk.walk_closest(s, o, d, 1e4))(courtyard4, o, d)
    for a, b in zip(eager, jitted):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pack_nodes_layout(courtyard4):
    """The 32-byte node table carries the BVH planes the oracle reads."""
    nodes = np.asarray(courtyard4.bvh_nodes)
    link = nodes[:, 3].view(np.int32)
    meta = nodes[:, 7].view(np.int32)
    count = np.asarray(courtyard4.bvh_tri_count)
    leaf = count > 0
    np.testing.assert_array_equal(nodes[:, 0:3], np.asarray(courtyard4.bvh_aabb_min))
    np.testing.assert_array_equal(nodes[:, 4:7], np.asarray(courtyard4.bvh_aabb_max))
    np.testing.assert_array_equal(meta >> 2, count)
    np.testing.assert_array_equal(
        (meta & 3)[~leaf], np.asarray(courtyard4.bvh_split_axis)[~leaf]
    )
    np.testing.assert_array_equal(link[leaf], np.asarray(courtyard4.bvh_tri_offset)[leaf])
    np.testing.assert_array_equal(
        link[~leaf], np.asarray(courtyard4.bvh_second_child)[~leaf]
    )


def test_walk_library_build_is_keyed_on_content(tmp_path):
    """The CPU library is built once and found again; its key follows the
    sources' content and the compile command, not file times."""
    path = walk.build("cpu")
    assert path.exists() and walk.build("cpu") == path
    header = tmp_path / "walk.h"
    unit = tmp_path / "walk_cpu.cc"
    shutil.copy(walk._HEADER, header)
    shutil.copy(walk._CPU_UNIT, unit)
    assert library_path("walk_cpu", [header, unit], walk.cpu_command()) == path
    header.write_text(header.read_text() + "\n// changed\n")
    assert library_path("walk_cpu", [header, unit], walk.cpu_command()) != path
    assert library_path("walk_cpu", [walk._HEADER, walk._CPU_UNIT],
                        walk.cpu_command() + ["-g"]) != path
    with pytest.raises(ValueError, match="no walk build"):
        walk.build("ROCM")


def test_build_library_concurrent_and_errors(tmp_path):
    """Concurrent builders of one library all get the same, complete file
    (built under a lock, renamed into place); a compile error is raised with
    the compiler's output."""
    src = tmp_path / "answer.cc"
    src.write_text(
        f'extern "C" int rf_answer() {{ return {tmp_path.stat().st_ino % 1000}; }}\n'
    )
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    paths = []
    threads = [
        threading.Thread(
            target=lambda: paths.append(build_library("test_answer", [src], [src], cmd))
        )
        for _ in range(4)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert len(paths) == 4 and len(set(paths)) == 1
    lib = ctypes.CDLL(str(paths[0]))
    lib.rf_answer.restype = ctypes.c_int
    assert lib.rf_answer() == tmp_path.stat().st_ino % 1000
    paths[0].unlink()

    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building libtest_bad"):
        build_library("test_bad", [bad], [bad], cmd)


@pytest.mark.gpu
def test_cuda_walk_matches_oracle(gpu):
    """The nvcc build (sm_90a, -fmad=false) on the card against the lockstep
    oracle on the card, courtyard(8), 65536 random rays. Hits agree on all
    but 1e-4 of the rays, t to 1e-5 relative, triangles except on ties
    (coplanar neighbours at equal t)."""
    from rayfinder_tpu.render.scene import build_device_scene
    from rayfinder_tpu.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(8)
    scene = build_device_scene(flat, textures=textures)
    o, d = _random_rays(65536, seed=11)
    hit, t, tri = (np.asarray(x) for x in walk.walk_closest(scene, o, d, 1e4))
    r_hit, r_t, r_tri, _ = (np.asarray(x) for x in intersect_closest(scene, o, d, jnp.float32(1e4)))
    assert (hit == r_hit).mean() >= 0.9999
    both = hit & r_hit
    assert np.all(np.abs(t - r_t)[both] <= 1e-5 * r_t[both])
    assert (tri == r_tri)[both].mean() >= 0.999
    occ = np.asarray(walk.walk_any(scene, o, d, 1e4))
    assert (occ == np.asarray(intersect_any(scene, o, d, jnp.float32(1e4)))).mean() >= 0.9999
