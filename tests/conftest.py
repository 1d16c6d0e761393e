"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the sharding
tests have a mesh. An explicit JAX_PLATFORMS is respected: `JAX_PLATFORMS=cuda
pytest -m gpu tests/` runs the tests that need the card (chip_smoke.py does).
Whether a card is present is decided inside fixtures, never while a module
is imported, so every test worker collects the same tests.

The small open scene stands in for a downloaded asset: it is generated from
a seed, written as a GLB and loaded back through the glTF loader.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA GPU; skips elsewhere")
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects it"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX sees a CUDA GPU."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def small_glb(tmp_path_factory):
    """The seeded small open scene (scene/procedural.small_open_scene)
    written as a GLB."""
    from rayfinder_tpu.scene.procedural import write_small_open_glb

    return write_small_open_glb(tmp_path_factory.mktemp("small") / "small_open.glb")


@pytest.fixture(scope="session")
def small_scene(small_glb):
    from rayfinder_tpu.scene import load_gltf

    return load_gltf(small_glb)


@pytest.fixture(scope="session")
def small_flat(small_scene):
    from rayfinder_tpu.scene import FlattenedScene

    return FlattenedScene.from_scene(small_scene)


@pytest.fixture(scope="session")
def small_bvh(small_flat):
    from rayfinder_tpu.bvh import build_bvh

    return build_bvh(small_flat.positions)


@pytest.fixture(scope="session")
def small_device_scene(small_scene, small_flat, small_bvh):
    from rayfinder_tpu.render.scene import build_device_scene

    return build_device_scene(
        small_flat, bvh=small_bvh, textures=small_scene.base_color_textures
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
