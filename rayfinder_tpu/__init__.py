"""rayfinder-tpu: a wavefront path tracer in JAX.

Rebuilds the capabilities of Nelarius/rayfinder (C++/WebGPU) in JAX: SoA ray
batches, a per-ray BVH walk compiled for the GPU (ops/walk.py) beside plain
XLA engines, and `shard_map` tile/sample parallelism across device meshes.

Quick start::

    from rayfinder_tpu import load_scene, render_image, SamplingParams, create_camera
    from rayfinder_tpu.sky.model import sky_state_from_ui

    scene = load_scene("scene.glb")           # .glb/.gltf or .pt
    camera = create_camera([2, 1.5, 2], [0.1, 0.8, 0], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(1.0, (1, 1, 1), 30.0, 0.0)
    img = render_image(scene, sky, camera, width=800, height=600,
                       sampling=SamplingParams(128, 4))
"""

__version__ = "0.1.0"

import os as _os
import pathlib as _pathlib

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    # Persistent compile cache at a fixed path inside the checkout. Where
    # JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    # set here.
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"),
    )


def __getattr__(name):
    # Lazy exports keep `import rayfinder_tpu` from building the render modules.
    if name == "load_scene":
        from .render.scene import load_device_scene

        return load_device_scene
    if name in ("render_image", "render_image_tiled", "SamplingParams", "trace_radiance"):
        from .render import pathtracer

        return getattr(pathtracer, name)
    if name in ("create_camera", "Camera"):
        from .render import camera

        return getattr(camera, name)
    if name in ("Renderer", "RenderParameters", "Sky"):
        from .render import renderer

        return getattr(renderer, name)
    if name == "DeferredRenderer":
        from .render.deferred import DeferredRenderer

        return DeferredRenderer
    raise AttributeError(f"module 'rayfinder_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = [
    "load_scene",
    "render_image",
    "render_image_tiled",
    "SamplingParams",
    "trace_radiance",
    "create_camera",
    "Camera",
    "Renderer",
    "RenderParameters",
    "Sky",
    "DeferredRenderer",
]
