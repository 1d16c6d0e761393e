"""The `walk` traversal engine: one thread per ray walks the BVH with a
32-entry stack, near child first, as the reference's megakernel does
(ray_intersection.cpp:138-213, reference_path_tracer.wgsl:321-429).

The walk is written once, in native/walk.h, and compiled twice: for the GPU
by nvcc (native/walk_cuda.cu, sm_90a) and for the CPU by g++
(native/walk_cpu.cc), so the CPU tests run the same walk as the card. Both
are called through `jax.ffi`. The libraries are built from the repository's
sources at first use (utils/native_build.py); the CUDA one only where JAX
sees a GPU.

Its semantics are those of the lockstep oracle (render/traverse.py), which
the tests compare it against.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import threading

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.native_build import NATIVE_DIR, build_library

_CLOSEST = "rf_walk_closest"
_ANY = "rf_walk_any"

_HEADER = NATIVE_DIR / "walk.h"
_CPU_UNIT = NATIVE_DIR / "walk_cpu.cc"
_CUDA_UNIT = NATIVE_DIR / "walk_cuda.cu"

_lock = threading.Lock()
_registered: dict[str, ctypes.CDLL] = {}


def pack_nodes(aabb_min, aabb_max, tri_offset, second_child, tri_count, split_axis) -> np.ndarray:
    """Pack the BVH's SoA planes into the walk's (N, 8) float32 node table:
    [lo.xyz, link, hi.xyz, meta] per 32-byte node, with the int32 fields
    bitcast. link is a leaf's first triangle or an interior node's second
    child; meta = triangle count << 2 | split axis (native/walk.h, rf::Node)."""
    tri_count = np.asarray(tri_count, np.int64)
    leaf = tri_count > 0
    link = np.where(leaf, np.asarray(tri_offset, np.int64), np.asarray(second_child, np.int64))
    meta = (tri_count << 2) | (np.asarray(split_axis, np.int64) & 3)
    nodes = np.empty((tri_count.shape[0], 8), np.float32)
    nodes[:, 0:3] = aabb_min
    nodes[:, 3] = link.astype(np.int32).view(np.float32)
    nodes[:, 4:7] = aabb_max
    nodes[:, 7] = meta.astype(np.int32).view(np.float32)
    return nodes


def _include_flags() -> list[str]:
    return ["-I", jax.ffi.include_dir(), "-I", str(NATIVE_DIR)]


def cpu_command() -> list[str]:
    """g++ without contraction to FMA, so rounding matches the jnp oracle."""
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", *_include_flags()]


def cuda_command() -> list[str]:
    """nvcc for Hopper (sm_90a) without FMA contraction (-fmad=false)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
        "-shared", "-Xcompiler", "-fPIC", "-fmad=false", *_include_flags(),
    ]


def build(platform: str) -> pathlib.Path:
    """Build (or find) the walk library for "cpu" or "CUDA"."""
    if platform == "cpu":
        return build_library("walk_cpu", [_HEADER, _CPU_UNIT], [_CPU_UNIT], cpu_command())
    if platform == "CUDA":
        return build_library("walk_cuda", [_HEADER, _CUDA_UNIT], [_CUDA_UNIT], cuda_command())
    raise ValueError(f"no walk build for platform {platform!r}")


def _gpu_present() -> bool:
    try:
        return len(jax.devices("gpu")) > 0
    except RuntimeError:  # no GPU backend in this process
        return False


def _register() -> None:
    """Register the FFI targets once per process: the CPU build always, the
    CUDA build where JAX has a GPU."""
    with _lock:
        wanted = [("cpu", "Cpu")] + ([("CUDA", "Cuda")] if _gpu_present() else [])
        for platform, suffix in wanted:
            if platform in _registered:
                continue
            lib = ctypes.CDLL(str(build(platform)))
            for target, symbol in ((_CLOSEST, "RfWalkClosest"), (_ANY, "RfWalkAny")):
                jax.ffi.register_ffi_target(
                    target, jax.ffi.pycapsule(getattr(lib, symbol + suffix)), platform=platform
                )
            _registered[platform] = lib  # keeps the library loaded


def _rays(origin, direction, t_max):
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    num_rays = origin.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (num_rays,))
    return origin, direction, t_max, num_rays


def walk_closest(scene, origin, direction, t_max):
    """Closest hit for (B, 3) rays; t_max is a scalar or (B,). Returns
    (hit, t, tri): t is t_max and tri -1 where nothing is hit."""
    _register()
    origin, direction, t_max, n = _rays(origin, direction, t_max)
    t, tri = jax.ffi.ffi_call(
        _CLOSEST,
        (jax.ShapeDtypeStruct((n,), jnp.float32), jax.ShapeDtypeStruct((n,), jnp.int32)),
    )(scene.bvh_nodes, scene.tri_positions, origin, direction, t_max)
    return tri >= 0, t, tri


def walk_any(scene, origin, direction, t_max):
    """Any hit (shadow rays) for (B, 3) rays. Returns occluded: (B,) bool."""
    _register()
    origin, direction, t_max, n = _rays(origin, direction, t_max)
    occluded = jax.ffi.ffi_call(_ANY, jax.ShapeDtypeStruct((n,), jnp.int32))(
        scene.bvh_nodes, scene.tri_positions, origin, direction, t_max
    )
    return occluded != 0
