"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp).

The Python builder (build.py) is the semantic reference; the native builder
produces identical topology (asserted in tests/test_native_bvh.py) and is
~50-100x faster, which matters for Sponza-scale scenes (262K triangles). The
shared library is compiled at first use with g++ -O3 -ffp-contract=off (the
contract flag keeps float rounding identical to numpy — no FMA contraction)
into native/build/, keyed on a hash of source, compiler and flags
(utils/native_build.py).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from ..utils.native_build import NATIVE_DIR, build_library
from .build import Bvh

_SOURCE = NATIVE_DIR / "bvh_builder.cpp"
_COMMAND = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library("bvh_builder", [_SOURCE], [_SOURCE], _COMMAND)))
        lib.rf_build_bvh.restype = ctypes.c_int64
        lib.rf_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return False


def build_bvh_native(triangles: np.ndarray) -> Bvh:
    """Build a BVH with the native builder. Same contract as build.build_bvh."""
    lib = _load()
    triangles = np.ascontiguousarray(triangles, dtype=np.float32)
    num_tris = triangles.shape[0]
    cap = 2 * num_tris

    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    tri_offset = np.empty(cap, np.uint32)
    second_child = np.empty(cap, np.uint32)
    tri_count = np.empty(cap, np.uint32)
    split_axis = np.empty(cap, np.uint32)
    triangle_indices = np.empty(num_tris, np.int64)

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    n = lib.rf_build_bvh(
        ptr(triangles, ctypes.c_float),
        num_tris,
        ptr(aabb_min, ctypes.c_float),
        ptr(aabb_max, ctypes.c_float),
        ptr(tri_offset, ctypes.c_uint32),
        ptr(second_child, ctypes.c_uint32),
        ptr(tri_count, ctypes.c_uint32),
        ptr(split_axis, ctypes.c_uint32),
        ptr(triangle_indices, ctypes.c_int64),
    )
    if n < 0:
        raise RuntimeError("rf_build_bvh failed (bad input or capacity overflow)")

    return Bvh(
        aabb_min=aabb_min[:n].copy(),
        aabb_max=aabb_max[:n].copy(),
        triangles_offset=tri_offset[:n].copy(),
        second_child_offset=second_child[:n].copy(),
        triangle_count=tri_count[:n].copy(),
        split_axis=split_axis[:n].copy(),
        triangle_indices=triangle_indices,
    )


def build_bvh_fast(triangles: np.ndarray) -> Bvh:
    """Native builder when available, Python fallback otherwise."""
    if native_available():
        return build_bvh_native(triangles)
    from .build import build_bvh

    return build_bvh(triangles)
