"""Device-resident scene: SoA jnp arrays consumed by the render kernels.

The analog of the reference's scene bind group
(src/pt/reference_path_tracer.cpp:131-270): BVH nodes, triangle attribute
arrays in BVH leaf order, a texture-descriptor table, and one packed texel
atlas. All arrays are static-shaped device buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..bvh import Bvh, reorder_attributes
from ..scene import FlattenedScene, Texture

# Packed-texel-atlas budget, matching the reference's storage-buffer binding
# limit for its texture buffer (src/pt/reference_path_tracer.cpp:253-263,
# gpu_limits.hpp maxStorageBufferBindingSize rationale in
# notes/storage_buffer_binding_size.md).
MAX_TEXEL_BYTES = 256 * 1024 * 1024


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """SoA device arrays. Triangles are in BVH leaf order."""

    # BVH (reference node contract, bvh.hpp:14-21, split into SoA planes)
    bvh_aabb_min: Any  # (N, 3) f32
    bvh_aabb_max: Any  # (N, 3) f32
    bvh_tri_offset: Any  # (N,) i32
    bvh_second_child: Any  # (N,) i32
    bvh_tri_count: Any  # (N,) i32
    bvh_split_axis: Any  # (N,) i32 (leaf nodes hold an arbitrary valid axis)
    # The same nodes packed once for the walk engine (ops/walk.pack_nodes).
    bvh_nodes: Any  # (N, 8) f32, 32-byte nodes

    # Triangle attributes (reference_path_tracer.wgsl:133-149)
    tri_positions: Any  # (T, 3, 3) f32
    tri_normals: Any  # (T, 3, 3) f32
    tri_uvs: Any  # (T, 3, 2) f32
    tri_texture: Any  # (T,) i32

    # Texture atlas (reference_path_tracer.cpp:209-270)
    tex_width: Any  # (K,) i32
    tex_height: Any  # (K,) i32
    tex_offset: Any  # (K,) i32
    tex_desc: Any  # (K, 3) i32 packed [width, height, offset] descriptor rows
    texels: Any  # (P,) uint32 packed BGRA

    # Triangle clusters for the wavefront engine (bvh/clusters.py).
    # Clusters are BVH-treelet-aligned leaf-order ranges (tight AABBs).
    cluster_tris: Any  # (C, L, 3, 3) f32 padded blocks
    cluster_min: Any  # (C, 3) f32
    cluster_max: Any  # (C, 3) f32
    cluster_tri_map: Any  # (C * L,) i32 padded slot -> real triangle
    cluster_start: Any  # (C,) i32 first leaf-order triangle of each cluster

    # Packed per-triangle shading attributes: one 25-float row per triangle
    # (9 positions, 9 normals, 6 uvs, texture index as bitcast f32) so the
    # post-traversal surface lookup is a single chunky row gather.
    tri_attrs: Any  # (T, 25) f32

    @property
    def num_triangles(self) -> int:
        return self.tri_positions.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.bvh_aabb_min.shape[0]


def build_device_scene(
    flat: FlattenedScene,
    bvh: Bvh | None = None,
    textures: list[Texture] | None = None,
) -> DeviceScene:
    """Build the BVH (if not given), reorder attributes into leaf order, pack
    textures into one atlas, and upload everything as jnp arrays."""
    if bvh is None:
        from ..bvh.native import build_bvh_fast

        bvh = build_bvh_fast(flat.positions)
    from ..bvh.clusters import DEFAULT_LEAF_SIZE, build_clusters, treelet_ranges
    from ..ops.walk import pack_nodes

    positions = reorder_attributes(flat.positions, bvh.triangle_indices)
    normals = reorder_attributes(flat.normals, bvh.triangle_indices)
    uvs = reorder_attributes(flat.tex_coords, bvh.triangle_indices)
    tex_idx = reorder_attributes(flat.texture_indices, bvh.triangle_indices)

    if textures:
        widths = np.asarray([t.width for t in textures], dtype=np.int32)
        heights = np.asarray([t.height for t in textures], dtype=np.int32)
        sizes = widths.astype(np.int64) * heights
        total_bytes = int(sizes.sum()) * 4
        if total_bytes > MAX_TEXEL_BYTES:
            # Same policy as the reference's packed texel buffer, which
            # refuses scenes past its storage-binding budget
            # (reference_path_tracer.cpp:253-263,
            # notes/storage_buffer_binding_size.md). Keeping the cap also
            # guarantees the int32 texel offsets below cannot overflow.
            raise ValueError(
                f"Texture atlas of {total_bytes} bytes exceeds the "
                f"{MAX_TEXEL_BYTES} byte limit"
            )
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        texels = np.concatenate([t.pixels for t in textures]).astype(np.uint32)
    else:
        widths = np.asarray([1], dtype=np.int32)
        heights = np.asarray([1], dtype=np.int32)
        offsets = np.asarray([0], dtype=np.int32)
        # Default white texel: BGRA 0xFFFFFFFF.
        texels = np.asarray([0xFFFFFFFF], dtype=np.uint32)

    clusters = build_clusters(
        positions, ranges=treelet_ranges(bvh, DEFAULT_LEAF_SIZE, positions)
    )

    num_tris = positions.shape[0]
    tri_attrs = np.empty((num_tris, 25), dtype=np.float32)
    tri_attrs[:, 0:9] = positions.reshape(num_tris, 9)
    tri_attrs[:, 9:18] = normals.reshape(num_tris, 9)
    tri_attrs[:, 18:24] = uvs.reshape(num_tris, 6)
    tri_attrs[:, 24] = tex_idx.astype(np.uint32).view(np.float32)

    return DeviceScene(
        bvh_aabb_min=jnp.asarray(bvh.aabb_min),
        bvh_aabb_max=jnp.asarray(bvh.aabb_max),
        bvh_tri_offset=jnp.asarray(bvh.triangles_offset.astype(np.int32)),
        bvh_second_child=jnp.asarray(bvh.second_child_offset.astype(np.int32)),
        bvh_tri_count=jnp.asarray(bvh.triangle_count.astype(np.int32)),
        bvh_split_axis=jnp.asarray(
            np.where(bvh.triangle_count > 0, 0, bvh.split_axis).astype(np.int32)
        ),
        bvh_nodes=jnp.asarray(
            pack_nodes(
                bvh.aabb_min, bvh.aabb_max, bvh.triangles_offset,
                bvh.second_child_offset, bvh.triangle_count, bvh.split_axis,
            )
        ),
        tri_positions=jnp.asarray(positions),
        tri_normals=jnp.asarray(normals),
        tri_uvs=jnp.asarray(uvs),
        tri_texture=jnp.asarray(tex_idx.astype(np.int32)),
        tex_width=jnp.asarray(widths),
        tex_height=jnp.asarray(heights),
        tex_offset=jnp.asarray(offsets),
        tex_desc=jnp.asarray(np.stack([widths, heights, offsets], axis=1)),
        texels=jnp.asarray(texels),
        cluster_tris=jnp.asarray(clusters.tris),
        cluster_min=jnp.asarray(clusters.aabb_min),
        cluster_max=jnp.asarray(clusters.aabb_max),
        cluster_tri_map=jnp.asarray(clusters.tri_map),
        cluster_start=jnp.asarray(clusters.start),
        tri_attrs=jnp.asarray(tri_attrs),
    )


def load_device_scene(path) -> DeviceScene:
    """Load a .glb/.gltf or .pt file straight into a DeviceScene."""
    import pathlib

    path = pathlib.Path(path)
    if path.suffix == ".pt":
        from ..io.ptformat import read_pt

        pt = read_pt(path)
        return pt.to_device_scene()
    from ..scene import load_gltf

    scene = load_gltf(path)
    flat = FlattenedScene.from_scene(scene)
    return build_device_scene(flat, textures=scene.base_color_textures)
