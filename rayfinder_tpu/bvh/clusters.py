"""Triangle clusters: the acceleration structure of the wavefront engine.

The wavefront engine (render/wavefront.py) replaces deep per-ray traversal
with a shallow two-stage scheme that plain XLA can express:

1. triangles — already spatially sorted by the SAH builder's depth-first leaf
   order — are chunked into fixed-size clusters of LEAF_SIZE consecutive
   triangles with precomputed AABBs;
2. rays are culled against cluster AABBs densely (no gathers), and each ray
   intersects the whole triangle blocks of its nearest overlapped clusters
   as dense Möller-Trumbore batches.

This trades more triangle tests for regular, gather-light compute.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

DEFAULT_LEAF_SIZE = int(os.environ.get("RAYFINDER_LEAF", "128"))


@dataclasses.dataclass
class ClusterSet:
    """Host-side cluster arrays (C clusters of up to L triangles each)."""

    tris: np.ndarray  # (C, L, 3, 3) f32, padded blocks
    aabb_min: np.ndarray  # (C, 3) f32
    aabb_max: np.ndarray  # (C, 3) f32
    tri_map: np.ndarray  # (C * L,) int32: padded slot -> real triangle index
    start: np.ndarray  # (C,) int32: first leaf-order triangle of each cluster

    @property
    def num_clusters(self) -> int:
        return self.tris.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.tris.shape[1]


def treelet_ranges(
    bvh, leaf_size: int, positions: np.ndarray | None = None,
    sa_alpha: float = 1.0,
) -> np.ndarray:
    """Cut the BVH into maximal subtrees of <= leaf_size triangles, then
    merge consecutive cuts that still fit — but only when the merge does not
    BLOAT the cluster AABB.

    Because the builder flattens depth-first and reorders triangles into leaf
    order (bvh.cpp:263-291), every subtree covers a CONTIGUOUS leaf-order
    range — so treelet clusters are ranges [start, end) whose AABBs respect
    the tree's own spatial splits, much tighter than blind fixed chunks at
    branch boundaries. Returns (C, 2) int64 [start, end) ranges.

    positions: (N, 3, 3) leaf-ordered triangle vertices. When given, a merge
    is accepted only if the union's AABB surface area <= sa_alpha * (sum of
    the parts' areas) — consecutive cuts at major branch boundaries can be
    spatially DISJOINT, and unconditionally merging them (the round-1
    behavior) unions far-apart geometry into one fat AABB. Measured on
    courtyard(14) bounce rays (offline study, 2026-08-18): unconditional
    merge C=777/fill 95/total SA 7776/per-lane needed clusters 3.58;
    SA-bounded (alpha=1) C=868/fill 85/SA 3935/need 0.83 — far fewer
    clusters entered per ray for +12% clusters. positions=None falls back to
    NO merging.
    """
    tc = np.asarray(bvh.triangle_count, np.int64)
    off = np.asarray(bvh.triangles_offset, np.int64)
    sc = np.asarray(bvh.second_child_offset, np.int64)
    num_tris = int(tc[tc > 0].sum())

    cuts = []
    stack = [0]
    while stack:
        i = stack.pop()
        if tc[i] > 0:
            cuts.append((int(off[i]), int(off[i] + tc[i])))
            continue
        # Subtree triangle range = [min leaf offset, max leaf end) — compute
        # lazily: a subtree of an in-order leaf layout spans from its
        # leftmost leaf's offset to its rightmost leaf's end. Walk down the
        # left spine for start and right spine for end.
        lo = i
        while tc[lo] == 0:
            lo = lo + 1
        hi = i
        while tc[hi] == 0:
            hi = int(sc[hi])
        start, end = int(off[lo]), int(off[hi] + tc[hi])
        if end - start <= leaf_size:
            cuts.append((start, end))
        else:
            stack.append(int(sc[i]))
            stack.append(i + 1)
    cuts.sort()
    assert cuts[0][0] == 0 and cuts[-1][1] == num_tris

    if positions is None:
        return np.asarray(cuts, np.int64)

    # Ranges are <= leaf_size triangles, so the merge scan's area
    # evaluations stay O(total triangles).
    verts = np.asarray(positions, np.float32).reshape(-1, 3)

    def _sa(s: int, e: int) -> float:
        blk = verts[3 * s:3 * e]
        ext = blk.max(axis=0) - blk.min(axis=0)
        return float(ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])

    merged = []
    cs, ce = cuts[0]
    for s, e in cuts[1:]:
        if e - cs <= leaf_size and _sa(cs, e) <= sa_alpha * (
            _sa(cs, ce) + _sa(s, e)
        ):
            ce = e
        else:
            merged.append((cs, ce))
            cs, ce = s, e
    merged.append((cs, ce))
    return np.asarray(merged, np.int64)


def build_clusters(
    tri_positions: np.ndarray,
    leaf_size: int = DEFAULT_LEAF_SIZE,
    ranges: np.ndarray | None = None,
) -> ClusterSet:
    """Chunk leaf-ordered triangles into padded fixed-size cluster blocks.

    ranges: optional (C, 2) [start, end) leaf-order ranges (treelet_ranges);
    default = blind consecutive chunks of leaf_size.

    Padding slots are DEGENERATE (all-zero) triangles: Möller-Trumbore rejects
    them unconditionally (|det| = 0 < EPSILON), so a padded slot can never win
    an argmin — which makes `start[cluster] + slot` the real leaf-order
    triangle index directly, with no remap gather on the hot path. tri_map is
    kept (range layout, padding clamped in-range) for engines that still
    index it. Cluster AABBs cover only the real triangles.
    """
    tri_positions = np.ascontiguousarray(tri_positions, dtype=np.float32)
    num_tris = tri_positions.shape[0]
    if ranges is None:
        num_clusters = -(-num_tris // leaf_size)
        starts = np.arange(num_clusters, dtype=np.int64) * leaf_size
        ends = np.minimum(starts + leaf_size, num_tris)
    else:
        starts = np.asarray(ranges[:, 0], np.int64)
        ends = np.asarray(ranges[:, 1], np.int64)
        num_clusters = starts.shape[0]
    counts = ends - starts
    assert counts.max() <= leaf_size

    blocks = np.zeros((num_clusters, leaf_size, 3, 3), dtype=np.float32)
    tri_map = np.empty((num_clusters, leaf_size), dtype=np.int32)
    slot = np.arange(leaf_size, dtype=np.int64)
    idx = starts[:, None] + slot[None, :]  # (C, L) candidate indices
    valid = slot[None, :] < counts[:, None]
    idx_clamped = np.minimum(idx, num_tris - 1)
    blocks[valid] = tri_positions[idx_clamped[valid]]
    tri_map[:, :] = np.where(valid, idx_clamped, starts[:, None]).astype(np.int32)

    mask = valid[:, :, None, None]
    aabb_min = np.where(mask, blocks, np.inf).min(axis=(1, 2))
    aabb_max = np.where(mask, blocks, -np.inf).max(axis=(1, 2))
    return ClusterSet(
        tris=blocks,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        tri_map=tri_map.reshape(-1),
        start=starts.astype(np.int32),
    )
