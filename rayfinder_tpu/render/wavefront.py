"""Wavefront traversal in plain XLA: chunked cull → top-k near-first
cluster walk.

An XLA alternative to the per-ray stack walk (traverse.py, ops/walk.py),
made only of dense array operations. Semantics are identical to the
reference's closest-hit / any-hit queries
(src/pt/reference_path_tracer.wgsl:321-429) — both compute exact minima over
the same accepted triangle set — but the computation is reorganized:

1. **Cull** (per ray chunk): every ray is slab-tested against every cluster
   AABB — elementwise work over a (K, C) grid, no gathers.
2. **Order**: `lax.top_k` sorts each ray's overlapped clusters by entry
   distance. This is the dense analog of the reference's near-child-first
   stack ordering (wgsl:408-418) and enables the same pruning: once a hit is
   found closer than the next cluster's entry t, the lane is done.
3. **Walk**: a short `while_loop` over cluster slots; in step m every lane
   intersects its m-th nearest cluster's whole (L, 3, 3) triangle block with
   dense Möller-Trumbore (blocks fetched with exact row gathers).
4. No scatters in the walk: reductions stay lane-aligned.

Capacity overflow is HANDLED, not just reported: a ray overlapping more than
MAX_CLUSTERS_PER_RAY cluster AABBs is only *provably* resolved when its best
hit is nearer than the last kept cluster entry (dropped clusters all enter
later, and a triangle hit can never be nearer than its cluster's entry t).
Rays that fail that proof are re-walked at FULL cluster capacity (no
overflow possible) in compacted sub-batches (_escalate) — results are exact
for every ray. The returned `overflow` count is the number of escalated
rays, kept for observability (tests/test_wavefront.py pins it to 0 on the
small open scene and exercises the escalation on an enclosed many-cluster
scene).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .intersect import ray_triangle
from .scene import DeviceScene

RAY_CHUNK = 65536  # rays traversed per chunk (bounds device temporaries)
MAX_CLUSTERS_PER_RAY = 32  # top-k capacity per ray
_MAX_CULL_ENTRIES = 32 * 1024 * 1024  # cap on the (chunk, C) cull grid
_ESC_CHUNK = 1024  # unresolved-overflow rays re-walked per escalation step


def _ray_chunk(num_clusters: int, num_rays: int | None = None) -> int:
    """Shrink the ray chunk for large scenes so the dense (chunk, C) cull
    grid stays bounded (~128MB of f32 temporaries); never pad a small batch
    past the next power of two above its actual size."""
    chunk = RAY_CHUNK
    while chunk > 1024 and chunk * num_clusters > _MAX_CULL_ENTRIES:
        chunk //= 2
    if num_rays is not None:
        while chunk > 1024 and chunk // 2 >= num_rays:
            chunk //= 2
    return chunk


def _slab_entry(origin, inv_dir, dir_neg, aabb_min, aabb_max, t_max):
    """Slab test returning (hit, t_entry). Same accept set as
    intersect.ray_aabb (ray_intersection.cpp:101-136); t_entry = max(tmin, 0)."""
    near = jnp.where(dir_neg, aabb_max, aabb_min)
    far = jnp.where(dir_neg, aabb_min, aabb_max)
    t0 = (near - origin) * inv_dir
    t1 = (far - origin) * inv_dir

    tmin_xy = jnp.maximum(t0[..., 0], t0[..., 1])
    tmax_xy = jnp.minimum(t1[..., 0], t1[..., 1])
    fail_xy = (t0[..., 0] > t1[..., 1]) | (t0[..., 1] > t1[..., 0])
    fail_z = (tmin_xy > t1[..., 2]) | (t0[..., 2] > tmax_xy)
    tmin = jnp.maximum(tmin_xy, t0[..., 2])
    tmax = jnp.minimum(tmax_xy, t1[..., 2])

    hit = ~fail_xy & ~fail_z & (tmin < t_max) & (tmax > 0.0)
    return hit, jnp.maximum(tmin, 0.0)


def _gather_cluster_blocks(scene: DeviceScene, cid):
    """(K,) cluster ids -> (K, L, 3, 3) triangle blocks by a plain take,
    which is exact (a one-hot matrix product would round in TF32 or bf16
    at default precision)."""
    return scene.cluster_tris[cid]


def _order_clusters(scene, origin, direction, t_max, top_k: int):
    """Cull + near-first ordering for one ray chunk.

    Returns (entry, cids, overflow): entry (K, top_k) ascending cluster entry
    distances (inf past the last overlapped cluster), cids (K, top_k) cluster
    ids, overflow (K,) bool capacity-exceeded flags.
    """
    inv_dir = jnp.float32(1.0) / direction
    dir_neg = inv_dir < 0.0
    hit, t_entry = _slab_entry(
        origin[:, None, :],
        inv_dir[:, None, :],
        dir_neg[:, None, :],
        scene.cluster_min[None, :, :],
        scene.cluster_max[None, :, :],
        t_max[:, None],
    )
    score = jnp.where(hit, t_entry, jnp.inf)
    neg_entry, cids = jax.lax.top_k(-score, top_k)  # ascending t_entry
    overflow = jnp.sum(hit, axis=-1) > top_k
    return -neg_entry, cids.astype(jnp.int32), overflow


def _walk_closest(scene, origin, direction, t_max, entry, cids):
    """Near-first cluster walk with per-lane distance pruning."""
    leaf = scene.cluster_tris.shape[1]
    num_slots = entry.shape[1]
    batch = origin.shape[0]
    # Derive initial carries from the (possibly shard_map-varying) ray arrays
    # so while_loop carry types match under manual sharding (cf. traverse.py).
    zero_i = (origin[:, 0] * 0.0).astype(jnp.int32)
    t_max = t_max + 0.0 * origin[:, 0]

    def slot_entry(m):
        return jax.lax.dynamic_slice_in_dim(entry, m, 1, axis=1)[:, 0]

    def cond(state):
        m, best_t, _ = state
        return (m < num_slots) & jnp.any(slot_entry(jnp.minimum(m, num_slots - 1)) < best_t)

    def body(state):
        m, best_t, best_tri = state
        e = slot_entry(m)
        lane_active = e < best_t
        cid = jax.lax.dynamic_slice_in_dim(cids, m, 1, axis=1)[:, 0]
        blocks = _gather_cluster_blocks(scene, jnp.where(lane_active, cid, 0))

        hit, t, _, _ = ray_triangle(
            origin[:, None, :],
            direction[:, None, :],
            blocks[:, :, 0],
            blocks[:, :, 1],
            blocks[:, :, 2],
            best_t[:, None],
        )
        hit = hit & lane_active[:, None]
        t_masked = jnp.where(hit, t, jnp.inf)
        slot = jnp.argmin(t_masked, axis=-1)
        block_t = jnp.take_along_axis(t_masked, slot[:, None], axis=-1)[:, 0]
        tri = scene.cluster_tri_map[cid * leaf + slot.astype(jnp.int32)]

        better = block_t < best_t  # already bounded by best_t via MT t_max
        best_t = jnp.where(better, block_t, best_t)
        best_tri = jnp.where(better, tri, best_tri)
        return m + 1, best_t, best_tri

    _, best_t, best_tri = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), t_max, zero_i - 1),
    )
    found = best_tri >= 0
    return found, jnp.where(found, best_t, t_max), best_tri


def _walk_any(scene, origin, direction, t_max, entry, cids):
    """Any-hit cluster walk; lanes stop at the first intersection."""
    num_slots = entry.shape[1]
    batch = origin.shape[0]
    zero_i = (origin[:, 0] * 0.0).astype(jnp.int32)

    def slot_entry(m):
        return jax.lax.dynamic_slice_in_dim(entry, m, 1, axis=1)[:, 0]

    def cond(state):
        m, occluded = state
        active = jnp.isfinite(slot_entry(jnp.minimum(m, num_slots - 1))) & ~occluded
        return (m < num_slots) & jnp.any(active)

    def body(state):
        m, occluded = state
        e = slot_entry(m)
        lane_active = jnp.isfinite(e) & ~occluded
        cid = jax.lax.dynamic_slice_in_dim(cids, m, 1, axis=1)[:, 0]
        blocks = _gather_cluster_blocks(scene, jnp.where(lane_active, cid, 0))

        hit, _, _, _ = ray_triangle(
            origin[:, None, :],
            direction[:, None, :],
            blocks[:, :, 0],
            blocks[:, :, 1],
            blocks[:, :, 2],
            t_max[:, None],
        )
        occluded = occluded | (jnp.any(hit, axis=-1) & lane_active)
        return m + 1, occluded

    _, occluded = jax.lax.while_loop(cond, body, (jnp.int32(0), zero_i > 0))
    return occluded


def _escalate(scene, origin, direction, t_max, unresolved, walk, results):
    """Re-walk `unresolved` rays at FULL cluster capacity (k = num clusters —
    overflow is impossible), in compacted _ESC_CHUNK-ray sub-batches so the
    dense (esc, C) cull grid stays small, scattering exact results back into
    `results` (a tuple of per-ray 1-D arrays). Runs zero iterations when
    nothing is unresolved."""
    num_rays = origin.shape[0]
    num_clusters = scene.cluster_tris.shape[0]
    esc = min(_ESC_CHUNK, num_rays)

    def cond(st):
        return jnp.any(st[0])

    def body(st):
        unresolved, results = st
        idx = jnp.nonzero(unresolved, size=esc, fill_value=num_rays)[0]
        idx = idx.astype(jnp.int32)
        valid = idx < num_rays
        safe = jnp.minimum(idx, num_rays - 1)
        o, d, tm = origin[safe], direction[safe], t_max[safe]
        entry, cids, _ = _order_clusters(scene, o, d, tm, num_clusters)
        new = walk(o, d, tm, entry, cids)
        results = tuple(
            r.at[idx].set(jnp.where(valid, n, r[safe]), mode="drop")
            for r, n in zip(results, new)
        )
        unresolved = unresolved.at[idx].set(False, mode="drop")
        return unresolved, results

    _, results = jax.lax.while_loop(cond, body, (unresolved, results))
    return results


def _pad_rays(origin, direction, t_max, chunk: int):
    """Pad the ray batch to a chunk multiple with guaranteed-miss rays."""
    num_rays = origin.shape[0]
    padded = -(-num_rays // chunk) * chunk
    if padded == num_rays:
        return origin, direction, t_max, num_rays
    pad = padded - num_rays
    origin = jnp.concatenate(
        [origin, jnp.full((pad, 3), 1e30, jnp.float32)], axis=0
    )
    direction = jnp.concatenate(
        [direction, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (pad, 1))],
        axis=0,
    )
    t_max = jnp.concatenate([t_max, jnp.full((pad,), 1.0, jnp.float32)], axis=0)
    return origin, direction, t_max, num_rays


@partial(jax.jit, static_argnames=("top_k",))
def intersect_closest_wavefront(
    scene: DeviceScene, origin, direction, t_max, *, top_k: int = MAX_CLUSTERS_PER_RAY
):
    """Closest-hit query. Returns (hit, t, tri_idx, escalated_count).

    Results are EXACT for every ray: overflowed rays whose best hit is not
    provably nearer than every dropped cluster (best_t <= last kept entry)
    are re-walked at full cluster capacity (_escalate). escalated_count
    reports how many rays needed that (observability; 0 on small open
    scenes)."""
    num_rays = origin.shape[0]
    num_clusters = scene.cluster_tris.shape[0]
    k = min(top_k, num_clusters)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (num_rays,))
    chunk_size = _ray_chunk(num_clusters, num_rays)
    origin, direction, t_max, _ = _pad_rays(origin, direction, t_max, chunk_size)

    def chunk(args):
        o, d, tm = args
        entry, cids, overflow = _order_clusters(scene, o, d, tm, k)
        hit, t, tri = _walk_closest(scene, o, d, tm, entry, cids)
        # A dropped cluster's entry >= the last kept entry, and a triangle
        # hit is never nearer than its cluster's entry, so best_t <= last
        # kept entry proves no dropped cluster can beat it.
        proven = hit & (t <= entry[:, -1])
        return hit, t, tri, overflow & ~proven

    num_chunks = origin.shape[0] // chunk_size
    if num_chunks == 1:
        hit, t, tri, unresolved = chunk((origin, direction, t_max))
    else:
        hit, t, tri, unresolved = jax.lax.map(
            chunk,
            (
                origin.reshape(num_chunks, chunk_size, 3),
                direction.reshape(num_chunks, chunk_size, 3),
                t_max.reshape(num_chunks, chunk_size),
            ),
        )
        hit = hit.reshape(-1)
        t = t.reshape(-1)
        tri = tri.reshape(-1)
        unresolved = unresolved.reshape(-1)

    escalated = jnp.sum(unresolved.astype(jnp.int32))
    if k < num_clusters:  # full-capacity walk can't have dropped anything
        hit, t, tri = _escalate(
            scene, origin, direction, t_max, unresolved,
            lambda o, d, tm, e, c: _walk_closest(scene, o, d, tm, e, c),
            (hit, t, tri),
        )
    return hit[:num_rays], t[:num_rays], tri[:num_rays], escalated


@partial(jax.jit, static_argnames=("top_k",))
def intersect_any_wavefront(
    scene: DeviceScene, origin, direction, t_max, *, top_k: int = MAX_CLUSTERS_PER_RAY
):
    """Any-hit (shadow) query. Returns (occluded, escalated_count).

    Exact for every ray: an overflowed ray is only provably done when some
    kept cluster occluded it; unoccluded overflowed rays re-walk at full
    capacity (a dropped cluster could hide the blocker)."""
    num_rays = origin.shape[0]
    num_clusters = scene.cluster_tris.shape[0]
    k = min(top_k, num_clusters)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (num_rays,))
    chunk_size = _ray_chunk(num_clusters, num_rays)
    origin, direction, t_max, _ = _pad_rays(origin, direction, t_max, chunk_size)

    def chunk(args):
        o, d, tm = args
        entry, cids, overflow = _order_clusters(scene, o, d, tm, k)
        occluded = _walk_any(scene, o, d, tm, entry, cids)
        return occluded, overflow & ~occluded

    num_chunks = origin.shape[0] // chunk_size
    if num_chunks == 1:
        occluded, unresolved = chunk((origin, direction, t_max))
    else:
        occluded, unresolved = jax.lax.map(
            chunk,
            (
                origin.reshape(num_chunks, chunk_size, 3),
                direction.reshape(num_chunks, chunk_size, 3),
                t_max.reshape(num_chunks, chunk_size),
            ),
        )
        occluded = occluded.reshape(-1)
        unresolved = unresolved.reshape(-1)

    escalated = jnp.sum(unresolved.astype(jnp.int32))
    if k < num_clusters:
        (occluded,) = _escalate(
            scene, origin, direction, t_max, unresolved,
            lambda o, d, tm, e, c: (_walk_any(scene, o, d, tm, e, c),),
            (occluded,),
        )
    return occluded[:num_rays], escalated
