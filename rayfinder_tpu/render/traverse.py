"""Lockstep BVH traversal over SoA ray batches (jax.numpy reference path).

The reference traverses its flattened BVH with a per-thread 32-deep stack and
near-child-first ordering (src/common/ray_intersection.cpp:138-213,
src/pt/reference_path_tracer.wgsl:370-429). Plain jnp has no per-lane control
flow, so here the traversal is reformulated as a lockstep "if-if" loop over
a whole ray batch inside one `lax.while_loop`:

* every iteration, each active lane performs exactly one unit of work — either
  one AABB/node step or one triangle test from its current leaf scan range;
* per-lane state (current node, stack, leaf scan cursor, t_max, best hit)
  lives in SoA registers of shape (B,) / (B, 32);
* the loop runs until every lane has exhausted its stack.

Visit order per lane is identical to the reference's (near child first via
`split_axis` + direction sign, leaf triangles in order), so per-ray
`nodes_visited` matches the CPU tool's heatmap exactly. This module is the
correctness reference; the per-ray walk in ops/walk.py is the fast path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .intersect import ray_aabb, ray_triangle
from .scene import DeviceScene

STACK_DEPTH = 32


def _traverse(scene: DeviceScene, origin, direction, t_max, any_hit: bool):
    """Shared lockstep loop. origin/direction: (B, 3). t_max: scalar or (B,).

    Returns (hit, t, tri_idx, nodes_visited); for any_hit the search stops at
    the first forward intersection per lane (shadow rays, wgsl:321-368).
    """
    batch = origin.shape[0]
    inv_dir = jnp.float32(1.0) / direction
    dir_neg = inv_dir < 0.0

    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (batch,)) + 0.0 * origin[:, 0]

    # Derive initial per-lane state from the (possibly shard_map-varying)
    # ray arrays so while_loop carry types match under manual sharding.
    zero_i = (origin[:, 0] * 0.0).astype(jnp.int32)
    state = dict(
        node=zero_i,
        sp=zero_i,
        stack=jnp.zeros((batch, STACK_DEPTH), jnp.int32) + zero_i[:, None],
        tri_ptr=zero_i,
        tri_end=zero_i,
        t_best=t_max,
        hit_tri=zero_i - 1,
        done=zero_i > 0,
        nodes_visited=zero_i,
    )

    def cond(s):
        return ~jnp.all(s["done"])

    def body(s):
        active = ~s["done"]
        scanning = active & (s["tri_ptr"] < s["tri_end"])
        node_phase = active & ~scanning

        # --- triangle phase: test one triangle from the leaf scan range ---
        tri = jnp.clip(s["tri_ptr"], 0, scene.num_triangles - 1)
        verts = scene.tri_positions[tri]  # (B, 3, 3) gather
        t_hit, t, _, _ = ray_triangle(
            origin, direction, verts[:, 0], verts[:, 1], verts[:, 2], s["t_best"]
        )
        tri_hit = scanning & t_hit
        t_best = jnp.where(tri_hit, t, s["t_best"])
        hit_tri = jnp.where(tri_hit, tri, s["hit_tri"])
        # Any-hit rays terminate on the first intersection.
        done = s["done"] | (tri_hit if any_hit else jnp.zeros_like(tri_hit))
        tri_ptr = jnp.where(scanning, s["tri_ptr"] + 1, s["tri_ptr"])
        scan_finished = scanning & (tri_ptr >= s["tri_end"]) & ~done

        # --- node phase: one AABB test against the current node ---
        node = jnp.clip(s["node"], 0, scene.num_nodes - 1)
        n_min = scene.bvh_aabb_min[node]
        n_max = scene.bvh_aabb_max[node]
        n_count = scene.bvh_tri_count[node]
        n_offset = scene.bvh_tri_offset[node]
        n_second = scene.bvh_second_child[node]
        n_axis = scene.bvh_split_axis[node]

        nodes_visited = s["nodes_visited"] + node_phase.astype(jnp.int32)
        aabb_hit = node_phase & ray_aabb(origin, inv_dir, dir_neg, n_min, n_max, t_best)
        is_leaf = n_count > 0

        # Leaf hit: begin the triangle scan next iteration, then pop.
        enter_leaf = aabb_hit & is_leaf
        tri_ptr = jnp.where(enter_leaf, n_offset, tri_ptr)
        tri_end = jnp.where(enter_leaf, n_offset + n_count, s["tri_end"])

        # Interior hit: push the far child, descend into the near child
        # (near-first ordering via dirNeg[splitAxis], wgsl:408-418).
        descend = aabb_hit & ~is_leaf
        axis_neg = jnp.take_along_axis(dir_neg, n_axis[:, None], axis=-1)[:, 0]
        near = jnp.where(axis_neg, n_second, node + 1)
        far = jnp.where(axis_neg, node + 1, n_second)
        sp = s["sp"]
        stack = jnp.where(
            descend[:, None] & (jnp.arange(STACK_DEPTH)[None, :] == sp[:, None]),
            far[:, None],
            s["stack"],
        )
        sp = jnp.where(descend, sp + 1, sp)
        new_node = jnp.where(descend, near, node)

        # Pop: lanes that missed the AABB or just finished a leaf scan.
        want_pop = (node_phase & ~aabb_hit) | scan_finished
        empty = want_pop & (sp == 0)
        done = done | empty
        do_pop = want_pop & (sp > 0)
        sp = jnp.where(do_pop, sp - 1, sp)
        popped = jnp.take_along_axis(
            stack, jnp.clip(sp, 0, STACK_DEPTH - 1)[:, None], axis=1
        )[:, 0]
        new_node = jnp.where(do_pop, popped, new_node)

        return dict(
            node=new_node,
            sp=sp,
            stack=stack,
            tri_ptr=tri_ptr,
            tri_end=tri_end,
            t_best=t_best,
            hit_tri=hit_tri,
            done=done,
            nodes_visited=nodes_visited,
        )

    final = jax.lax.while_loop(cond, body, state)
    hit = final["hit_tri"] >= 0
    return hit, final["t_best"], final["hit_tri"], final["nodes_visited"]


@partial(jax.jit, static_argnames=())
def intersect_closest(scene: DeviceScene, origin, direction, t_max):
    """Closest-hit traversal (wgsl rayIntersectBvh semantics).

    Returns (hit, t, tri_idx, nodes_visited), each (B,).
    """
    return _traverse(scene, origin, direction, t_max, any_hit=False)


@partial(jax.jit, static_argnames=())
def intersect_any(scene: DeviceScene, origin, direction, t_max):
    """Any-hit traversal for shadow rays (wgsl shadowRay semantics).

    Returns occluded: (B,) bool.
    """
    hit, _, _, _ = _traverse(scene, origin, direction, t_max, any_hit=True)
    return hit
