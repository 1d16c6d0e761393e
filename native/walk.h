// Per-ray BVH walk: the reference's closest-hit and any-hit traversal
// (ray_intersection.cpp:138-213, reference_path_tracer.wgsl:321-429) as one
// function that walk_cpu.cc and walk_cuda.cu both compile, so the CPU tests
// run the very walk the GPU runs.
//
// Semantics match the lockstep oracle (rayfinder_tpu/render/traverse.py):
// near child first by the node's split axis and the ray's direction sign, a
// 32-entry stack, leaf triangles tested in order against the running best t,
// and the accept sets of intersect.ray_aabb and intersect.ray_triangle. The
// min/max below propagate NaN like XLA's, so NaN and parked rays miss in the
// same way in both.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define RF_HD __host__ __device__ __forceinline__
#else
#define RF_HD inline
#endif

namespace rf {

constexpr int kStackDepth = 32;
constexpr float kEpsilon = 1e-5f;

// 32-byte node, packed once per scene by rayfinder_tpu/ops/walk.pack_nodes.
// link: first triangle of a leaf, or the second (far-side) child of an
// interior node (the first child is the next node). meta: count << 2 | axis;
// count > 0 marks a leaf.
struct Node {
  float lo[3];
  int32_t link;
  float hi[3];
  int32_t meta;
};
static_assert(sizeof(Node) == 32, "node layout is shared with pack_nodes");

RF_HD float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
RF_HD float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  bool neg[3];
};

RF_HD Ray make_ray(const float* o, const float* d) {
  Ray r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[k];
    r.d[k] = d[k];
    r.inv[k] = 1.0f / d[k];
    r.neg[k] = r.inv[k] < 0.0f;
  }
  return r;
}

// intersect.ray_aabb: slab test with the reference's asymmetric compares.
RF_HD bool hit_aabb(const Ray& r, const Node& n, float t_max) {
  float t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    const float near_k = r.neg[k] ? n.hi[k] : n.lo[k];
    const float far_k = r.neg[k] ? n.lo[k] : n.hi[k];
    t0[k] = (near_k - r.o[k]) * r.inv[k];
    t1[k] = (far_k - r.o[k]) * r.inv[k];
  }
  const float tmin_xy = nan_max(t0[0], t0[1]);
  const float tmax_xy = nan_min(t1[0], t1[1]);
  const bool fail_xy = (t0[0] > t1[1]) || (t0[1] > t1[0]);
  const bool fail_z = (tmin_xy > t1[2]) || (t0[2] > tmax_xy);
  const float tmin = nan_max(tmin_xy, t0[2]);
  const float tmax = nan_min(tmax_xy, t1[2]);
  return !fail_xy && !fail_z && (tmin < t_max) && (tmax > 0.0f);
}

// intersect.ray_triangle: Moller-Trumbore with EPSILON = 1e-5, in the same
// operation order as the jnp version (cross products as jnp.cross, dot
// products summed x, y, z).
RF_HD bool hit_triangle(const Ray& r, const float* v, float t_max, float* t_out) {
  const float e1[3] = {v[3] - v[0], v[4] - v[1], v[5] - v[2]};
  const float e2[3] = {v[6] - v[0], v[7] - v[1], v[8] - v[2]};
  const float h[3] = {r.d[1] * e2[2] - r.d[2] * e2[1],
                      r.d[2] * e2[0] - r.d[0] * e2[2],
                      r.d[0] * e2[1] - r.d[1] * e2[0]};
  const float det = e1[0] * h[0] + e1[1] * h[1] + e1[2] * h[2];
  const float inv_det = 1.0f / det;
  const float s[3] = {r.o[0] - v[0], r.o[1] - v[1], r.o[2] - v[2]};
  const float u = inv_det * (s[0] * h[0] + s[1] * h[1] + s[2] * h[2]);
  const float q[3] = {s[1] * e1[2] - s[2] * e1[1],
                      s[2] * e1[0] - s[0] * e1[2],
                      s[0] * e1[1] - s[1] * e1[0]};
  const float vv = inv_det * (r.d[0] * q[0] + r.d[1] * q[1] + r.d[2] * q[2]);
  const float t = inv_det * (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]);
  *t_out = t;
  const float abs_det = det < 0.0f ? -det : det;
  return abs_det >= kEpsilon && u >= 0.0f && u <= 1.0f && vv >= 0.0f &&
         u + vv <= 1.0f && t > kEpsilon && t < t_max;
}

// Walk one ray. tris: (T, 3, 3) leaf-ordered vertex positions. Returns the
// hit triangle (or -1) and the best t (t_max when nothing is hit). With
// any_hit the walk stops at the first accepted triangle.
RF_HD int32_t walk(const Node* __restrict__ nodes, const float* __restrict__ tris,
                   const float* o, const float* d, float t_max, bool any_hit,
                   float* t_best_out) {
  const Ray r = make_ray(o, d);
  float t_best = t_max;
  int32_t best_tri = -1;
  int32_t stack[kStackDepth];
  int sp = 0;
  int32_t node = 0;
  for (;;) {
    const Node n = nodes[node];
    if (hit_aabb(r, n, t_best)) {
      const int32_t count = n.meta >> 2;
      if (count == 0) {
        // Interior: descend into the near child, push the far one. A push
        // past the stack's end is dropped and a pop there rereads its top
        // entry, exactly as the lockstep oracle does.
        const bool neg = r.neg[n.meta & 3];
        const int32_t near_child = neg ? n.link : node + 1;
        const int32_t far_child = neg ? node + 1 : n.link;
        if (sp < kStackDepth) stack[sp] = far_child;
        ++sp;
        node = near_child;
        continue;
      }
      for (int32_t i = n.link; i < n.link + count; ++i) {
        float t;
        if (hit_triangle(r, tris + 9 * static_cast<int64_t>(i), t_best, &t)) {
          t_best = t;
          best_tri = i;
          if (any_hit) {
            *t_best_out = t_best;
            return best_tri;
          }
        }
      }
    }
    if (sp == 0) break;
    --sp;
    node = stack[sp < kStackDepth ? sp : kStackDepth - 1];
  }
  *t_best_out = t_best;
  return best_tri;
}

}  // namespace rf
