// The in-loop BVH walk of the megakernel: the closest triangle of one
// object-space ray over the binary BVH of a mesh, one thread per ray.
//
// Replaces: bpt_tpu/kernels/megakernel.py::_mesh_walk (the fused kernel's
// in-loop walk over the escape-linked, BVH4 and Woop packs of
// bpt_tpu/accel/cluster.py), untextured meshes.  It computes what
// bpt_tpu_torch/accel/traverse.py traverse_bvh computes, step for step:
// the root slab test; pop an entry and skip it unless its entry t is below
// the best hit; at a leaf, Moller-Trumbore with the cull flag and the
// isnan(t) miss; at an inner node, both children's slab tests against the
// best hit, the far child pushed before the near one (near = left when
// t_l <= t_r); the same clamp on a full stack.  Ties go to the first
// triangle in visit order, so the visit order is what keeps the kernel
// bit-equal to the plain walk.
//
// What bounds it on this card: not arithmetic (a slab pair is ~30 FLOP, a
// triangle test ~52) but latency: every step is a dependent gather of a
// node or triangle record chosen by the previous step, and the 32 threads
// of a warp diverge, each on its own path through the tree, so a warp runs
// as long as its longest walk.  The tables of a large mesh (524,288
// triangles: 33.5 MB of nodes, 25.2 MB of triangles) live in device memory
// and the L2 cache.
//
// What the design does about that: each thread keeps its own 28-entry
// stack of (node, entry t) in local memory (the TPU kernels share one
// cursor per packet of rays because Mosaic has no per-lane gather; a GPU
// thread gathers for itself); nodes are packed for two 16-byte loads
// (min.xyz + the triangle id, max.xyz + the right child, the ids bit-cast
// into the fourth lanes) and triangles for three (one vertex each); the
// vertex normals are read only at the winning triangle.  Node reordering,
// wide BVHs and ray sorting are later work.
#pragma once

#include "vec.cuh"

namespace bpt {

constexpr int kStackDepth = 28;  // the reference's stack size

struct MeshHit {
  float t, u, v;
  int tri;  // -1: no triangle hit
};

// Slab test: the entry t, or kInf when the box is missed, lies behind the ray
// or starts at or beyond t_best.
__device__ __forceinline__ float aabb_t(float4 lo, float4 hi, V3 ro, V3 inv, float t_best) {
  float nx = (lo.x - ro.x) * inv.x, ny = (lo.y - ro.y) * inv.y, nz = (lo.z - ro.z) * inv.z;
  float fx = (hi.x - ro.x) * inv.x, fy = (hi.y - ro.y) * inv.y, fz = (hi.z - ro.z) * inv.z;
  float t0 = fmaxf(fmaxf(fminf(nx, fx), fminf(ny, fy)), fminf(nz, fz));
  float t1 = fminf(fminf(fmaxf(nx, fx), fmaxf(ny, fy)), fmaxf(nz, fz));
  return (fmaxf(t0, 0.0f) <= t1 && t0 < t_best) ? t0 : kInf;
}

// Moller-Trumbore with a backface-cull flag; kInf on a miss, u and v always.
__device__ __forceinline__ float triangle_t_uv(V3 p0, V3 p1, V3 p2, V3 ro, V3 rd, bool cull, float* u_out,
                                               float* v_out) {
  V3 e1 = sub(p1, p0);
  V3 e2 = sub(p2, p0);
  V3 pvec = cross(rd, e2);
  float raw_det = dot(e1, pvec);
  float inv_det = safe_inv(raw_det);
  V3 tvec = sub(ro, p0);
  float u = dot(tvec, pvec) * inv_det;
  V3 qvec = cross(tvec, e1);
  float v = dot(rd, qvec) * inv_det;
  float t = dot(e2, qvec) * inv_det;
  bool miss = (u < 0.0f) || (u > 1.0f) || (v < 0.0f) || (u + v > 1.0f) || (t <= 0.0f) || (cull && raw_det < 0.0f) ||
              isnan(t);
  *u_out = u;
  *v_out = v;
  return miss ? kInf : t;
}

__device__ __forceinline__ V3 xyz(float4 a) { return v3(a.x, a.y, a.z); }

// nodes: 2 float4 per node, (min.xyz, tri as int bits), (max.xyz, right as
// int bits); tris: 3 float4 per triangle, one vertex each.
__device__ __forceinline__ MeshHit bvh_closest(const float4* __restrict__ nodes, const float4* __restrict__ tris,
                                               V3 ro, V3 rd, bool cull) {
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  int stack_node[kStackDepth];
  float stack_t[kStackDepth];
  MeshHit best = {kInf, 0.0f, 0.0f, -1};
  const float root_t = aabb_t(__ldg(nodes + 0), __ldg(nodes + 1), ro, inv, kInf);
  stack_node[0] = 0;
  stack_t[0] = root_t;
  int ptr = root_t < kInf ? 1 : 0;
  while (ptr > 0) {
    --ptr;
    const int node = stack_node[ptr];
    if (!(stack_t[ptr] < best.t)) continue;  // farther than the best hit
    const float4 lo = __ldg(nodes + 2 * node), hi = __ldg(nodes + 2 * node + 1);
    const int tri = __float_as_int(lo.w);
    if (tri >= 0) {
      const float4* p = tris + 3 * tri;
      float u, v;
      float t = triangle_t_uv(xyz(__ldg(p)), xyz(__ldg(p + 1)), xyz(__ldg(p + 2)), ro, rd, cull, &u, &v);
      if (t < best.t) best = {t, u, v, tri};
    } else {
      const int left = node + 1, right = __float_as_int(hi.w);
      float t_l = aabb_t(__ldg(nodes + 2 * left), __ldg(nodes + 2 * left + 1), ro, inv, best.t);
      float t_r = aabb_t(__ldg(nodes + 2 * right), __ldg(nodes + 2 * right + 1), ro, inv, best.t);
      const bool near_is_left = t_l <= t_r;
      const int near_node = near_is_left ? left : right, far_node = near_is_left ? right : left;
      const float near_t = fminf(t_l, t_r), far_t = fmaxf(t_l, t_r);
      if (far_t < kInf) {  // push far, then near, so near pops first
        const int i = min(ptr, kStackDepth - 1);
        stack_node[i] = far_node;
        stack_t[i] = far_t;
        ptr = min(ptr + 1, kStackDepth);
      }
      if (near_t < kInf) {
        const int i = min(ptr, kStackDepth - 1);
        stack_node[i] = near_node;
        stack_t[i] = near_t;
        ptr = min(ptr + 1, kStackDepth);
      }
    }
  }
  return best;
}

// The winning triangle's interpolated vertex normal, normalized:
// normalize(w n0 + u n1 + v n2), w = 1 - u - v.  normals: 3 float4 per
// triangle.
__device__ __forceinline__ V3 mesh_normal(const float4* __restrict__ normals, const MeshHit& h) {
  const float w = (1.0f - h.u) - h.v;
  const float4* p = normals + 3 * h.tri;
  const float4 n0 = __ldg(p), n1 = __ldg(p + 1), n2 = __ldg(p + 2);
  return normalize(v3((n0.x * w + n1.x * h.u) + n2.x * h.v, (n0.y * w + n1.y * h.u) + n2.y * h.v,
                      (n0.z * w + n1.z * h.u) + n2.z * h.v));
}

}  // namespace bpt
