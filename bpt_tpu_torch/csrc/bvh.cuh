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
// best hit, then the near child (left when t_l <= t_r) next and the far one
// later, as the plain walk's push far, push near, pop does, with its clamp
// on a full stack.  Ties go to the first triangle in visit order, so the
// visit order is what keeps the kernel bit-equal to the plain walk.
//
// What bounds it on this card: not arithmetic (a slab pair is ~30 FLOP, a
// triangle test ~52) but latency: every step is a dependent gather of a
// node or triangle record chosen by the previous step, and the 32 threads
// of a warp diverge, each on its own path through the tree, so a warp runs
// as long as its longest walk.  The tables of a large mesh (524,288
// triangles: 33.55 MB of node records, 25.2 MB of triangles) live in
// device memory and the L2 cache.
//
// What the design does about that: the node table holds child-pair records
// (MeshTables.nodes, Aila and Laine's layout for a binary BVH on a GPU):
// record 0 a header with the root's box and reference, then one 64-byte
// record per inner node with both children's boxes and references, the
// references int32 bits in the w lanes of the first two float4s.  A
// reference r >= 1 is the record of an inner child, r < 0 the leaf of
// triangle -1 - r.  So a step makes one dependent load, not two: an inner
// step the node's record (four independent 16-byte loads, one round
// trip), a leaf step its triangle (three); the TPU's layout, a child's box
// in the child's own record, made a thread load the popped node's record
// first only to learn where its children were.  The near child is carried
// in registers to the next step: the plain walk pushes it after the far
// child and pops it at once, so the visits and their order are the same,
// and only far children pass through the thread's 28-entry stack of
// (reference, entry t) in local memory (the TPU kernels share one cursor
// per packet of rays because Mosaic has no per-lane gather; a GPU thread
// gathers for itself).  The vertex normals are read only at the winning
// triangle.
//
// What still holds it back: every step waits for its record or triangle
// from L1, L2 or device memory, a far child's step also for its pop, and
// the walks of a warp diverge.  A wide BVH and ray sorting inside the
// megakernel are later work; a stack in shared memory was slower in the
// megakernel (PERF.md, Findings).
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

// nodes: MeshTables.nodes, 4 float4 per child-pair record; tris: 3 float4
// per triangle, one vertex each.
__device__ __forceinline__ MeshHit bvh_closest(const float4* __restrict__ nodes, const float4* __restrict__ tris,
                                               V3 ro, V3 rd, bool cull) {
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  int stack_ref[kStackDepth];
  float stack_t[kStackDepth];
  MeshHit best = {kInf, 0.0f, 0.0f, -1};
  const float4 root_lo = __ldg(nodes + 0), root_hi = __ldg(nodes + 1);  // the header
  const float root_t = aabb_t(root_lo, root_hi, ro, inv, kInf);
  int ptr = 0;
  int carried = __float_as_int(root_lo.w);
  bool have = root_t < kInf;
  while (have || ptr > 0) {
    int ref;
    if (have) {  // the root or the last step's near child: its entry t is below best.t, as the plain pop finds
      ref = carried;
      have = false;
    } else {
      --ptr;
      ref = stack_ref[ptr];
      if (!(stack_t[ptr] < best.t)) continue;  // farther than the best hit
    }
    if (ref < 0) {  // a leaf: its triangle, no node record
      const int tri = -1 - ref;
      const float4* p = tris + 3 * tri;
      float u, v;
      float t = triangle_t_uv(xyz(__ldg(p)), xyz(__ldg(p + 1)), xyz(__ldg(p + 2)), ro, rd, cull, &u, &v);
      if (t < best.t) best = {t, u, v, tri};
    } else {  // an inner node: one record holds both children
      const float4* r = nodes + 4 * ref;
      const float4 l_lo = __ldg(r), l_hi = __ldg(r + 1), r_lo = __ldg(r + 2), r_hi = __ldg(r + 3);
      const int left = __float_as_int(l_lo.w), right = __float_as_int(l_hi.w);
      float t_l = aabb_t(l_lo, l_hi, ro, inv, best.t);
      float t_r = aabb_t(r_lo, r_hi, ro, inv, best.t);
      const bool near_is_left = t_l <= t_r;
      const int near_ref = near_is_left ? left : right, far_ref = near_is_left ? right : left;
      const float near_t = fminf(t_l, t_r), far_t = fmaxf(t_l, t_r);
      // The plain walk pushes far, then near, and pops near at once; on a full stack (ptr 27) its clamped
      // pushes overwrite far with near.  Here far is pushed while there is room and near is carried.
      if (near_t < kInf) {
        if (far_t < kInf && ptr < kStackDepth - 1) {
          stack_ref[ptr] = far_ref;
          stack_t[ptr] = far_t;
          ++ptr;
        }
        carried = near_ref;
        have = true;
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
