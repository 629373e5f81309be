// Wavefront closest-hit kernel for Hopper (sm_90a): the closest triangle of
// each of N object-space rays over a mesh's binary BVH, one thread per ray.
//
// Replaces: bpt_tpu/kernels/traverse.py::_make_kernel, launched through
// _traverse_call (K3, entry packet_closest_hit: the BVH and the triangle
// table resident in VMEM), and ::_make_hbm_kernel, launched through
// _traverse_call_hbm (K4, entry hbm_closest_hit: the triangle table left in
// HBM, leaves fetched by double-buffered DMA).  Both walk the clusterized
// packs of bpt_tpu/accel/cluster.py with one shared node cursor per packet
// of rays, because Mosaic has no per-lane gather.  On this card one kernel
// serves both: every thread walks for itself and reads the tables straight
// from device memory through the read-only path, whatever the mesh's size.
// It computes what bpt_tpu_torch/accel/traverse.py traverse_bvh computes,
// step for step (csrc/bvh.cuh bvh_closest, shared with the megakernel's
// in-loop walk: the same visit order with the same 28-entry stack, strict
// < so that ties go to the first triangle in visit order, the same cull
// rule), and writes t, the triangle id, and the barycentric
// u, v bit-equal to it (no fast math, --fmad=false).  A lane outside the
// mask, or whose ray misses the root box, reports t = kInf, tri = -1,
// u = v = 0, as the plain walk does.  The gradient (the port of _recompute)
// is plain torch: kernels/traverse.py _ClosestHit.
//
// What bounds it on this card: latency, not bytes or arithmetic.  Each step
// of a walk waits for a gather chosen by the step before, and the 32
// threads of a warp follow 32 paths through the tree, so a warp lasts as
// long as its longest walk.  The records a frame's walks touch (a
// 524,288-triangle mesh: 33.55 MB of node records, 25.2 MB of triangles)
// fit the 50 MB L2 only in part.
//
// What the design does about that: the walk of csrc/bvh.cuh over
// child-pair node records, one dependent load a step (an inner node's
// 64-byte record with both children's boxes, or a leaf's triangle, never a
// leaf's node record), the near child carried in registers and only far
// children on the local-memory stack; the rays are read once (24 bytes)
// and the results written once (20 bytes).  What still holds it back: each
// step waits for its record from L1, L2 or device memory, and the walks of
// a warp diverge, which this launch shape (128 threads, one ray each, in
// the caller's order) does nothing about.  Wide BVHs and ray sorting are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

using namespace bpt;

__global__ void closest_hit_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                                   const uint8_t* __restrict__ active, const float4* __restrict__ nodes,
                                   const float4* __restrict__ tris, int n, int cull, float* __restrict__ t_out,
                                   int64_t* __restrict__ tri_out, float* __restrict__ u_out,
                                   float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  MeshHit h = {kInf, 0.0f, 0.0f, -1};
  if (active == nullptr || active[i]) {
    const V3 o = v3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
    const V3 d = v3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
    h = bvh_closest(nodes, tris, o, d, cull != 0);
  }
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

}  // namespace

// The closest hit of n rays: ro, rd (n, 3) float32 object-space origins and
// unnormalized directions; active (n,) bytes, or null for every lane; nodes
// (T, 4, 4) (child-pair records) and tris (T, 3, 4) float32, the mesh's
// MeshTables; cull != 0 culls back faces.  Writes t, u, v (n,) float32 and
// tri (n,) int64 on the stream.  Returns the CUDA error of the launch.
extern "C" int bpt_closest_hit(const float* ro, const float* rd, const uint8_t* active, const float* nodes,
                               const float* tris, int n, int cull, float* t_out, int64_t* tri_out, float* u_out,
                               float* v_out, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  closest_hit_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, active, reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris), n, cull, t_out,
      tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
