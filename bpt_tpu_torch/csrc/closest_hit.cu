// Wavefront closest-hit kernel for Hopper (sm_90a): the closest triangle of
// each of N object-space rays over a mesh's binary BVH, one thread per
// walking ray.
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
// fit the 50 MB L2 only in part.  Few lanes walk, and their walks differ
// in length by orders of magnitude: of the capacity mesh's 1024² primary
// rays from the glTF camera only a band of rows enters the mesh's box, and
// a launch lasts as long as that band's longest walks; at bounce 2 about
// 44% of the lanes are on the mask and fewer than half of those enter the
// root box, scattered over the image (chip_smoke.py phase 28 prints these
// counts).
//
// What the design does about that: the walk of csrc/bvh.cuh over
// child-pair node records, one dependent load a step (an inner node's
// 64-byte record with both children's boxes, or a leaf's triangle, never a
// leaf's node record), the near child carried in registers and only far
// children on the local-memory stack; the rays are read once (24 bytes)
// and the results written once (20 bytes).  Each block takes a span of
// kBlock consecutive lanes of the caller's order.  Its threads first test
// their lanes: a lane walks only if it is on the mask and its ray enters
// the root box (the walk's own first step, with the same operands, so a
// lane that fails it gets the miss values the walk would give, written
// here).  A ballot and a popcount prefix over the block's warps then pack
// the walking lanes into the block's first threads, one walk a thread, so
// the walks of a bounce fill whole warps instead of a few threads of
// every warp, and warps with nothing to walk end at once.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings), against one thread per
// lane in the caller's order: the same time on primary rays, 19% less on
// bounce 2.  The shapes that lost there: 2-D pixel tiles a warp (8x4,
// 8x8, 16x16; any tile of more than 32 lanes gives a warp several walks in
// a row, and the band's warps then last 2-4 times longer), live lanes
// packed inside a warp's tile, blocks of 512 threads, persistent blocks
// drawing tiles from a counter, and a stack in shared memory.  Wide BVHs
// and ray sorting are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "bvh.cuh"

namespace {

using namespace bpt;

constexpr int kBlock = 128;  // threads a block, and lanes a block's span
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int i) {
  const float* p = a + 3 * static_cast<int64_t>(i);
  return v3(p[0], p[1], p[2]);
}

__device__ __forceinline__ void write_hit(int i, const MeshHit& h, float* __restrict__ t_out,
                                          int64_t* __restrict__ tri_out, float* __restrict__ u_out,
                                          float* __restrict__ v_out) {
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(const float* __restrict__ ro, const float* __restrict__ rd, const uint8_t* __restrict__ active,
                       const float4* __restrict__ nodes, const float4* __restrict__ tris, int n, int cull,
                       float* __restrict__ t_out, int64_t* __restrict__ tri_out, float* __restrict__ u_out,
                       float* __restrict__ v_out) {
  __shared__ int walking[kBlock];  // the span's walking lanes, packed
  __shared__ int warp_walking[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t lane_id = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool in_range = lane_id < n;
  const int i = static_cast<int>(lane_id);
  bool walks = false;
  if (in_range && (active == nullptr || active[i])) {
    const V3 d = load3(rd, i);
    const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    walks = aabb_t(__ldg(nodes), __ldg(nodes + 1), load3(ro, i), inv, kInf) < kInf;
  }
  if (in_range && !walks) write_hit(i, MeshHit{kInf, 0.0f, 0.0f, -1}, t_out, tri_out, u_out, v_out);
  const unsigned ballot = __ballot_sync(0xffffffffu, walks);
  if (lane == 0) warp_walking[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? warp_walking[w] : 0;
    count += warp_walking[w];
  }
  if (walks) walking[base + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < count) {
    const int j = walking[threadIdx.x];
    write_hit(j, bvh_closest(nodes, tris, load3(ro, j), load3(rd, j), cull != 0), t_out, tri_out, u_out, v_out);
  }
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
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kBlock - 1) / kBlock);
  closest_hit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, active, reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris), n, cull, t_out,
      tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
