// The staged path's sort key for Hopper (sm_90a): the int32 reorder key of
// every lane of a phase's state, computed between two K2 launches.  The
// staged path (bpt_tpu_torch/kernels/staged.py trace_staged, through
// launch_key) sorts the keys with torch.sort and hands the permutation to the
// next phase.
//
// Replaces: bpt_tpu/kernels/megakernel.py::_sort_key (:2631), which XLA runs
// between the staged Pallas launches of _trace_staged.  Its plain version is
// staged.sort_key, the composition key_from_box(state, *key_box(state)):
// pass 1 here is key_box, pass 2 key_from_box, each bit-equal to its half.
//
// GPU-native form:
//   * The state row (staged.py, csrc/staged.cu) is key-first: ro in words
//     0-2, rd in 3-5, the flags word (bit 0 alive) in 6, home in 7.  A lane's
//     key reads one 32-byte sector of its 64-byte row, two 16-byte loads,
//     and nothing else of it.
//   * Pass 1 (key_box_kernel): a fixed grid of a few blocks an SM walks the
//     lanes with a grid-stride loop.  Each block reduces the min and max of
//     the live lanes' origins per axis (a dead lane counts as +1e9 / -1e9, as
//     the masked min and max of sort_key and JAX do) through warp shuffles
//     and shared memory, and writes one partial box.  On the staged path K2
//     has already reduced the rows it wrote, one box a warp (csrc/staged.cu
//     write_warp_box): pass 1 then reduces those boxes (24 bytes a warp of
//     32 lanes) instead of reading the rows, and the key reads the rows once.
//   * Pass 2 (key_kernel): each block of the same grid first reduces every
//     partial box (a few hundred of 24 bytes, from L2) to the pool's box, so
//     no block waits for another and no counter or atomic is needed; block 0
//     writes the box out.  Then one thread a lane writes the key: the origin
//     quantised to 64 cells per axis over the box, the 6-bit Morton spread,
//     the direction's octant (or, under dir-morton, 4 cells per axis), dead
//     lanes 1 << 30, in sort_key's expression order with correctly rounded
//     operations and no contraction.
//   Min and max are exact and the reduction order is fixed, so the box and
//   the key do not change from run to run.
//
// What bounds it: bytes.  The function must read every lane's flags word, a
// live lane's ro and rd (24 bytes more), and write every key (4 bytes).
// Pass 2 reads each row's first sector and writes the key; from the rows,
// pass 1 reads the sector again.  A 32-byte read seems to cost its row's
// whole 64 bytes of device memory (PERF.md, K2's row), which is why the box
// comes from K2 where it can.  The arithmetic is a few dozen operations a
// lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a block; block_box relies on it
constexpr uint32_t kAlive = 1u;
constexpr int kDeadKey = 1 << 30;
constexpr float kBig = 1e9f;  // a dead lane's origin in the min (+) and the max (-)
constexpr float kMinExtent = 1e-6f;
enum KeyMode { kOctMorton = 0, kMortonOct = 1, kDirMorton = 2 };  // staged.KEY_MODES' order

// The min (lo) and max (hi) of the origins per axis; 6 floats in memory.
struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ Box empty_box() {
  const float inf = __int_as_float(0x7f800000);
  return Box{{inf, inf, inf}, {-inf, -inf, -inf}};
}

__device__ __forceinline__ void merge(Box& b, const Box& o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.lo[k] = fminf(b.lo[k], o.lo[k]);
    b.hi[k] = fmaxf(b.hi[k], o.hi[k]);
  }
}

// The box of the whole block, in every thread: shuffles within each warp,
// then the warps' boxes through shared memory.
__device__ __forceinline__ Box block_box(Box b) {
  __shared__ Box warps[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Box o;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o.lo[k] = __shfl_xor_sync(0xffffffffu, b.lo[k], off);
      o.hi[k] = __shfl_xor_sync(0xffffffffu, b.hi[k], off);
    }
    merge(b, o);
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = b;
  __syncthreads();
  b = warps[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) merge(b, warps[w]);
  return b;
}

// Pass 1: one partial box per block, of the n_boxes boxes given or else of
// the rows.
__global__ void __launch_bounds__(kThreads) key_box_kernel(const uint4* __restrict__ rows, long long lanes,
                                                           const Box* __restrict__ boxes, long long n_boxes,
                                                           Box* __restrict__ partials) {
  Box b = empty_box();
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t j = first; boxes && j < (size_t)n_boxes; j += stride) merge(b, boxes[j]);
  for (size_t i = first; !boxes && i < (size_t)lanes; i += stride) {
    const uint4 a = __ldg(rows + 4 * i);      // ro.x, ro.y, ro.z, rd.x
    const uint4 f = __ldg(rows + 4 * i + 1);  // rd.y, rd.z, flags, home
    const bool alive = f.z & kAlive;
    const float o[3] = {__uint_as_float(a.x), __uint_as_float(a.y), __uint_as_float(a.z)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b.lo[k] = fminf(b.lo[k], alive ? o[k] : kBig);
      b.hi[k] = fmaxf(b.hi[k], alive ? o[k] : -kBig);
    }
  }
  b = block_box(b);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
}

// Bit k of a 6-bit cell index moved to bit 3k.
__device__ __forceinline__ uint32_t spread6(uint32_t q) {
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 6; ++k) out |= ((q >> k) & 1u) << (3 * k);
  return out;
}

// clamp((v - lo) / extent * 64, 0, 63), truncated: sort_key's order.
__device__ __forceinline__ uint32_t cell(float v, float lo, float extent) {
  const float q = __fmul_rn(__fdiv_rn(__fsub_rn(v, lo), extent), 64.0f);
  return (uint32_t)fminf(fmaxf(q, 0.0f), 63.0f);
}

// clamp((d * 0.5 + 0.5) * 4, 0, 3), truncated: dir-morton's direction cell.
__device__ __forceinline__ uint32_t dir_cell(float d) {
  const float q = __fmul_rn(__fadd_rn(__fmul_rn(d, 0.5f), 0.5f), 4.0f);
  return (uint32_t)fminf(fmaxf(q, 0.0f), 3.0f);
}

// Pass 2: the pool's box from n_partials partial boxes, then every lane's key.
__global__ void __launch_bounds__(kThreads) key_kernel(const uint4* __restrict__ rows, long long lanes,
                                                       const Box* __restrict__ partials, int n_partials, int mode,
                                                       int* __restrict__ keys, float* __restrict__ box_out) {
  Box b = empty_box();
  for (int j = threadIdx.x; j < n_partials; j += kThreads) merge(b, partials[j]);
  b = block_box(b);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box_out[k] = b.lo[k];
      box_out[3 + k] = b.hi[k];
    }
  }
  float extent[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) extent[k] = fmaxf(__fsub_rn(b.hi[k], b.lo[k]), kMinExtent);
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < (size_t)lanes; i += stride) {
    const uint4 a = __ldg(rows + 4 * i);
    const uint4 f = __ldg(rows + 4 * i + 1);
    int key = kDeadKey;
    if (f.z & kAlive) {
      const uint32_t morton = (spread6(cell(__uint_as_float(a.x), b.lo[0], extent[0])) << 2) |
                              (spread6(cell(__uint_as_float(a.y), b.lo[1], extent[1])) << 1) |
                              spread6(cell(__uint_as_float(a.z), b.lo[2], extent[2]));
      const float dx = __uint_as_float(a.w), dy = __uint_as_float(f.x), dz = __uint_as_float(f.y);
      if (mode == kDirMorton) {
        key = (int)((((dir_cell(dx) << 4) | (dir_cell(dy) << 2) | dir_cell(dz)) << 18) | morton);
      } else {
        const uint32_t octant = ((dx > 0.0f ? 1u : 0u) << 2) | ((dy > 0.0f ? 1u : 0u) << 1) | (dz > 0.0f ? 1u : 0u);
        key = (int)(mode == kMortonOct ? (morton << 3) | octant : (octant << 18) | morton);
      }
    }
    keys[i] = key;
  }
}

}  // namespace

// The key of each of `lanes` state rows (16 int32 words each) into `keys`,
// and the box it quantised over into `box_out` (lo xyz, hi xyz), on
// `stream`, with `blocks` blocks of 256 threads in each pass.  Pass 1
// writes `blocks` partial boxes (6 floats each) into `partials`, from the
// `n_boxes` boxes at `boxes` or, where `boxes` is null, from the rows; pass
// 2 reduces them and writes the keys.  Returns the CUDA error of the
// launches, or -1 for arguments the kernels do not take.
extern "C" int bpt_sort_key(const void* rows, long long lanes, int mode, const float* boxes, long long n_boxes,
                            float* partials, int blocks, int* keys, float* box_out, void* stream) {
  if (lanes <= 0 || blocks <= 0 || mode < kOctMorton || mode > kDirMorton || (boxes && n_boxes <= 0)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* state = static_cast<const uint4*>(rows);
  Box* part = reinterpret_cast<Box*>(partials);
  key_box_kernel<<<blocks, kThreads, 0, s>>>(state, lanes, reinterpret_cast<const Box*>(boxes), n_boxes, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  key_kernel<<<blocks, kThreads, 0, s>>>(state, lanes, part, blocks, mode, keys, box_out);
  return static_cast<int>(cudaGetLastError());
}
