// The bilinear sample's VJP into its map (sm_90a): the gradient of an
// (h, w, c) map from the cotangents g of n REPEAT-wrapped bilinear samples
// of it at n UVs.
//
// Replaces no TPU kernel.  The JAX package leaves this scatter to XLA (the
// transpose of its gather).  The port's plain version is autograd's
// backward of bpt_tpu_torch/textures.py sample_bilinear: four index_select
// backwards, each an index_add_ of every lane's weighted cotangent into
// the map with global atomics.  The fused route's inverse-rendering step
// samples a learnt albedo once a bounce and frame (kernels/megakernel.py
// compose_deferred), a million lanes a 1024² frame, so a 64² albedo took
// four million-row index_add_ launches a sample into 4096 rows, and every
// lane whose bounce applied no albedo (uv 0, cotangent exactly 0) added
// into the same four texels.
//
// Each lane's taps and weights are recomputed from its UV with
// csrc/textures.cuh's expressions (x = u * W - 0.5, floorf, the floored
// modulo), and the four cotangents formed as autograd forms them:
// (g (1 - fy)) (1 - fx) for tap (y0, x0), (g (1 - fy)) fx for (y0, x1),
// (g fy) (1 - fx) for (y1, x0), (g fy) fx for (y1, x1).  The terms are the
// plain version's floats; only the order of their sums differs.  A lane
// whose cotangent channels are all exactly 0 adds nothing (+0 changes no
// sum), which removes the hot spot at uv 0.
//
// What bounds it on this card: the lanes' bytes (a UV and c cotangents,
// read once) and the adds into the map's gradient.  One warp a block,
// whose shared memory holds its own copy of the map's gradient (a 64² RGB
// map is 48 KB); a map over the block's opt-in shared memory limit takes
// the plain version (kernels/texel_grad.py texel_kernel_route).  The warp
// takes spans of kAhead x 32 lanes, its loads issued together; at each tap
// the lanes with the same texel are found by __match_any_sync and summed in
// lane order by the lowest of them, which alone adds into the copy, so
// every address takes its adds in an order fixed by the lanes' positions.
// Each block then writes its copy to a partial, and texel_grad_sum adds the
// partials texel by texel in a fixed order.  The gradient is therefore the
// same from run to run on one card (the number of blocks follows the card's
// SMs and occupancy).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings): a
// 1024² sample of a 64² map, 70% of its lanes unapplied, 0.14 ms of device
// time where autograd's four index_add_ took 5.5 ms.

#include <cstdint>
#include <cuda_runtime.h>

#include "textures.cuh"

namespace {

constexpr int kWarp = 32;          // threads of a block of the first pass
constexpr int kAhead = 4;          // lanes a thread loads before it adds any
constexpr int kMaxChannels = 4;    // channels a map may have
constexpr int kSumWarps = 8;       // warps of a block of the sum pass
constexpr unsigned kFull = 0xffffffffu;

// A lane's four taps, flat texel indices y * w + x in the order (y0, x0),
// (y0, x1), (y1, x0), (y1, x1), and the bilinear weights.
struct Taps {
  int t[4];
  float fx, fy, gx, gy;  // gx = 1 - fx, gy = 1 - fy
};

__device__ __forceinline__ Taps taps_of(float u, float v, int h, int w) {
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const int xi0 = bpt::wrap((int)x0, w), yi0 = bpt::wrap((int)y0, h);
  const int xi1 = bpt::wrap(xi0 + 1, w), yi1 = bpt::wrap(yi0 + 1, h);
  Taps t;
  t.t[0] = yi0 * w + xi0;
  t.t[1] = yi0 * w + xi1;
  t.t[2] = yi1 * w + xi0;
  t.t[3] = yi1 * w + xi1;
  t.fx = x - x0;
  t.fy = y - y0;
  t.gx = 1.0f - t.fx;
  t.gy = 1.0f - t.fy;
  return t;
}

// Loads lane i's c cotangents into g; whether any is not 0.
__device__ __forceinline__ bool load_cotangent(const float* __restrict__ cot, long long i, int c,
                                               float (&g)[kMaxChannels]) {
  bool live = false;
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    g[ch] = ch < c ? __ldg(cot + i * c + ch) : 0.0f;
    live |= g[ch] != 0.0f;
  }
  return live;
}

// One tap of the warp's lanes into the block's copy acc: each lane's
// (g wy) wx channel by channel; a lane with texel -1 adds nothing.  The
// lanes that share a texel are summed in lane order by the lowest of them,
// which alone writes.  Every lane of the warp calls it.
__device__ __forceinline__ void add_tap(float* acc, float* stage, int t, float wy, float wx,
                                        const float (&g)[kMaxChannels], int c, int lane, int width) {
  const unsigned group = __match_any_sync(kFull, t);
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch)
    if (ch < c) stage[ch * width + lane] = (g[ch] * wy) * wx;
  __syncwarp();
  if (t >= 0 && lane == __ffs(group) - 1) {
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) {
        float s = 0.0f;
        for (unsigned m = group; m; m &= m - 1) s += stage[ch * width + __ffs(m) - 1];
        acc[t * c + ch] += s;
      }
    }
  }
  __syncwarp();
}

// The first pass: block b sums the taps of its spans of
// lanes into its copy of the map's gradient and writes it to partials[b].
// Dynamic shared memory: the copy (h w c floats), then c x 32 staged values.
__global__ void __launch_bounds__(kWarp)
    texel_grad_shared(const float* __restrict__ uv, const float* __restrict__ cot, long long n, int h, int w, int c,
                      float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int hwc = h * w * c, lane = threadIdx.x, width = blockDim.x;
  float* acc = smem;
  float* stage = smem + hwc;
  for (int i = lane; i < hwc; i += width) acc[i] = 0.0f;
  __syncwarp();
  const long long span = (long long)width * kAhead;
  for (long long base = blockIdx.x * span; base < n; base += gridDim.x * span) {
    float g[kAhead][kMaxChannels];
    float u[kAhead], v[kAhead];
    bool live[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long i = base + k * width + lane;
      if (i < n) {
        live[k] = load_cotangent(cot, i, c, g[k]);
        u[k] = __ldg(uv + 2 * i);
        v[k] = __ldg(uv + 2 * i + 1);
      } else {
        live[k] = false;
        u[k] = v[k] = 0.0f;
#pragma unroll
        for (int ch = 0; ch < kMaxChannels; ++ch) g[k][ch] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (!__any_sync(kFull, live[k])) continue;
      Taps tp = taps_of(u[k], v[k], h, w);
      if (!live[k]) tp.t[0] = tp.t[1] = tp.t[2] = tp.t[3] = -1;
      add_tap(acc, stage, tp.t[0], tp.gy, tp.gx, g[k], c, lane, width);
      add_tap(acc, stage, tp.t[1], tp.gy, tp.fx, g[k], c, lane, width);
      add_tap(acc, stage, tp.t[2], tp.fy, tp.gx, g[k], c, lane, width);
      add_tap(acc, stage, tp.t[3], tp.fy, tp.fx, g[k], c, lane, width);
    }
  }
  float* out = partials + (long long)blockIdx.x * hwc;
  for (int i = lane; i < hwc; i += width) out[i] = acc[i];
}

// The second pass: out[i] = the sum of partials[b][i] over
// the blocks b, in a fixed order.  A block takes 32 entries; its warp j sums the
// partials j, j + kSumWarps, ... and the first warp adds the kSumWarps sums
// in order.
__global__ void __launch_bounds__(kWarp * kSumWarps)
    texel_grad_sum(const float* __restrict__ partials, int blocks, int hwc, float* __restrict__ out) {
  __shared__ float sums[kSumWarps * kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int i = blockIdx.x * kWarp + lane;
  float s = 0.0f;
  if (i < hwc) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kSumWarps) s += __ldg(partials + (long long)b * hwc + i);
  }
  sums[warp * kWarp + lane] = s;
  __syncthreads();
  if (warp == 0 && i < hwc) {
    float total = 0.0f;
    for (int j = 0; j < kSumWarps; ++j) total += sums[j * kWarp + lane];
    out[i] = total;
  }
}

int device_attribute(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return static_cast<int>(err);
}

}  // namespace

// The shared memory a block may use on the current device once it opts in,
// in bytes: the largest map's gradient it can hold.  Returns the CUDA error.
extern "C" int bpt_texel_grad_smem_limit(int* bytes) {
  return device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, bytes);
}

// The number of blocks of texel_grad_shared that the current device holds
// at once with smem bytes of dynamic shared memory each (at least 1).
// Raises the kernel's dynamic shared memory limit to limit, the device's
// opt-in limit, first, so that any smem up to it launches.  Returns the
// CUDA error.
extern "C" int bpt_texel_grad_capacity(int limit, int smem, int* blocks) {
  int sms = 0, per_sm = 0;
  int err = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (err == 0)
    err = static_cast<int>(cudaFuncSetAttribute(texel_grad_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, limit));
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, texel_grad_shared, kWarp, smem));
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  return err;
}

// The map's gradient: uv (n, 2) and cot (n, c) float32, an (h, w, c) map,
// 1 <= c <= 4, whose copy and staged cotangents take smem bytes, at most
// the limit given to bpt_texel_grad_capacity; blocks from 1 to that
// capacity; partials (blocks, h, w, c) float32 scratch; out (h, w, c)
// float32, every entry written.  Two launches on the stream.  Returns the
// CUDA error of the launches.
extern "C" int bpt_texel_grad(const float* uv, const float* cot, long long n, int h, int w, int c, int smem,
                                     int blocks, float* partials, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hwc = h * w * c;
  texel_grad_shared<<<blocks, kWarp, smem, s>>>(uv, cot, n, h, w, c, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  texel_grad_sum<<<(hwc + kWarp - 1) / kWarp, kWarp * kSumWarps, 0, s>>>(partials, blocks, hwc, out);
  return static_cast<int>(cudaGetLastError());
}
