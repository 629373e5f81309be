// The walk-loop cost microbenchmark (K5) for Hopper (sm_90a): one (8, 256)
// float32 tile goes n_iter times round a loop of the walk loop's building
// blocks, in one thread block.
//
// Replaces: tools/loop_cost.py::make_kernel, launched through run (the
// pallas_call at :57).  Each iteration i loads table row i % 64 (a
// scalar-indexed row load), runs a dependent chain of NOps steps
// v = max(fma(v, row[k % 128], 1e-7), v * 0.99995) on the tile and, with
// Reduce, a tile-wide any(v > acc), acc the tile at the start of the
// iteration, after which the tile is scaled by 0.9999 by a branch (Cond,
// lax.cond) or a select (jnp.where).  It computes what
// bpt_tpu_torch/kernels/loop_cost.py loop_cost_reference computes, bit for
// bit: XLA contracts v * r + 1e-7 into one fused multiply-add, so the
// kernel calls __fmaf_rn for it, and --fmad=false keeps every other product
// a plain multiply.
//
// The mapping: the tile is one block of 256 threads, thread c holding
// column c's 8 values in registers, because the any-reduce spans the whole
// tile (__syncthreads_or, a block-wide vote); the 32 KB table is copied once
// into shared memory (VMEM's counterpart), where row[k % 128] is a
// broadcast read that every thread makes from one address.  NOps, Reduce and
// Cond are template arguments: the chain is unrolled, as the JAX trace
// unrolls it.  n_iter is a runtime argument.
//
// What bounds it on this card: neither bytes (48 KB in and out) nor the
// card's FP32 rate, which one block on one of the 132 SMs cannot reach (at
// most 1/132 of it).  The chain is issue-bound on its SM: per step each of
// the 8 warps issues an FFMA, an FMUL and an FMNMX for each of its 8 values.
// That is what it measures: the serial cost per iteration of the loop's
// constructs, the latency floor under the BVH walk's loop.  The loop is not
// unrolled: one trip per iteration, as in the JAX while_loop.  With NOps = 0
// and no reduce the body computes nothing and ptxas deletes the loop (an
// empty asm statement on the tile did not keep it); a volatile read of the
// row's first word, the JAX body's row load whose value this configuration
// does not use, keeps it, so that configuration times the loop and its row
// load.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;      // the tile's rows: values per thread
constexpr int kCols = 256;    // the tile's columns: threads of the block
constexpr int kTabRows = 64;
constexpr int kTabCols = 128;

template <int NOps, bool Reduce, bool Cond>
__global__ void __launch_bounds__(kCols) loop_cost_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                                                          float* __restrict__ out, int n_iter) {
  __shared__ float s_tab[kTabRows * kTabCols];
  const int c = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kTabRows * kTabCols; j += kCols) s_tab[j + c] = tab[j + c];
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = x[r * kCols + c];
  __syncthreads();

#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const float* row = s_tab + (i % kTabRows) * kTabCols;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = v[r];
#pragma unroll
    for (int k = 0; k < NOps; ++k) {
      const float w = row[k % kTabCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = fmaxf(__fmaf_rn(v[r], w, 1.0e-7f), v[r] * 0.99995f);
    }
    if constexpr (Reduce) {
      bool up = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) up |= v[r] > acc[r];
      const bool flag = __syncthreads_or(up) != 0;
      if constexpr (Cond) {
        if (flag) {  // uniform over the block
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] *= 0.9999f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = flag ? v[r] * 0.9999f : v[r];
      }
    }
    if constexpr (NOps == 0 && !Reduce) {
      const float w = *static_cast<const volatile float*>(row);
      (void)w;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * kCols + c] = v[r];
}

template <int NOps, bool Reduce, bool Cond>
int launch(const float* tab, const float* x, float* out, int n_iter, cudaStream_t stream) {
  loop_cost_kernel<NOps, Reduce, Cond><<<1, kCols, 0, stream>>>(tab, x, out, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile after n_iter iterations of configuration (n_ops, reduce, cond):
// tab (64, 128) and x, out (8, 256) float32, contiguous, on the card.
// Launches one block on the stream.  Returns the CUDA error of the launch,
// or cudaErrorInvalidValue for a configuration without an instantiation
// (kernels/loop_cost.py CONFIGS lists them).
extern "C" int bpt_loop_cost(const float* tab, const float* x, float* out, int n_iter, int n_ops, int reduce,
                             int cond, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!reduce && !cond) {
    switch (n_ops) {
      case 0: return launch<0, false, false>(tab, x, out, n_iter, s);
      case 40: return launch<40, false, false>(tab, x, out, n_iter, s);
      case 100: return launch<100, false, false>(tab, x, out, n_iter, s);
      case 320: return launch<320, false, false>(tab, x, out, n_iter, s);
    }
  } else if (reduce && !cond && n_ops == 40) {
    return launch<40, true, false>(tab, x, out, n_iter, s);
  } else if (reduce && cond) {
    if (n_ops == 40) return launch<40, true, true>(tab, x, out, n_iter, s);
    if (n_ops == 320) return launch<320, true, true>(tab, x, out, n_iter, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
