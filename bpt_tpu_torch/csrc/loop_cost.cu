// The walk-loop cost microbenchmark (K5) for Hopper (sm_90a): one (8, 256)
// float32 tile goes n_iter times round a loop of the walk loop's building
// blocks, spread over a thread-block cluster.
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
// The mapping: a cluster of Cluster blocks of 256 threads, one block an SM;
// block b holds rows [b V, b V + V) of the tile, V = 8 / Cluster, thread c
// column c's V values in registers.  At Cluster 8 every thread runs one
// dependent chain, so a step costs the chain's latency (the FFMA and the
// FMUL both read v and run side by side, the FMNMX needs both: two
// instruction latencies, 11 cycles as measured), while its SM's 4
// schedulers issue 2 warps x 3 instructions a step: the chain, not issue,
// sets the pace, which is what the JAX tool asks of the walk's loop.  At Cluster 1 (one block, 8 values
// a thread) the same work is issue-bound on one SM.  Each block copies the
// 32 KB table into its shared memory (VMEM's counterpart) once, where
// row[k % 128] is a broadcast read from one address.
//
// The any-reduce spans the whole tile.  Each block votes with
// __syncthreads_or; thread r of the block of rank b stores the word
// (i << 1) | vote into slot [i & 1][b] of rank r's shared memory
// (distributed shared memory, a volatile store); then every thread waits
// on its own block's slots [i & 1][0, Cluster) until each holds iteration
// i's word, and ORs the votes.  The word names its iteration, so no
// barrier is needed to know it has arrived: a cluster barrier a trip
// (barrier.cluster arrive.release / wait.acquire) measured slower, 750 ns
// a trip against 360 (ab_variants/loop_cost_barrier.patch).  The slots
// alternate by iteration parity: a block stores its word for i + 2 only
// after it has seen every block's word for i + 1, which each block stores
// only after all its threads have read the words of i (its
// __syncthreads_or of i + 1 lies between), so no word is overwritten
// before every block has read it.
// The flag, and so the Cond branch, is uniform over the cluster.  One
// launch path and one vote serve every cluster size, 1 included (a block
// then stores its word into its own slot).
//
// NOps, Reduce, Cond and Cluster are template arguments: the chain is
// unrolled, as the JAX trace unrolls it; the cluster size kept for each
// configuration is the one that measured fastest in turns (kConfigs below,
// PERF.md's K5 row): 8 for a chain alone, 4 for a 40-step chain with the
// reduce (its vote is cheaper among 4 blocks), 8 at 320 steps, and one
// block for the bare loop, where no mapping measured apart from the
// others.  The mappings that lost are
// bpt_tpu_torch/tools/ab_variants/loop_cost_cluster*.patch.
// n_iter is a runtime argument, and the loop is not unrolled: one trip per
// iteration, as in the JAX while_loop.  With NOps = 0 and no reduce the body computes nothing and
// ptxas deletes the loop (an empty asm statement on the tile did not keep
// it); a volatile read of the row's first word, the JAX body's row load
// whose value this configuration does not use, keeps it, so that
// configuration times the loop and its row load.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;      // the tile's rows
constexpr int kCols = 256;    // the tile's columns: threads of a block
constexpr int kTabRows = 64;
constexpr int kTabCols = 128;

template <int NOps, bool Reduce, bool Cond, int Cluster>
__global__ void __launch_bounds__(kCols) loop_cost_kernel(const float* __restrict__ tab, const float* __restrict__ x,
                                                          float* __restrict__ out, int n_iter) {
  static_assert(Cluster == 1 || Cluster == 2 || Cluster == 4 || Cluster == 8, "8 rows over 1, 2, 4 or 8 blocks");
  constexpr int kVals = kRows / Cluster;
  __shared__ float s_tab[kTabRows * kTabCols];
  __shared__ unsigned int s_votes[2][8];  // [parity][rank]: (iteration << 1) | vote, stored by that rank
  const int c = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x);  // the grid is one cluster
  const int row0 = rank * kVals;
#pragma unroll
  for (int j = 0; j < kTabRows * kTabCols; j += kCols) s_tab[j + c] = tab[j + c];
  float v[kVals];
#pragma unroll
  for (int r = 0; r < kVals; ++r) v[r] = x[(row0 + r) * kCols + c];
  if constexpr (Reduce) {
    if (c < 16) (&s_votes[0][0])[c] = 0xFFFFFFFFu;  // no iteration's word
    cg::this_cluster().sync();  // every block runs, its slots set, before any store into them
  } else {
    __syncthreads();
  }

#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    const float* row = s_tab + (i % kTabRows) * kTabCols;
    float acc[kVals];
#pragma unroll
    for (int r = 0; r < kVals; ++r) acc[r] = v[r];
#pragma unroll
    for (int k = 0; k < NOps; ++k) {
      const float w = row[k % kTabCols];
#pragma unroll
      for (int r = 0; r < kVals; ++r) v[r] = fmaxf(__fmaf_rn(v[r], w, 1.0e-7f), v[r] * 0.99995f);
    }
    if constexpr (Reduce) {
      bool up = false;
#pragma unroll
      for (int r = 0; r < kVals; ++r) up |= v[r] > acc[r];
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned word = (static_cast<unsigned>(i) << 1) | (__syncthreads_or(up) != 0);
      unsigned int* slot = s_votes[i & 1];
      if (c < Cluster) *static_cast<volatile unsigned int*>(cluster.map_shared_rank(slot + rank, c)) = word;
      const volatile unsigned int* seen = slot;
      unsigned any = 0;
#pragma unroll
      for (int r = 0; r < Cluster; ++r) {  // wait for every rank's word of this iteration
        unsigned w;
        do {
          w = seen[r];
        } while ((w >> 1) != static_cast<unsigned>(i));
        any |= w & 1u;
      }
      const bool flag = any != 0;
      if constexpr (Cond) {
        if (flag) {  // uniform over the cluster
#pragma unroll
          for (int r = 0; r < kVals; ++r) v[r] *= 0.9999f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kVals; ++r) v[r] = flag ? v[r] * 0.9999f : v[r];
      }
    }
    if constexpr (NOps == 0 && !Reduce) {
      const float w = *static_cast<const volatile float*>(row);
      (void)w;
    }
  }
#pragma unroll
  for (int r = 0; r < kVals; ++r) out[(row0 + r) * kCols + c] = v[r];
}

template <int NOps, bool Reduce, bool Cond, int Cluster>
int launch(const float* tab, const float* x, float* out, int n_iter, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Cluster);
  config.blockDim = dim3(kCols);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, loop_cost_kernel<NOps, Reduce, Cond, Cluster>, tab, x, out,
                                             n_iter);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// One instantiation: its configuration, the cluster size kept for it, and
// its launch.
struct Config {
  int n_ops;
  bool reduce;
  bool cond;
  int cluster;
  int (*launch)(const float*, const float*, float*, int, cudaStream_t);
};

template <int NOps, bool Reduce, bool Cond, int Cluster>
constexpr Config entry() {
  return {NOps, Reduce, Cond, Cluster, launch<NOps, Reduce, Cond, Cluster>};
}

// The instantiations, one a configuration of kernels/loop_cost.py CONFIGS,
// each at the cluster size that measured fastest (PERF.md's K5 row).
constexpr Config kConfigs[] = {
    entry<0, false, false, 1>(),   // the bare loop
    entry<40, false, false, 8>(),  // the chains alone
    entry<100, false, false, 8>(),
    entry<320, false, false, 8>(),
    entry<40, true, false, 4>(),  // the chains with the reduce, by select and by branch
    entry<40, true, true, 4>(),
    entry<320, true, true, 8>(),
};

// Configuration (n_ops, reduce, cond)'s entry, nullptr for one without an
// instantiation.
const Config* config_of(int n_ops, int reduce, int cond) {
  for (const Config& c : kConfigs) {
    if (c.n_ops == n_ops && c.reduce == (reduce != 0) && c.cond == (cond != 0)) return &c;
  }
  return nullptr;
}

}  // namespace

// The tile after n_iter iterations of configuration (n_ops, reduce, cond):
// tab (64, 128) and x, out (8, 256) float32, contiguous, on the card.
// Launches one cluster of bpt_loop_cost_cluster(...) blocks on the stream.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for a
// configuration without an instantiation (kernels/loop_cost.py CONFIGS
// lists them).
extern "C" int bpt_loop_cost(const float* tab, const float* x, float* out, int n_iter, int n_ops, int reduce,
                             int cond, void* stream) {
  const Config* c = config_of(n_ops, reduce, cond);
  if (c == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return c->launch(tab, x, out, n_iter, static_cast<cudaStream_t>(stream));
}

// The blocks of configuration (n_ops, reduce, cond)'s cluster (each holds
// 8 / that rows of the tile), 0 for a configuration without an
// instantiation.
extern "C" int bpt_loop_cost_cluster(int n_ops, int reduce, int cond) {
  const Config* c = config_of(n_ops, reduce, cond);
  return c ? c->cluster : 0;
}
