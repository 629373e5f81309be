// The staged phase kernel (K2) for Hopper (sm_90a): bounces [lo, hi) of
// every lane of a pool of F progressive frames, F * H * W lanes, one thread
// per lane.  The driver (bpt_tpu_torch/kernels/staged.py trace_staged)
// launches one phase per bounce range and sorts the lanes between phases
// (the key kernel of csrc/sort_key.cu, then torch.sort), so that the lanes
// of a warp are coherent again after their paths diverge.
//
// Replaces: bpt_tpu/kernels/megakernel.py::_make_kernel in staged mode,
// launched through _pallas_forward_staged (pallas_call at :2619) and driven
// by _trace_staged and _prb_staged_fn, in every configuration of K1 (the
// template arguments of csrc/megakernel.cu: kGrads, kEnv, kNee, kMesh,
// kTextured; 24 instantiations, entry bpt_trace_phase).  The bounce body is
// K1's own (csrc/path.cuh trace_bounces), so a pool's frames equal K1's
// launches bit for bit under --fmad=false.  One phase of one frame (lo = 0,
// hi = bounces, F = 1) is K1's frame, launched as K1 is, but it runs 0-7%
// slower on an H100 (sky and the textured HDRI configurations +5-7%:
// bpt_tpu_torch/tools/ab_time.py), the price of the resume and state code it
// carries; so K1 stays the monolithic route.
//
// GPU-native form of what the TPU kernel computes:
//   * Phase 0 (lo == 0) derives each lane's identity from its thread index,
//     in K1's 16x16 pixel tiles: lane i is pixel (fslot, py, px) of the
//     pool, i = (fslot * H + py) * W + px, its home; no pix planes.  Its RNG seeds, ray and film
//     coordinates use the absolute row py + row_offset of a film full_height
//     rows tall (a row-sharded slice traces the rows of the whole image).
//   * Each frame's draws come from (F,) tables indexed by fslot: frame_u and
//     frame_f (K1's scalars) and the blue-noise offset; the thread gathers
//     its blue-noise texel and makes its env-NEE draws itself, as K1 does.
//   * A later phase's lane i reads its state from state_in row perm[i] (the
//     sort's permutation fused into the load: no permute pass, no group-8
//     bundles, which exist on the TPU because a row gather costs ~15 cycles
//     a row there).  The state is 16 words per lane, row-major, so a lane's
//     gather is four 16-byte loads.  The row is key-first: ro (words 0-2),
//     rd (3-5), the flags word (6: alive, spec, sample_light, coat_hit,
//     d_count, prev_mat) and home (7) fill its first 32-byte sector, all
//     that the sort key reads; mask (8-10), sharp (11) and the two RNG words
//     (12-13) follow (bit-cast, exact); 2 words pad.  It carries only what
//     the next phase reads: the radiance is 0 until the event that ends a
//     path, and the blue-noise texel is gathered again from the identity.
//   * Records are written home, not carried: the first-hit normal, color
//     and id, the color and sharpness flag of an ended path, the grads
//     mode's sg entries and deferred planes go straight to the lane's home
//     pixel of the (F, H, W) output planes.  One lane owns one pixel, so no
//     atomics are needed, and nothing is scattered home at the end.
//   * A dead lane writes zeros over words 4-7 (the quad that holds flags and
//     home) and leaves; the key puts dead lanes last.  A resuming lane loads
//     that quad first and the rest of its row only if it is alive.  Indices
//     are size_t: F * H * W * 16 words passes 2^31.
//   * With the rows, each warp writes the box of the origins it wrote (min
//     and max of the live rows', +-1e9 for a dead row: write_warp_box, warp
//     shuffles only, 24 bytes a warp), so that the key's first pass reduces
//     those instead of reading 32 bytes of every row again.  Every thread
//     reaches it: phase_lane returns what its lane wrote and never exits.
//
// What bounds it: as K1, per-thread arithmetic and latency with divergence
// (the BVH walk's dependent gathers above all), plus each phase's state:
// the 56 bytes of a live lane's row read (a gather through perm) and
// written (the row's 2 pad words make it four 16-byte accesses), and the
// lane's permutation index (int64, as torch.sort gives it).  The key is a
// kernel of its own (csrc/sort_key.cu), the sort torch.sort.  The warp
// boxes cost the phases 0.3-4% and save the key half its time (PERF.md,
// K2's row).

#include <cstdint>
#include <cuda_runtime.h>

#include "path.cuh"

namespace bpt {

// One phase's arguments: K1's block (out_* are the pool's (F, H, W) planes,
// width / height one frame's, frame_u / frame_f / bn_ox / bn_oy unused)
// and the pool's.  Mirrored by kernels/staged.py _StagedArgs;
// bpt_staged_args_size lets the wrapper check the match.
struct StagedArgs {
  TraceArgs t;
  const uint4* state_in;  // (lanes, 4): 16 words a lane; null in phase 0
  uint4* state_out;  // null in the last phase
  float* boxes;  // (warps, 6): each warp's box of the rows it wrote (lo xyz, hi xyz); null: none
  const int64_t* perm;  // (lanes,): lane i resumes state_in row perm[i]; null in phase 0
  const uint32_t* frame_u;  // (F,) the frame counters as uint32
  const float* frame_f;  // (F,) the frame counters
  const int* bn_off;  // (F, 2) each frame's blue-noise offset (ox, oy)
  long long lanes;  // F * H * W
  int frames, lo, hi, row_offset, full_height;
};

}  // namespace bpt

namespace {

using namespace bpt;

constexpr uint32_t kAlive = 1u, kSpec = 2u, kSampleLight = 4u, kCoat = 8u;
constexpr float kBig = 1e9f;  // a dead row's origin in the key's box, + in the min and - in the max

// What a lane left in state_out: no row (a thread past the pool), a dead
// row, or a live row with origin ro.
struct RowOut {
  float x, y, z;
  int kind;
};
constexpr int kNoRow = 0, kDeadRow = 1, kLiveRow = 2;

__device__ __forceinline__ RowOut no_row() { return RowOut{0.0f, 0.0f, 0.0f, kNoRow}; }
__device__ __forceinline__ RowOut dead_row() { return RowOut{0.0f, 0.0f, 0.0f, kDeadRow}; }

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured>
__device__ __forceinline__ RowOut phase_lane(const StagedArgs& s) {
  const TraceArgs& a = s.t;
  const SceneConsts c = load_scene<kMesh>(a);
  const bool last = s.hi >= a.bounces;
  Path p;
  size_t i, home;
  if (s.lo == 0) {  // 16x16 tiles of frame blockIdx.z, as K1's blocks: lane i is pixel i
    const int tx = blockIdx.x * blockDim.x + threadIdx.x;
    const int ty = blockIdx.y * blockDim.y + threadIdx.y;
    if (tx >= a.width || ty >= a.height) return no_row();
    i = home = ((size_t)blockIdx.z * a.height + ty) * a.width + tx;
  } else {
    i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)s.lanes) return no_row();
    const uint4* src = s.state_in + 4 * (size_t)s.perm[i];
    const uint4 w1 = src[1];  // rd.y, rd.z, flags, home
    if (!(w1.z & kAlive)) {
      if (!last) s.state_out[4 * i + 1] = make_uint4(0u, 0u, 0u, 0u);
      return dead_row();
    }
    const uint4 w0 = src[0], w2 = src[2], w3 = src[3];  // ro, rd.x; mask, sharp; sx, sy
    p.ro = v3(__uint_as_float(w0.x), __uint_as_float(w0.y), __uint_as_float(w0.z));
    p.rd = v3(__uint_as_float(w0.w), __uint_as_float(w1.x), __uint_as_float(w1.y));
    p.mask = v3(__uint_as_float(w2.x), __uint_as_float(w2.y), __uint_as_float(w2.z));
    p.acc = v3(0.0f, 0.0f, 0.0f);
    p.sharp = __uint_as_float(w2.w);
    p.spec = w1.z & kSpec;
    p.sample_light = w1.z & kSampleLight;
    p.coat_hit = w1.z & kCoat;
    p.d_count = (int)((w1.z >> 8) & 0xffu);
    p.prev_mat = (int)(int16_t)(w1.z >> 16);
    home = w1.w;
    p.sx = w3.x;
    p.sy = w3.y;
  }
  const size_t hw = (size_t)a.width * (size_t)a.height;
  const int fslot = (int)(home / hw);
  const size_t rem = home - (size_t)fslot * hw;
  const int px = (int)(rem % (size_t)a.width);
  const int py = (int)(rem / (size_t)a.width) + s.row_offset;
  const Home h{(uint32_t)home, (uint32_t)(hw * (size_t)s.frames)};
  float bn[4];
  blue_noise_texel(a.blue_noise, px, py, s.bn_off[2 * fslot], s.bn_off[2 * fslot + 1], bn);
  if (s.lo == 0) {
    clear_grads<kGrads, kEnv, kTextured>(a, h);
    start_path(c, px, py, a.width, s.full_height, s.frame_u[fslot], p);
  }
  const float frame_f = s.frame_f[fslot];
  Records rec = no_records();
  const LaneConsts k = lane_consts<kGrads, kEnv, kNee, kMesh, kTextured>(a, c);
  const bool alive =
      trace_bounces<kGrads, kEnv, kNee, kMesh, kTextured>(a, c, k, p, rec, bn, s.lo, s.hi, frame_f, h);
  if (s.lo == 0 || rec.after_metal) {  // the records of bounces 0 and 1
    a.out_normal[3 * home + 0] = rec.normal.x;
    a.out_normal[3 * home + 1] = rec.normal.y;
    a.out_normal[3 * home + 2] = rec.normal.z;
    a.out_oid[home] = rec.id;
  }
  if (s.lo == 0) {
    a.out_ocolor[3 * home + 0] = rec.color.x;
    a.out_ocolor[3 * home + 1] = rec.color.y;
    a.out_ocolor[3 * home + 2] = rec.color.z;
  }
  if (!alive || last) {
    a.out_color[3 * home + 0] = fmaxf(p.acc.x, 0.0f);
    a.out_color[3 * home + 1] = fmaxf(p.acc.y, 0.0f);
    a.out_color[3 * home + 2] = fmaxf(p.acc.z, 0.0f);
    a.out_sharp[home] = p.sharp;
    if (!last) s.state_out[4 * i + 1] = make_uint4(0u, 0u, 0u, 0u);
    return dead_row();
  }
  const uint32_t flags = kAlive | (p.spec ? kSpec : 0u) | (p.sample_light ? kSampleLight : 0u) |
                         (p.coat_hit ? kCoat : 0u) | (((uint32_t)p.d_count & 0xffu) << 8) |
                         (((uint32_t)p.prev_mat & 0xffffu) << 16);
  uint4* dst = s.state_out + 4 * i;
  dst[0] = make_uint4(__float_as_uint(p.ro.x), __float_as_uint(p.ro.y), __float_as_uint(p.ro.z),
                      __float_as_uint(p.rd.x));
  dst[1] = make_uint4(__float_as_uint(p.rd.y), __float_as_uint(p.rd.z), flags, (uint32_t)home);
  dst[2] = make_uint4(__float_as_uint(p.mask.x), __float_as_uint(p.mask.y), __float_as_uint(p.mask.z),
                      __float_as_uint(p.sharp));
  dst[3] = make_uint4(p.sx, p.sy, 0u, 0u);
  return RowOut{p.ro.x, p.ro.y, p.ro.z, kLiveRow};
}

// The box of the rows a warp wrote, the key's pass 1 over them (csrc/sort_key.cu):
// min and max of the live rows' origins, a dead row +-1e9, no row nothing.
// Every thread of the block reaches it (phase_lane returns, it never exits).
__device__ __forceinline__ void write_warp_box(const StagedArgs& s, const RowOut& r) {
  const float inf = __int_as_float(0x7f800000);
  const bool live = r.kind == kLiveRow, dead = r.kind == kDeadRow;
  float v[6] = {live ? r.x : dead ? kBig : inf, live ? r.y : dead ? kBig : inf, live ? r.z : dead ? kBig : inf,
                live ? r.x : dead ? -kBig : -inf, live ? r.y : dead ? -kBig : -inf,
                live ? r.z : dead ? -kBig : -inf};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = k < 3 ? fminf(v[k], o) : fmaxf(v[k], o);
    }
  }
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31u) == 0u) {
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    float* out = s.boxes + 6 * (block * (blockDim.x * blockDim.y / 32) + (tid >> 5));
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k] = v[k];
  }
}

// The kernels, K1's register policy: without a mesh 3 blocks of 256
// threads an SM (80 registers; they spill 38-60 bytes to L1), with one the
// compiler's own choice.  (256, 2) removes the spills but is 6-9% slower
// in the Cornell and sky pools' phases (PERF.md, K2's row).
template <bool kGrads, int kEnv, int kNee>
__global__ void __launch_bounds__(256, 3) phase_kernel(const StagedArgs s) {
  const RowOut r = phase_lane<kGrads, kEnv, kNee, false, false>(s);
  if (s.boxes) write_warp_box(s, r);
}

template <bool kGrads, int kEnv, int kNee, bool kTextured>
__global__ void phase_kernel(const StagedArgs s) {
  const RowOut r = phase_lane<kGrads, kEnv, kNee, true, kTextured>(s);
  if (s.boxes) write_warp_box(s, r);
}

// Phase 0 runs K1's launch shape, 16x16 pixel tiles (a grid of tiles per
// frame, the frames along z), so that a warp's first rays are coherent;
// a later phase one thread per sorted lane, 256 a block.
template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured = false>
int launch_cfg(const StagedArgs& s, void* stream) {
  const dim3 block = s.lo == 0 ? dim3(16, 16) : dim3(256);
  const dim3 grid = s.lo == 0 ? dim3((s.t.width + 15) / 16, (s.t.height + 15) / 16, s.frames)
                              : dim3((unsigned)((s.lanes + 255) / 256));
  const size_t smem = scene_smem_bytes(s.t, kMesh);
  if constexpr (kMesh) {
    phase_kernel<kGrads, kEnv, kNee, kTextured><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(s);
  } else {
    phase_kernel<kGrads, kEnv, kNee><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrads, int kEnv, int kNee>
int launch_mesh(const StagedArgs& s, int mesh, void* stream) {
  if (mesh == 2) return launch_cfg<kGrads, kEnv, kNee, true, true>(s, stream);
  return mesh ? launch_cfg<kGrads, kEnv, kNee, true>(s, stream) : launch_cfg<kGrads, kEnv, kNee, false>(s, stream);
}

template <bool kGrads>
int launch_mode(const StagedArgs& s, int env, int nee, int mesh, void* stream) {
  if (env == kEnvNone && nee == kNeeQuad) return launch_mesh<kGrads, kEnvNone, kNeeQuad>(s, mesh, stream);
  if (env == kEnvSky && nee == kNeeSun) return launch_mesh<kGrads, kEnvSky, kNeeSun>(s, mesh, stream);
  if (env == kEnvHdri && nee == kNeeSun) return launch_mesh<kGrads, kEnvHdri, kNeeSun>(s, mesh, stream);
  if (env == kEnvHdri && nee == kNeeEnv) return launch_mesh<kGrads, kEnvHdri, kNeeEnv>(s, mesh, stream);
  return -1;
}

}  // namespace

extern "C" int bpt_staged_args_size() { return static_cast<int>(sizeof(bpt::StagedArgs)); }

// One phase of the configuration the arguments select, as bpt_trace (env,
// nee, mesh, grads).  Returns the CUDA error of the launch, or -1 for a
// combination that is not built or a pool the grid cannot hold (more than
// 65535 frames, or 2^31 blocks).
extern "C" int bpt_trace_phase(const bpt::StagedArgs* args, int grads, int env, int nee, int mesh, void* stream) {
  const bpt::StagedArgs& s = *args;
  if (mesh < 0 || mesh > 2 || s.lanes <= 0 || s.frames <= 0 || s.frames > 65535 ||
      (s.lanes + 255) / 256 > 0x7fffffffLL)
    return -1;
  return grads ? launch_mode<true>(s, env, nee, mesh, stream) : launch_mode<false>(s, env, nee, mesh, stream);
}
