// Path-tracing megakernel for Hopper (sm_90a): the Cornell, transformed-
// quadric, physical-sky, glTF-mesh (untextured and textured PBR) and HDRI
// configurations, each in forward and in grads mode.
//
// Replaces: bpt_tpu/kernels/megakernel.py::_make_kernel, launched through
// _pallas_forward (monolithic mode), in these configurations:
//   * Cornell: quads + matrix-instanced unit spheres, env "none", quad-light
//     next-event estimation;
//   * quadric: the same plus the 12 transformed unit quadrics of
//     scenes/quadric_geometry.py (csrc/quadrics.cuh; nqd = 12, shape_k a
//     runtime argument);
//   * sky: env "sky" (the Preetham miss shading of csrc/sky.cuh) with sun
//     NEE through the specular lobe;
//   * mesh: an untextured triangle mesh walked in the bounce loop through
//     its binary BVH (csrc/bvh.cuh), after the quads (the glTF demo);
//   * hdri: env "hdri" (the equirect miss of csrc/hdri.cuh) with sun NEE or
//     luminance-CDF environment NEE, with the mesh (the HDRI demo);
//   * textured (mesh_textured): a mesh with PBR maps under any of the
//     environments above; at each mesh hit the thread fetches and decodes
//     its own texels (csrc/textures.cuh): the normal map before the world
//     transform, then the albedo, the emissive terminal and the per-texel
//     class, and with metal_roughness_lobe the METAL bounce's lobe.
// Template arguments select each at compile time: kEnv (none, sky, hdri),
// kNee (quad, sun, env), kMesh, kTextured (only with kMesh) and kGrads for
// param_grads (entry bpt_trace, argument grads: 12 forward and 12 grads
// instantiations).  It computes what the plain PyTorch integrator
// (bpt_tpu_torch/integrator/radiance.py, a mirror of the JAX wavefront)
// computes, draw for draw: ray generation with tent AA and thin-lens DoF (4
// hash draws), then up to `bounces` bounces with the fixed per-bounce
// schedule gate1, gate2 (blue noise) and hem.r, hem.phi (hash), then
// quad.x, quad.y, quad.z with quad NEE, then lobe.cos, lobe.phi with sun
// and env NEE and with the metal roughness lobe (after the quad triple).
// Without quad NEE there is no light-hit block: a LIGHT-typed surface is an
// unknown material and ends the path, as in the plain version.  The
// per-lane code (the argument block, ray generation, the bounce body) is in
// csrc/path.cuh, shared with the staged phase kernel (csrc/staged.cu), so
// that the two compute the same expressions in the same order.
//
// The grads mode writes the same 11 planes plus the path-replay planes
// out_sg, (n_sg, H, W) planes-major, n_obj = ns + nqd + nq objects in
// hit-id order (spheres, quadrics, quads): plane j counts the bounces whose
// throughput factor is linear in object j's color (diffuse, metal, the
// clearcoat base, a light hit that contributes, and refraction when
// transparent_tint is on); with the tint off, plane n_obj + j sums 0.01 * t
// over the refractions that leave glass object j, in bounce order (the
// Beer-Lambert exponent).  The gate is the kernel's own absorption test
// dot(n, rd) >= 0, so plane and absorption agree even at 0.  A sky miss adds
// nothing, nor does a mesh hit (its hit color is 1).  The backward
// (kernels/megakernel.py, _PathReplay) turns the planes into gradients.
//
// The grads mode also writes the deferred planes out_def, (n_def, H, W),
// what the TPU kernel hands to its outside composition (_compose_result)
// so that autograd reaches the HDR map, its exposure and a textured mesh's
// albedo and emissive maps (integrator/radiance.py deferred_layout): under
// env hdri the miss throughput mw (3) and the miss direction (3), the
// lookup left out of the color; with a textured mesh, per bounce the
// albedo uv (2; -kInf where the bounce applied no albedo factor), then the
// emissive-terminal weight (3) and uv (2), the albedo factors and the
// emission left out of the color (every path ends at one terminal event,
// after all of its albedo factors, so they factor out exactly).  The
// wrapper composes the color in torch.
//
// What bounds it on this card: per-thread arithmetic and latency, with warp
// divergence.  Cornell: the intersection of every ray with 6 quads and 2
// instanced spheres, plus sin/cos/exp/log and IEEE divides and square
// roots, divergent across the four material branches.  A scene whose quads
// are all parallelograms (every demo scene) takes the TPU kernel's
// fast_quads test (csrc/path.cuh parallelogram_t: one plane intersection
// and a dual-basis inside test, 34 operations and one reciprocal a quad)
// instead of two Moller-Trumbore fans (104 and two reciprocals); its
// per-quad algebra (the plane normal, the dual basis and their inverse
// lengths) is made once per quad geometry by the wrapper and read from the
// quad row.  Quadric: the 12 unit intersectors per live bounce, and above
// all the torus's SDF march: a ray inside the torus's bound marches until
// |d| < 0.01 (tens of steps, up to 500 near grazing), and the 31 other
// threads of its warp wait for the slowest one.  Sky: the Preetham
// evaluation on every miss (acos, cos, exp and 4 powf per channel) and
// the sun lobe's powf per bounce.  Mesh: the BVH walk's dependent gathers
// and the warp divergence of the walks (csrc/bvh.cuh); HDRI: the equirect
// gathers and the CDF searches (csrc/hdri.cuh); textured: on top of the
// walk, up to four bilinear samples per mesh hit (one 64-byte record of four
// float4 loads each) from texel tables larger than the L2 cache
// (csrc/textures.cuh).  Without
// a mesh it moves almost no memory: a few hundred floats of scene
// constants, one blue-noise texel and 11 output floats per pixel.  The grads mode adds
// n_sg * 4 bytes per pixel.
//
// What the design does about that: one thread per pixel with its whole path
// state in registers; the scene block (camera, parameters, the 128-byte
// quad rows, the sphere and quadric rows) sits in shared memory, loaded
// once per block and read as float4s; the blue-noise texel is gathered
// directly from the 256x256x4 table (the TPU kernel needed host-rolled
// planes because Mosaic has no per-lane gather).  Unlike the TPU's masked
// lockstep, a thread leaves the bounce loop once its path is dead (a dead
// lane's records never change again), evaluates only its own material's
// branch and the environment only on its own miss, leaves the torus march
// when its lane freezes, and does not march a ray that misses the torus's
// bound; every draw of a bounce is still consumed, so the random streams
// stay aligned with the plain version.  The mesh walk, the texel work and
// the HDRI code are compiled only into the instantiations that use them (a configuration
// pays registers and scheduling for code it carries even when it never
// runs it: the quadric loop costs the Cornell configuration 2-3%).  The
// divergence of the march and of the walk is left as it is here: the staged
// kernel (csrc/staged.cu) sorts rays between bounces instead.
//
// The grads planes: a thread cannot hold n_obj accumulators (the wrapper
// allows 256 quads + 64 spheres + 12 quadrics), but a path touches at most
// `bounces` entries of its own pixel's planes.  So each thread first writes
// zeros to its pixel's n_sg entries (the planes' only full write, coalesced
// across the warp: n_sg * 4 B per pixel, no separate memset launch), then
// read-modify-writes the entry of the object it hit on each bounce that
// counts: at most `bounces` further 4-byte loads and stores per pixel, which
// stay in L2.  One thread owns one pixel, so no atomics are needed.
//
// Numerics: no fast math; 1/sqrtf rather than rsqrtf; dot products summed
// in (x + y) + z order, as the plain version does.  Built with --fmad=false:
// with nvcc's default FMA contraction, 17 (METAL right sphere) and 31
// (TRANSPARENT) of the 1024x1024 first-hit normals missed the parity
// tolerance (rtol 1e-3, atol 1e-4) against the plain version on an H100;
// without it the kernel's outputs are bit-equal to the plain version's on
// the card.  Restoring FMA is a later performance change.
//
// Registers: nvcc's -Xptxas -v report for every instantiation is printed by
// chip_smoke.py's build phase (PERF.md keeps the numbers).  The quadric code
// costs the Cornell configuration about 2-3% of device time (measured with
// bpt_tpu_torch/tools/ab_time.py against a copy without the quadric loop):
// the price of one function for the configurations that share the quad-NEE
// path.

#include <cstdint>
#include <cuda_runtime.h>

#include "path.cuh"

namespace {

using namespace bpt;

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured>
__device__ __forceinline__ void trace_pixel(const TraceArgs& a) {
  const SceneConsts c = load_scene<kMesh>(a);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= a.width || py >= a.height) return;
  const int pix = py * a.width + px;
  const Home h{(uint32_t)pix, (uint32_t)(a.width * a.height)};
  clear_grads<kGrads, kEnv, kTextured>(a, h);

  float bn[4];
  blue_noise_texel(a.blue_noise, px, py, a.bn_ox, a.bn_oy, bn);
  Path p;
  start_path(c, px, py, a.width, a.height, a.frame_u, p);
  Records rec = no_records();
  // the lane constants after the ray generation: they are not live through it
  const LaneConsts k = lane_consts<kGrads, kEnv, kNee, kMesh, kTextured>(a, c);
  trace_bounces<kGrads, kEnv, kNee, kMesh, kTextured>(a, c, k, p, rec, bn, 0, a.bounces, a.frame_f, h);

  a.out_color[3 * pix + 0] = fmaxf(p.acc.x, 0.0f);
  a.out_color[3 * pix + 1] = fmaxf(p.acc.y, 0.0f);
  a.out_color[3 * pix + 2] = fmaxf(p.acc.z, 0.0f);
  a.out_normal[3 * pix + 0] = rec.normal.x;
  a.out_normal[3 * pix + 1] = rec.normal.y;
  a.out_normal[3 * pix + 2] = rec.normal.z;
  a.out_ocolor[3 * pix + 0] = rec.color.x;
  a.out_ocolor[3 * pix + 1] = rec.color.y;
  a.out_ocolor[3 * pix + 2] = rec.color.z;
  a.out_oid[pix] = rec.id;
  a.out_sharp[pix] = p.sharp;
}

// The kernels: one thread per pixel.  Without a mesh, 64 registers let 4
// blocks of 256 threads share an SM; they spill to L1, yet run faster than
// 3 blocks at 80 registers or no bound (bpt_tpu_torch/tools/ab_time.py
// --only nomesh over variant checkouts; PERF.md keeps the numbers): with
// the parallelogram quad test the extra warps hide more latency than the
// spills cost.  An untextured mesh configuration keeps the compiler's own
// choice: a register bound there costs more than it gains.  A textured one
// is a kernel of its own, so that its register policy is its own: at (256,
// 4) it takes 64 registers and spills 200-290 bytes to L1, and runs faster
// than at (256, 3) (80 registers) and than with the compiler's 88-96
// registers (2 blocks an SM): the texel loads' latency wants the other
// blocks' warps (tools/ab_time.py --only textured; PERF.md keeps the numbers).
template <bool kGrads, int kEnv, int kNee>
__global__ void __launch_bounds__(256, 4) trace_kernel(const TraceArgs a) {
  trace_pixel<kGrads, kEnv, kNee, false, false>(a);
}

template <bool kGrads, int kEnv, int kNee, bool kTextured>
__global__ void trace_kernel(const TraceArgs a) {
  trace_pixel<kGrads, kEnv, kNee, true, kTextured>(a);
}

template <bool kGrads, int kEnv, int kNee>
__global__ void __launch_bounds__(256, 4) trace_kernel_textured(const TraceArgs a) {
  trace_pixel<kGrads, kEnv, kNee, true, true>(a);
}

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured = false>
int launch_cfg(const TraceArgs& a, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((a.width + block.x - 1) / block.x, (a.height + block.y - 1) / block.y);
  const size_t smem = sizeof(float) * scene_floats(a, kMesh);
  if constexpr (kTextured) {
    trace_kernel_textured<kGrads, kEnv, kNee><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  } else if constexpr (kMesh) {
    trace_kernel<kGrads, kEnv, kNee, false><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    trace_kernel<kGrads, kEnv, kNee><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrads, int kEnv, int kNee>
int launch_mesh(const TraceArgs& a, int mesh, void* stream) {
  if (mesh == 2) return launch_cfg<kGrads, kEnv, kNee, true, true>(a, stream);
  return mesh ? launch_cfg<kGrads, kEnv, kNee, true>(a, stream) : launch_cfg<kGrads, kEnv, kNee, false>(a, stream);
}

template <bool kGrads>
int launch_mode(const TraceArgs& a, int env, int nee, int mesh, void* stream) {
  if (env == kEnvNone && nee == kNeeQuad) return launch_mesh<kGrads, kEnvNone, kNeeQuad>(a, mesh, stream);
  if (env == kEnvSky && nee == kNeeSun) return launch_mesh<kGrads, kEnvSky, kNeeSun>(a, mesh, stream);
  if (env == kEnvHdri && nee == kNeeSun) return launch_mesh<kGrads, kEnvHdri, kNeeSun>(a, mesh, stream);
  if (env == kEnvHdri && nee == kNeeEnv) return launch_mesh<kGrads, kEnvHdri, kNeeEnv>(a, mesh, stream);
  return -1;
}

}  // namespace

extern "C" int bpt_trace_args_size() { return static_cast<int>(sizeof(bpt::TraceArgs)); }

// One frame of the configuration the arguments select: env 0 none, 1 sky,
// 2 hdri; nee 0 quad, 1 sun, 2 env (the pairs none + quad, sky + sun,
// hdri + sun and hdri + env); mesh 0 none, 1 untextured, 2 textured (PBR
// maps).  grads != 0 adds the (n_sg, H, W) path-replay planes out_sg
// (n_sg = ns + nqd + nq with transparent_tint, twice that without) and,
// under env hdri or with a textured mesh, the (n_def, H, W) deferred planes
// out_def (6 under env hdri, then 2 * bounces + 5 with a textured mesh),
// every configuration.  Returns the CUDA error of the launch, or -1 for a
// combination that is not built.
extern "C" int bpt_trace(const bpt::TraceArgs* args, int grads, int env, int nee, int mesh, void* stream) {
  const bpt::TraceArgs& a = *args;
  if (mesh < 0 || mesh > 2) return -1;
  return grads ? launch_mode<true>(a, env, nee, mesh, stream) : launch_mode<false>(a, env, nee, mesh, stream);
}
