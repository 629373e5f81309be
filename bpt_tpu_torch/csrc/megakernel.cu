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
// unknown material and ends the path, as in the plain version.
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
// divergence.  Cornell: the intersection of every ray with 6 quads as 12
// Moller-Trumbore triangles and 2 instanced spheres, plus sin/cos/exp/log
// and IEEE divides and square roots, divergent across the four material
// branches.  Quadric: the 12 unit intersectors per live bounce, and above
// all the torus's SDF march: a ray inside the torus's bound marches until
// |d| < 0.01 (tens of steps, up to 500 near grazing), and the 31 other
// threads of its warp wait for the slowest one.  Sky: the Preetham
// evaluation on every miss (acos, cos, exp and 4 powf per channel) and
// the sun lobe's powf per bounce.  Mesh: the BVH walk's dependent gathers
// and the warp divergence of the walks (csrc/bvh.cuh); HDRI: the equirect
// gathers and the CDF searches (csrc/hdri.cuh); textured: on top of the
// walk, four bilinear samples (4 taps of dependent scalar loads each) per
// PBR hit from maps larger than the L2 cache (csrc/textures.cuh).  Without
// a mesh it moves almost no memory: a few hundred floats of scene
// constants, one blue-noise texel and 11 output floats per pixel.  The grads mode adds
// n_sg * 4 bytes per pixel.
//
// What the design does about that: one thread per pixel with its whole path
// state in registers; the scene constants and the parameter pack sit in
// shared memory, loaded once per block; the blue-noise texel is gathered
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
// divergence of the march and of the walk is left as it is: sorting rays or
// marching in a separate pass is later work.
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

#include "bvh.cuh"
#include "hdri.cuh"
#include "quadrics.cuh"
#include "sky.cuh"
#include "textures.cuh"
#include "vec.cuh"

namespace bpt {

// Everything one launch reads and writes.  Its layout is mirrored by
// kernels/megakernel.py _TraceArgs (ctypes): pointers first, then 32-bit
// fields; bpt_trace_args_size lets the wrapper check the match.  It lives in
// a named namespace: with the struct in the unnamed one, the C entry that
// takes it was not exported from nvcc's shared library.
struct TraceArgs {
  const float* cam;
  const float* params;
  const float* quads;
  const float* spheres;
  const float* quadrics;
  const float* mesh;  // kMeshFloats constants
  const float4* mesh_nodes;
  const float4* mesh_tris;
  const float4* mesh_normals;
  const float* hdr;  // (H, W, 3) equirect map
  const float* row_cdf;  // (H,)
  const float* col_cdf;  // (H, W)
  const float* env_pdf;  // (H, W)
  const float* blue_noise;
  float* out_color;
  float* out_normal;
  float* out_ocolor;
  float* out_oid;
  float* out_sharp;
  float* out_sg;
  const float2* mesh_uvs;  // textured: uv0, uv1, uv2 per triangle
  float* out_def;  // grads mode: the deferred planes (n_def, H, W), or null
  const float* tex[4];  // textured: albedo, normal, metallic-roughness, emissive (h, w, 3) maps (or null)
  int nq, ns, nqd;
  int bn_ox, bn_oy, width, height, bounces;
  float eps;
  int light_index, diffuse_indirect_max, camera_is_moving, transparent_tint;
  uint32_t frame_u;
  float frame_f;
  int tex_h[4], tex_w[4];
  int metal_roughness_lobe;
};

}  // namespace bpt

namespace {

using namespace bpt;

constexpr uint32_t kMagic = 1103515245u;

constexpr int kLight = 0;
constexpr int kDiffuse = 1;
constexpr int kTransparent = 2;
constexpr int kMetal = 3;
constexpr int kClearcoat = 4;
constexpr int kPbr = 10;

constexpr int kEnvNone = 0, kEnvSky = 1, kEnvHdri = 2;
constexpr int kNeeQuad = 0, kNeeSun = 1, kNeeEnv = 2;

// Packed scene layouts (bpt_tpu_torch/kernels/megakernel.py pack_scene /
// pack_camera / pack_params / pack_mesh): cam = pos3 right3 up3 fwd3 ulen
// vlen aperture focus; quad row (20) = n3 v0 v1 v2 v3 color3 mat pad; sphere
// row (21) = inverse 4x4 row-major (16) color3 mat pad; quadric row (20) =
// inverse 4x4 row-major (16) color3 mat; mesh constants (17) = inverse 4x4
// row-major (16) mat (kPbr for a mesh with an albedo), and its nodes,
// triangles and normals (csrc/bvh.cuh), UV records and texels
// (csrc/textures.cuh); the parameter pack: vec.cuh.
constexpr int kCamFloats = 16;
constexpr int kQuadFloats = 20;
constexpr int kSphereFloats = 21;
constexpr int kQuadricFloats = 20;
constexpr int kMeshFloats = 17;


// iq's uvec2 hash, one draw: native uint32 wrap-around, mantissa bitcast.
__device__ __forceinline__ float rng_next(uint32_t& sx, uint32_t& sy) {
  sx += 1u;
  sy += 1u;
  uint32_t qx = kMagic * ((sx >> 1) ^ sy);
  uint32_t qy = kMagic * ((sy >> 1) ^ sx);
  uint32_t n = kMagic * (qx ^ (qy >> 3));
  return __uint_as_float((n >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float tent(float x) {
  return x < 0.5f ? sqrtf(fmaxf(2.0f * x, 0.0f)) - 1.0f : 1.0f - sqrtf(fmaxf(2.0f - 2.0f * x, 0.0f));
}

// Moller-Trumbore with backface cull; kInf on a miss.
__device__ __forceinline__ float triangle_t(V3 v0, V3 v1, V3 v2, V3 ro, V3 rd) {
  V3 e1 = sub(v1, v0);
  V3 e2 = sub(v2, v0);
  V3 pvec = cross(rd, e2);
  float raw_det = dot(e1, pvec);
  float det = safe_inv(raw_det);
  V3 tvec = sub(ro, v0);
  float u = dot(tvec, pvec) * det;
  V3 qvec = cross(tvec, e1);
  float v = dot(rd, qvec) * det;
  float t = dot(e2, qvec) * det;
  bool miss = (u < 0.0f) || (u > 1.0f) || (v < 0.0f) || (u + v > 1.0f) || (t <= 0.0f) ||
              (raw_det < 0.0f) || isnan(t);
  return miss ? kInf : t;
}

// (m @ [p, w]).xyz for a row-major 4x4 matrix; w = 1 for points, 0 for dirs.
__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  return v3((m[0] * p.x + m[1] * p.y + m[2] * p.z) + m[3], (m[4] * p.x + m[5] * p.y + m[6] * p.z) + m[7],
            (m[8] * p.x + m[9] * p.y + m[10] * p.z) + m[11]);
}
__device__ __forceinline__ V3 xform_dir(const float* m, V3 d) {
  return v3(m[0] * d.x + m[1] * d.y + m[2] * d.z, m[4] * d.x + m[5] * d.y + m[6] * d.z,
            m[8] * d.x + m[9] * d.y + m[10] * d.z);
}
// transpose(m3) @ n
__device__ __forceinline__ V3 xform_normal(const float* m, V3 n) {
  return v3(m[0] * n.x + m[4] * n.y + m[8] * n.z, m[1] * n.x + m[5] * n.y + m[9] * n.z,
            m[2] * n.x + m[6] * n.y + m[10] * n.z);
}

// Exact dielectric Fresnel: returns Re, writes the IoR ratio.
__device__ __forceinline__ float fresnel(V3 rd, V3 n, float etai, float etat, float* ratio_out) {
  float cosi = clampf(dot(rd, n), -1.0f, 1.0f);
  bool inside = cosi > 0.0f;
  float ei = inside ? etat : etai;
  float et = inside ? etai : etat;
  float ratio = ei / et;
  float sint = ratio * safe_sqrt(1.0f - cosi * cosi);
  float cost = safe_sqrt(1.0f - sint * sint);
  float ca = fabsf(cosi);
  float rs = ((et * ca) - (ei * cost)) / fmaxf((et * ca) + (ei * cost), 1e-20f);
  float rp = ((ei * ca) - (et * cost)) / fmaxf((ei * ca) + (et * cost), 1e-20f);
  float re = clampf((rs * rs + rp * rp) * 0.5f, 0.0f, 1.0f);
  *ratio_out = ratio;
  return sint >= 1.0f ? 1.0f : re;
}

// Cosine-weighted direction about nl from two uniforms (cross-trick ONB).
__device__ __forceinline__ V3 cos_hemisphere(V3 nl, float r_, float p_) {
  float r = sqrtf(r_);
  float phi = p_ * kTwoPi;
  float x = r * cosf(phi);
  float y = r * sinf(phi);
  float z = safe_sqrt(1.0f - x * x - y * y);
  V3 u, v;
  onb(nl, &u, &v);
  return normalize(add(add(mul(u, x), mul(v, y)), mul(nl, z)));
}

// Quad-light NEE: direction toward a point of the light and its weight.
__device__ __forceinline__ V3 quad_light(const float* lq, V3 x, V3 nl, float rx, float ry, float rz,
                                         float* weight) {
  V3 ln = load3(lq + 0);
  V3 lv0 = load3(lq + 3), lv1 = load3(lq + 6), lv2 = load3(lq + 9), lv3 = load3(lq + 12);
  V3 rp = v3(lv0.x + (lv2.x - lv0.x) * clampf(rx, 0.1f, 0.9f), lv0.y + (lv2.y - lv0.y) * clampf(ry, 0.1f, 0.9f),
             lv0.z + (lv2.z - lv0.z) * clampf(rz, 0.1f, 0.9f));
  V3 d = sub(rp, x);
  V3 e1 = sub(lv1, lv0), e3 = sub(lv3, lv0);
  float r2 = sqrtf(fmaxf(dot(e1, e1), 0.0f)) * sqrtf(fmaxf(dot(e3, e3), 0.0f));
  float d2 = dot(d, d);
  float cos_a_max = safe_sqrt(1.0f - clampf(r2 / fmaxf(d2, 1e-20f), 0.0f, 1.0f));
  d = normalize(d);
  float dot_nl = fmaxf(dot(nl, d), 0.0f);
  float w = 2.0f * (1.0f - cos_a_max) * fmaxf(-dot(d, ln), 0.0f) * dot_nl;
  *weight = clampf(w, 0.0f, 1.0f);
  return d;
}

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured>
__global__ void trace_kernel(const TraceArgs a) {
  static_assert(kMesh || !kTextured, "a textured configuration walks a mesh");
  constexpr bool kSky = kEnv == kEnvSky;
  const int nq = a.nq, ns = a.ns, nqd = a.nqd, width = a.width, height = a.height, bounces = a.bounces;
  const int diffuse_indirect_max = a.diffuse_indirect_max, transparent_tint = a.transparent_tint;
  const float eps = a.eps, frame_f = a.frame_f;
  float* __restrict__ out_sg = a.out_sg;

  // ---- constants into shared memory: cam | params | quads | spheres | quadrics | mesh
  extern __shared__ float smem[];
  float* cam = smem;
  float* P = cam + kCamFloats;
  float* quads = P + kParamFloats;
  float* spheres = quads + nq * kQuadFloats;
  float* quadrics = spheres + ns * kSphereFloats;
  float* mesh_inv = quadrics + nqd * kQuadricFloats;
  const int seg[6] = {kCamFloats, kParamFloats, nq * kQuadFloats, ns * kSphereFloats, nqd * kQuadricFloats,
                      kMesh ? kMeshFloats : 0};
  const float* src[6] = {a.cam, a.params, a.quads, a.spheres, a.quadrics, a.mesh};
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  int base = 0;
  for (int g = 0; g < 6; ++g) {
    for (int i = tid; i < seg[g]; i += blockDim.x * blockDim.y) smem[base + i] = src[g][i];
    base += seg[g];
  }
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const int pix = py * width + px;
  const float shape_k = P[kPShapeK];
  const int mesh_mat = kMesh ? (int)mesh_inv[16] : 0;
  const bool mesh_cull = mesh_mat != kTransparent;  // double-sided only when untextured TRANSPARENT
  const bool lobe = kTextured && a.metal_roughness_lobe;

  // ---- grads mode: zero this pixel's path-replay entries -----------------
  constexpr bool kDeferMiss = kGrads && kEnv == kEnvHdri;  // the environment's radiance composed outside
  constexpr bool kDeferTex = kGrads && kTextured;  // the albedo factors and the emission composed outside
  const size_t plane = (size_t)width * (size_t)height;
  const int n_obj = ns + nqd + nq;
  const int def_tex = kDeferMiss ? 6 : 0;  // the first textured deferred plane
  float* __restrict__ out_def = a.out_def;
  auto put_def = [&](int j, float v) { out_def[j * plane + pix] = v; };
  auto put_def3 = [&](int j, V3 v) {
    put_def(j, v.x);
    put_def(j + 1, v.y);
    put_def(j + 2, v.z);
  };
  if constexpr (kGrads) {
    const int n_sg = transparent_tint ? n_obj : 2 * n_obj;
    for (int j = 0; j < n_sg; ++j) out_sg[j * plane + pix] = 0.0f;
    if constexpr (kDeferMiss) {
      for (int j = 0; j < 6; ++j) put_def(j, 0.0f);
    }
    if constexpr (kDeferTex) {
      for (int j = 0; j < 2 * bounces; ++j) put_def(def_tex + j, -kInf);
      for (int j = 0; j < 5; ++j) put_def(def_tex + 2 * bounces + j, 0.0f);
    }
  }
  // the entry of the object hit (a mesh hit, id n_obj, has no plane)
  auto add_sg = [&](int obj, float v) {
    if constexpr (kGrads) {
      if (obj < n_obj) out_sg[obj * plane + pix] += v;
    }
  };
  auto add_beer = [&](int obj, float v) {
    if constexpr (kGrads) {
      if (obj < n_obj) out_sg[(n_obj + obj) * plane + pix] += v;
    }
  };

  // ---- RNG seeds from absolute pixel coordinates -------------------------
  uint32_t sx = a.frame_u * (uint32_t)px;
  uint32_t sy = (a.frame_u + 1u) * (uint32_t)py;

  // ---- blue-noise decision texel: ((p + offset) mod 256), channels mod 1 --
  const float* texel = a.blue_noise + (((py + a.bn_oy) & 255) * 256 + ((px + a.bn_ox) & 255)) * 4;
  float bn[4];
  for (int c = 0; c < 4; ++c) bn[c] = texel[c] - floorf(texel[c]);

  // ---- ray generation: tent AA + thin-lens DoF (4 draws) -----------------
  V3 c_pos = load3(cam + 0), c_right = load3(cam + 3), c_up = load3(cam + 6), c_fwd = load3(cam + 9);
  float ulen = cam[12], vlen = cam[13], aperture = cam[14], focus = cam[15];
  float ox = tent(rng_next(sx, sy));
  float oy = tent(rng_next(sx, sy));
  float ndc_x = (((float)px + 0.5f + ox) / (float)width) * 2.0f - 1.0f;
  float ndc_y = (((float)py + 0.5f + oy) / (float)height) * 2.0f - 1.0f;
  V3 rd = normalize(v3((ndc_x * c_right.x) * ulen + (ndc_y * c_up.x) * vlen + c_fwd.x,
                       (ndc_x * c_right.y) * ulen + (ndc_y * c_up.y) * vlen + c_fwd.y,
                       (ndc_x * c_right.z) * ulen + (ndc_y * c_up.z) * vlen + c_fwd.z));
  float angle = rng_next(sx, sy) * kTwoPi;
  float radius = rng_next(sx, sy) * aperture;
  float ca = cosf(angle), sa = sinf(angle), sr = safe_sqrt(radius);
  V3 ap = v3((ca * c_right.x + sa * c_up.x) * sr, (ca * c_right.y + sa * c_up.y) * sr,
             (ca * c_right.z + sa * c_up.z) * sr);
  rd = normalize(sub(mul(rd, focus), ap));
  V3 ro = add(c_pos, ap);

  // ---- per-path state -----------------------------------------------------
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  V3 mask = v3(1.0f, 1.0f, 1.0f);
  bool spec = true, sample_light = false, coat_hit = false;
  int d_count = 0, prev_mat = -100;
  float sharp = 0.0f;
  V3 obj_normal = v3(0.0f, 0.0f, 0.0f), obj_color = v3(0.0f, 0.0f, 0.0f);
  float obj_id = -kInf;
  const float* lq = quads + (kNee == kNeeQuad ? a.light_index : 0) * kQuadFloats;

  for (int bounce = 0; bounce < bounces; ++bounce) {
    // ---- closest hit: spheres, quadrics, quads; strict < keeps ties ------
    float t_best = kInf;
    V3 nrm = v3(0.0f, 0.0f, 0.0f), hc = v3(0.0f, 0.0f, 0.0f);
    int mat = -100;
    float hid = -kInf;
    int hobj = -1;
    float hu = 0.0f, hv = 0.0f;  // a textured mesh hit's UV
    for (int s = 0; s < ns; ++s) {
      const float* m = spheres + s * kSphereFloats;
      QHit h = q_sphere(xform_point(m, ro), xform_dir(m, rd));
      if (h.t < t_best) {
        t_best = h.t;
        nrm = normalize(xform_normal(m, normalize(h.n)));
        hc = load3(m + 16);
        mat = (int)m[19];
        hid = (float)s;
        hobj = s;
      }
    }
    for (int i = 0; i < nqd; ++i) {
      const float* m = quadrics + i * kQuadricFloats;
      QHit h = quadric_intersect(i, xform_point(m, ro), xform_dir(m, rd), shape_k);
      if (h.t < t_best) {
        t_best = h.t;
        nrm = normalize(xform_normal(m, normalize(h.n)));
        hc = load3(m + 16);
        mat = (int)m[19];
        hid = (float)(ns + i);
        hobj = ns + i;
      }
    }
    for (int q = 0; q < nq; ++q) {
      const float* Q = quads + q * kQuadFloats;
      V3 v0 = load3(Q + 3), v1 = load3(Q + 6), v2 = load3(Q + 9), v3_ = load3(Q + 12);
      float t = fminf(triangle_t(v0, v1, v2, ro, rd), triangle_t(v0, v2, v3_, ro, rd));
      if (t < t_best) {
        t_best = t;
        nrm = load3(Q + 0);
        hc = load3(Q + 15);
        mat = (int)Q[18];
        hid = (float)(ns + nqd + q);
        hobj = ns + nqd + q;
      }
    }
    if constexpr (kMesh) {  // the model: object space, the BVH walk, the winner's normal
      const V3 ro_o = xform_point(mesh_inv, ro), rd_o = xform_dir(mesh_inv, rd);  // rd_o unnormalized
      const MeshHit mh = bvh_closest(a.mesh_nodes, a.mesh_tris, ro_o, rd_o, mesh_cull);
      if (mh.t < t_best) {
        t_best = mh.t;
        V3 n_obj = mesh_normal(a.mesh_normals, mh);
        if constexpr (kTextured) {  // the normal map perturbs the object-space normal
          mesh_uv(a.mesh_uvs, mh.tri, mh.u, mh.v, &hu, &hv);
          if (a.tex[kTexNormal]) n_obj = perturb_normal(n_obj, a.tex[kTexNormal], a.tex_h[kTexNormal],
                                                        a.tex_w[kTexNormal], hu, hv);
        }
        nrm = normalize(xform_normal(mesh_inv, n_obj));
        hc = v3(1.0f, 1.0f, 1.0f);
        mat = mesh_mat;
        hid = (float)(ns + nqd + nq);
        hobj = ns + nqd + nq;
      }
    }
    if (t_best >= kInf) {  // a miss ends the path; env "none" leaves it black
      if constexpr (kEnv != kEnvNone) {
        V3 env = v3(0.0f, 0.0f, 0.0f);
        if constexpr (kSky) {
          env = sky_color(rd, P);
        } else if constexpr (!kDeferMiss) {
          env = hdr_color(a.hdr, (int)P[kPHdrH], (int)P[kPHdrW], rd, P[kPExposure]);
        }
        if (bounce == 0) {  // a primary ray sees the environment
          if constexpr (kDeferMiss) {
            put_def3(0, mask);
            put_def3(3, rd);
          } else {
            acc = env;
          }
          sharp = 1.01f;
        } else {  // first-match case chain c2 > c3 > c4 > c5
          const float sun_cos = dot(rd, load3(P + kPSun));
          bool c2 = d_count == 0 && spec;
          bool c3 = sample_light;
          bool c4 = d_count == 1 && prev_mat == kTransparent && spec && (kSky || bounce < 3);
          bool c5 = d_count > 0;
          // clip the sun disc; env NEE already covers the whole map at a diffuse vertex
          const float sun_clip = kNee == kNeeEnv ? 0.0f : (sun_cos < 0.99f ? 1.0f : 0.0f);
          if constexpr (kDeferMiss) {  // the miss throughput: the weight the environment's radiance takes
            put_def3(0, (c2 || c3 || c4) ? mask : c5 ? mul(mask, sun_clip) : v3(0.0f, 0.0f, 0.0f));
            put_def3(3, rd);
          } else {
            V3 lit = mul3(mask, env);
            if (c2 || c3 || c4) {
              acc = lit;
            } else if (c5) {
              acc = mul(lit, sun_clip);
            } else {
              acc = v3(0.0f, 0.0f, 0.0f);
            }
          }
          if (c2) sharp = 1.01f;
          if (!kSky && !c2 && !c3 && c4 && sun_cos > 0.99f) sharp = 1.01f;
        }
      }
      break;
    }

    V3 n = normalize(nrm);
    V3 nl = dot(n, rd) < 0.0f ? n : neg(n);
    V3 x = add(ro, mul(rd, t_best));

    // ---- first-hit records for the edge detector -------------------------
    if (bounce == 0) {
      obj_normal = nl;
      obj_color = hc;
      obj_id = hid;
    } else if (bounce == 1 && prev_mat == kMetal) {
      obj_normal = nl;
      obj_id = hid;
    }

    // ---- a light hit ends the path (quad-light NEE only) -----------------
    if constexpr (kNee == kNeeQuad) {
      if (mat == kLight) {
        if (d_count == 0) sharp = 1.01f;
        if (spec || sample_light) {
          acc = mul3(mask, hc);
          add_sg(hobj, 1.0f);
        }
        break;
      }
    }
    // ---- so does a failed shadow ray -------------------------------------
    if (sample_light) break;

    // ---- a textured mesh's PBR texels: albedo, emission, class, roughness
    float mr_g = 0.0f;  // the METAL lobe's roughness
    bool pbr_hit = false;
    if constexpr (kTextured) {
      if (mat == kPbr) {
        pbr_hit = true;
        if constexpr (kDeferTex) {
          hc = v3(1.0f, 1.0f, 1.0f);  // the albedo factor is composed outside
        } else {
          hc = sample_linear(a.tex[kTexAlbedo], a.tex_h[kTexAlbedo], a.tex_w[kTexAlbedo], hu, hv);
        }
        if (a.tex[kTexEmissive]) {  // an emissive texel ends a specular path, tested before the class
          const V3 em = sample_linear(a.tex[kTexEmissive], a.tex_h[kTexEmissive], a.tex_w[kTexEmissive], hu, hv);
          if (spec && fmaxf(fmaxf(em.x, em.y), em.z) > 0.01f) {
            sharp = 1.01f;
            if constexpr (kDeferTex) {  // the emission is composed outside: its weight and uv
              put_def3(def_tex + 2 * bounces, mask);
              put_def(def_tex + 2 * bounces + 3, hu);
              put_def(def_tex + 2 * bounces + 4, hv);
            } else {
              acc = mul3(mask, em);
            }
            break;
          }
        }
        mat = kDiffuse;
        if (a.tex[kTexMetalRough]) {  // roughness (G): CLEARCOAT; metalness (B) overrides it: METAL
          const Taps t = bilinear_taps(a.tex_h[kTexMetalRough], a.tex_w[kTexMetalRough], hu, hv);
          mr_g = srgb_linear(tap_channel(a.tex[kTexMetalRough], t, 1));
          if (mr_g > 0.01f) mat = kClearcoat;
          if (srgb_linear(tap_channel(a.tex[kTexMetalRough], t, 2)) > 0.01f) mat = kMetal;
        }
      }
    }

    // ---- this bounce's fixed-schedule draws (all consumed) --------------
    const float gate1 = bn[(2 * bounce) & 3];
    const float gate2 = bn[(2 * bounce + 1) & 3];
    const float hem_r = rng_next(sx, sy);
    const float hem_p = rng_next(sx, sy);
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, lc = 0.0f, lp = 0.0f;
    if constexpr (kNee == kNeeQuad) {  // quad.x, quad.y, quad.z
      q0 = rng_next(sx, sy);
      q1 = rng_next(sx, sy);
      q2 = rng_next(sx, sy);
    }
    if (kNee != kNeeQuad || lobe) {  // lobe.cos, lobe.phi
      lc = rng_next(sx, sy);
      lp = rng_next(sx, sy);
    }
    // a bounce whose throughput takes the albedo factor (DIFFUSE, METAL, CLEARCOAT's base) records its uv
    auto albedo_factor = [&]() {
      if constexpr (kDeferTex) {
        if (pbr_hit) {
          put_def(def_tex + 2 * bounce, hu);
          put_def(def_tex + 2 * bounce + 1, hv);
        }
      }
    };
    auto nee = [&](float* w) {
      if constexpr (kNee == kNeeSun) {
        return sun_nee(P, nl, lc, lp, w);
      } else if constexpr (kNee == kNeeEnv) {
        return env_nee(a.row_cdf, a.col_cdf, a.env_pdf, (int)P[kPHdrH], (int)P[kPHdrW], nl, lc, lp, w);
      } else {
        return quad_light(lq, x, nl, q0, q1, q2, w);
      }
    };

    if (mat == kDiffuse) {
      int dc = d_count + 1;
      bool go_indirect = (dc <= diffuse_indirect_max) && (gate1 < 0.5f);
      V3 md = mul3(mask, hc);
      if (go_indirect) {
        rd = cos_hemisphere(nl, hem_r, hem_p);
        mask = md;
      } else {
        float w;
        rd = nee(&w);
        mask = mul(md, w);
      }
      ro = add(x, mul(nl, eps));
      spec = false;
      sample_light = !go_indirect;
      d_count = dc;
      add_sg(hobj, 1.0f);
      albedo_factor();
    } else if (mat == kMetal) {
      mask = mul3(mask, hc);
      add_sg(hobj, 1.0f);
      albedo_factor();
      rd = reflect(rd, nl);
      if (lobe) rd = roughness_lobe(rd, mr_g, lc, lp);
      ro = add(x, mul(nl, eps));
      sample_light = false;
    } else if (mat == kTransparent) {
      float ratio;
      float re = fresnel(rd, n, 1.0f, 1.5f, &ratio);
      float tr = 1.0f - re;
      float p = 0.25f + 0.5f * re;
      if (gate1 < p) {
        mask = mul(mask, re / p);
        rd = reflect(rd, nl);
        ro = add(x, mul(nl, eps));
      } else {
        V3 absorb = v3(1.0f, 1.0f, 1.0f);
        if (transparent_tint) {
          absorb = hc;
          add_sg(hobj, 1.0f);
        } else if (dot(n, rd) >= 0.0f) {  // inside: Beer-Lambert on exit
          absorb = v3(expf(logf(clampf(hc.x, 0.01f, 0.99f)) * 0.01f * t_best),
                      expf(logf(clampf(hc.y, 0.01f, 0.99f)) * 0.01f * t_best),
                      expf(logf(clampf(hc.z, 0.01f, 0.99f)) * 0.01f * t_best));
          add_beer(hobj, 0.01f * t_best);
        }
        float f = tr / (1.0f - p);
        mask = v3((mask.x * absorb.x) * f, (mask.y * absorb.y) * f, (mask.z * absorb.z) * f);
        // GLSL refract(rd, nl, ratio); 0 on total internal reflection
        float cosi = dot(nl, rd);
        float k = 1.0f - ratio * ratio * (1.0f - cosi * cosi);
        float s = ratio * cosi + sqrtf(fmaxf(k, 0.0f));
        rd = k < 0.0f ? v3(0.0f, 0.0f, 0.0f) : sub(mul(rd, ratio), mul(nl, s));
        ro = sub(x, mul(nl, eps));
        spec = spec || (d_count == 1);
      }
      sample_light = false;
      sharp = (d_count == 0 && !coat_hit && !a.camera_is_moving) ? 1.01f : (d_count > 0 ? 0.0f : -1.0f);
    } else if (mat == kClearcoat) {
      float unused_ratio;
      float re = fresnel(rd, nl, 1.0f, 1.4f, &unused_ratio);
      float tr = 1.0f - re;
      float p = 0.25f + 0.5f * re;
      if (gate1 < p) {
        mask = mul(mask, re / p);
        rd = reflect(rd, nl);
        sample_light = false;
        sharp = d_count == 0 ? (frame_f > 500.0f ? 1.01f : -1.0f) : 0.0f;
      } else {
        int dc = d_count + 1;
        bool go_indirect = (dc <= diffuse_indirect_max) && (gate2 < 0.5f);
        float f = tr / (1.0f - p);
        V3 mb = v3((mask.x * f) * hc.x, (mask.y * f) * hc.y, (mask.z * f) * hc.z);
        if (go_indirect) {
          rd = cos_hemisphere(nl, hem_r, hem_p);
          mask = mb;
        } else {
          float w;
          rd = nee(&w);
          mask = mul(mb, w);
        }
        // `bounce < 3` guards against noisy coat-after-glass pixels
        sample_light = !go_indirect && (bounce < 3);
        spec = false;
        d_count = dc;
        sharp = 0.0f;
        add_sg(hobj, 1.0f);
        albedo_factor();
      }
      ro = add(x, mul(nl, eps));
      coat_hit = true;
    } else {
      break;  // unknown material ids (and LIGHT without quad NEE) end the path
    }
    prev_mat = mat;
  }

  a.out_color[3 * pix + 0] = fmaxf(acc.x, 0.0f);
  a.out_color[3 * pix + 1] = fmaxf(acc.y, 0.0f);
  a.out_color[3 * pix + 2] = fmaxf(acc.z, 0.0f);
  a.out_normal[3 * pix + 0] = obj_normal.x;
  a.out_normal[3 * pix + 1] = obj_normal.y;
  a.out_normal[3 * pix + 2] = obj_normal.z;
  a.out_ocolor[3 * pix + 0] = obj_color.x;
  a.out_ocolor[3 * pix + 1] = obj_color.y;
  a.out_ocolor[3 * pix + 2] = obj_color.z;
  a.out_oid[pix] = obj_id;
  a.out_sharp[pix] = sharp;
}

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured = false>
int launch_cfg(const TraceArgs& a, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((a.width + block.x - 1) / block.x, (a.height + block.y - 1) / block.y);
  const size_t smem = sizeof(float) * (kCamFloats + kParamFloats + a.nq * kQuadFloats + a.ns * kSphereFloats +
                                       a.nqd * kQuadricFloats + (kMesh ? kMeshFloats : 0));
  trace_kernel<kGrads, kEnv, kNee, kMesh, kTextured><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
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
