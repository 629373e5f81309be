// The path tracer's per-lane code, shared by the monolithic megakernel (K1,
// csrc/megakernel.cu) and the staged phase kernel (K2, csrc/staged.cu): the
// argument block, the scene block in shared memory, ray generation and the
// body of one bounce (with the quad test: the parallelogram test or the
// two triangle fans).  Both kernels run these expressions in this order,
// so that under --fmad=false a path traced in several phases ends bit for
// bit where one traced in a single launch does.  The notes on numerics,
// draw order and the grads mode's planes are in csrc/megakernel.cu.
#pragma once

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
  const float* scene;  // the scene block: cam | params | quads | spheres | quadrics | mesh constants
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
  const float4* tex[4];  // textured: albedo, normal, metallic-roughness, emissive texel tables (or null)
  int nq, ns, nqd;
  int bn_ox, bn_oy, width, height, bounces;
  float eps;
  int light_index, diffuse_indirect_max, camera_is_moving, transparent_tint;
  uint32_t frame_u;
  float frame_f;
  int tex_h[4], tex_w[4];
  int metal_roughness_lobe;
  int fast_quads;  // every quad is a parallelogram: the parallelogram test, else the two triangle fans
};

// Map i's texel table (csrc/textures.cuh).
__device__ __forceinline__ TexMap tex_map(const TraceArgs& a, int i) {
  return TexMap{a.tex[i], a.tex_h[i], a.tex_w[i]};
}

constexpr uint32_t kMagic = 1103515245u;

constexpr int kLight = 0;
constexpr int kDiffuse = 1;
constexpr int kTransparent = 2;
constexpr int kMetal = 3;
constexpr int kClearcoat = 4;
constexpr int kPbr = 10;

constexpr int kEnvNone = 0, kEnvSky = 1, kEnvHdri = 2;
constexpr int kNeeQuad = 0, kNeeSun = 1, kNeeEnv = 2;

// The scene block (bpt_tpu_torch/kernels/launch_args.py trace_args, from
// pack_camera / pack_params / pack_scene / pack_mesh), one contiguous
// float32 array: cam (16) = pos3 right3 up3 fwd3 ulen vlen aperture focus;
// the parameter pack (24, vec.cuh); nq quad rows (32) = the parallelogram
// test's per-quad algebra ng3 c0 d1 k1 d3 k3 (made once per quad geometry),
// v0 mat n3 pad v1 v2 v3 color3 (kQ* below); ns sphere rows (24) = inverse
// 4x4 row-major (16) color3 mat pad4; nqd quadric rows (20) = inverse 4x4
// row-major (16) color3 mat; with a mesh its constants (17) = inverse 4x4
// row-major (16) mat (kPbr for a mesh with an albedo).  Every part but the
// last starts on a 16-byte boundary, so that the shape loops read their
// rows as float4s (ld4), which ran faster than scalar loads and than a
// constant bank (bpt_tpu_torch/tools/ab_time.py; PERF.md keeps the
// numbers).  The mesh's nodes, triangles and normals (csrc/bvh.cuh), UV
// records and texels (csrc/textures.cuh) are tables of their own.
constexpr int kCamFloats = 16;
constexpr int kQuadFloats = 32;
constexpr int kSphereFloats = 24;
constexpr int kQuadricFloats = 20;
constexpr int kMeshFloats = 17;
constexpr int kQNg = 0, kQC0 = 3, kQD1 = 4, kQK1 = 7, kQD3 = 8, kQK3 = 11, kQV0 = 12, kQMat = 15, kQN = 16,
              kQV1 = 20, kQV2 = 23, kQV3 = 26, kQColor = 29;

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

// Four consecutive floats of the scene block (16-byte aligned): one float4
// load from shared memory, a broadcast (every lane of a warp reads the same
// row).
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Rows 0-2 of a row-major 4x4 matrix in the scene block.
struct Mat34 {
  float4 r0, r1, r2;
};
__device__ __forceinline__ Mat34 ld_mat(const float* m) { return Mat34{ld4(m), ld4(m + 4), ld4(m + 8)}; }

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
// The same three on a matrix already loaded.
__device__ __forceinline__ V3 xform_point(const Mat34& m, V3 p) {
  return v3((m.r0.x * p.x + m.r0.y * p.y + m.r0.z * p.z) + m.r0.w,
            (m.r1.x * p.x + m.r1.y * p.y + m.r1.z * p.z) + m.r1.w,
            (m.r2.x * p.x + m.r2.y * p.y + m.r2.z * p.z) + m.r2.w);
}
__device__ __forceinline__ V3 xform_dir(const Mat34& m, V3 d) {
  return v3(m.r0.x * d.x + m.r0.y * d.y + m.r0.z * d.z, m.r1.x * d.x + m.r1.y * d.y + m.r1.z * d.z,
            m.r2.x * d.x + m.r2.y * d.y + m.r2.z * d.z);
}
__device__ __forceinline__ V3 xform_normal(const Mat34& m, V3 n) {
  return v3(m.r0.x * n.x + m.r1.x * n.y + m.r2.x * n.z, m.r0.y * n.x + m.r1.y * n.y + m.r2.y * n.z,
            m.r0.z * n.x + m.r1.z * n.y + m.r2.z * n.z);
}

// The parallelogram test (the TPU kernel's fast_quads path) of the quad row
// Q: one plane intersection, then the hit point's coordinates along e1 and
// e3 from the dual basis d1, d3 (their inverse lengths k1, k3), inside [0, 1]
// each; denom > 0 is the fans' backface cull.  The row's per-quad algebra was
// made once per quad geometry.  kInf on a miss, NaN included.
__device__ __forceinline__ float parallelogram_t(const float* Q, V3 ro, V3 rd) {
  const float4 a = ld4(Q + kQNg), b = ld4(Q + kQD1), d = ld4(Q + kQD3), v0 = ld4(Q + kQV0);
  const float denom = rd.x * a.x + rd.y * a.y + rd.z * a.z;
  const float ron = ro.x * a.x + ro.y * a.y + ro.z * a.z;
  const float tt = (a.w - ron) * safe_inv(denom);
  const float hx = ro.x + rd.x * tt - v0.x, hy = ro.y + rd.y * tt - v0.y, hz = ro.z + rd.z * tt - v0.z;
  const float aa = (hx * b.x + hy * b.y + hz * b.z) * b.w;
  const float bb = (hx * d.x + hy * d.y + hz * d.z) * d.w;
  const bool miss = (tt <= 0.0f) || (aa < 0.0f) || (aa > 1.0f) || (bb < 0.0f) || (bb > 1.0f) || (denom > 0.0f) ||
                    isnan(tt);
  return miss ? kInf : tt;
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
  V3 ln = load3(lq + kQN);
  V3 lv0 = load3(lq + kQV0), lv1 = load3(lq + kQV1), lv2 = load3(lq + kQV2), lv3 = load3(lq + kQV3);
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

// The parts of the scene block in shared memory.
struct SceneConsts {
  const float* cam;
  const float* P;
  const float* quads;
  const float* spheres;
  const float* quadrics;
  const float* mesh_inv;
};

__host__ __device__ inline int scene_floats(const TraceArgs& a, bool mesh) {
  return kCamFloats + kParamFloats + a.nq * kQuadFloats + a.ns * kSphereFloats + a.nqd * kQuadricFloats +
         (mesh ? kMeshFloats : 0);
}

// The scene block in shared memory: every thread of the block copies its
// share, then the block waits (call before any thread returns).  Every
// read in the shape loops is warp-uniform, a broadcast.
template <bool kMesh>
__device__ __forceinline__ SceneConsts load_scene(const TraceArgs& a) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = scene_floats(a, kMesh);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) smem[i] = a.scene[i];
  __syncthreads();
  SceneConsts c;
  c.cam = smem;
  c.P = smem + kCamFloats;
  c.quads = c.P + kParamFloats;
  c.spheres = c.quads + a.nq * kQuadFloats;
  c.quadrics = c.spheres + a.ns * kSphereFloats;
  c.mesh_inv = c.quadrics + a.nqd * kQuadricFloats;
  return c;
}

// What every bounce of a lane reads but never changes.
struct LaneConsts {
  float shape_k;
  int mesh_mat;
  bool mesh_cull;  // double-sided only when untextured TRANSPARENT
  bool lobe;
  int n_obj;
  int def_tex;  // the first textured deferred plane
  const float* lq;  // the light quad (quad NEE)
};

template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured>
__device__ __forceinline__ LaneConsts lane_consts(const TraceArgs& a, const SceneConsts& c) {
  LaneConsts k;
  k.shape_k = c.P[kPShapeK];
  k.mesh_mat = kMesh ? (int)c.mesh_inv[16] : 0;
  k.mesh_cull = k.mesh_mat != kTransparent;
  k.lobe = kTextured && a.metal_roughness_lobe;
  k.n_obj = a.ns + a.nqd + a.nq;
  k.def_tex = (kGrads && kEnv == kEnvHdri) ? 6 : 0;
  k.lq = c.quads + (kNee == kNeeQuad ? a.light_index : 0) * kQuadFloats;
  return k;
}

// A path's state between bounces.
struct Path {
  V3 ro, rd, acc, mask;
  bool spec, sample_light, coat_hit;
  int d_count, prev_mat;
  float sharp;
  uint32_t sx, sy;
};

// Where a lane's per-pixel planes live: entry j of plane p is at
// p * plane + pix (both below 2^31: the wrappers check the pixel count; the
// products are formed in size_t).
struct Home {
  uint32_t pix;
  uint32_t plane;
};

// The blue-noise decision texel ((p + offset) mod 256), channels mod 1.
__device__ __forceinline__ void blue_noise_texel(const float* table, int px, int py, int ox, int oy, float bn[4]) {
  const float* texel = table + (((py + oy) & 255) * 256 + ((px + ox) & 255)) * 4;
  for (int c = 0; c < 4; ++c) bn[c] = texel[c] - floorf(texel[c]);
}

// A fresh path for absolute pixel (px, py) of a film film_w x film_h: the RNG
// seeds, then ray generation with tent AA + thin-lens DoF (4 draws).
__device__ __forceinline__ void start_path(const SceneConsts& c, int px, int py, int film_w, int film_h,
                                           uint32_t frame_u, Path& p) {
  p.sx = frame_u * (uint32_t)px;
  p.sy = (frame_u + 1u) * (uint32_t)py;
  const float* cam = c.cam;
  V3 c_pos = load3(cam + 0), c_right = load3(cam + 3), c_up = load3(cam + 6), c_fwd = load3(cam + 9);
  float ulen = cam[12], vlen = cam[13], aperture = cam[14], focus = cam[15];
  float ox = tent(rng_next(p.sx, p.sy));
  float oy = tent(rng_next(p.sx, p.sy));
  float ndc_x = (((float)px + 0.5f + ox) / (float)film_w) * 2.0f - 1.0f;
  float ndc_y = (((float)py + 0.5f + oy) / (float)film_h) * 2.0f - 1.0f;
  V3 rd = normalize(v3((ndc_x * c_right.x) * ulen + (ndc_y * c_up.x) * vlen + c_fwd.x,
                       (ndc_x * c_right.y) * ulen + (ndc_y * c_up.y) * vlen + c_fwd.y,
                       (ndc_x * c_right.z) * ulen + (ndc_y * c_up.z) * vlen + c_fwd.z));
  float angle = rng_next(p.sx, p.sy) * kTwoPi;
  float radius = rng_next(p.sx, p.sy) * aperture;
  float ca = cosf(angle), sa = sinf(angle), sr = safe_sqrt(radius);
  V3 ap = v3((ca * c_right.x + sa * c_up.x) * sr, (ca * c_right.y + sa * c_up.y) * sr,
             (ca * c_right.z + sa * c_up.z) * sr);
  p.rd = normalize(sub(mul(rd, focus), ap));
  p.ro = add(c_pos, ap);
  p.acc = v3(0.0f, 0.0f, 0.0f);
  p.mask = v3(1.0f, 1.0f, 1.0f);
  p.spec = true;
  p.sample_light = false;
  p.coat_hit = false;
  p.d_count = 0;
  p.prev_mat = -100;
  p.sharp = 0.0f;
}

// The grads mode's per-pixel planes before a path starts: its sg entries 0,
// the deferred miss planes 0, the albedo uvs -kInf (no factor), the
// emissive weight and uv 0.
template <bool kGrads, int kEnv, bool kTextured>
__device__ __forceinline__ void clear_grads(const TraceArgs& a, const Home& h) {
  if constexpr (kGrads) {
    constexpr int def_tex = kEnv == kEnvHdri ? 6 : 0;  // the first textured deferred plane
    const int n_obj = a.ns + a.nqd + a.nq;
    const int n_sg = a.transparent_tint ? n_obj : 2 * n_obj;
    for (int j = 0; j < n_sg; ++j) a.out_sg[(size_t)j * h.plane + h.pix] = 0.0f;
    if constexpr (kEnv == kEnvHdri) {
      for (int j = 0; j < 6; ++j) a.out_def[(size_t)j * h.plane + h.pix] = 0.0f;
    }
    if constexpr (kTextured) {
      for (int j = 0; j < 2 * a.bounces; ++j) a.out_def[(size_t)(def_tex + j) * h.plane + h.pix] = -kInf;
      for (int j = 0; j < 5; ++j) a.out_def[(size_t)(def_tex + 2 * a.bounces + j) * h.plane + h.pix] = 0.0f;
    }
  }
}

// The first-hit records for the edge detector, kept in registers: set at
// bounce 0 (normal, color, id of a hit) and, after a mirror, at bounce 1
// (normal, id).
struct Records {
  V3 normal, color;
  float id;
  bool after_metal;  // bounce 1 rewrote normal and id
};

__device__ __forceinline__ Records no_records() {
  return Records{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), -kInf, false};
}

// Bounces [lo, hi) of path p; returns false when the path ended in them (its
// color is then p.acc and its flag p.sharp).  frame_f is the lane's frame
// counter, bn its blue-noise texel; h locates its grads-mode planes.
template <bool kGrads, int kEnv, int kNee, bool kMesh, bool kTextured>
__device__ __forceinline__ bool trace_bounces(const TraceArgs& a, const SceneConsts& c, const LaneConsts& k, Path& p,
                                              Records& rec, const float bn[4], int lo, int hi, float frame_f,
                                              const Home& h) {
  static_assert(kMesh || !kTextured, "a textured configuration walks a mesh");
  constexpr bool kSky = kEnv == kEnvSky;
  constexpr bool kDeferMiss = kGrads && kEnv == kEnvHdri;  // the environment's radiance composed outside
  constexpr bool kDeferTex = kGrads && kTextured;  // the albedo factors and the emission composed outside
  const int nq = a.nq, ns = a.ns, nqd = a.nqd, bounces = a.bounces;
  const int n_obj = k.n_obj, def_tex = k.def_tex;
  const float* P = c.P;
  float* __restrict__ out_def = a.out_def;
  float* __restrict__ out_sg = a.out_sg;
  auto put_def = [&](int j, float v) { out_def[(size_t)j * h.plane + h.pix] = v; };
  auto put_def3 = [&](int j, V3 v) {
    put_def(j, v.x);
    put_def(j + 1, v.y);
    put_def(j + 2, v.z);
  };
  // the entry of the object hit (a mesh hit, id n_obj, has no plane)
  auto add_sg = [&](int obj, float v) {
    if constexpr (kGrads) {
      if (obj < n_obj) out_sg[(size_t)obj * h.plane + h.pix] += v;
    }
  };
  auto add_beer = [&](int obj, float v) {
    if constexpr (kGrads) {
      if (obj < n_obj) out_sg[(size_t)(n_obj + obj) * h.plane + h.pix] += v;
    }
  };
  V3 ro = p.ro, rd = p.rd;
  bool alive = true;
  for (int bounce = lo; bounce < hi; ++bounce) {
    // ---- closest hit: spheres, quadrics, quads; strict < keeps ties ------
    float t_best = kInf;
    V3 nrm = v3(0.0f, 0.0f, 0.0f), hc = v3(0.0f, 0.0f, 0.0f);
    int mat = -100;
    float hid = -kInf;
    int hobj = -1;
    float hu = 0.0f, hv = 0.0f;  // a textured mesh hit's UV
    for (int s = 0; s < ns; ++s) {
      const float* m = c.spheres + s * kSphereFloats;
      const Mat34 M = ld_mat(m);
      QHit hit = q_sphere(xform_point(M, ro), xform_dir(M, rd));
      if (hit.t < t_best) {
        t_best = hit.t;
        nrm = normalize(xform_normal(M, normalize(hit.n)));
        hc = load3(m + 16);
        mat = (int)m[19];
        hid = (float)s;
        hobj = s;
      }
    }
    for (int i = 0; i < nqd; ++i) {
      const float* m = c.quadrics + i * kQuadricFloats;
      const Mat34 M = ld_mat(m);
      QHit hit = quadric_intersect(i, xform_point(M, ro), xform_dir(M, rd), k.shape_k);
      if (hit.t < t_best) {
        t_best = hit.t;
        nrm = normalize(xform_normal(M, normalize(hit.n)));
        hc = load3(m + 16);
        mat = (int)m[19];
        hid = (float)(ns + i);
        hobj = ns + i;
      }
    }
    auto take_quad = [&](float t, const float* Q, int q) {
      t_best = t;
      const float4 n = ld4(Q + kQN);
      nrm = v3(n.x, n.y, n.z);
      hc = load3(Q + kQColor);
      mat = (int)Q[kQMat];
      hid = (float)(ns + nqd + q);
      hobj = ns + nqd + q;
    };
    if (a.fast_quads) {  // every quad is a parallelogram
      for (int q = 0; q < nq; ++q) {
        const float* Q = c.quads + q * kQuadFloats;
        const float t = parallelogram_t(Q, ro, rd);
        if (t < t_best) take_quad(t, Q, q);
      }
    } else {  // the two triangle fans (v0, v1, v2) and (v0, v2, v3)
      for (int q = 0; q < nq; ++q) {
        const float* Q = c.quads + q * kQuadFloats;
        V3 v0 = load3(Q + kQV0), v1 = load3(Q + kQV1), v2 = load3(Q + kQV2), v3_ = load3(Q + kQV3);
        const float t = fminf(triangle_t(v0, v1, v2, ro, rd), triangle_t(v0, v2, v3_, ro, rd));
        if (t < t_best) take_quad(t, Q, q);
      }
    }
    if constexpr (kMesh) {  // the model: object space, the BVH walk, the winner's normal
      const V3 ro_o = xform_point(c.mesh_inv, ro), rd_o = xform_dir(c.mesh_inv, rd);  // rd_o unnormalized
      const MeshHit mh = bvh_closest(a.mesh_nodes, a.mesh_tris, ro_o, rd_o, k.mesh_cull);
      if (mh.t < t_best) {
        t_best = mh.t;
        V3 n_o = mesh_normal(a.mesh_normals, mh);
        if constexpr (kTextured) {  // the normal map perturbs the object-space normal
          if (!p.sample_light) {  // a shadow ray ends here: no output reads its UV or its normal
            mesh_uv(a.mesh_uvs, mh.tri, mh.u, mh.v, &hu, &hv);
            if (a.tex[kTexNormal]) n_o = perturb_normal(n_o, tex_map(a, kTexNormal), hu, hv);
          }
        }
        nrm = normalize(xform_normal(c.mesh_inv, n_o));
        hc = v3(1.0f, 1.0f, 1.0f);
        mat = k.mesh_mat;
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
            put_def3(0, p.mask);
            put_def3(3, rd);
          } else {
            p.acc = env;
          }
          p.sharp = 1.01f;
        } else {  // first-match case chain c2 > c3 > c4 > c5
          const float sun_cos = dot(rd, load3(P + kPSun));
          bool c2 = p.d_count == 0 && p.spec;
          bool c3 = p.sample_light;
          bool c4 = p.d_count == 1 && p.prev_mat == kTransparent && p.spec && (kSky || bounce < 3);
          bool c5 = p.d_count > 0;
          // clip the sun disc; env NEE already covers the whole map at a diffuse vertex
          const float sun_clip = kNee == kNeeEnv ? 0.0f : (sun_cos < 0.99f ? 1.0f : 0.0f);
          if constexpr (kDeferMiss) {  // the miss throughput: the weight the environment's radiance takes
            put_def3(0, (c2 || c3 || c4) ? p.mask : c5 ? mul(p.mask, sun_clip) : v3(0.0f, 0.0f, 0.0f));
            put_def3(3, rd);
          } else {
            V3 lit = mul3(p.mask, env);
            if (c2 || c3 || c4) {
              p.acc = lit;
            } else if (c5) {
              p.acc = mul(lit, sun_clip);
            } else {
              p.acc = v3(0.0f, 0.0f, 0.0f);
            }
          }
          if (c2) p.sharp = 1.01f;
          if (!kSky && !c2 && !c3 && c4 && sun_cos > 0.99f) p.sharp = 1.01f;
        }
      }
      alive = false;
      break;
    }

    V3 n = normalize(nrm);
    V3 nl = dot(n, rd) < 0.0f ? n : neg(n);
    V3 x = add(ro, mul(rd, t_best));

    // ---- first-hit records for the edge detector -------------------------
    if (bounce == 0) {
      rec.normal = nl;
      rec.color = hc;
      rec.id = hid;
    } else if (bounce == 1 && p.prev_mat == kMetal) {
      rec.normal = nl;
      rec.id = hid;
      rec.after_metal = true;
    }

    // ---- a light hit ends the path (quad-light NEE only) -----------------
    if constexpr (kNee == kNeeQuad) {
      if (mat == kLight) {
        if (p.d_count == 0) p.sharp = 1.01f;
        if (p.spec || p.sample_light) {
          p.acc = mul3(p.mask, hc);
          add_sg(hobj, 1.0f);
        }
        alive = false;
        break;
      }
    }
    // ---- so does a failed shadow ray -------------------------------------
    if (p.sample_light) {
      alive = false;
      break;
    }

    // ---- a textured mesh's PBR texels: albedo, emission, class, roughness
    float mr_g = 0.0f;  // the METAL lobe's roughness
    bool pbr_hit = false;
    if constexpr (kTextured) {
      if (mat == kPbr) {
        pbr_hit = true;
        // each map is loaded and combined in turn (loading every tap first held more registers and ran
        // slower): the albedo (composed outside in the grads mode), the emissive map on a specular path
        // only (an emissive texel ends only a specular path), the metallic-roughness map
        const bool glow = a.tex[kTexEmissive] != nullptr && p.spec;
        if constexpr (kDeferTex) {
          hc = v3(1.0f, 1.0f, 1.0f);  // the albedo factor is composed outside
        } else {
          hc = combine_linear(fetch_taps(tex_map(a, kTexAlbedo), hu, hv));
        }
        if (glow) {  // an emissive texel ends a specular path, tested before the class
          const V3 em = combine_linear(fetch_taps(tex_map(a, kTexEmissive), hu, hv));
          if (fmaxf(fmaxf(em.x, em.y), em.z) > 0.01f) {
            p.sharp = 1.01f;
            if constexpr (kDeferTex) {  // the emission is composed outside: its weight and uv
              put_def3(def_tex + 2 * bounces, p.mask);
              put_def(def_tex + 2 * bounces + 3, hu);
              put_def(def_tex + 2 * bounces + 4, hv);
            } else {
              p.acc = mul3(p.mask, em);
            }
            alive = false;
            break;
          }
        }
        mat = kDiffuse;
        if (a.tex[kTexMetalRough]) {  // roughness (G): CLEARCOAT; metalness (B) overrides it: METAL
          const Texels mr = fetch_taps(tex_map(a, kTexMetalRough), hu, hv);
          mr_g = srgb_linear(tap_channel(mr.c00.y, mr.c01.y, mr.c10.y, mr.c11.y, mr));
          if (mr_g > 0.01f) mat = kClearcoat;
          if (srgb_linear(tap_channel(mr.c00.z, mr.c01.z, mr.c10.z, mr.c11.z, mr)) > 0.01f) mat = kMetal;
        }
      }
    }

    // ---- this bounce's fixed-schedule draws (all consumed) --------------
    const float gate1 = bn[(2 * bounce) & 3];
    const float gate2 = bn[(2 * bounce + 1) & 3];
    const float hem_r = rng_next(p.sx, p.sy);
    const float hem_p = rng_next(p.sx, p.sy);
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, lc = 0.0f, lp = 0.0f;
    if constexpr (kNee == kNeeQuad) {  // quad.x, quad.y, quad.z
      q0 = rng_next(p.sx, p.sy);
      q1 = rng_next(p.sx, p.sy);
      q2 = rng_next(p.sx, p.sy);
    }
    if (kNee != kNeeQuad || k.lobe) {  // lobe.cos, lobe.phi
      lc = rng_next(p.sx, p.sy);
      lp = rng_next(p.sx, p.sy);
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
        return quad_light(k.lq, x, nl, q0, q1, q2, w);
      }
    };

    const float eps = a.eps;
    if (mat == kDiffuse) {
      int dc = p.d_count + 1;
      bool go_indirect = (dc <= a.diffuse_indirect_max) && (gate1 < 0.5f);
      V3 md = mul3(p.mask, hc);
      if (go_indirect) {
        rd = cos_hemisphere(nl, hem_r, hem_p);
        p.mask = md;
      } else {
        float w;
        rd = nee(&w);
        p.mask = mul(md, w);
      }
      ro = add(x, mul(nl, eps));
      p.spec = false;
      p.sample_light = !go_indirect;
      p.d_count = dc;
      add_sg(hobj, 1.0f);
      albedo_factor();
    } else if (mat == kMetal) {
      p.mask = mul3(p.mask, hc);
      add_sg(hobj, 1.0f);
      albedo_factor();
      rd = reflect(rd, nl);
      if (k.lobe) rd = roughness_lobe(rd, mr_g, lc, lp);
      ro = add(x, mul(nl, eps));
      p.sample_light = false;
    } else if (mat == kTransparent) {
      float ratio;
      float re = fresnel(rd, n, 1.0f, 1.5f, &ratio);
      float tr = 1.0f - re;
      float pr = 0.25f + 0.5f * re;
      if (gate1 < pr) {
        p.mask = mul(p.mask, re / pr);
        rd = reflect(rd, nl);
        ro = add(x, mul(nl, eps));
      } else {
        V3 absorb = v3(1.0f, 1.0f, 1.0f);
        if (a.transparent_tint) {
          absorb = hc;
          add_sg(hobj, 1.0f);
        } else if (dot(n, rd) >= 0.0f) {  // inside: Beer-Lambert on exit
          absorb = v3(expf(logf(clampf(hc.x, 0.01f, 0.99f)) * 0.01f * t_best),
                      expf(logf(clampf(hc.y, 0.01f, 0.99f)) * 0.01f * t_best),
                      expf(logf(clampf(hc.z, 0.01f, 0.99f)) * 0.01f * t_best));
          add_beer(hobj, 0.01f * t_best);
        }
        float f = tr / (1.0f - pr);
        p.mask = v3((p.mask.x * absorb.x) * f, (p.mask.y * absorb.y) * f, (p.mask.z * absorb.z) * f);
        // GLSL refract(rd, nl, ratio); 0 on total internal reflection
        float cosi = dot(nl, rd);
        float kk = 1.0f - ratio * ratio * (1.0f - cosi * cosi);
        float s = ratio * cosi + sqrtf(fmaxf(kk, 0.0f));
        rd = kk < 0.0f ? v3(0.0f, 0.0f, 0.0f) : sub(mul(rd, ratio), mul(nl, s));
        ro = sub(x, mul(nl, eps));
        p.spec = p.spec || (p.d_count == 1);
      }
      p.sample_light = false;
      p.sharp = (p.d_count == 0 && !p.coat_hit && !a.camera_is_moving) ? 1.01f : (p.d_count > 0 ? 0.0f : -1.0f);
    } else if (mat == kClearcoat) {
      float unused_ratio;
      float re = fresnel(rd, nl, 1.0f, 1.4f, &unused_ratio);
      float tr = 1.0f - re;
      float pr = 0.25f + 0.5f * re;
      if (gate1 < pr) {
        p.mask = mul(p.mask, re / pr);
        rd = reflect(rd, nl);
        p.sample_light = false;
        p.sharp = p.d_count == 0 ? (frame_f > 500.0f ? 1.01f : -1.0f) : 0.0f;
      } else {
        int dc = p.d_count + 1;
        bool go_indirect = (dc <= a.diffuse_indirect_max) && (gate2 < 0.5f);
        float f = tr / (1.0f - pr);
        V3 mb = v3((p.mask.x * f) * hc.x, (p.mask.y * f) * hc.y, (p.mask.z * f) * hc.z);
        if (go_indirect) {
          rd = cos_hemisphere(nl, hem_r, hem_p);
          p.mask = mb;
        } else {
          float w;
          rd = nee(&w);
          p.mask = mul(mb, w);
        }
        // `bounce < 3` guards against noisy coat-after-glass pixels
        p.sample_light = !go_indirect && (bounce < 3);
        p.spec = false;
        p.d_count = dc;
        p.sharp = 0.0f;
        add_sg(hobj, 1.0f);
        albedo_factor();
      }
      ro = add(x, mul(nl, eps));
      p.coat_hit = true;
    } else {
      alive = false;  // unknown material ids (and LIGHT without quad NEE) end the path
      break;
    }
    p.prev_mat = mat;
  }
  p.ro = ro;
  p.rd = rd;
  return alive;
}

}  // namespace bpt
