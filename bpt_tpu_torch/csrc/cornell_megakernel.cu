// Cornell-family path-tracing megakernel for Hopper (sm_90a).
//
// Replaces: bpt_tpu/kernels/megakernel.py::_make_kernel, launched through
// _pallas_forward (monolithic mode), in its Cornell configuration: quads +
// matrix-instanced unit spheres, env "none", quad-light next-event
// estimation, with param_grads off (entry bpt_cornell_trace) and on
// (entry bpt_cornell_trace_grads).  It computes what the plain PyTorch
// integrator (bpt_tpu_torch/integrator/radiance.py, a mirror of the JAX
// wavefront) computes, draw for draw: ray generation with tent AA and
// thin-lens DoF (4 hash draws), then up to `bounces` bounces with the fixed
// per-bounce schedule gate1, gate2 (blue noise) and hem.r, hem.phi, quad.x,
// quad.y, quad.z (hash).
//
// The grads mode (template argument kGrads) writes the same 11 planes plus
// the path-replay planes out_sg, (n_sg, H, W) planes-major, n_obj = ns + nq
// objects in hit-id order (spheres, then quads): plane j counts the bounces
// whose throughput factor is linear in object j's color (diffuse, metal, the
// clearcoat base, a light hit that contributes, and refraction when
// transparent_tint is on); with the tint off, plane n_obj + j sums 0.01 * t
// over the refractions that leave glass object j, in bounce order (the
// Beer-Lambert exponent).  The gate is the kernel's own absorption test
// dot(n, rd) >= 0, so plane and absorption agree even at 0.  The backward
// (kernels/megakernel.py, _PathReplay) turns the planes into gradients.
//
// What bounds it on this card: per-thread arithmetic and latency (the
// intersection of every ray with 6 quads as 12 Moller-Trumbore triangles and
// 2 instanced spheres, plus sin/cos/exp/log and IEEE divides and square
// roots), with warp divergence across the four material branches.  It moves
// almost no memory: a few hundred floats of scene constants, one blue-noise
// texel and 11 output floats per pixel.  The grads mode adds n_sg * 4 bytes
// per pixel: 64 B, i.e. 64 MB per 1024^2 frame, for the Cornell box's 8
// objects with the tint off (16 planes), which by itself is ~20 us of HBM
// time at 3.35 TB/s.
//
// What the design does about that: one thread per pixel with its whole path
// state in registers; the scene constants sit in shared memory, loaded once
// per block; the blue-noise texel is gathered directly from the 256x256x4
// table (the TPU kernel needed host-rolled planes because Mosaic has no
// per-lane gather).  Unlike the TPU's masked lockstep, a thread leaves the
// bounce loop once its path is dead (a dead lane's records never change
// again) and evaluates only its own material's branch; every draw of a
// bounce is still consumed, so the random streams stay aligned with the
// plain version.  Making it fast (persistent blocks, material sorting) is
// later work.
//
// The grads planes: a thread cannot hold n_obj accumulators (the wrapper
// allows 256 quads + 64 spheres), but a path touches at most `bounces`
// entries of its own pixel's planes.  So each thread first writes zeros to
// its pixel's n_sg entries (the planes' only full write, coalesced across the
// warp: n_sg * 4 B per pixel, no separate memset launch), then
// read-modify-writes the entry of the object it hit on each bounce that
// counts: at most `bounces` further 4-byte loads and stores per pixel, which
// stay in L2.  One thread owns one pixel, so no atomics are needed.
//
// Numerics: no fast math; 1/sqrtf rather than rsqrtf; dot products summed
// in (x + y) + z order, as the plain version does.  Built with --fmad=false:
// with nvcc's default FMA contraction, 17 (METAL right sphere) and 31
// (TRANSPARENT) of the 1024x1024 first-hit normals missed the parity
// tolerance (rtol 1e-3, atol 1e-4) against the plain version on an H100; without it the kernel's outputs are bit-equal
// to the plain version's on the card.  Restoring FMA is a later
// performance change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1.0e6f;
constexpr float kTwoPi = 6.28318530717958648f;
constexpr uint32_t kMagic = 1103515245u;

constexpr int kLight = 0;
constexpr int kDiffuse = 1;
constexpr int kTransparent = 2;
constexpr int kMetal = 3;
constexpr int kClearcoat = 4;

// Packed scene layouts (bpt_tpu_torch/kernels/megakernel.py pack_scene /
// pack_camera): cam = pos3 right3 up3 fwd3 ulen vlen aperture focus;
// quad row (20) = n3 v0 v1 v2 v3 color3 mat pad; sphere row (21) =
// inverse 4x4 row-major (16) color3 mat pad.
constexpr int kCamFloats = 16;
constexpr int kQuadFloats = 20;
constexpr int kSphereFloats = 21;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize(V3 v) {
  return mul(v, 1.0f / sqrtf(fmaxf(dot(v, v), 1e-20f)));
}
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(x > 1e-20f ? x : 1e-20f); }
__device__ __forceinline__ float safe_inv(float x) {
  float ax = fabsf(x);
  return (x < 0.0f ? -1.0f : 1.0f) / (ax > 1e-12f ? ax : 1e-12f);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
// GLSL reflect: I - 2*dot(N,I)*N
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, mul(n, 2.0f * dot(n, i))); }

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
  V3 helper = fabsf(nl.y) < 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 u = normalize(cross(helper, nl));
  V3 v = cross(nl, u);
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

template <bool kGrads>
__global__ void cornell_trace_kernel(const float* __restrict__ cam_g, const float* __restrict__ quads_g, int nq,
                                     const float* __restrict__ spheres_g, int ns,
                                     const float* __restrict__ blue_noise, int bn_ox, int bn_oy, int width,
                                     int height, int bounces, float eps, int light_index, int diffuse_indirect_max,
                                     int camera_is_moving, int transparent_tint, uint32_t frame_u, float frame_f,
                                     float* __restrict__ out_color, float* __restrict__ out_normal,
                                     float* __restrict__ out_ocolor, float* __restrict__ out_oid,
                                     float* __restrict__ out_sharp, float* __restrict__ out_sg) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* quads = cam + kCamFloats;
  float* spheres = quads + nq * kQuadFloats;
  const int n_const = kCamFloats + nq * kQuadFloats + ns * kSphereFloats;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_const; i += blockDim.x * blockDim.y) {
    float v;
    if (i < kCamFloats) {
      v = cam_g[i];
    } else if (i < kCamFloats + nq * kQuadFloats) {
      v = quads_g[i - kCamFloats];
    } else {
      v = spheres_g[i - kCamFloats - nq * kQuadFloats];
    }
    smem[i] = v;
  }
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const int pix = py * width + px;

  // ---- grads mode: zero this pixel's path-replay entries -----------------
  const size_t plane = (size_t)width * (size_t)height;
  const int n_obj = ns + nq;
  if constexpr (kGrads) {
    const int n_sg = transparent_tint ? n_obj : 2 * n_obj;
    for (int j = 0; j < n_sg; ++j) out_sg[j * plane + pix] = 0.0f;
  }
  auto add_sg = [&](int j, float v) {
    if constexpr (kGrads) out_sg[j * plane + pix] += v;
  };

  // ---- RNG seeds from absolute pixel coordinates -------------------------
  uint32_t sx = frame_u * (uint32_t)px;
  uint32_t sy = (frame_u + 1u) * (uint32_t)py;

  // ---- blue-noise decision texel: ((p + offset) mod 256), channels mod 1 --
  const float* texel = blue_noise + (((py + bn_oy) & 255) * 256 + ((px + bn_ox) & 255)) * 4;
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
  const float* lq = quads + light_index * kQuadFloats;

  for (int bounce = 0; bounce < bounces; ++bounce) {
    // ---- closest hit: spheres first, then quads; strict < keeps ties -----
    float t_best = kInf;
    V3 nrm = v3(0.0f, 0.0f, 0.0f), hc = v3(0.0f, 0.0f, 0.0f);
    int mat = -100;
    float hid = -kInf;
    int hobj = -1;
    for (int s = 0; s < ns; ++s) {
      const float* m = spheres + s * kSphereFloats;
      V3 o = xform_point(m, ro), d = xform_dir(m, rd);
      float a = dot(d, d), b = 2.0f * dot(d, o), c = dot(o, o) - 1.0f;
      float inv_a = safe_inv(a);
      b = b * inv_a;
      c = c * inv_a;
      float nhb = -b * 0.5f;
      float u2 = nhb * nhb - c;
      bool real = u2 >= 0.0f;
      float u = safe_sqrt(u2);
      nhb = real ? nhb : 0.0f;
      u = real ? u : 0.0f;
      float t0 = nhb - u, t1 = nhb + u;
      float t;
      V3 n_obj;
      if (t0 > 0.0f) {
        t = t0;
        n_obj = mul(add(o, mul(d, t0)), 2.0f);
      } else if (t1 > 0.0f) {
        t = t1;
        n_obj = mul(add(o, mul(d, t1)), 2.0f);
      } else {
        t = kInf;
        n_obj = v3(0.0f, 1.0f, 0.0f);
      }
      if (t < t_best) {
        t_best = t;
        nrm = normalize(xform_normal(m, normalize(n_obj)));
        hc = load3(m + 16);
        mat = (int)m[19];
        hid = (float)s;
        hobj = s;
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
        hid = (float)(ns + q);
        hobj = ns + q;
      }
    }
    if (t_best >= kInf) break;  // env "none": a miss is black and ends the path

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

    // ---- a light hit ends the path -----------------------------------------
    if (mat == kLight) {
      if (d_count == 0) sharp = 1.01f;
      if (spec || sample_light) {
        acc = v3(mask.x * hc.x, mask.y * hc.y, mask.z * hc.z);
        add_sg(hobj, 1.0f);
      }
      break;
    }
    // ---- so does a failed shadow ray -------------------------------------
    if (sample_light) break;

    // ---- this bounce's fixed-schedule draws (all consumed) --------------
    const float gate1 = bn[(2 * bounce) & 3];
    const float gate2 = bn[(2 * bounce + 1) & 3];
    const float hem_r = rng_next(sx, sy);
    const float hem_p = rng_next(sx, sy);
    const float qx = rng_next(sx, sy);
    const float qy = rng_next(sx, sy);
    const float qz = rng_next(sx, sy);

    if (mat == kDiffuse) {
      int dc = d_count + 1;
      bool go_indirect = (dc <= diffuse_indirect_max) && (gate1 < 0.5f);
      V3 md = v3(mask.x * hc.x, mask.y * hc.y, mask.z * hc.z);
      if (go_indirect) {
        rd = cos_hemisphere(nl, hem_r, hem_p);
        mask = md;
      } else {
        float w;
        rd = quad_light(lq, x, nl, qx, qy, qz, &w);
        mask = mul(md, w);
      }
      ro = add(x, mul(nl, eps));
      spec = false;
      sample_light = !go_indirect;
      d_count = dc;
      add_sg(hobj, 1.0f);
    } else if (mat == kMetal) {
      mask = v3(mask.x * hc.x, mask.y * hc.y, mask.z * hc.z);
      add_sg(hobj, 1.0f);
      rd = reflect(rd, nl);
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
          add_sg(n_obj + hobj, 0.01f * t_best);
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
      sharp = (d_count == 0 && !coat_hit && !camera_is_moving) ? 1.01f : (d_count > 0 ? 0.0f : -1.0f);
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
          rd = quad_light(lq, x, nl, qx, qy, qz, &w);
          mask = mul(mb, w);
        }
        // `bounce < 3` guards against noisy coat-after-glass pixels
        sample_light = !go_indirect && (bounce < 3);
        spec = false;
        d_count = dc;
        sharp = 0.0f;
        add_sg(hobj, 1.0f);
      }
      ro = add(x, mul(nl, eps));
      coat_hit = true;
    } else {
      break;  // unknown material ids end the path
    }
    prev_mat = mat;
  }

  out_color[3 * pix + 0] = fmaxf(acc.x, 0.0f);
  out_color[3 * pix + 1] = fmaxf(acc.y, 0.0f);
  out_color[3 * pix + 2] = fmaxf(acc.z, 0.0f);
  out_normal[3 * pix + 0] = obj_normal.x;
  out_normal[3 * pix + 1] = obj_normal.y;
  out_normal[3 * pix + 2] = obj_normal.z;
  out_ocolor[3 * pix + 0] = obj_color.x;
  out_ocolor[3 * pix + 1] = obj_color.y;
  out_ocolor[3 * pix + 2] = obj_color.z;
  out_oid[pix] = obj_id;
  out_sharp[pix] = sharp;
}

template <bool kGrads>
int launch(const float* cam, const float* quads, int nq, const float* spheres, int ns, const float* blue_noise,
           int bn_ox, int bn_oy, int width, int height, int bounces, float eps, int light_index,
           int diffuse_indirect_max, int camera_is_moving, int transparent_tint, unsigned int frame_u, float frame_f,
           float* out_color, float* out_normal, float* out_ocolor, float* out_oid, float* out_sharp, float* out_sg,
           void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  const size_t smem = sizeof(float) * (kCamFloats + nq * kQuadFloats + ns * kSphereFloats);
  cornell_trace_kernel<kGrads><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, quads, nq, spheres, ns, blue_noise, bn_ox, bn_oy, width, height, bounces, eps, light_index,
      diffuse_indirect_max, camera_is_moving, transparent_tint, frame_u, frame_f, out_color, out_normal, out_ocolor,
      out_oid, out_sharp, out_sg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bpt_cornell_trace(const float* cam, const float* quads, int nq, const float* spheres, int ns,
                                 const float* blue_noise, int bn_ox, int bn_oy, int width, int height,
                                 int bounces, float eps, int light_index, int diffuse_indirect_max,
                                 int camera_is_moving, int transparent_tint, unsigned int frame_u, float frame_f,
                                 float* out_color, float* out_normal, float* out_ocolor, float* out_oid,
                                 float* out_sharp, void* stream) {
  return launch<false>(cam, quads, nq, spheres, ns, blue_noise, bn_ox, bn_oy, width, height, bounces, eps,
                       light_index, diffuse_indirect_max, camera_is_moving, transparent_tint, frame_u, frame_f,
                       out_color, out_normal, out_ocolor, out_oid, out_sharp, nullptr, stream);
}

// As bpt_cornell_trace, plus the (n_sg, H, W) path-replay planes out_sg,
// n_sg = ns + nq with transparent_tint and 2 * (ns + nq) without.
extern "C" int bpt_cornell_trace_grads(const float* cam, const float* quads, int nq, const float* spheres, int ns,
                                       const float* blue_noise, int bn_ox, int bn_oy, int width, int height,
                                       int bounces, float eps, int light_index, int diffuse_indirect_max,
                                       int camera_is_moving, int transparent_tint, unsigned int frame_u,
                                       float frame_f, float* out_color, float* out_normal, float* out_ocolor,
                                       float* out_oid, float* out_sharp, float* out_sg, void* stream) {
  return launch<true>(cam, quads, nq, spheres, ns, blue_noise, bn_ox, bn_oy, width, height, bounces, eps,
                      light_index, diffuse_indirect_max, camera_is_moving, transparent_tint, frame_u, frame_f,
                      out_color, out_normal, out_ocolor, out_oid, out_sharp, out_sg, stream);
}
