// Float3 helpers shared by the megakernel and its headers.  Every helper
// mirrors bpt_tpu_torch/core/vecmath.py operation for operation: dot
// products sum in (x + y) + z order, normalize multiplies by 1 / sqrt.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bpt {

constexpr float kInf = 1.0e6f;
constexpr float kTwoPi = 6.28318530717958648f;

// The layout of the parameter pack (kernels/launch_args.py pack_params):
// shape_k, the sun direction, the sun-only sky terms, the sun lobe, the
// sun-NEE weight scale, the sky's per-channel constants, and the HDRI
// map's exposure, height and width.
constexpr int kParamFloats = 24;  // 2 pads: the next part starts on a 16-byte boundary
constexpr int kPShapeK = 0, kPSun = 1, kPSunE = 4, kPGamma = 5, kPBlend = 6, kPLobeExp = 7, kPLobeRough = 8,
              kPSunWeight = 9, kPRayleigh = 10, kPMie = 13, kPExtinction = 16, kPExposure = 19, kPHdrH = 20,
              kPHdrW = 21;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
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
// ro + rd * t
__device__ __forceinline__ V3 at(V3 ro, V3 rd, float t) { return add(ro, mul(rd, t)); }
// GLSL reflect: I - 2*dot(N,I)*N
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, mul(n, 2.0f * dot(n, i))); }
// The reference's cross-trick ONB about w.
__device__ __forceinline__ void onb(V3 w, V3* u, V3* v) {
  V3 helper = fabsf(w.y) < 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  *u = normalize(cross(helper, w));
  *v = cross(w, *u);
}

// A direction in the specular lobe about w from the draws (lc, lp), for sun
// NEE and the metal roughness lobe: cos(theta) = lc^exponent, then
// normalize(mix(w, lobe, rough)).
__device__ __forceinline__ V3 lobe_dir(V3 w, float exponent, float rough, float lc, float lp) {
  const float cos_t = powf(lc, exponent);
  const float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
  const float phi = lp * kTwoPi;
  V3 u, v;
  onb(w, &u, &v);
  const float a = cosf(phi) * sin_t, b = sinf(phi) * sin_t;
  const V3 lobe = add(add(mul(u, a), mul(v, b)), mul(w, cos_t));
  return normalize(add(w, mul(sub(lobe, w), rough)));
}

}  // namespace bpt
