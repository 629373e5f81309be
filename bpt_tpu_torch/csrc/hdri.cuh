// The HDRI environment of the megakernel: the equirect lookup on a miss and
// the luminance-CDF environment sample for next-event estimation.
//
// Replaces, in bpt_tpu/kernels/megakernel.py: the deferred miss planes that
// the TPU kernel writes for an outside Get_HDR_Color composition
// (_compose_result) and the inverse-CDF draw planes precomputed per bounce
// outside the kernel (_env_nee_planes).  Both exist because Mosaic has no
// per-lane gather; here each thread gathers its own texels and CDF entries.
// hdr_color mirrors bpt_tpu_torch/env.py get_hdr_color and env_nee its
// sample_env_cdf plus the weight of integrator/radiance.py, operation for
// operation: atan2f / acosf, the clamp, floorf, the floored modulo in x
// (x0 = -1 wherever u * w - 0.5 < 0: C's % is not floored, so the index
// wraps explicitly), the bilinear weights in the plain version's order, the
// exposure; the row as the lower bound of u1 in row_cdf (torch.searchsorted,
// side left), the column by exactly ceil(log2 W) halving steps over
// col_cdf[row] (never materialised), the direction from sinf / cosf and the
// weight cos / (pi max(pdf, 1e-8)).  pi enters as a float32 constant, as
// PyTorch converts math.pi.
//
// What bounds it on this card: a miss gathers 4 texels (12 floats) of the
// map; an env-NEE draw runs about log2 H + log2 W dependent loads in the
// CDFs.  The map and the CDFs are small (a 512x256 map: 1.5 MB, the CDFs
// 1 MB) and stay in the L2 cache; latency, not bytes, is the cost.
#pragma once

#include "vec.cuh"

namespace bpt {

constexpr float kPiF = 3.14159265358979323846f;

__device__ __forceinline__ V3 hdr_color(const float* __restrict__ img, int h, int w, V3 rd, float exposure) {
  float u = atan2f(rd.x, rd.z) * (float)0.15915494309 + 0.5f;
  float v = acosf(clampf(-rd.y, -1.0f, 1.0f)) * (float)0.31830988618379067;
  float x = u * (float)w - 0.5f;
  float y = v * (float)h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int x0i = (int)x0 % w;
  if (x0i < 0) x0i += w;  // floored modulo, as jnp.mod / torch.remainder
  int x1i = (x0i + 1) % w;
  int y0i = min(max((int)y0, 0), h - 1);
  int y1i = min(max(y0i + 1, 0), h - 1);
  const float* c00 = img + 3 * (y0i * w + x0i);
  const float* c01 = img + 3 * (y0i * w + x1i);
  const float* c10 = img + 3 * (y1i * w + x0i);
  const float* c11 = img + 3 * (y1i * w + x1i);
  float out[3];
  for (int c = 0; c < 3; ++c) {
    float top = __ldg(c00 + c) * (1.0f - fx) + __ldg(c01 + c) * fx;
    float bottom = __ldg(c10 + c) * (1.0f - fx) + __ldg(c11 + c) * fx;
    out[c] = (top * (1.0f - fy) + bottom * fy) * exposure;
  }
  return v3(out[0], out[1], out[2]);
}

// A direction drawn from the environment's luminance x sin(theta) CDFs with
// the draws (u1, u2), and its weight max(0, dot(dir, nl)) / (pi max(pdf, 1e-8)).
__device__ __forceinline__ V3 env_nee(const float* __restrict__ row_cdf, const float* __restrict__ col_cdf,
                                      const float* __restrict__ pdf, int h, int w, V3 nl, float u1, float u2,
                                      float* weight) {
  int lo = 0, hi = h;
  while (lo < hi) {  // the first row whose cdf >= u1
    const int mid = (lo + hi) >> 1;
    if (__ldg(row_cdf + mid) < u1) lo = mid + 1; else hi = mid;
  }
  const int row = min(lo, h - 1);
  const float* crow = col_cdf + row * w;
  int steps = 1;
  while ((1 << steps) < w) ++steps;  // ceil(log2 W), at least 1
  int clo = 0, chi = w;
  for (int s = 0; s < steps; ++s) {
    const int mid = (clo + chi) >> 1;
    const bool go_hi = __ldg(crow + min(mid, w - 1)) < u2;
    clo = go_hi ? mid + 1 : clo;
    chi = go_hi ? chi : mid;
  }
  const int col = min(clo, w - 1);
  const float vv = ((float)row + 0.5f) / (float)h;
  const float uu = ((float)col + 0.5f) / (float)w;
  const float theta = vv * kPiF;
  const float phi = ((uu - 0.5f) * 2.0f) * kPiF;
  const float sin_t = sinf(theta);
  const V3 d = v3(sin_t * sinf(phi), -cosf(theta), sin_t * cosf(phi));
  *weight = fmaxf(dot(d, nl), 0.0f) / (kPiF * fmaxf(__ldg(pdf + row * w + col), 1e-8f));
  return d;
}

}  // namespace bpt
