// The Preetham sky toward one direction, and the sun-NEE lobe.
//
// sky_color mirrors the per-direction part of get_sky_color
// (bpt_tpu_torch/sky.py) operation for operation.  The terms that depend on
// the sun alone (its intensity sun_e, the final exponent gamma and the
// horizon blend) arrive as floats, computed on the device by the same torch
// function the plain version calls (sky_sun_terms), as are the per-channel
// scattering constants.  PyTorch on CUDA computes torch.pow(x, 1.5) and
// x ** gamma with powf, torch.pow(x, 0.5) with sqrtf, torch.acos with acosf.
#pragma once

#include "vec.cuh"

namespace bpt {

__device__ __forceinline__ V3 sky_color(V3 rd, const float* P) {
  const double kPi = 3.14159265358979323;
  const double kG = 0.76;
  V3 view = normalize(rd);
  V3 sun = load3(P + kPSun);
  const float sun_e = P[kPSunE], gamma = P[kPGamma], blend = P[kPBlend];
  float cos_view_sun = dot(view, sun);
  float zenith = acosf(clampf(fmaxf(view.y, 0.0f), -1.0f, 1.0f));
  float inverse = 1.0f / (cosf(zenith) + 0.15f * powf(fmaxf(93.885f - zenith * (float)(180.0 / kPi), (float)1e-6),
                                                       (float)-1.253));
  float rayleigh_opt = 8400.0f * inverse;
  float mie_opt = 1250.0f * inverse;
  float c = cos_view_sun * 0.5f + 0.5f;
  float r_phase = (float)0.05968310365946075 * (1.0f + c * c);
  float hg_x = fmaxf(1.0f - (float)(2.0 * kG) * cos_view_sun + (float)(kG * kG), 0.0f);
  float hg_den = powf(hg_x, 1.5f);
  float m_phase = (float)0.07957747154594767 * ((1.0f / fmaxf(hg_den, (float)1e-20)) * (float)(1.0 - kG * kG));
  float st = clampf((cos_view_sun - (float)0.9998) * (float)(1.0 / ((0.9998 + 0.00002) - 0.9998)), 0.0f, 1.0f);
  float sundisk = st * st * (3.0f - 2.0f * st);
  const float night[3] = {0.0f, (float)0.0003, (float)0.00075};
  float out[3];
  for (int ch = 0; ch < 3; ++ch) {
    float ray = P[kPRayleigh + ch], mie = P[kPMie + ch];
    float fex = expf(-(ray * rayleigh_opt + mie * mie_opt));
    float ratio = (ray * r_phase + mie * m_phase) / P[kPExtinction + ch];
    float lin = powf(fmaxf(sun_e * ratio * (1.0f - fex), 0.0f), 1.5f);
    lin = lin * (1.0f + (sqrtf(fmaxf(sun_e * ratio * fex, 0.0f)) - 1.0f) * blend);
    float l0 = 0.1f * fex;
    l0 = l0 + (sun_e * 19000.0f * fex) * sundisk;
    float tex = (lin + l0) * 0.04f + night[ch];
    out[ch] = powf(fmaxf(tex, 0.0f), gamma);
  }
  return v3(out[0], out[1], out[2]);
}

// Sun NEE: a direction in the specular lobe about the sun from the draws
// (lc, lp), and its weight max(0, dot(dir, nl)) * scale, scale being 0.05
// (weight mode "sky") or sun_power^2 * 1e-7 ("hdri").
__device__ __forceinline__ V3 sun_nee(const float* P, V3 nl, float lc, float lp, float* weight) {
  V3 d = lobe_dir(load3(P + kPSun), P[kPLobeExp], P[kPLobeRough], lc, lp);
  *weight = fmaxf(dot(d, nl), 0.0f) * P[kPSunWeight];
  return d;
}

}  // namespace bpt
