// The texel work of a textured (PBR) mesh in the megakernel: the winner's
// UV, the bilinear REPEAT-wrapped sample, the tangent-space normal map, the
// sRGB decode and the metal roughness lobe.
//
// Replaces, in bpt_tpu/kernels/megakernel.py: the mesh_textured
// configuration of _make_kernel, whose walk (textured=True) writes a
// per-bounce UV plane and triangle-baked material decisions for an outside
// composition (_compose_result: the deferred albedo, the emissive terminal,
// the metal lobe's roughness), with the normal map baked per vertex
// (bpt_tpu/scenes/gltf_scene.py bake_triangle_attrs,
// _bake_vertex_normal_map).  All of that exists because Mosaic has no
// per-lane gather.  Here each thread fetches its own texels at each mesh
// hit and decides per texel, so the kernel computes what the plain
// wavefront computes (bpt_tpu_torch/textures.py sample_bilinear,
// perturb_normal; integrator/radiance.py, the PBR decode), operation for
// operation: x = u * W - 0.5, floorf, the floored modulo on both axes
// (C's % truncates toward zero, so a negative index wraps explicitly), the
// combine (c00 (1 - fx) + c01 fx) (1 - fy) + (c10 (1 - fx) + c11 fx) fy,
// the true divisions of the normal map's normalisations, powf(max(x, 0),
// 2.2f) as PyTorch's CUDA pow computes torch.pow(x, 2.2), and the lobe's
// exponent 1 / (exp(7 - 7 sqrt(r)) + 1) per lane.
//
// What bounds it on this card: each tap is three dependent-address 4-byte
// loads (two for the metallic-roughness map, whose R channel no branch
// reads) from a map that does not fit the L1 (a 2048² map is 50 MB),
// divergent across a warp whose lanes hit different places; bytes move only
// for the texels the lanes touch.  The kernel reads the maps as the scene
// holds them, (H, W, 3) float32, through the read-only path (__ldg), so a
// textured mesh keeps one copy of each map on the card.  Hardware texture
// filtering is not used: its 8-bit fractional weights cannot reproduce the
// plain version's float weights.  Wider loads (a padded float4 layout),
// caching texels in shared memory, half-precision maps and sorting hits by
// UV are later work.
#pragma once

#include "vec.cuh"

namespace bpt {

constexpr int kTexAlbedo = 0, kTexNormal = 1, kTexMetalRough = 2, kTexEmissive = 3;

// i mod n, floored (as torch.remainder / jnp.mod), n > 0.
__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The four taps of a bilinear sample with REPEAT wrap of an (h, w) map at
// (u, v), v = 0 at row 0: the float offsets of texels (y0, x0), (y0, x1),
// (y1, x0), (y1, x1) in an (h, w, 3) map and the weights fx, fy.
struct Taps {
  int i00, i01, i10, i11;
  float fx, fy;
};

__device__ __forceinline__ Taps bilinear_taps(int h, int w, float u, float v) {
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const int x0i = wrap((int)x0, w), x1i = wrap(x0i + 1, w);
  const int y0i = wrap((int)y0, h), y1i = wrap(y0i + 1, h);
  return Taps{(y0i * w + x0i) * 3, (y0i * w + x1i) * 3, (y1i * w + x0i) * 3, (y1i * w + x1i) * 3, x - x0, y - y0};
}

// Channel c of the sample: (c00 (1 - fx) + c01 fx) (1 - fy) + (c10 (1 - fx) + c11 fx) fy.
__device__ __forceinline__ float tap_channel(const float* __restrict__ tex, const Taps& t, int c) {
  const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
  return (__ldg(tex + t.i00 + c) * gx + __ldg(tex + t.i01 + c) * t.fx) * gy +
         (__ldg(tex + t.i10 + c) * gx + __ldg(tex + t.i11 + c) * t.fx) * t.fy;
}

// The RGB bilinear sample of an (h, w, 3) map at (u, v).
__device__ __forceinline__ V3 sample_bilinear(const float* __restrict__ tex, int h, int w, float u, float v) {
  const Taps t = bilinear_taps(h, w, u, v);
  return v3(tap_channel(tex, t, 0), tap_channel(tex, t, 1), tap_channel(tex, t, 2));
}

// An sRGB-encoded value decoded to linear: powf(max(x, 0), 2.2f).
__device__ __forceinline__ float srgb_linear(float x) { return powf(fmaxf(x, 0.0f), 2.2f); }

// The RGB sample decoded to linear.
__device__ __forceinline__ V3 sample_linear(const float* __restrict__ tex, int h, int w, float u, float v) {
  const V3 c = sample_bilinear(tex, h, w, u, v);
  return v3(srgb_linear(c.x), srgb_linear(c.y), srgb_linear(c.z));
}

// v / sqrt(max(|v|², 1e-20)), three true divisions.
__device__ __forceinline__ V3 unit_div(V3 v) {
  const float l = sqrtf(fmaxf(dot(v, v), 1e-20f));
  return v3(v.x / l, v.y / l, v.z / l);
}

// The winning triangle's interpolated UV, (uv0 w + uv1 u) + uv2 v, from
// its record (uv0, uv1, uv2).
__device__ __forceinline__ void mesh_uv(const float2* __restrict__ uvs, int tri, float u, float v, float* out_u,
                                        float* out_v) {
  const float w = (1.0f - u) - v;
  const float2 a = __ldg(uvs + 3 * tri), b = __ldg(uvs + 3 * tri + 1), c = __ldg(uvs + 3 * tri + 2);
  *out_u = (a.x * w + b.x * u) + c.x * v;
  *out_v = (a.y * w + b.y * u) + c.y * v;
}

// Tangent-space normal mapping of an object-space normal: the cross-trick
// frame S = unit(cross(up, n)), T = cross(n, S), up = (0, 1, 0) where
// |n.y| < 0.9, else (1, 0, 0); the texel m = unit(2 sample - 1);
// unit(S m.x + T m.y + n m.z).
__device__ __forceinline__ V3 perturb_normal(V3 n_obj, const float* __restrict__ tex, int h, int w, float u,
                                             float v) {
  const V3 nl = unit_div(n_obj);
  const V3 up = fabsf(nl.y) < 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 s = unit_div(cross(up, nl));
  const V3 t = cross(nl, s);
  const V3 c = sample_bilinear(tex, h, w, u, v);
  const V3 m = unit_div(v3(c.x * 2.0f - 1.0f, c.y * 2.0f - 1.0f, c.z * 2.0f - 1.0f));
  return unit_div(add(add(mul(s, m.x), mul(t, m.y)), mul(nl, m.z)));
}

// The METAL bounce of metal_roughness_lobe: the lobe of this lane's
// roughness (clamped to [0, 1]; 0 off the mesh) about the mirror direction.
__device__ __forceinline__ V3 roughness_lobe(V3 refl, float roughness, float lc, float lp) {
  const float r = clampf(roughness, 0.0f, 1.0f);
  const float exponent = 1.0f / (expf(sqrtf(r) * -7.0f + 7.0f) + 1.0f);
  return lobe_dir(refl, exponent, r, lc, lp);
}

}  // namespace bpt
