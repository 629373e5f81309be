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
// The maps come as a texel table per map (bpt_tpu_torch/textures.py
// texel_quads, made once per map set by kernels/launch_args.py
// texel_table_of): the reference's quad_pack, the 2x2 footprint whose first
// tap is texel (y, x) stored at (y, x) as four 16-byte slots (three channels
// and a zero), so a sample is four aligned float4 loads (__ldg) from one
// 64-byte record, where it was twelve dependent scalar loads from two rows
// of the map.  The table holds four times the map's texels; the floats are
// the map's own and the combine keeps tap_channel's order, so the kernel
// computes what the plain version computes.
//
// What bounds it on this card: the taps' loads, divergent across a warp
// whose lanes hit different places in tables larger than the 50 MB L2 (the
// stand-in's four 2048² maps make 1074 MB of tables), and their latency,
// which the textured kernels hide with 4 blocks of 256 threads an SM
// (csrc/megakernel.cu).  A hit samples only the maps an output reads
// (csrc/path.cuh): the UV and the normal map not on a shadow ray, the
// emissive map only on a specular path, the albedo not in the grads mode.  Hardware texture filtering is not used: its 8-bit
// fractional weights cannot reproduce the plain version's float weights.
#pragma once

#include "vec.cuh"

namespace bpt {

constexpr int kTexAlbedo = 0, kTexNormal = 1, kTexMetalRough = 2, kTexEmissive = 3;

// i mod n, floored (as torch.remainder / jnp.mod), n > 0.
__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// One map's texel table and the map's (h, w).
struct TexMap {
  const float4* quads;
  int h, w;
};

// A sample's four taps as loaded, (y0, x0), (y0, x1), (y1, x0), (y1, x1),
// and the weights fx, fy.
struct Texels {
  float4 c00, c01, c10, c11;
  float fx, fy;
};

// The bilinear sample with REPEAT wrap of an (h, w) map at (u, v), v = 0 at
// row 0: the record of its first tap (y0, x0), the floored modulo on both
// axes, holds all four.
__device__ __forceinline__ Texels fetch_taps(const TexMap& m, float u, float v) {
  const float x = u * (float)m.w - 0.5f;
  const float y = v * (float)m.h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float4* rec = m.quads + (wrap((int)y0, m.h) * m.w + wrap((int)x0, m.w)) * 4;
  return Texels{__ldg(rec), __ldg(rec + 1), __ldg(rec + 2), __ldg(rec + 3), x - x0, y - y0};
}

// One channel of the sample: (c00 (1 - fx) + c01 fx) (1 - fy) + (c10 (1 - fx) + c11 fx) fy.
__device__ __forceinline__ float tap_channel(float c00, float c01, float c10, float c11, const Texels& t) {
  const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
  return (c00 * gx + c01 * t.fx) * gy + (c10 * gx + c11 * t.fx) * t.fy;
}

// The RGB bilinear sample of loaded taps.
__device__ __forceinline__ V3 combine(const Texels& t) {
  return v3(tap_channel(t.c00.x, t.c01.x, t.c10.x, t.c11.x, t), tap_channel(t.c00.y, t.c01.y, t.c10.y, t.c11.y, t),
            tap_channel(t.c00.z, t.c01.z, t.c10.z, t.c11.z, t));
}

// An sRGB-encoded value decoded to linear: powf(max(x, 0), 2.2f).
__device__ __forceinline__ float srgb_linear(float x) { return powf(fmaxf(x, 0.0f), 2.2f); }

// The RGB sample of loaded taps decoded to linear.
__device__ __forceinline__ V3 combine_linear(const Texels& t) {
  const V3 c = combine(t);
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
__device__ __forceinline__ V3 perturb_normal(V3 n_obj, const TexMap& map, float u, float v) {
  const Texels taps = fetch_taps(map, u, v);
  const V3 nl = unit_div(n_obj);
  const V3 up = fabsf(nl.y) < 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 s = unit_div(cross(up, nl));
  const V3 t = cross(nl, s);
  const V3 c = combine(taps);
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
