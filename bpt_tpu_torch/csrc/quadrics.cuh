// The twelve unit-space intersectors of the transformed-quadric scene.
//
// Each mirrors its plain version in bpt_tpu_torch/geometry/quadrics.py
// operation for operation (the same association, `x ** 2` as x * x, the
// same candidate priority), not the TPU kernel's component forms
// (bpt_tpu/kernels/megakernel.py _q_sphere ... _q_torus), so that the
// kernel's hits are bit-equal to the plain version's.  Each returns the
// closest positive t (kInf on a miss) and the unnormalized object-space
// normal.  Host constants are written as (float)(double expression), which
// is how PyTorch turns a Python number into a float32 operand.
#pragma once

#include "vec.cuh"

namespace bpt {

constexpr int kTorusMaxSteps = 500;

struct QHit {
  float t;
  V3 n;
};

__device__ __forceinline__ V3 miss_n() { return v3(0.0f, 1.0f, 0.0f); }

__device__ __forceinline__ void solve_quadratic(float a, float b, float c, float* t0, float* t1) {
  float inv_a = safe_inv(a);
  b = b * inv_a;
  c = c * inv_a;
  float nhb = -b * 0.5f;
  float u2 = nhb * nhb - c;
  bool real = u2 >= 0.0f;
  float u = safe_sqrt(u2);
  nhb = real ? nhb : 0.0f;
  u = real ? u : 0.0f;
  *t0 = nhb - u;
  *t1 = nhb + u;
}

__device__ __forceinline__ QHit pick_two(float t0, V3 n0, bool ok0, float t1, V3 n1, bool ok1) {
  if (ok0) return QHit{t0, n0};
  if (ok1) return QHit{t1, n1};
  return QHit{kInf, miss_n()};
}

// (a, b, c) of the infinite unit cylinder x^2 + z^2 = 1.
__device__ __forceinline__ void xz2(V3 ro, V3 rd, float* a, float* b, float* c) {
  *a = rd.x * rd.x + rd.z * rd.z;
  *b = 2.0f * (rd.x * ro.x + rd.z * ro.z);
  *c = ro.x * ro.x + ro.z * ro.z - 1.0f;
}

__device__ __forceinline__ V3 cyl_normal(V3 h) { return v3(2.0f * h.x, 0.0f, 2.0f * h.z); }

// The normal of the chosen root only (this one also serves the Cornell
// spheres on every live bounce).
__device__ __forceinline__ QHit q_sphere(V3 ro, V3 rd) {
  float t0, t1;
  solve_quadratic(dot(rd, rd), 2.0f * dot(rd, ro), dot(ro, ro) - 1.0f, &t0, &t1);
  if (t0 > 0.0f) return QHit{t0, mul(at(ro, rd, t0), 2.0f)};
  if (t1 > 0.0f) return QHit{t1, mul(at(ro, rd, t1), 2.0f)};
  return QHit{kInf, miss_n()};
}

__device__ __forceinline__ QHit q_cylinder(V3 ro, V3 rd) {
  float a, b, c, t0, t1;
  xz2(ro, rd, &a, &b, &c);
  solve_quadratic(a, b, c, &t0, &t1);
  V3 h0 = at(ro, rd, t0), h1 = at(ro, rd, t1);
  return pick_two(t0, cyl_normal(h0), t0 > 0.0f && fabsf(h0.y) <= 1.0f, t1, cyl_normal(h1),
                  t1 > 0.0f && fabsf(h1.y) <= 1.0f);
}

__device__ __forceinline__ QHit q_cone(V3 ro, V3 rd, float kshape) {
  float k = clampf(kshape, (float)0.01, 1.0f);
  float j = 1.0f / k;
  float h = j * 2.0f - 1.0f;
  float kq = k * 0.25f;
  float a = j * (rd.x * rd.x) + j * (rd.z * rd.z) - kq * (rd.y * rd.y);
  float b = 2.0f * (j * rd.x * ro.x + j * rd.z * ro.z - kq * rd.y * (ro.y - h));
  float c = j * (ro.x * ro.x) + j * (ro.z * ro.z) - kq * ((ro.y - h) * (ro.y - h));
  float t0, t1;
  solve_quadratic(a, b, c, &t0, &t1);
  V3 h0 = at(ro, rd, t0), h1 = at(ro, rd, t1);
  V3 n0 = v3(2.0f * h0.x * j, 2.0f * (h - h0.y) * kq, 2.0f * h0.z * j);
  V3 n1 = v3(2.0f * h1.x * j, 2.0f * (h - h1.y) * kq, 2.0f * h1.z * j);
  return pick_two(t0, n0, t0 > 0.0f && fabsf(h0.y) <= 1.0f, t1, n1, t1 > 0.0f && fabsf(h1.y) <= 1.0f);
}

__device__ __forceinline__ QHit q_paraboloid(V3 ro, V3 rd) {
  float a = rd.x * rd.x + rd.z * rd.z;
  float b = 2.0f * (rd.x * ro.x + rd.z * ro.z) + 0.5f * rd.y;
  float c = ro.x * ro.x + ro.z * ro.z + 0.5f * (ro.y - 1.0f);
  float t0, t1;
  solve_quadratic(a, b, c, &t0, &t1);
  V3 h0 = at(ro, rd, t0), h1 = at(ro, rd, t1);
  return pick_two(t0, v3(2.0f * h0.x, 0.5f, 2.0f * h0.z), t0 > 0.0f && fabsf(h0.y) <= 1.0f, t1,
                  v3(2.0f * h1.x, 0.5f, 2.0f * h1.z), t1 > 0.0f && fabsf(h1.y) <= 1.0f);
}

__device__ __forceinline__ QHit q_hyperboloid(V3 ro, V3 rd, float kshape) {
  float k = (kshape * kshape * kshape * kshape + (float)0.0012) * 1000.0f;
  float j = k - 1.0f;
  float a = k * (rd.x * rd.x) + k * (rd.z * rd.z) - j * (rd.y * rd.y);
  float b = 2.0f * (k * rd.x * ro.x + k * rd.z * ro.z - j * rd.y * ro.y);
  float c = (k * (ro.x * ro.x) + k * (ro.z * ro.z) - j * (ro.y * ro.y)) - 1.0f;
  float t0, t1;
  solve_quadratic(a, b, c, &t0, &t1);
  V3 h0 = at(ro, rd, t0), h1 = at(ro, rd, t1);
  V3 n0 = v3(2.0f * h0.x * k, -2.0f * h0.y * j, 2.0f * h0.z * k);
  V3 n1 = v3(2.0f * h1.x * k, -2.0f * h1.y * j, 2.0f * h1.z * k);
  return pick_two(t0, n0, t0 > 0.0f && fabsf(h0.y) <= 1.0f, t1, n1, t1 > 0.0f && fabsf(h1.y) <= 1.0f);
}

__device__ __forceinline__ void cap_roots(V3 ro, V3 rd, float center_y, float* t0, float* t1) {
  V3 ell = v3(ro.x, ro.y - center_y, ro.z);
  solve_quadratic(dot(rd, rd), 2.0f * dot(rd, ell), dot(ell, ell) - 1.0f, t0, t1);
}

__device__ __forceinline__ V3 cap_n(V3 ro, V3 rd, float t, float off) {
  V3 h = at(ro, rd, t);
  return v3(2.0f * h.x, 2.0f * (h.y - off), 2.0f * h.z);
}

__device__ __forceinline__ QHit q_capsule(V3 ro, V3 rd, float kshape) {
  float k = kshape + 0.25f;
  float nk = -k;
  float s0t0, s0t1, s1t0, s1t1, a, b, c, t0, t1;
  cap_roots(ro, rd, k, &s0t0, &s0t1);
  cap_roots(ro, rd, nk, &s1t0, &s1t1);
  xz2(ro, rd, &a, &b, &c);
  solve_quadratic(a, b, c, &t0, &t1);
  // all first roots, then all second roots; the first valid candidate wins
  if (s0t0 > 0.0f && at(ro, rd, s0t0).y >= k) return QHit{s0t0, cap_n(ro, rd, s0t0, k)};
  if (s1t0 > 0.0f && at(ro, rd, s1t0).y <= nk) return QHit{s1t0, cap_n(ro, rd, s1t0, nk)};
  if (t0 > 0.0f && fabsf(at(ro, rd, t0).y) <= k) return QHit{t0, cyl_normal(at(ro, rd, t0))};
  if (s0t1 > 0.0f && at(ro, rd, s0t1).y >= k) return QHit{s0t1, cap_n(ro, rd, s0t1, k)};
  if (s1t1 > 0.0f && at(ro, rd, s1t1).y <= nk) return QHit{s1t1, cap_n(ro, rd, s1t1, nk)};
  if (t1 > 0.0f && fabsf(at(ro, rd, t1).y) <= k) return QHit{t1, cyl_normal(at(ro, rd, t1))};
  return QHit{kInf, miss_n()};
}

__device__ __forceinline__ QHit q_flattened_ring(V3 ro, V3 rd, float kshape) {
  float k = kshape - (float)0.01;
  float a, b, c_outer, t0, t1, c0, c1;
  xz2(ro, rd, &a, &b, &c_outer);
  solve_quadratic(a, b, c_outer, &t0, &t1);
  solve_quadratic(a, b, c_outer + 1.0f - k, &c0, &c1);
  float inv_y = safe_inv(rd.y);
  float d0 = -(ro.y - 1.0f) * inv_y;
  float d1 = -(ro.y + 1.0f) * inv_y;
  auto disk_ok = [&](float d) {
    V3 h = at(ro, rd, d);
    float x2z2 = h.x * h.x + h.z * h.z;
    return d > 0.0f && x2z2 <= 1.0f && x2z2 > k;
  };
  auto side_ok = [&](float t) { return t > 0.0f && fabsf(at(ro, rd, t).y) <= 1.0f; };
  const V3 up = v3(0.0f, 1.0f, 0.0f), down = v3(-0.0f, -1.0f, -0.0f);
  if (side_ok(t0)) return QHit{t0, cyl_normal(at(ro, rd, t0))};
  if (rd.y < 0.0f && disk_ok(d0)) return QHit{d0, up};
  if (rd.y > 0.0f && disk_ok(d1)) return QHit{d1, down};
  if (side_ok(c0)) return QHit{c0, cyl_normal(at(ro, rd, c0))};
  if (side_ok(c1)) return QHit{c1, cyl_normal(at(ro, rd, c1))};
  if (side_ok(t1)) return QHit{t1, cyl_normal(at(ro, rd, t1))};
  if (rd.y > 0.0f && disk_ok(d0)) return QHit{d0, up};
  if (rd.y < 0.0f && disk_ok(d1)) return QHit{d1, down};
  return QHit{kInf, miss_n()};
}

// torch.sign: (0 < x) - (x < 0)
__device__ __forceinline__ float signf_(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

__device__ __forceinline__ QHit q_box(V3 ro, V3 rd) {
  const float r[3] = {ro.x, ro.y, ro.z}, d[3] = {rd.x, rd.y, rd.z};
  float tmin[3], tmax[3];
  for (int i = 0; i < 3; ++i) {
    float inv = safe_inv(d[i]);
    float near_ = (-1.0f - r[i]) * inv;
    float far_ = (1.0f - r[i]) * inv;
    tmin[i] = fminf(near_, far_);
    tmax[i] = fmaxf(near_, far_);
  }
  float t0 = fmaxf(fmaxf(tmin[0], tmin[1]), tmin[2]);
  float t1 = fminf(fminf(tmax[0], tmax[1]), tmax[2]);
  float ne[3], nx[3];
  for (int i = 0; i < 3; ++i) {
    float ns = -signf_(d[i]);
    int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    ne[i] = ns * (tmin[i] >= tmin[i1] ? 1.0f : 0.0f) * (tmin[i] >= tmin[i2] ? 1.0f : 0.0f);
    nx[i] = ns * (tmax[i] <= tmax[i1] ? 1.0f : 0.0f) * (tmax[i] <= tmax[i2] ? 1.0f : 0.0f);
  }
  bool ok = t0 < t1;
  return pick_two(t0, v3(ne[0], ne[1], ne[2]), ok && t0 > 0.0f, t1, v3(nx[0], nx[1], nx[2]), ok && t1 > 0.0f);
}

// One pair of sides of the pyramid/frustum: main axis x (main_x) or z.
__device__ __forceinline__ QHit pyramid_side(V3 ro, V3 rd, bool main_x, float j, float h, float kq) {
  float rdm = main_x ? rd.x : rd.z, rom = main_x ? ro.x : ro.z;
  float a = j * (rdm * rdm) - kq * (rd.y * rd.y);
  float b = 2.0f * (j * rdm * rom - kq * rd.y * (ro.y - h));
  float c = j * (rom * rom) - kq * ((ro.y - h) * (ro.y - h));
  float t0, t1;
  solve_quadratic(a, b, c, &t0, &t1);
  auto valid = [&](float t) {
    V3 p = at(ro, rd, t);
    float ho = main_x ? p.z : p.x;
    bool inside_other = (j * (ho * ho) - kq * ((p.y - h) * (p.y - h))) <= 0.0f;
    return t > 0.0f && fabsf(p.x) <= 1.0f && fabsf(p.z) <= 1.0f && p.y <= 1.0f && inside_other;
  };
  auto nrm = [&](float t) {
    V3 p = at(ro, rd, t);
    float comp_main = 2.0f * (main_x ? p.x : p.z) * j;
    float comp_y = 2.0f * (p.y - h) * -kq;
    return main_x ? v3(comp_main, comp_y, 0.0f) : v3(0.0f, comp_y, comp_main);
  };
  bool ok0 = valid(t0);
  bool ok1 = valid(t1) && !ok0;
  return pick_two(t0, nrm(t0), ok0, t1, nrm(t1), ok1);
}

__device__ __forceinline__ QHit q_pyramid_frustum(V3 ro, V3 rd, float kshape) {
  float k = clampf(kshape, (float)0.01, 1.0f);
  float j = 1.0f / k;
  float h = j * 2.0f - 1.0f;
  float kq = k * 0.25f;
  QHit xs = pyramid_side(ro, rd, true, j, h, kq);
  QHit zs = pyramid_side(ro, rd, false, j, h, kq);
  return xs.t <= zs.t ? xs : zs;
}

__device__ __forceinline__ QHit q_disk(V3 ro, V3 rd) {
  float t0 = -ro.y * safe_inv(rd.y);
  V3 p = at(ro, rd, t0);
  bool ok = t0 > 0.0f && p.x * p.x + p.z * p.z <= 1.0f;
  return QHit{ok ? t0 : kInf, v3(0.0f, 1.0f, 0.0f)};
}

__device__ __forceinline__ QHit q_rectangle(V3 ro, V3 rd) {
  float t0 = -ro.y * safe_inv(rd.y);
  V3 p = at(ro, rd, t0);
  bool ok = t0 > 0.0f && fabsf(p.x) <= 1.0f && fabsf(p.z) <= 1.0f;
  return QHit{ok ? t0 : kInf, v3(0.0f, 1.0f, 0.0f)};
}

__device__ __forceinline__ float map_torus(V3 p, float k) {
  float ring = sqrtf(fmaxf(p.x * p.x + p.z * p.z, (float)1e-20)) - (1.0f - k);
  return sqrtf(fmaxf(ring * ring + p.y * p.y, (float)1e-20)) - k;
}

// Analytic bound, then the SDF march.  The plain version runs a fixed
// 500-step loop in which a lane freezes for good once |d| < 0.01 or it has
// marched 8 units; a thread here leaves the loop when it freezes (the same
// fixed point), and a ray that misses the bound does not march at all (its
// march result is discarded).  Threads of a warp that converge early wait
// for the slowest: the march dominates this configuration.
__device__ __forceinline__ QHit q_torus(V3 ro, V3 rd, float kshape) {
  float k = 1.0f - clampf(kshape, (float)0.01, (float)0.99);
  float a, b, c, t0, t1;
  xz2(ro, rd, &a, &b, &c);
  solve_quadratic(a, b, c, &t0, &t1);
  float h0y = ro.y + rd.y * t0, h1y = ro.y + rd.y * t1;
  float tc = (t0 > 0.0f && fabsf(h0y) <= k) ? t0 : ((t1 > 0.0f && fabsf(h1y) <= k) ? t1 : kInf);
  float inv_y = safe_inv(rd.y);
  auto disk = [&](float off) {
    float d = -(ro.y + off) * inv_y;
    V3 p = at(ro, rd, d);
    return (d > 0.0f && p.x * p.x + p.z * p.z <= 1.0f) ? d : kInf;
  };
  float t_start = fminf(fminf(disk(k), disk(-k)), tc);
  if (!(t_start < kInf)) return QHit{kInf, miss_n()};
  float t = t_start, d = kInf;
  for (int step = 0; step < kTorusMaxSteps; ++step) {
    if (!(fabsf(d) >= (float)0.01 && t - t_start <= 8.0f)) break;
    float d_new = map_torus(at(ro, rd, t), k);
    if (fabsf(d_new) >= (float)0.01) t = t + d_new;
    d = d_new;
  }
  if (!(fabsf(d) < (float)0.01)) return QHit{kInf, miss_n()};
  V3 p = at(ro, rd, t);
  const float e = (float)(0.5773 * 0.0002);
  float m1 = map_torus(v3(p.x + e, p.y + -e, p.z + -e), k);
  float m2 = map_torus(v3(p.x + -e, p.y + -e, p.z + e), k);
  float m3 = map_torus(v3(p.x + -e, p.y + e, p.z + -e), k);
  float m4 = map_torus(v3(p.x + e, p.y + e, p.z + e), k);
  V3 n = v3(((e * m1 + -e * m2) + -e * m3) + e * m4, ((-e * m1 + -e * m2) + e * m3) + e * m4,
            ((-e * m1 + e * m2) + -e * m3) + e * m4);
  return QHit{t, n};
}

// Shape i of UNIT_INTERSECTORS (geometry/quadrics.py), in object space.
__device__ __forceinline__ QHit quadric_intersect(int i, V3 ro, V3 rd, float k) {
  switch (i) {
    case 0: return q_sphere(ro, rd);
    case 1: return q_cylinder(ro, rd);
    case 2: return q_cone(ro, rd, k);
    case 3: return q_paraboloid(ro, rd);
    case 4: return q_hyperboloid(ro, rd, k);
    case 5: return q_capsule(ro, rd, k);
    case 6: return q_flattened_ring(ro, rd, k);
    case 7: return q_box(ro, rd);
    case 8: return q_pyramid_frustum(ro, rd, k);
    case 9: return q_disk(ro, rd);
    case 10: return q_rectangle(ro, rd);
    default: return q_torus(ro, rd, k);
  }
}

}  // namespace bpt
