// Native BVH builder — C++ twin of bpt_tpu/accel/builder.py.
//
// The reference's builder (js/BVH_Fast_Builder.js) is itself a port of a
// C++ CUDA renderer's builder; this is our native tier for large meshes
// (the pure-numpy builder is fine to ~100k triangles, this one holds
// 500k+ — the reference's stated capacity — at interactive latency).
//
// Identical algorithm and flat layout to builder.py:
//   * top-down, split at the spatial median of the ranked longest axis,
//   * next-best axis when a side comes up empty, even/odd fallback,
//   * preorder left-first emission => left child == parent + 1,
//   * right-child id patched into the parent, leaves hold one triangle.
// std::stable_partition mirrors numpy's order-preserving boolean selection,
// so native and numpy builds produce bit-identical trees (tested).
//
// C ABI for ctypes; no dependencies beyond the C++ standard library.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Frame {
  int64_t begin;
  int64_t end;     // exclusive
  int64_t parent;  // node id, -1 for root
  bool is_left;
  int32_t depth;
};

}  // namespace

extern "C" int bvh_build(const float* aabb_min, const float* aabb_max,
                         int64_t n_tris, int32_t* node_tri,
                         int32_t* node_right, float* node_min,
                         float* node_max, int32_t* out_max_depth) {
  if (n_tris < 1) return -1;
  std::vector<int64_t> ids(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) ids[i] = i;
  std::vector<float> centroid(n_tris * 3);
  for (int64_t i = 0; i < n_tris; ++i)
    for (int c = 0; c < 3; ++c)
      centroid[i * 3 + c] = 0.5f * (aabb_min[i * 3 + c] + aabb_max[i * 3 + c]);

  std::vector<Frame> stack;
  stack.reserve(128);
  stack.push_back({0, n_tris, -1, true, 0});
  int64_t next_id = 0;
  int32_t max_depth = 0;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const int64_t my_id = next_id++;
    if (f.depth > max_depth) max_depth = f.depth;
    if (f.parent >= 0 && !f.is_left) node_right[f.parent] = (int32_t)my_id;

    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = f.begin; i < f.end; ++i) {
      const int64_t t = ids[i];
      for (int c = 0; c < 3; ++c) {
        mn[c] = std::min(mn[c], aabb_min[t * 3 + c]);
        mx[c] = std::max(mx[c], aabb_max[t * 3 + c]);
      }
    }
    for (int c = 0; c < 3; ++c) {
      node_min[my_id * 3 + c] = mn[c];
      node_max[my_id * 3 + c] = mx[c];
    }
    node_tri[my_id] = -1;
    node_right[my_id] = -1;

    const int64_t count = f.end - f.begin;
    if (count == 1) {
      node_tri[my_id] = (int32_t)ids[f.begin];
      continue;
    }

    // ranked axes, longest extent first (stable order like np.argsort(-e))
    float extent[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
    int order[3] = {0, 1, 2};
    std::stable_sort(order, order + 3,
                     [&](int a, int b) { return extent[a] > extent[b]; });

    int64_t mid = -1;
    for (int oi = 0; oi < 3; ++oi) {
      const int axis = order[oi];
      const float split = 0.5f * (mn[axis] + mx[axis]);
      auto it = std::stable_partition(
          ids.begin() + f.begin, ids.begin() + f.end,
          [&](int64_t t) { return centroid[t * 3 + axis] < split; });
      const int64_t n_left = it - (ids.begin() + f.begin);
      if (n_left > 0 && n_left < count) {
        mid = f.begin + n_left;
        break;
      }
    }
    if (mid < 0) {
      // all centroids coincide: alternate even/odd assignment
      std::vector<int64_t> left, right;
      left.reserve((count + 1) / 2);
      right.reserve(count / 2);
      for (int64_t i = f.begin; i < f.end; ++i)
        (((i - f.begin) % 2 == 0) ? left : right).push_back(ids[i]);
      int64_t w = f.begin;
      for (int64_t t : left) ids[w++] = t;
      mid = w;
      for (int64_t t : right) ids[w++] = t;
    }

    // push right first so the left branch is emitted immediately after
    stack.push_back({mid, f.end, my_id, false, f.depth + 1});
    stack.push_back({f.begin, mid, my_id, true, f.depth + 1});
  }

  *out_max_depth = max_depth;
  return (next_id == 2 * n_tris - 1) ? 0 : -2;
}

// Binned-SAH builder — C++ twin of builder.py's build_bvh_sah.  Bit-exact
// determinism contract with the numpy implementation (see its docstring):
// float32 centroids and bin indices, float64 sweep costs, ties broken
// toward the lower axis then the lower bin, stable partition.
extern "C" int bvh_build_sah(const float* aabb_min, const float* aabb_max,
                             int64_t n_tris, int32_t* node_tri,
                             int32_t* node_right, float* node_min,
                             float* node_max, int32_t* out_max_depth) {
  if (n_tris < 1) return -1;
  constexpr int K = 16;  // bins (builder.py _SAH_BINS)
  static const float kScaleNum = (float)K * (float)(1.0 - 1e-6);
  std::vector<int64_t> ids(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) ids[i] = i;
  std::vector<float> centroid(n_tris * 3);
  for (int64_t i = 0; i < n_tris; ++i)
    for (int c = 0; c < 3; ++c)
      centroid[i * 3 + c] = 0.5f * (aabb_min[i * 3 + c] + aabb_max[i * 3 + c]);

  std::vector<Frame> stack;
  stack.reserve(128);
  stack.push_back({0, n_tris, -1, true, 0});
  int64_t next_id = 0;
  int32_t max_depth = 0;

  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const int64_t my_id = next_id++;
    if (f.depth > max_depth) max_depth = f.depth;
    if (f.parent >= 0 && !f.is_left) node_right[f.parent] = (int32_t)my_id;

    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    float cmn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float cmx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = f.begin; i < f.end; ++i) {
      const int64_t t = ids[i];
      for (int c = 0; c < 3; ++c) {
        mn[c] = std::min(mn[c], aabb_min[t * 3 + c]);
        mx[c] = std::max(mx[c], aabb_max[t * 3 + c]);
        cmn[c] = std::min(cmn[c], centroid[t * 3 + c]);
        cmx[c] = std::max(cmx[c], centroid[t * 3 + c]);
      }
    }
    for (int c = 0; c < 3; ++c) {
      node_min[my_id * 3 + c] = mn[c];
      node_max[my_id * 3 + c] = mx[c];
    }
    node_tri[my_id] = -1;
    node_right[my_id] = -1;

    const int64_t count = f.end - f.begin;
    if (count == 1) {
      node_tri[my_id] = (int32_t)ids[f.begin];
      continue;
    }

    double best_cost = 1e300;
    int best_axis = -1;
    int best_bin = -1;
    bool have_best = false;
    for (int axis = 0; axis < 3; ++axis) {
      const float cext = cmx[axis] - cmn[axis];
      if (!(cext > 0.0f)) continue;
      const float scale = kScaleNum / cext;
      int64_t counts[K] = {0};
      float bmn[K][3], bmx[K][3];
      for (int b = 0; b < K; ++b)
        for (int c = 0; c < 3; ++c) {
          bmn[b][c] = 3.4e38f;
          bmx[b][c] = -3.4e38f;
        }
      for (int64_t i = f.begin; i < f.end; ++i) {
        const int64_t t = ids[i];
        int b = (int)((centroid[t * 3 + axis] - cmn[axis]) * scale);
        if (b > K - 1) b = K - 1;
        counts[b]++;
        for (int c = 0; c < 3; ++c) {
          bmn[b][c] = std::min(bmn[b][c], aabb_min[t * 3 + c]);
          bmx[b][c] = std::max(bmx[b][c], aabb_max[t * 3 + c]);
        }
      }
      // prefix/suffix sweeps; costs in double
      float lmn[K][3], lmx[K][3], rmn[K][3], rmx[K][3];
      int64_t lcnt[K];
      for (int c = 0; c < 3; ++c) {
        lmn[0][c] = bmn[0][c];
        lmx[0][c] = bmx[0][c];
        rmn[K - 1][c] = bmn[K - 1][c];
        rmx[K - 1][c] = bmx[K - 1][c];
      }
      lcnt[0] = counts[0];
      for (int b = 1; b < K; ++b) {
        lcnt[b] = lcnt[b - 1] + counts[b];
        for (int c = 0; c < 3; ++c) {
          lmn[b][c] = std::min(lmn[b - 1][c], bmn[b][c]);
          lmx[b][c] = std::max(lmx[b - 1][c], bmx[b][c]);
        }
      }
      for (int b = K - 2; b >= 0; --b)
        for (int c = 0; c < 3; ++c) {
          rmn[b][c] = std::min(rmn[b + 1][c], bmn[b][c]);
          rmx[b][c] = std::max(rmx[b + 1][c], bmx[b][c]);
        }
      auto area = [](const float* lo, const float* hi) -> double {
        double d0 = std::max((double)hi[0] - (double)lo[0], 0.0);
        double d1 = std::max((double)hi[1] - (double)lo[1], 0.0);
        double d2 = std::max((double)hi[2] - (double)lo[2], 0.0);
        return d0 * d1 + d1 * d2 + d2 * d0;
      };
      for (int b = 0; b < K - 1; ++b) {  // split after bin b
        const int64_t nl = lcnt[b];
        const int64_t nr = count - nl;
        if (nl <= 0 || nr <= 0) continue;
        const double cost =
            (double)nl * area(lmn[b], lmx[b]) + (double)nr * area(rmn[b + 1], rmx[b + 1]);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          have_best = true;
        }
      }
    }

    int64_t mid;
    if (have_best) {
      const int axis = best_axis;
      const float scale = kScaleNum / (cmx[axis] - cmn[axis]);
      const float base = cmn[axis];
      const int cut = best_bin;
      auto it = std::stable_partition(
          ids.begin() + f.begin, ids.begin() + f.end, [&](int64_t t) {
            int b = (int)((centroid[t * 3 + axis] - base) * scale);
            if (b > K - 1) b = K - 1;
            return b <= cut;
          });
      mid = it - ids.begin();
    } else {
      // all centroids coincide on every axis: alternate even/odd
      std::vector<int64_t> left, right;
      left.reserve((count + 1) / 2);
      right.reserve(count / 2);
      for (int64_t i = f.begin; i < f.end; ++i)
        (((i - f.begin) % 2 == 0) ? left : right).push_back(ids[i]);
      int64_t w = f.begin;
      for (int64_t t : left) ids[w++] = t;
      mid = w;
      for (int64_t t : right) ids[w++] = t;
    }

    stack.push_back({mid, f.end, my_id, false, f.depth + 1});
    stack.push_back({f.begin, mid, my_id, true, f.depth + 1});
  }

  *out_max_depth = max_depth;
  return (next_id == 2 * n_tris - 1) ? 0 : -2;
}
