// Native BVH builder: binned-SAH over triangle AABBs, flattened to the
// skip-link SoA layout consumed by ops/bvh.py's device traversal.
//
// Scene compilation is the one host-side hot path of the framework (the
// reference's analogue is the per-render _prepare_scene_data flattener,
// cuda_texture_renderer.py:790-908); for mesh-heavy scenes the Python
// builder dominates compile time, so this C++ implementation (exposed via a
// plain C ABI for ctypes) replaces it when available.  Output is
// bit-compatible with the numpy builder: same binning (16 bins, largest
// centroid extent axis), same stable median fallback, same DFS order and
// skip-link resolution, so tests can assert equivalence.
//
// Build: g++ -O3 -shared -fPIC -o libptrt_bvh.so bvh_builder.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;

struct V3d {
  double x = 0, y = 0, z = 0;
};

struct Builder {
  const float* tri_min;  // (T, 3)
  const float* tri_max;  // (T, 3)
  std::vector<double> cx, cy, cz;  // centroids
  int leaf_size;
  int max_nodes;

  // outputs (SoA, DFS order)
  float* lo;          // (M, 3)
  float* hi;          // (M, 3)
  int32_t* skip;      // (M,)
  uint8_t* is_leaf;   // (M,)
  int32_t* slots;     // (M, leaf_size)
  int n_nodes = 0;
  bool overflow = false;

  double centroid(int axis, int32_t i) const {
    switch (axis) {
      case 0: return cx[i];
      case 1: return cy[i];
      default: return cz[i];
    }
  }

  void bounds(const std::vector<int32_t>& idx, V3d* blo, V3d* bhi) const {
    blo->x = blo->y = blo->z = std::numeric_limits<double>::infinity();
    bhi->x = bhi->y = bhi->z = -std::numeric_limits<double>::infinity();
    for (int32_t i : idx) {
      blo->x = std::min(blo->x, (double)tri_min[3 * i + 0]);
      blo->y = std::min(blo->y, (double)tri_min[3 * i + 1]);
      blo->z = std::min(blo->z, (double)tri_min[3 * i + 2]);
      bhi->x = std::max(bhi->x, (double)tri_max[3 * i + 0]);
      bhi->y = std::max(bhi->y, (double)tri_max[3 * i + 1]);
      bhi->z = std::max(bhi->z, (double)tri_max[3 * i + 2]);
    }
  }

  static double half_area(const V3d& a, const V3d& b) {
    double dx = std::max(b.x - a.x, 0.0);
    double dy = std::max(b.y - a.y, 0.0);
    double dz = std::max(b.z - a.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
  }

  int emit(const V3d& blo, const V3d& bhi, int32_t skip_to) {
    if (n_nodes >= max_nodes) {
      overflow = true;
      return -1;
    }
    int me = n_nodes++;
    lo[3 * me + 0] = (float)blo.x;
    lo[3 * me + 1] = (float)blo.y;
    lo[3 * me + 2] = (float)blo.z;
    hi[3 * me + 0] = (float)bhi.x;
    hi[3 * me + 1] = (float)bhi.y;
    hi[3 * me + 2] = (float)bhi.z;
    skip[me] = skip_to;
    is_leaf[me] = 0;
    for (int k = 0; k < leaf_size; ++k) slots[leaf_size * me + k] = -1;
    return me;
  }

  // skip_to semantics match the Python flattener: -1 = "patched to the right
  // sibling's root", -2 = end-of-walk sentinel (resolved to n_nodes).
  int build(std::vector<int32_t>& idx, int32_t skip_to) {
    V3d blo, bhi;
    bounds(idx, &blo, &bhi);
    int me = emit(blo, bhi, skip_to);
    if (me < 0) return -1;

    if ((int)idx.size() <= leaf_size) {
      is_leaf[me] = 1;
      for (size_t k = 0; k < idx.size(); ++k)
        slots[leaf_size * me + k] = idx[k];
      return me;
    }

    // largest centroid-extent axis
    double cmin[3], cmax[3];
    for (int a = 0; a < 3; ++a) {
      cmin[a] = std::numeric_limits<double>::infinity();
      cmax[a] = -std::numeric_limits<double>::infinity();
    }
    for (int32_t i : idx) {
      double c[3] = {cx[i], cy[i], cz[i]};
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    int axis = 0;
    double ext = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a) {
      if (cmax[a] - cmin[a] > ext) {
        ext = cmax[a] - cmin[a];
        axis = a;
      }
    }

    std::vector<int32_t> left_idx, right_idx;
    if (ext > 1e-12) {
      std::vector<int> bin_of(idx.size());
      for (size_t k = 0; k < idx.size(); ++k) {
        int b = (int)((centroid(axis, idx[k]) - cmin[axis]) / ext * kBins);
        bin_of[k] = std::min(b, kBins - 1);
      }
      double best_cost = std::numeric_limits<double>::infinity();
      int best_split = -1;
      for (int split = 1; split < kBins; ++split) {
        std::vector<int32_t> l, r;
        for (size_t k = 0; k < idx.size(); ++k)
          (bin_of[k] < split ? l : r).push_back(idx[k]);
        if (l.empty() || r.empty()) continue;
        V3d llo, lhi, rlo, rhi;
        bounds(l, &llo, &lhi);
        bounds(r, &rlo, &rhi);
        double cost =
            half_area(llo, lhi) * l.size() + half_area(rlo, rhi) * r.size();
        if (cost < best_cost) {
          best_cost = cost;
          best_split = split;
          left_idx.swap(l);
          right_idx.swap(r);
        }
      }
      if (best_split < 0) left_idx.clear();
    }
    if (left_idx.empty() || right_idx.empty()) {
      // stable median split
      std::vector<int32_t> order(idx);
      std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return centroid(axis, a) < centroid(axis, b);
      });
      size_t half = order.size() / 2;
      left_idx.assign(order.begin(), order.begin() + half);
      right_idx.assign(order.begin() + half, order.end());
    }

    if (build(left_idx, -1) < 0) return -1;
    int right_root = n_nodes;
    // patch the left subtree's unresolved skips to the right sibling root
    for (int j = me + 1; j < right_root; ++j)
      if (skip[j] == -1) skip[j] = right_root;
    if (build(right_idx, skip_to) < 0) return -1;
    return me;
  }
};

}  // namespace

extern "C" {

// Returns the node count, or -1 on overflow (caller retries with a larger
// max_nodes).  Output arrays must hold max_nodes entries.
int ptrt_build_bvh(const float* tri_min, const float* tri_max, int n_tris,
                   int leaf_size, int max_nodes, float* out_lo, float* out_hi,
                   int32_t* out_skip, uint8_t* out_is_leaf,
                   int32_t* out_slots) {
  if (n_tris <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.leaf_size = leaf_size;
  b.max_nodes = max_nodes;
  b.lo = out_lo;
  b.hi = out_hi;
  b.skip = out_skip;
  b.is_leaf = out_is_leaf;
  b.slots = out_slots;
  b.cx.resize(n_tris);
  b.cy.resize(n_tris);
  b.cz.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    b.cx[i] = 0.5 * ((double)tri_min[3 * i + 0] + tri_max[3 * i + 0]);
    b.cy[i] = 0.5 * ((double)tri_min[3 * i + 1] + tri_max[3 * i + 1]);
    b.cz[i] = 0.5 * ((double)tri_min[3 * i + 2] + tri_max[3 * i + 2]);
  }
  std::vector<int32_t> root(n_tris);
  for (int i = 0; i < n_tris; ++i) root[i] = i;
  if (b.build(root, -2) < 0 || b.overflow) return -1;
  // resolve sentinels: -2 (end of walk) and any stray -1 → n_nodes
  for (int i = 0; i < b.n_nodes; ++i)
    if (b.skip[i] < 0) b.skip[i] = b.n_nodes;
  return b.n_nodes;
}
}
