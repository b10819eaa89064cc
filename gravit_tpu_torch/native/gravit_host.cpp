// Native host runtime of gravit_tpu_torch: binned-SAH BVH builder + OBJ
// parser. A copy of gravit_tpu/native/gravit_host.cpp, so that the port
// builds the same trees (node table AND leaf triangle order) as the JAX
// package does by default.
//
// The reference keeps every host-side hot path in C++ (BVH build:
// data/accel/BVH.cpp; readers: data/reader/*). Device compute is PyTorch
// and CUDA; scene ingestion and acceleration-structure builds are native,
// exposed through a C ABI consumed via ctypes (native/__init__.py).
//
// Build: g++ -O3 -fPIC -shared -o libgravit_host-<digest>.so gravit_host.cpp
// (native/__init__.py builds it into gravit_tpu_torch/_build/ at first use)
//
// BVH output layout matches accel/bvh.py FlatBVH:
//   bounds: (n_nodes, 8) f32  lo.xyz hi.xyz pad pad
//   meta:   (n_nodes, 4) i32  [left|tri_start, right|tri_count, is_leaf, axis]
//   order:  (T,)        i32  leaf-order position -> original triangle id

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Aabb &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct BuildCtx {
  std::vector<Aabb> tri_box;
  std::vector<Vec3> centroid;
  std::vector<float> bounds;  // n_nodes * 8
  std::vector<int32_t> meta;  // n_nodes * 4
  std::vector<int32_t> order;
  int32_t order_pos = 0;
  int max_leaf = 8;
  int max_depth_seen = 0;
};

int new_node(BuildCtx &c) {
  c.bounds.insert(c.bounds.end(), 8, 0.f);
  c.meta.insert(c.meta.end(), 4, 0);
  return (int)(c.bounds.size() / 8) - 1;
}

void build_rec(BuildCtx &c, std::vector<int32_t> &idx, int begin, int end,
               int slot, int depth) {
  c.max_depth_seen = std::max(c.max_depth_seen, depth);
  Aabb box;
  for (int i = begin; i < end; ++i) box.grow(c.tri_box[idx[i]]);
  float *b = &c.bounds[slot * 8];
  b[0] = box.lo.x; b[1] = box.lo.y; b[2] = box.lo.z;
  b[3] = box.hi.x; b[4] = box.hi.y; b[5] = box.hi.z;

  int count = end - begin;
  if (count <= c.max_leaf || depth >= 60) {
    int32_t *m = &c.meta[slot * 4];
    m[0] = c.order_pos;
    m[1] = count;
    m[2] = 1;
    m[3] = 0;
    for (int i = begin; i < end; ++i) c.order[c.order_pos++] = idx[i];
    return;
  }

  // centroid extent -> split axis
  Aabb cb;
  for (int i = begin; i < end; ++i) cb.grow(c.centroid[idx[i]]);
  float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
  int axis = 0;
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;

  int mid;
  if (ext[axis] <= 0.f) {
    mid = begin + count / 2;
  } else {
    const float cmin = axis == 0 ? cb.lo.x : axis == 1 ? cb.lo.y : cb.lo.z;
    const float scale = kBins * (1.0f - 1e-6f) / ext[axis];
    auto bin_of = [&](int t) {
      const Vec3 &p = c.centroid[t];
      float v = axis == 0 ? p.x : axis == 1 ? p.y : p.z;
      int bidx = (int)((v - cmin) * scale);
      return std::min(bidx, kBins - 1);
    };
    int counts[kBins] = {0};
    Aabb bin_box[kBins];
    for (int i = begin; i < end; ++i) {
      int bi = bin_of(idx[i]);
      counts[bi]++;
      bin_box[bi].grow(c.tri_box[idx[i]]);
    }
    // prefix/suffix SAH sweep
    float lcost[kBins - 1], rcost[kBins - 1];
    {
      Aabb acc;
      int n = 0;
      for (int s = 0; s < kBins - 1; ++s) {
        acc.grow(bin_box[s]);
        n += counts[s];
        lcost[s] = n ? acc.area() * n : FLT_MAX / 4;
        if (!n) lcost[s] = FLT_MAX / 4;
      }
      Aabb racc;
      int rn = 0;
      for (int s = kBins - 2; s >= 0; --s) {
        racc.grow(bin_box[s + 1]);
        rn += counts[s + 1];
        rcost[s] = rn ? racc.area() * rn : FLT_MAX / 4;
        if (!rn) rcost[s] = FLT_MAX / 4;
      }
    }
    int best = -1;
    float best_cost = FLT_MAX;
    for (int s = 0; s < kBins - 1; ++s) {
      float cost = lcost[s] + rcost[s];
      if (cost < best_cost && lcost[s] < FLT_MAX / 8 &&
          rcost[s] < FLT_MAX / 8) {
        best_cost = cost;
        best = s;
      }
    }
    if (best < 0) {
      mid = begin + count / 2;
    } else {
      auto it = std::partition(idx.begin() + begin, idx.begin() + end,
                               [&](int t) { return bin_of(t) <= best; });
      mid = (int)(it - idx.begin());
      if (mid == begin || mid == end) mid = begin + count / 2;
    }
  }

  int l = new_node(c);
  int r = new_node(c);
  int32_t *m = &c.meta[slot * 4];
  m[0] = l;
  m[1] = r;
  m[2] = 0;
  m[3] = axis;
  build_rec(c, idx, begin, mid, l, depth + 1);
  build_rec(c, idx, mid, end, r, depth + 1);
}

}  // namespace

extern "C" {

// Returns n_nodes (>0) on success, -1 on failure. Caller provides buffers
// sized for the worst case: bounds 8*(2T), meta 4*(2T), order T.
int gravit_build_bvh(const float *v0, const float *e1, const float *e2,
                     int num_tris, int max_leaf, float *bounds_out,
                     int32_t *meta_out, int32_t *order_out,
                     int32_t *depth_out) {
  if (num_tris <= 0) return -1;
  BuildCtx c;
  c.max_leaf = max_leaf;
  c.tri_box.resize(num_tris);
  c.centroid.resize(num_tris);
  c.order.resize(num_tris);
  for (int t = 0; t < num_tris; ++t) {
    Vec3 a{v0[3 * t], v0[3 * t + 1], v0[3 * t + 2]};
    Vec3 b{a.x + e1[3 * t], a.y + e1[3 * t + 1], a.z + e1[3 * t + 2]};
    Vec3 d{a.x + e2[3 * t], a.y + e2[3 * t + 1], a.z + e2[3 * t + 2]};
    Aabb box;
    box.grow(a);
    box.grow(b);
    box.grow(d);
    c.tri_box[t] = box;
    c.centroid[t] = {(box.lo.x + box.hi.x) * 0.5f,
                     (box.lo.y + box.hi.y) * 0.5f,
                     (box.lo.z + box.hi.z) * 0.5f};
  }
  std::vector<int32_t> idx(num_tris);
  for (int t = 0; t < num_tris; ++t) idx[t] = t;

  int root = new_node(c);
  build_rec(c, idx, 0, num_tris, root, 0);

  int n_nodes = (int)(c.bounds.size() / 8);
  std::memcpy(bounds_out, c.bounds.data(), c.bounds.size() * sizeof(float));
  std::memcpy(meta_out, c.meta.data(), c.meta.size() * sizeof(int32_t));
  std::memcpy(order_out, c.order.data(), c.order.size() * sizeof(int32_t));
  if (depth_out) *depth_out = c.max_depth_seen;
  return n_nodes;
}

// Fast OBJ scan: counts then fills vertex/face arrays (triangulated fan).
// Two-pass C ABI: call with verts=faces=null to get counts.
int gravit_parse_obj(const char *path, float *verts, int32_t *faces,
                     int32_t *nv_out, int32_t *nf_out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  int64_t nv = 0, nf = 0;
  const bool counting = (verts == nullptr);
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      if (counting) {
        nv++;
      } else {
        float x, y, z;
        if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
          verts[3 * nv] = x;
          verts[3 * nv + 1] = y;
          verts[3 * nv + 2] = z;
          nv++;
        }
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      // tokenize: take leading int of each vertex spec
      int ids[64];
      int n = 0;
      char *p = line + 2;
      while (*p && n < 64) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == 0 || *p == '\n' || *p == '\r') break;
        long v = std::strtol(p, &p, 10);
        if (v < 0) v = nv + v + 1;  // negative relative (1-based here)
        ids[n++] = (int)v - 1;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      for (int k = 1; k + 1 < n; ++k) {
        if (counting) {
          nf++;
        } else {
          faces[3 * nf] = ids[0];
          faces[3 * nf + 1] = ids[k];
          faces[3 * nf + 2] = ids[k + 1];
          nf++;
        }
      }
    }
  }
  std::fclose(f);
  *nv_out = (int32_t)nv;
  *nf_out = (int32_t)nf;
  return 0;
}

}  // extern "C"
