// Native scene pipeline: triangle precompute, Morton ordering, octree build.
//
// The reference implements its host-side scene pipeline in native code (Rust:
// make_triangle raytrace.rs:340-383, build_bounding_box raytrace.rs:790-845,
// obj parsing; C++ host marshalling cuda_rt.cc:326-441).  This library is the
// TPU build's native runtime for the same stage: everything upstream of the
// device (parsing -> precompute -> spatial ordering -> octree) runs here at
// C++ speed for large scenes, exported through a plain C ABI consumed via
// ctypes (rust_raytrace_tpu/utils/native.py).  The numpy implementations
// remain as the portable fallback and as the differential test oracle.
//
// All math is float32 with the same operation order as geometry.py, so the
// two pipelines agree bit-for-bit almost everywhere (tests enforce 1e-6).
//
// Build: g++ -O3 -march=native -ffp-contract=off -shared -fPIC scene_pipeline.cc -o libscene.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float len2(V3 a) { return dot(a, a); }
inline V3 unit(V3 a) { return a * (1.0f / std::sqrt(len2(a))); }

inline V3 ld(const float* p) { return {p[0], p[1], p[2]}; }
inline void st(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }

}  // namespace

extern "C" {

// Triangle precompute (make_triangle, raytrace.rs:340-383): centroid,
// inward edge perpendiculars + distances, normal, bounding radius^2.
// points: [n,3,3] row-major f32.  Outputs: incenter [n,3], norm [n,3],
// sides [n,3,3], side_lens [n,3], bounding_r2 [n].
void rt_make_triangles(const float* points, int64_t n, float* incenter,
                       float* norm, float* sides, float* side_lens,
                       float* bounding_r2) {
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * 9;
    V3 a = ld(p), b = ld(p + 3), c = ld(p + 6);
    V3 cen = (a + b + c) * (1.0f / 3.0f);
    st(incenter + i * 3, cen);

    V3 corners[3] = {a, b, c};
    V3 s[3];
    for (int k = 0; k < 3; ++k) {
      V3 vedge = corners[(k + 1) % 3] - corners[k];
      V3 po = cen - corners[k];
      V3 pc = vedge * (dot(vedge, po) / len2(vedge));
      V3 oc = pc - po;
      float l = std::sqrt(len2(oc));
      s[k] = oc * (1.0f / l);
      st(sides + i * 9 + k * 3, s[k]);
      side_lens[i * 3 + k] = l;
    }
    st(norm + i * 3, unit(cross(s[0], s[1])));

    float r2 = 0.0f;
    for (int k = 0; k < 3; ++k) r2 = std::max(r2, len2(corners[k] - cen));
    bounding_r2[i] = r2;
  }
}

// Morton ordering of centroids 1..n-1 (pages.py morton_order): 10-bit
// quantization per axis, 30-bit interleave, stable sort.  out: [n-1] int64.
static inline uint64_t spread10(uint64_t x) {
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  x = (x | (x << 2)) & 0x09249249ull;
  return x;
}

void rt_morton_order(const float* incenter, int64_t n, int64_t* out) {
  if (n <= 1) return;
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 1; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], incenter[i * 3 + k]);
      hi[k] = std::max(hi[k], incenter[i * 3 + k]);
    }
  float span[3];
  for (int k = 0; k < 3; ++k) span[k] = std::max(hi[k] - lo[k], 1e-20f);

  std::vector<std::pair<uint64_t, int64_t>> keyed(n - 1);
  for (int64_t i = 1; i < n; ++i) {
    uint64_t code = 0;
    for (int k = 0; k < 3; ++k) {
      float q = (incenter[i * 3 + k] - lo[k]) / span[k] * 1024.0f;
      uint32_t qi = (uint32_t)std::min(q, 1023.0f);
      code |= spread10(qi) << k;
    }
    keyed[i - 1] = {code, i};
  }
  std::stable_sort(keyed.begin(), keyed.end(),
                   [](auto& a, auto& b) { return a.first < b.first; });
  for (int64_t i = 0; i < n - 1; ++i) out[i] = keyed[i].second;
}

// KD page ordering (pages.py kd_order): recursive page-aligned SAH splits of
// the centroids — axis AND split position minimizing
// SA(left)*n_left + SA(right)*n_right over all page-multiple positions.
// Exact behavioral copy of the numpy version: same stable sorts, the same
// left-associative f32 cost arithmetic (the build uses -ffp-contract=off),
// strict-< first-wins tie rule over (axis asc, split asc) — so the two paths
// emit identical orders and the differential test can assert equality.
static float half_area3(const float* lo, const float* hi) {
  float e0 = hi[0] - lo[0];
  float e1 = hi[1] - lo[1];
  float e2 = hi[2] - lo[2];
  return e0 * e1 + e1 * e2 + e2 * e0;
}

static void kd_rec(const float* c, int64_t* ids, int64_t n, int64_t page,
                   int64_t** out_cursor) {
  if (n <= page) {
    std::copy(ids, ids + n, *out_cursor);
    *out_cursor += n;
    return;
  }
  int64_t kpages = (n + page - 1) / page;
  float best_cost = 0.0f;
  bool have_best = false;
  int64_t best_nl = 0;
  std::vector<int64_t> best_order;
  std::vector<int64_t> o(n);
  std::vector<float> pmin(3 * n), pmax(3 * n), smin(3 * n), smax(3 * n);
  for (int ax = 0; ax < 3; ++ax) {
    std::copy(ids, ids + n, o.begin());
    std::stable_sort(o.begin(), o.end(), [c, ax](int64_t a, int64_t b) {
      return c[a * 3 + ax] < c[b * 3 + ax];
    });
    for (int k = 0; k < 3; ++k) {
      pmin[k] = pmax[k] = c[o[0] * 3 + k];
      smin[(n - 1) * 3 + k] = smax[(n - 1) * 3 + k] = c[o[n - 1] * 3 + k];
    }
    for (int64_t i = 1; i < n; ++i)
      for (int k = 0; k < 3; ++k) {
        float v = c[o[i] * 3 + k];
        pmin[i * 3 + k] = std::min(pmin[(i - 1) * 3 + k], v);
        pmax[i * 3 + k] = std::max(pmax[(i - 1) * 3 + k], v);
      }
    for (int64_t i = n - 2; i >= 0; --i)
      for (int k = 0; k < 3; ++k) {
        float v = c[o[i] * 3 + k];
        smin[i * 3 + k] = std::min(smin[(i + 1) * 3 + k], v);
        smax[i * 3 + k] = std::max(smax[(i + 1) * 3 + k], v);
      }
    for (int64_t kl = 1; kl < kpages; ++kl) {
      int64_t nl = kl * page;
      if (nl >= n) break;
      float sal = half_area3(&pmin[(nl - 1) * 3], &pmax[(nl - 1) * 3]);
      float sar = half_area3(&smin[nl * 3], &smax[nl * 3]);
      float cost = sal * (float)nl + sar * (float)(n - nl);
      if (!have_best || cost < best_cost) {
        have_best = true;
        best_cost = cost;
        best_nl = nl;
        best_order = o;
      }
    }
  }
  std::copy(best_order.begin(), best_order.end(), ids);
  kd_rec(c, ids, best_nl, page, out_cursor);
  kd_rec(c, ids + best_nl, n - best_nl, page, out_cursor);
}

void rt_kd_order(const float* incenter, int64_t n, int64_t page_size,
                 int64_t* out) {
  if (n <= 1) return;
  std::vector<int64_t> ids(n - 1);
  for (int64_t i = 1; i < n; ++i) ids[i - 1] = i;
  int64_t* cursor = out;
  kd_rec(incenter, ids.data(), n - 1, page_size, &cursor);
}

// ---------------------------------------------------------------------------
// Octree build (build_bounding_box, raytrace.rs:790-845) with the reference's
// box_contains_polygon / face_contains_triangle predicates (:645-779).
// Flattened output: per node (orig, len2, depth, kind) plus child/leaf spans.

namespace {

struct TriData {
  const float* incenter;   // [n,3]
  const float* norm;       // [n,3]
  const float* corners;    // [n,3,3]
  int64_t n;
};

bool box_contains_point(V3 orig, float len2v, V3 p) {
  V3 op = p - orig;
  return std::fabs(op.x) < len2v && std::fabs(op.y) < len2v &&
         std::fabs(op.z) < len2v;
}

// face_contains_triangle (raytrace.rs:645-729)
bool face_contains_triangle(V3 p, V3 n1, float len2v, const TriData& td,
                            int64_t t) {
  V3 tn = ld(td.norm + t * 3);
  V3 tc = ld(td.incenter + t * 3);
  float h1 = dot(n1, p + n1 * len2v);
  float h2 = dot(tn, tc);
  float nd = dot(n1, tn);
  float denom = 1.0f - nd * nd;
  float c1 = (h1 - h2 * nd) / denom;
  float c2 = (h2 - h1 * nd) / denom;

  V3 lo_ = n1 * c1 + tn * c2;
  V3 dirc = cross(n1, tn);
  V3 dir = unit(dirc);               // make_ray normalizes (raytrace.rs:201)
  V3 inv = {1.0f / dir.x, 1.0f / dir.y, 1.0f / dir.z};

  const float* pp = &p.x;
  const float* lop = &lo_.x;
  const float* invp = &inv.x;
  const float* n1p = &n1.x;

  // first clip: pull origin behind the box if needed (raytrace.rs:659-685)
  float tmin = 3.402823466e38f;
  for (int k = 0; k < 3; ++k) {
    if (n1p[k] != 0.0f) continue;
    float t1 = (pp[k] - len2v - lop[k]) * invp[k];
    float t2 = (pp[k] + len2v - lop[k]) * invp[k];
    tmin = std::min(tmin, std::min(t1, t2));
  }
  V3 lo2 = lo_;
  if (!(tmin > 0.0f)) lo2 = lo_ + dir * (tmin * 2.0f);

  // slab clip on free axes (raytrace.rs:687-716)
  const float* lo2p = &lo2.x;
  tmin = -3.402823466e38f;
  float tmax = 3.402823466e38f;
  for (int k = 0; k < 3; ++k) {
    if (n1p[k] != 0.0f) continue;
    float t1 = (pp[k] - len2v - lo2p[k]) * invp[k];
    float t2 = (pp[k] + len2v - lo2p[k]) * invp[k];
    tmin = std::max(tmin, std::min(t1, t2));
    tmax = std::min(tmax, std::max(t1, t2));
  }
  if (tmax < tmin) return false;

  // does the line pass between the projected corners? (raytrace.rs:718-728)
  V3 proj[3], dv[3];
  for (int k = 0; k < 3; ++k) {
    V3 corner = ld(td.corners + t * 9 + k * 3);
    float tp = dot(corner - lo2, dir) / len2(dir);
    proj[k] = lo2 + dir * tp;
    dv[k] = proj[k] - corner;
  }
  return dot(dv[0], dv[1]) < 0.0f || dot(dv[0], dv[2]) < 0.0f ||
         dot(dv[1], dv[2]) < 0.0f;
}

bool box_contains_polygon(V3 orig, float len2v, const TriData& td, int64_t t) {
  if (box_contains_point(orig, len2v, ld(td.incenter + t * 3))) return true;
  for (int k = 0; k < 3; ++k)
    if (box_contains_point(orig, len2v, ld(td.corners + t * 9 + k * 3)))
      return true;
  static const V3 faces[6] = {{1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                              {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};
  for (const V3& f : faces)
    if (face_contains_triangle(orig, f, len2v, td, t)) return true;
  return false;
}

struct FlatTree {
  // per node: orig[3], len2, depth, first_child, num_children,
  //           leaf_start, leaf_count  (children are contiguous)
  std::vector<float> node_orig;
  std::vector<float> node_len2;
  std::vector<int32_t> node_depth;
  std::vector<int32_t> children_start;
  std::vector<int32_t> num_children;
  std::vector<int32_t> child_indices;
  std::vector<int64_t> leaf_start;
  std::vector<int64_t> leaf_count;
  std::vector<int64_t> leaf_tris;
};

int32_t build_rec(const TriData& td, const std::vector<int64_t>& objs, V3 orig,
                  float len2v, int depth, int maxdepth, int minobjs,
                  FlatTree& out) {
  std::vector<int64_t> contained;
  contained.reserve(objs.size());
  for (int64_t t : objs)
    if (box_contains_polygon(orig, len2v, td, t)) contained.push_back(t);
  if (contained.empty()) return -1;

  int32_t me = (int32_t)out.node_len2.size();
  out.node_orig.insert(out.node_orig.end(), {orig.x, orig.y, orig.z});
  out.node_len2.push_back(len2v);
  out.node_depth.push_back(depth);
  out.children_start.push_back(-1);
  out.num_children.push_back(0);
  out.leaf_start.push_back(-1);
  out.leaf_count.push_back(0);

  if ((int)contained.size() < minobjs || depth >= maxdepth) {
    out.leaf_start[me] = (int64_t)out.leaf_tris.size();
    out.leaf_count[me] = (int64_t)contained.size();
    out.leaf_tris.insert(out.leaf_tris.end(), contained.begin(),
                         contained.end());
    return me;
  }

  float nl = len2v / 2.0f;
  std::vector<int32_t> kids;
  for (int i = 0; i < 8; ++i) {
    V3 off = {(i & 1) ? nl : -nl, (i & 2) ? nl : -nl, (i & 4) ? nl : -nl};
    int32_t k = build_rec(td, contained, orig + off, nl, depth + 1, maxdepth,
                          minobjs, out);
    if (k >= 0) kids.push_back(k);
  }
  if (kids.empty()) {
    // roll back this node (the reference returns None, raytrace.rs:842-844)
    out.node_orig.resize(me * 3);
    out.node_len2.resize(me);
    out.node_depth.resize(me);
    out.children_start.resize(me);
    out.num_children.resize(me);
    out.leaf_start.resize(me);
    out.leaf_count.resize(me);
    return -1;
  }
  out.children_start[me] = (int32_t)out.child_indices.size();
  out.num_children[me] = (int32_t)kids.size();
  out.child_indices.insert(out.child_indices.end(), kids.begin(), kids.end());
  return me;
}

FlatTree* g_last_tree = nullptr;

}  // namespace

// Build the octree; returns (num_nodes, num_leaf_tris) via out params.  The
// flat arrays are fetched with rt_octree_fetch + rt_octree_free.
// Children are listed per node in the child_indices array (spans given by
// children_start/num_children).
int32_t rt_build_octree(const float* incenter, const float* norm,
                        const float* corners, int64_t n, const float* orig,
                        float len2v, int32_t maxdepth, int32_t minobjs,
                        int64_t* num_nodes, int64_t* num_leaf_tris,
                        int64_t* num_child_entries) {
  TriData td{incenter, norm, corners, n};
  std::vector<int64_t> refvec;
  refvec.reserve(n > 0 ? n - 1 : 0);
  for (int64_t i = 1; i < n; ++i) refvec.push_back(i);  // skip sentinel (:791)

  delete g_last_tree;
  g_last_tree = new FlatTree();
  int32_t root = build_rec(td, refvec, ld(orig), len2v, 0, maxdepth, minobjs,
                           *g_last_tree);
  *num_nodes = (int64_t)g_last_tree->node_len2.size();
  *num_leaf_tris = (int64_t)g_last_tree->leaf_tris.size();
  *num_child_entries = (int64_t)g_last_tree->child_indices.size();
  return root;
}

void rt_octree_fetch(float* node_orig, float* node_len2, int32_t* node_depth,
                     int32_t* children_start, int32_t* num_children,
                     int32_t* child_indices, int64_t* leaf_start,
                     int64_t* leaf_count, int64_t* leaf_tris) {
  FlatTree& t = *g_last_tree;
  std::memcpy(node_orig, t.node_orig.data(), t.node_orig.size() * 4);
  std::memcpy(node_len2, t.node_len2.data(), t.node_len2.size() * 4);
  std::memcpy(node_depth, t.node_depth.data(), t.node_depth.size() * 4);
  std::memcpy(children_start, t.children_start.data(),
              t.children_start.size() * 4);
  std::memcpy(num_children, t.num_children.data(), t.num_children.size() * 4);
  std::memcpy(child_indices, t.child_indices.data(),
              t.child_indices.size() * 4);
  std::memcpy(leaf_start, t.leaf_start.data(), t.leaf_start.size() * 8);
  std::memcpy(leaf_count, t.leaf_count.data(), t.leaf_count.size() * 8);
  std::memcpy(leaf_tris, t.leaf_tris.data(), t.leaf_tris.size() * 8);
  delete g_last_tree;
  g_last_tree = nullptr;
}

}  // extern "C"
