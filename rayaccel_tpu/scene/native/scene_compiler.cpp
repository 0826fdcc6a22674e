// Native host-side scene compiler for rayaccel_tpu.
//
// Role of the reference's native scene-compile tier (Bvh2.cpp SAH builder +
// ThreadPool.cpp fork-join pool + the TrianglePair pass of Scene.cpp):
// the one part of this framework that stays latency-bound host code.
// Re-designed rather than translated: std::thread task recursion instead
// of a hand-rolled pool, explicit work stack instead of recursion-in-bbox
// tricks, and plain scalar loops (the AVX2 sweeps of the reference buy
// nothing here because scene compilation is a once-per-scene cost and the
// compiler autovectorizes the sweeps).
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Algorithm (same family as Bvh2.cpp:257-535):
//   - three centroid-sorted index orders, stable-partitioned per split
//   - exact full-sweep SAH with prefix/suffix bound sweeps
//   - costs: traversal 2, intersection 1; forced median split when a
//     would-be leaf exceeds max_leaf (<= 127, device leaf encoding)
//   - subtrees above a grain size build in parallel tasks

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(Vec3 a, Vec3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(Vec3 a, Vec3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline double half_area(Vec3 lo, Vec3 hi) {
  double dx = std::max(0.0f, hi.x - lo.x);
  double dy = std::max(0.0f, hi.y - lo.y);
  double dz = std::max(0.0f, hi.z - lo.z);
  return dx * dy + dy * dz + dz * dx;
}

constexpr double kTraversalCost = 2.0;
constexpr double kIntersectionCost = 1.0;
constexpr int kMaxLeafHard = 127;
constexpr int64_t kParallelGrain = 8192;

struct Builder {
  const float* verts;  // (V, 3)
  const uint32_t* idx; // (T, 3)
  int64_t T;
  int max_leaf;

  std::vector<Vec3> tmin, tmax;       // per-triangle bounds
  std::vector<float> cent[3];         // per-triangle centroids
  std::vector<int64_t> order[3];      // per-axis sorted windows
  std::vector<uint8_t> left_flag;

  // Output node arrays (grown under a mutex; indices stable).
  std::mutex node_mu;
  std::vector<uint8_t> kind;
  std::vector<int64_t> first, last, parent;
  std::vector<Vec3> nbmin, nbmax;

  std::atomic<int> active_tasks{0};

  int64_t alloc_node(int64_t par) {
    std::lock_guard<std::mutex> g(node_mu);
    kind.push_back(0);
    first.push_back(0);
    last.push_back(0);
    parent.push_back(par);
    nbmin.push_back({0, 0, 0});
    nbmax.push_back({0, 0, 0});
    return (int64_t)kind.size() - 1;
  }

  void set_node(int64_t n, uint8_t k, int64_t f, int64_t l, Vec3 lo, Vec3 hi) {
    std::lock_guard<std::mutex> g(node_mu);
    kind[n] = k;
    first[n] = f;
    last[n] = l;
    nbmin[n] = lo;
    nbmax[n] = hi;
  }

  // Build the subtree for window [start, end) rooted at `node`.
  void build(int64_t node, int64_t start, int64_t end,
             std::vector<std::future<void>>* futures,
             std::mutex* fut_mu) {
    const int64_t n = end - start;

    Vec3 lo = tmin[order[0][start]];
    Vec3 hi = tmax[order[0][start]];
    for (int64_t i = start + 1; i < end; ++i) {
      lo = vmin(lo, tmin[order[0][i]]);
      hi = vmax(hi, tmax[order[0][i]]);
    }

    bool make_leaf = n <= 1;
    int best_axis = -1;
    int64_t best_pivot = -1;

    if (!make_leaf) {
      double best_cost = std::numeric_limits<double>::infinity();
      // Reusable suffix-area scratch.
      static thread_local std::vector<double> suffix;
      if ((int64_t)suffix.size() < n) suffix.resize(n);

      for (int axis = 0; axis < 3; ++axis) {
        const int64_t* ord = order[axis].data() + start;
        // Backward sweep: suffix half-areas.
        Vec3 slo = tmin[ord[n - 1]];
        Vec3 shi = tmax[ord[n - 1]];
        suffix[n - 1] = half_area(slo, shi);
        for (int64_t i = n - 2; i >= 1; --i) {
          slo = vmin(slo, tmin[ord[i]]);
          shi = vmax(shi, tmax[ord[i]]);
          suffix[i] = half_area(slo, shi);
        }
        // Forward sweep with combined cost.
        Vec3 plo = tmin[ord[0]];
        Vec3 phi = tmax[ord[0]];
        for (int64_t i = 1; i < n; ++i) {
          double c = half_area(plo, phi) * (double)i
                     + suffix[i] * (double)(n - i);
          if (c < best_cost) {
            best_cost = c;
            best_axis = axis;
            best_pivot = i;
          }
          plo = vmin(plo, tmin[ord[i]]);
          phi = vmax(phi, tmax[ord[i]]);
        }
      }

      const double area = std::max(half_area(lo, hi), 1e-300);
      const double split_cost =
          kTraversalCost + best_cost / area * kIntersectionCost;
      const double leaf_cost = (double)n * kIntersectionCost;
      if (split_cost >= leaf_cost && n <= max_leaf) make_leaf = true;
    }

    if (make_leaf && n > max_leaf) {
      // Forced median split on the widest axis (Bvh2.cpp:478-485 analog).
      float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
      best_axis = (dx >= dy && dx >= dz) ? 0 : (dy >= dz ? 1 : 2);
      best_pivot = n / 2;
      make_leaf = false;
    }

    if (make_leaf) {
      set_node(node, 0, start, end, lo, hi);
      return;
    }

    // Stable 3-axis partition via the left-membership flags.
    {
      const int64_t* ord = order[best_axis].data() + start;
      for (int64_t i = 0; i < best_pivot; ++i) left_flag[ord[i]] = 1;
      static thread_local std::vector<int64_t> tmpv;
      if ((int64_t)tmpv.size() < n) tmpv.resize(n);
      for (int other = 0; other < 3; ++other) {
        if (other == best_axis) continue;
        int64_t* o = order[other].data() + start;
        int64_t a = 0, b = best_pivot;
        for (int64_t i = 0; i < n; ++i) {
          if (left_flag[o[i]]) tmpv[a++] = o[i];
          else tmpv[b++] = o[i];
        }
        std::memcpy(o, tmpv.data(), sizeof(int64_t) * n);
      }
      for (int64_t i = 0; i < best_pivot; ++i) left_flag[ord[i]] = 0;
    }

    int64_t lchild = alloc_node(node);
    int64_t rchild = alloc_node(node);
    set_node(node, 1, lchild, rchild, lo, hi);

    const int64_t mid = start + best_pivot;
    const bool spawn = (n > kParallelGrain) &&
        active_tasks.load() < (int)std::thread::hardware_concurrency() * 2;
    if (spawn) {
      active_tasks.fetch_add(1);
      std::future<void> f = std::async(std::launch::async, [=]() {
        build(rchild, mid, end, futures, fut_mu);
        active_tasks.fetch_sub(1);
      });
      {
        std::lock_guard<std::mutex> g(*fut_mu);
        futures->push_back(std::move(f));
      }
      build(lchild, start, mid, futures, fut_mu);
    } else {
      build(lchild, start, mid, futures, fut_mu);
      build(rchild, mid, end, futures, fut_mu);
    }
  }
};

Builder* g_last = nullptr;  // simple single-threaded-session result holder
std::mutex g_mu;

}  // namespace

extern "C" {

// Build the BVH. Returns the node count (<0 on error). Results are staged
// internally; fetch with racc_fetch_bvh, then racc_release.
int64_t racc_build_bvh(const float* verts, int64_t vert_count,
                       const uint32_t* idx, int64_t tri_count,
                       int max_leaf) {
  (void)vert_count;
  if (tri_count < 1) return -1;
  if (max_leaf > kMaxLeafHard) max_leaf = kMaxLeafHard;
  if (max_leaf < 1) max_leaf = 1;

  std::lock_guard<std::mutex> g(g_mu);
  delete g_last;
  auto* b = new Builder();
  g_last = b;
  b->verts = verts;
  b->idx = idx;
  b->T = tri_count;
  b->max_leaf = max_leaf;

  b->tmin.resize(tri_count);
  b->tmax.resize(tri_count);
  for (int a = 0; a < 3; ++a) {
    b->cent[a].resize(tri_count);
    b->order[a].resize(tri_count);
  }
  b->left_flag.assign(tri_count, 0);

  // Bounds + centroids (Bvh2.cpp:537-753 role), parallel over chunks.
  {
    const int nthreads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> ts;
    const int64_t chunk = (tri_count + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const int64_t s = t * chunk, e = std::min<int64_t>(tri_count, s + chunk);
      if (s >= e) break;
      ts.emplace_back([=]() {
        for (int64_t i = s; i < e; ++i) {
          const uint32_t* tri = idx + i * 3;
          Vec3 v0 = {verts[tri[0] * 3], verts[tri[0] * 3 + 1], verts[tri[0] * 3 + 2]};
          Vec3 v1 = {verts[tri[1] * 3], verts[tri[1] * 3 + 1], verts[tri[1] * 3 + 2]};
          Vec3 v2 = {verts[tri[2] * 3], verts[tri[2] * 3 + 1], verts[tri[2] * 3 + 2]};
          Vec3 lo = vmin(v0, vmin(v1, v2));
          Vec3 hi = vmax(v0, vmax(v1, v2));
          b->tmin[i] = lo;
          b->tmax[i] = hi;
          b->cent[0][i] = 0.5f * (lo.x + hi.x);
          b->cent[1][i] = 0.5f * (lo.y + hi.y);
          b->cent[2][i] = 0.5f * (lo.z + hi.z);
        }
      });
    }
    for (auto& t : ts) t.join();
  }

  // Three concurrent centroid sorts (role of the radix-sort tasks,
  // Bvh2.cpp:863-894); stable for determinism.
  {
    std::vector<std::thread> ts;
    for (int a = 0; a < 3; ++a) {
      ts.emplace_back([b, a]() {
        auto& ord = b->order[a];
        for (int64_t i = 0; i < b->T; ++i) ord[i] = i;
        const float* c = b->cent[a].data();
        std::stable_sort(ord.begin(), ord.end(),
                         [c](int64_t x, int64_t y) { return c[x] < c[y]; });
      });
    }
    for (auto& t : ts) t.join();
  }

  const int64_t root = b->alloc_node(-1);
  std::vector<std::future<void>> futures;
  std::mutex fut_mu;
  b->build(root, 0, tri_count, &futures, &fut_mu);
  // Tasks may append more tasks; drain until stable.
  for (;;) {
    std::vector<std::future<void>> batch;
    {
      std::lock_guard<std::mutex> g2(fut_mu);
      batch.swap(futures);
    }
    if (batch.empty()) break;
    for (auto& f : batch) f.wait();
  }
  return (int64_t)b->kind.size();
}

// Copy staged results into caller buffers sized by racc_build_bvh's return.
void racc_fetch_bvh(uint8_t* kind, int64_t* first, int64_t* last,
                    int64_t* parent, float* bbmin, float* bbmax,
                    int64_t* prim_order) {
  std::lock_guard<std::mutex> g(g_mu);
  Builder* b = g_last;
  if (!b) return;
  const int64_t N = (int64_t)b->kind.size();
  std::memcpy(kind, b->kind.data(), N);
  std::memcpy(first, b->first.data(), N * 8);
  std::memcpy(last, b->last.data(), N * 8);
  std::memcpy(parent, b->parent.data(), N * 8);
  for (int64_t i = 0; i < N; ++i) {
    bbmin[i * 3] = b->nbmin[i].x;
    bbmin[i * 3 + 1] = b->nbmin[i].y;
    bbmin[i * 3 + 2] = b->nbmin[i].z;
    bbmax[i * 3] = b->nbmax[i].x;
    bbmax[i * 3 + 1] = b->nbmax[i].y;
    bbmax[i * 3 + 2] = b->nbmax[i].z;
  }
  std::memcpy(prim_order, b->order[0].data(), b->T * 8);
}

void racc_release() {
  std::lock_guard<std::mutex> g(g_mu);
  delete g_last;
  g_last = nullptr;
}

// Shared-edge triangle pairing for one leaf (Scene.cpp:109-181 role).
// tri_ids: leaf triangle ids; writes pair rows [e1,e2,e3,p0] (12 floats),
// remap entries (2 per pair: orig | code<<30) and returns the pair count.
int64_t racc_pair_leaf(const float* verts, const uint32_t* idx,
                       const int64_t* tri_ids, int64_t count,
                       float* pair_rows, uint32_t* remap) {
  std::vector<int64_t> cand(tri_ids, tri_ids + count);
  int64_t pairs = 0;
  auto vtx = [&](uint32_t v) -> Vec3 {
    return {verts[v * 3], verts[v * 3 + 1], verts[v * 3 + 2]};
  };
  while (!cand.empty()) {
    const int64_t first_tri = cand.front();
    cand.erase(cand.begin());
    const uint32_t* t0 = idx + first_tri * 3;
    int match = -1, e0 = -1, e1 = -1;
    for (size_t ci = 0; ci < cand.size() && match < 0; ++ci) {
      const uint32_t* t1 = idx + cand[ci] * 3;
      for (int a = 0; a < 3 && match < 0; ++a) {
        for (int bb = 0; bb < 3; ++bb) {
          if (t0[a] == t1[(bb + 1) % 3] && t0[(a + 1) % 3] == t1[bb]) {
            match = (int)ci;
            e0 = a;
            e1 = bb;
            break;
          }
        }
      }
    }
    float* row = pair_rows + pairs * 12;
    if (match >= 0) {
      const int64_t second = cand[match];
      cand.erase(cand.begin() + match);
      const uint32_t* t1 = idx + second * 3;
      Vec3 p0 = vtx(t0[e0]);
      Vec3 p1 = vtx(t0[(e0 + 1) % 3]);
      Vec3 p2 = vtx(t0[(e0 + 2) % 3]);
      Vec3 p3 = vtx(t1[(e1 + 2) % 3]);
      row[0] = p0.x - p1.x; row[1] = p0.y - p1.y; row[2] = p0.z - p1.z;
      row[3] = p2.x - p0.x; row[4] = p2.y - p0.y; row[5] = p2.z - p0.z;
      row[6] = p3.x - p0.x; row[7] = p3.y - p0.y; row[8] = p3.z - p0.z;
      row[9] = p0.x; row[10] = p0.y; row[11] = p0.z;
      remap[pairs * 2] = (uint32_t)first_tri | ((uint32_t)e0 << 30);
      remap[pairs * 2 + 1] = (uint32_t)second | ((uint32_t)(e1 + 1) << 30);
    } else {
      // Degenerate self-pair: p3 = p1 => zero-area second triangle.
      Vec3 p0 = vtx(t0[0]);
      Vec3 p1 = vtx(t0[1]);
      Vec3 p2 = vtx(t0[2]);
      row[0] = p0.x - p1.x; row[1] = p0.y - p1.y; row[2] = p0.z - p1.z;
      row[3] = p2.x - p0.x; row[4] = p2.y - p0.y; row[5] = p2.z - p0.z;
      row[6] = p1.x - p0.x; row[7] = p1.y - p0.y; row[8] = p1.z - p0.z;
      row[9] = p0.x; row[10] = p0.y; row[11] = p0.z;
      remap[pairs * 2] = (uint32_t)first_tri;
      remap[pairs * 2 + 1] = (uint32_t)first_tri;
    }
    ++pairs;
  }
  return pairs;
}

// Pair every leaf in one call (avoids per-leaf FFI overhead). Inputs are
// the BVH arrays; outputs sized for the worst case (pairs <= tri_count).
// Writes per-node pair ranges into leaf_first/leaf_last (pair indices) and
// returns the total pair count.
int64_t racc_pair_all(const float* verts, const uint32_t* idx,
                      const uint8_t* kind, const int64_t* first,
                      const int64_t* last, int64_t node_count,
                      const int64_t* prim_order,
                      float* pair_rows, uint32_t* remap,
                      int64_t* leaf_first, int64_t* leaf_last) {
  int64_t pairs = 0;
  std::vector<int64_t> ids;
  for (int64_t n = 0; n < node_count; ++n) {
    if (kind[n] != 0) {
      leaf_first[n] = 0;
      leaf_last[n] = 0;
      continue;
    }
    leaf_first[n] = pairs;
    ids.assign(prim_order + first[n], prim_order + last[n]);
    pairs += racc_pair_leaf(verts, idx, ids.data(), (int64_t)ids.size(),
                            pair_rows + pairs * 12, remap + pairs * 2);
    leaf_last[n] = pairs;
  }
  return pairs;
}

}  // extern "C"
