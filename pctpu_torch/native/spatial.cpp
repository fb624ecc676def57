// pctpu native spatial index: KD-tree + octree with kNN / radius search.
//
// Host-side counterpart of the reference's from-scratch Python trees
// (Kdtree_Octree/lesson2/kdtree.py:10-208, octree.py:51-328,
// result_set.py:6-93 — SURVEY.md C3-C5). The TPU compute path serves the
// same capability with MXU-tiled / Pallas search (pctpu.ops); this library
// covers the host-side uses (ETL radius grouping, benchmark parity, small
// ad-hoc queries) at C++ speed with threaded batch queries.
//
// Reference semantics kept:
//   * KD-tree: round-robin split axis (kdtree.py:131 axis = (axis+1)%dim),
//     median split, leaf_size leaves; kNN prunes on axis distance vs worst
//     dist (kdtree.py:158-171); radius search identical with fixed worst
//     (kdtree.py:176-208).
//   * Octree: cube from max extent, 8-way morton-code children
//     (octree.py:88-97), termination on leaf_size OR min_extent
//     (octree.py:63); kNN visits the query's octant first then siblings with
//     overlaps() pruning and inside() early stop (octree.py:262-306); radius
//     search has a contains() fast path that skips per-point distance checks
//     when the octant is fully inside the ball (octree.py:151-163,199).
//     Unlike the reference — whose fast path only fires at the root because
//     it recurses into the non-fast variant (octree.py:199,208, SURVEY.md
//     §0) — the fast path here applies at every level.
//   * Comparison counters: every point-distance evaluation is counted per
//     query (result_set.py:24,36-37 comparison_counter), returned so callers
//     can report "%d comparison operations" like result_set.py:59,91-92.
//
// Exposed via ctypes (pctpu/native/spatial.py); built with plain g++.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <vector>

namespace {

struct KnnHeap {
    // Bounded worst-first list, insertion-sorted like the reference's
    // KNNResultSet.add_point (result_set.py:30-47). k is small (<=64).
    float* d2;     // [k], ascending
    int* idx;      // [k]
    int k, count;
    void init(float* d2buf, int* idxbuf, int kk) {
        d2 = d2buf; idx = idxbuf; k = kk; count = 0;
        for (int i = 0; i < k; ++i) { d2[i] = INFINITY; idx[i] = -1; }
    }
    inline float worst() const { return d2[k - 1]; }
    inline void add(float dist2, int i) {
        if (dist2 >= worst()) return;
        int j = k - 1;
        while (j > 0 && d2[j - 1] > dist2) {
            d2[j] = d2[j - 1]; idx[j] = idx[j - 1]; --j;
        }
        d2[j] = dist2; idx[j] = i;
        if (count < k) ++count;
    }
};

inline float dist2_3(const float* a, const float* b) {
    float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return dx * dx + dy * dy + dz * dz;
}

// ----------------------------------------------------------------- KD-tree
struct KdNode {
    int axis;       // -1 for leaf
    float split;
    int left, right;   // node indices
    int start, count;  // into perm[] (leaf only)
};

struct KdTree {
    std::vector<float> pts;   // [n*3]
    std::vector<int> perm;    // build-order permutation of point ids
    std::vector<KdNode> nodes;
    long n;

    int build(int lo, int hi, int axis, int leaf_size) {
        int id = (int)nodes.size();
        nodes.push_back({});
        KdNode& node_init = nodes[id];
        node_init.start = lo; node_init.count = hi - lo;
        if (hi - lo <= leaf_size) {
            nodes[id].axis = -1;
            nodes[id].left = nodes[id].right = -1;
            return id;
        }
        int mid = (lo + hi) / 2;
        const float* p = pts.data();
        std::nth_element(perm.begin() + lo, perm.begin() + mid,
                         perm.begin() + hi,
                         [p, axis](int a, int b) {
                             return p[3 * a + axis] < p[3 * b + axis];
                         });
        float split = p[3 * perm[mid] + axis];
        int next_axis = (axis + 1) % 3;  // kdtree.py:131 round-robin
        int l = build(lo, mid, next_axis, leaf_size);
        int r = build(mid, hi, next_axis, leaf_size);
        KdNode& node = nodes[id];
        node.axis = axis; node.split = split;
        node.left = l; node.right = r;
        return id;
    }

    void knn(const float* q, KnnHeap& rs, long& cmp, int node_id) const {
        const KdNode& nd = nodes[node_id];
        if (nd.axis < 0) {
            for (int i = nd.start; i < nd.start + nd.count; ++i) {
                int pi = perm[i];
                rs.add(dist2_3(q, &pts[3 * pi]), pi);
                ++cmp;
            }
            return;
        }
        float delta = q[nd.axis] - nd.split;
        int near = delta < 0.f ? nd.left : nd.right;
        int far = delta < 0.f ? nd.right : nd.left;
        knn(q, rs, cmp, near);
        if (delta * delta < rs.worst())  // kdtree.py:164-171 axis prune
            knn(q, rs, cmp, far);
    }

    void radius(const float* q, float r2, int cap, int* out_idx,
                float* out_d2, int& found, long& cmp, int node_id) const {
        const KdNode& nd = nodes[node_id];
        if (nd.axis < 0) {
            for (int i = nd.start; i < nd.start + nd.count; ++i) {
                int pi = perm[i];
                float d2 = dist2_3(q, &pts[3 * pi]);
                ++cmp;
                if (d2 <= r2) {
                    if (found < cap) { out_idx[found] = pi; out_d2[found] = d2; }
                    ++found;  // keep counting past cap (overflow observable)
                }
            }
            return;
        }
        float delta = q[nd.axis] - nd.split;
        int near = delta < 0.f ? nd.left : nd.right;
        int far = delta < 0.f ? nd.right : nd.left;
        radius(q, r2, cap, out_idx, out_d2, found, cmp, near);
        if (delta * delta <= r2)  // kdtree.py:199-207 fixed worst dist
            radius(q, r2, cap, out_idx, out_d2, found, cmp, far);
    }
};

// ------------------------------------------------------------------ Octree
struct Octant {
    float cx, cy, cz, extent;
    int children[8];   // -1 = none
    int start, count;  // into perm[] (leaf only; count=0 for interior)
    bool leaf;
};

struct Octree {
    std::vector<float> pts;
    std::vector<int> perm;
    std::vector<Octant> nodes;
    long n;
    int leaf_size;
    float min_extent;

    int build(int lo, int hi, float cx, float cy, float cz, float extent) {
        int id = (int)nodes.size();
        nodes.push_back({});
        {
            Octant& oc = nodes[id];
            oc.cx = cx; oc.cy = cy; oc.cz = cz; oc.extent = extent;
            for (int c = 0; c < 8; ++c) oc.children[c] = -1;
            oc.start = lo; oc.count = hi - lo; oc.leaf = true;
        }
        // octree.py:63 termination: few points or tiny extent
        if (hi - lo <= leaf_size || extent <= min_extent) return id;
        // partition perm[lo:hi] into 8 morton buckets (octree.py:88-97)
        int bucket_of[8];
        std::vector<int> tmp(perm.begin() + lo, perm.begin() + hi);
        int counts[8] = {0};
        const float* p = pts.data();
        for (int t : tmp) {
            int code = (p[3 * t] > cx) | ((p[3 * t + 1] > cy) << 1)
                     | ((p[3 * t + 2] > cz) << 2);
            ++counts[code];
        }
        int offs[8]; int acc = lo;
        for (int c = 0; c < 8; ++c) { offs[c] = acc; bucket_of[c] = acc; acc += counts[c]; }
        for (int t : tmp) {
            int code = (p[3 * t] > cx) | ((p[3 * t + 1] > cy) << 1)
                     | ((p[3 * t + 2] > cz) << 2);
            perm[bucket_of[code]++] = t;
        }
        float half = extent * 0.5f;
        for (int c = 0; c < 8; ++c) {
            if (!counts[c]) continue;
            float ncx = cx + (c & 1 ? half : -half);
            float ncy = cy + (c & 2 ? half : -half);
            float ncz = cz + (c & 4 ? half : -half);
            int child = build(offs[c], offs[c] + counts[c], ncx, ncy, ncz, half);
            nodes[id].children[c] = child;
        }
        nodes[id].leaf = false;  // start/count keep the full subtree range
        return id;
    }

    // ball-box tests (octree.py:106-163)
    static inline bool inside(const float* q, float r, const Octant& oc) {
        // ball fully inside octant -> can stop searching elsewhere
        return std::fabs(q[0] - oc.cx) + r <= oc.extent
            && std::fabs(q[1] - oc.cy) + r <= oc.extent
            && std::fabs(q[2] - oc.cz) + r <= oc.extent;
    }
    static inline bool overlaps(const float* q, float r, const Octant& oc) {
        float dx = std::fabs(q[0] - oc.cx), dy = std::fabs(q[1] - oc.cy),
              dz = std::fabs(q[2] - oc.cz);
        float m = oc.extent + r;
        if (dx > m || dy > m || dz > m) return false;
        if ((dx < oc.extent) + (dy < oc.extent) + (dz < oc.extent) >= 2)
            return true;
        float ex = std::max(dx - oc.extent, 0.f), ey = std::max(dy - oc.extent, 0.f),
              ez = std::max(dz - oc.extent, 0.f);
        return ex * ex + ey * ey + ez * ez < r * r;
    }
    static inline bool contains(const float* q, float r, const Octant& oc) {
        // octant fully inside ball -> take every point without dist checks
        float dx = std::fabs(q[0] - oc.cx) + oc.extent,
              dy = std::fabs(q[1] - oc.cy) + oc.extent,
              dz = std::fabs(q[2] - oc.cz) + oc.extent;
        return dx * dx + dy * dy + dz * dz < r * r;
    }

    bool knn(const float* q, KnnHeap& rs, long& cmp, int node_id) const {
        const Octant& oc = nodes[node_id];
        if (oc.leaf) {
            for (int i = oc.start; i < oc.start + oc.count; ++i) {
                int pi = perm[i];
                rs.add(dist2_3(q, &pts[3 * pi]), pi);
                ++cmp;
            }
            return rs.count == rs.k && inside(q, std::sqrt(rs.worst()), oc);
        }
        // query's own octant first (octree.py:283-289)
        int code = (q[0] > oc.cx) | ((q[1] > oc.cy) << 1) | ((q[2] > oc.cz) << 2);
        if (oc.children[code] >= 0 && knn(q, rs, cmp, oc.children[code]))
            return true;
        for (int c = 0; c < 8; ++c) {
            if (c == code || oc.children[c] < 0) continue;
            float w = rs.count == rs.k ? std::sqrt(rs.worst()) : INFINITY;
            if (std::isfinite(w) && !overlaps(q, w, nodes[oc.children[c]]))
                continue;
            if (knn(q, rs, cmp, oc.children[c])) return true;
        }
        return rs.count == rs.k && inside(q, std::sqrt(rs.worst()), oc);
    }

    void radius(const float* q, float r, int cap, int* out_idx,
                float* out_d2, int& found, long& cmp, int node_id,
                bool fast) const {
        const Octant& oc = nodes[node_id];
        if (fast && contains(q, r, oc)) {
            // fast path at EVERY level: perm[start:start+count] is the whole
            // subtree (partitioned in place), so take it without recursion
            for (int i = oc.start; i < oc.start + oc.count; ++i) {
                if (found < cap) {
                    int pi = perm[i];
                    out_idx[found] = pi;
                    out_d2[found] = dist2_3(q, &pts[3 * pi]);
                }
                ++found;
            }
            return;
        }
        if (oc.leaf) {
            float r2 = r * r;
            for (int i = oc.start; i < oc.start + oc.count; ++i) {
                int pi = perm[i];
                float d2 = dist2_3(q, &pts[3 * pi]);
                ++cmp;
                if (d2 <= r2) {
                    if (found < cap) { out_idx[found] = pi; out_d2[found] = d2; }
                    ++found;
                }
            }
            return;
        }
        for (int c = 0; c < 8; ++c) {
            if (oc.children[c] < 0) continue;
            if (!overlaps(q, r, nodes[oc.children[c]])) continue;
            radius(q, r, cap, out_idx, out_d2, found, cmp, oc.children[c], fast);
        }
    }
};

// ---------------------------------------------------------- batch threading
template <typename Fn>
struct QueryJob {
    Fn fn;
    long nq;
    long next;
    pthread_mutex_t lock;
};

template <typename Fn>
void* query_worker(void* arg) {
    QueryJob<Fn>* job = (QueryJob<Fn>*)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        long i = job->next;
        long end = std::min(job->nq, i + 64);
        job->next = end;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->nq) break;
        for (; i < end; ++i) job->fn(i);
    }
    return nullptr;
}

template <typename Fn>
void run_batch(Fn fn, long nq, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 128) n_threads = 128;
    if (n_threads == 1 || nq < 128) {
        for (long i = 0; i < nq; ++i) fn(i);
        return;
    }
    QueryJob<Fn> job{fn, nq, 0, PTHREAD_MUTEX_INITIALIZER};
    pthread_t threads[128];
    for (int t = 0; t < n_threads; ++t)
        pthread_create(&threads[t], nullptr, query_worker<Fn>, &job);
    for (int t = 0; t < n_threads; ++t) pthread_join(threads[t], nullptr);
    pthread_mutex_destroy(&job.lock);
}

}  // namespace

extern "C" {

// ---------------- KD-tree C API ----------------
void* kdtree_build(const float* pts, long n, int leaf_size) {
    if (n <= 0) return nullptr;
    if (leaf_size < 1) leaf_size = 1;
    KdTree* t = new KdTree();
    t->n = n;
    t->pts.assign(pts, pts + 3 * n);
    t->perm.resize(n);
    for (long i = 0; i < n; ++i) t->perm[i] = (int)i;
    t->nodes.reserve((size_t)(2 * n / leaf_size + 8));
    t->build(0, (int)n, 0, leaf_size);
    return t;
}

void kdtree_free(void* h) { delete (KdTree*)h; }
long kdtree_node_count(void* h) { return (long)((KdTree*)h)->nodes.size(); }

// out_idx/out_d2: [nq*k]; out_cmp: [nq] distance-comparison counters.
void kdtree_knn(void* h, const float* q, long nq, int k, int* out_idx,
                float* out_d2, long* out_cmp, int n_threads) {
    if (k < 1) return;  // KnnHeap::worst() reads d2[k-1]
    KdTree* t = (KdTree*)h;
    run_batch([&](long i) {
        KnnHeap rs;
        rs.init(out_d2 + i * k, out_idx + i * k, k);
        long cmp = 0;
        t->knn(q + 3 * i, rs, cmp, 0);
        out_cmp[i] = cmp;
    }, nq, n_threads);
}

// out_idx/out_d2: [nq*cap]; out_cnt: [nq] true neighbor counts (may exceed
// cap — overflow observable); out_cmp: [nq].
void kdtree_radius(void* h, const float* q, long nq, float r, int cap,
                   int* out_idx, float* out_d2, int* out_cnt, long* out_cmp,
                   int n_threads) {
    KdTree* t = (KdTree*)h;
    float r2 = r * r;
    run_batch([&](long i) {
        int found = 0; long cmp = 0;
        for (int j = 0; j < cap; ++j) out_idx[i * cap + j] = -1;
        t->radius(q + 3 * i, r2, cap, out_idx + i * cap, out_d2 + i * cap,
                  found, cmp, 0);
        out_cnt[i] = found;
        out_cmp[i] = cmp;
    }, nq, n_threads);
}

// ---------------- Octree C API ----------------
void* octree_build(const float* pts, long n, int leaf_size,
                   float min_extent) {
    if (n <= 0) return nullptr;
    if (leaf_size < 1) leaf_size = 1;
    Octree* t = new Octree();
    t->n = n;
    t->leaf_size = leaf_size;
    t->min_extent = min_extent;
    t->pts.assign(pts, pts + 3 * n);
    t->perm.resize(n);
    for (long i = 0; i < n; ++i) t->perm[i] = (int)i;
    float mn[3] = {pts[0], pts[1], pts[2]}, mx[3] = {pts[0], pts[1], pts[2]};
    for (long i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[3 * i + d]);
            mx[d] = std::max(mx[d], pts[3 * i + d]);
        }
    // cube from max half-extent (octree.py:318-325)
    float cx = 0.5f * (mn[0] + mx[0]), cy = 0.5f * (mn[1] + mx[1]),
          cz = 0.5f * (mn[2] + mx[2]);
    float extent = 0.5f * std::max(mx[0] - mn[0],
                                   std::max(mx[1] - mn[1], mx[2] - mn[2]));
    extent = std::max(extent, 1e-6f);
    t->build(0, (int)n, cx, cy, cz, extent);
    return t;
}

void octree_free(void* h) { delete (Octree*)h; }
long octree_node_count(void* h) { return (long)((Octree*)h)->nodes.size(); }

void octree_knn(void* h, const float* q, long nq, int k, int* out_idx,
                float* out_d2, long* out_cmp, int n_threads) {
    if (k < 1) return;  // KnnHeap::worst() reads d2[k-1]
    Octree* t = (Octree*)h;
    run_batch([&](long i) {
        KnnHeap rs;
        rs.init(out_d2 + i * k, out_idx + i * k, k);
        long cmp = 0;
        t->knn(q + 3 * i, rs, cmp, 0);
        out_cmp[i] = cmp;
    }, nq, n_threads);
}

// fast != 0 enables the contains() no-distance-check path (every level,
// unlike octree.py:199,208 which only applied it at the root).
void octree_radius(void* h, const float* q, long nq, float r, int cap,
                   int* out_idx, float* out_d2, int* out_cnt, long* out_cmp,
                   int fast, int n_threads) {
    Octree* t = (Octree*)h;
    run_batch([&](long i) {
        int found = 0; long cmp = 0;
        for (int j = 0; j < cap; ++j) out_idx[i * cap + j] = -1;
        t->radius(q + 3 * i, r, cap, out_idx + i * cap, out_d2 + i * cap,
                  found, cmp, 0, fast != 0);
        out_cnt[i] = found;
        out_cmp[i] = cmp;
    }, nq, n_threads);
}

}  // extern "C"
