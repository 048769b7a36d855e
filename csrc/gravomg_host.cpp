// Native host-side runtime for gravomg_tpu.
//
// Provides C-ABI implementations of the sequential reference-semantics
// algorithms (greedy disc sampling, multi-source Dijkstra) over the
// library's padded ELL graph layout, plus a fast OBJ loader.  Used as
//   * a fast golden oracle for large-scale compat verification (the
//     NumPy oracle in tests/oracle.py is exact but slow),
//   * the CPU baseline timing target for benchmarks (the reference repo
//     is a CPU C++ library of the same algorithms; see SURVEY.md §6),
//   * host-side IO for meshes too large for the Python path.
//
// Layout contract (matches gravomg_tpu.types.Graph):
//   neighbors: (V, K) int32 row-major, ascending per row, padding =
//              INT32_MAX; no self loops.
//   distances: (V, K) float64, +inf padding.
//
// Loaded via ctypes (gravomg_tpu/io/native.py); no pybind11 dependency.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <map>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr int32_t kInvalid = INT32_MAX;

inline double dist3(const double* a, const double* b) {
    const double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
}

struct Vec3 {
    double x, y, z;
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
    double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
    Vec3 cross(const Vec3& o) const {
        return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
    }
    double norm() const { return std::sqrt(dot(*this)); }
};

inline Vec3 vat(const double* pts, int64_t i) {
    return {pts[i * 3], pts[i * 3 + 1], pts[i * 3 + 2]};
}

}  // namespace

extern "C" {

// Greedy Poisson-disc sampling, reference C4 semantics
// (reference `src/sampling.cpp:7-53`): index-order scan, 1-hop
// rejection within radius, 2-hop rejection by summed hop distance.
// Returns the number of selected vertices (written to out_sel).
int64_t gmg_disc_sample(int64_t v, int32_t k, const int32_t* nbr,
                        const double* dist, double radius,
                        int32_t* out_sel) {
    std::vector<uint8_t> visited(v, 0);
    int64_t count = 0;
    for (int64_t i = 0; i < v; ++i) {
        if (visited[i]) continue;
        out_sel[count++] = static_cast<int32_t>(i);
        const int32_t* row = nbr + i * k;
        const double* drow = dist + i * k;
        for (int32_t a = 0; a < k; ++a) {
            const int32_t n1 = row[a];
            if (n1 == kInvalid) continue;
            const double d1 = drow[a];
            if (d1 < radius) {
                visited[n1] = 1;
                const int32_t* row2 = nbr + static_cast<int64_t>(n1) * k;
                const double* drow2 = dist + static_cast<int64_t>(n1) * k;
                for (int32_t b = 0; b < k; ++b) {
                    const int32_t n2 = row2[b];
                    if (n2 == kInvalid) continue;
                    if (d1 + drow2[b] < radius) visited[n2] = 1;
                }
            }
        }
    }
    return count;
}

// Multi-source Dijkstra, reference C6 semantics
// (reference `src/multigrid.cpp:77-125`): seeds at distance 0 with
// coarse-side parent ids, Euclidean relaxation from positions.  Uses the
// standard stale-entry skip (same fixpoint as the reference's
// skip-free loop; see SURVEY.md §2.1-C6).
void gmg_assign_parents(int64_t v, int32_t k, const int32_t* nbr,
                        const double* points, const int32_t* samples,
                        int64_t n_samples, int32_t* out_parent,
                        double* out_dist) {
    using Entry = std::pair<double, int64_t>;
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
    for (int64_t i = 0; i < v; ++i) {
        out_parent[i] = 0;
        out_dist[i] = std::numeric_limits<double>::infinity();
    }
    for (int64_t c = 0; c < n_samples; ++c) {
        const int64_t s = samples[c];
        out_parent[s] = static_cast<int32_t>(c);
        out_dist[s] = 0.0;
        heap.emplace(0.0, s);
    }
    while (!heap.empty()) {
        const auto [d, i] = heap.top();
        heap.pop();
        if (d > out_dist[i]) continue;
        const int32_t* row = nbr + i * k;
        const double* pi = points + i * 3;
        for (int32_t a = 0; a < k; ++a) {
            const int32_t n = row[a];
            if (n == kInvalid) continue;
            const double nd = d + dist3(pi, points + static_cast<int64_t>(n) * 3);
            if (nd < out_dist[n]) {
                out_parent[n] = out_parent[i];
                out_dist[n] = nd;
                heap.emplace(nd, n);
            }
        }
    }
}

// Mean edge length over valid ELL entries (reference C5 semantics,
// reference `src/multigrid.cpp:127-133`).
double gmg_average_edge_length(int64_t v, int32_t k, const int32_t* nbr,
                               const double* dist) {
    double total = 0.0;
    int64_t n = 0;
    for (int64_t i = 0; i < v * k; ++i) {
        if (nbr[i] != kInvalid) {
            total += dist[i];
            ++n;
        }
    }
    return n ? total / static_cast<double>(n) : 0.0;
}

// ELL SpMV (CPU baseline kernel): y = diag*x + sum_k off*x[nbr].
void gmg_ell_spmv(int64_t v, int32_t k, const int32_t* nbr,
                  const double* off, const double* diag, const double* x,
                  double* y) {
    for (int64_t i = 0; i < v; ++i) {
        double acc = diag[i] * x[i];
        const int32_t* row = nbr + i * k;
        const double* orow = off + i * k;
        for (int32_t a = 0; a < k; ++a) {
            const int32_t n = row[a];
            if (n != kInvalid) acc += orow[a] * x[n];
        }
        y[i] = acc;
    }
    }

// Minimal OBJ loader: vertices and triangle faces only.  Two-pass:
// first call with null outputs to get counts, then with buffers.
int64_t gmg_read_obj(const char* path, double* out_verts,
                     int32_t* out_faces, int64_t* out_nv, int64_t* out_nf) {
    FILE* fp = std::fopen(path, "r");
    if (!fp) return -1;
    char line[1024];
    int64_t nv = 0, nf = 0;
    while (std::fgets(line, sizeof line, fp)) {
        if (line[0] == 'v' && line[1] == ' ') {
            double x, y, z;
            if (std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
                if (out_verts) {
                    out_verts[nv * 3 + 0] = x;
                    out_verts[nv * 3 + 1] = y;
                    out_verts[nv * 3 + 2] = z;
                }
                ++nv;
            }
        } else if (line[0] == 'f' && line[1] == ' ') {
            long a, b, c;
            // accept "f a b c" and "f a/.. b/.. c/.."
            if (std::sscanf(line + 2, "%ld%*[^ ] %ld%*[^ ] %ld", &a, &b,
                            &c) == 3 ||
                std::sscanf(line + 2, "%ld %ld %ld", &a, &b, &c) == 3) {
                if (out_faces) {
                    out_faces[nf * 3 + 0] = static_cast<int32_t>(a - 1);
                    out_faces[nf * 3 + 1] = static_cast<int32_t>(b - 1);
                    out_faces[nf * 3 + 2] = static_cast<int32_t>(c - 1);
                }
                ++nf;
            }
        }
    }
    std::fclose(fp);
    *out_nv = nv;
    *out_nf = nf;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Full sequential hierarchy build (reference CS-1 pipeline semantics,
// reference `test/main.cpp:47-186`, per-stage contracts in
// SURVEY.md §2.1).  This is the measured CPU baseline for the
// "hierarchy construction" BASELINE metric: the same per-level stages
// the reference executes (sampling C4, parents C6, coarse edges C7,
// placement C8, triangles C9, prolongation C12), over the library's ELL
// layout, written from the documented behavioral contract (mirrors
// tests/oracle.py, not the reference source).
// ---------------------------------------------------------------------

namespace {

// C10 `inTriangle` semantics (`src/multigrid.cpp:18-55`) including the
// side-channel map protocol: first-encounter score with the
// UNNORMALIZED edge vector (the reference's off-by-|e|^2 quirk),
// unconditional kill overwrite.  Returns |distance to plane| or -1.
double in_triangle(const Vec3& p, const std::array<int32_t, 3>& tri,
                   const Vec3& normal, const double* pos,
                   std::map<int32_t, double>& inside_edge,
                   double* bary_out) {
    const Vec3 v1 = vat(pos, tri[0]), v2 = vat(pos, tri[1]),
               v3 = vat(pos, tri[2]);
    const Vec3 v1_to_p = p - v1;
    const Vec3 e12 = v2 - v1, e13 = v3 - v1;
    const double dist_to_plane = (p - v1).dot(normal);
    const Vec3 p_proj = p - normal * dist_to_plane;
    const double double_area = (v2 - v1).cross(v3 - v1).dot(normal);
    const double b0 = (v3 - v2).cross(p_proj - v2).dot(normal) / double_area;
    const double b1 = (v1 - v3).cross(p_proj - v3).dot(normal) / double_area;
    const double b2 = 1.0 - b0 - b1;
    if (inside_edge.find(tri[1]) == inside_edge.end())
        inside_edge[tri[1]] = (v1_to_p - e12 * v1_to_p.dot(e12)).norm();
    if (inside_edge.find(tri[2]) == inside_edge.end())
        inside_edge[tri[2]] = (v1_to_p - e13 * v1_to_p.dot(e13)).norm();
    if (b0 < 0.0 || b1 < 0.0) inside_edge[tri[1]] = -1.0;
    if (b0 < 0.0 || b2 < 0.0) inside_edge[tri[2]] = -1.0;
    bary_out[0] = b0;
    bary_out[1] = b1;
    bary_out[2] = b2;
    if (b0 >= 0.0 && b1 >= 0.0 && b2 >= 0.0) return std::fabs(dist_to_plane);
    return -1.0;
}

void invdist_weights(const double* pos, const Vec3& p, const int32_t* cols,
                     int n, double* w) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) {
        const double d = (p - vat(pos, cols[i])).norm();
        w[i] = 1.0 / std::max(1e-8, d);
        s += w[i];
    }
    for (int i = 0; i < n; ++i) w[i] /= s;
}

struct LevelGraph {
    int64_t v = 0;
    int32_t k = 0;
    std::vector<int32_t> nbr;   // (v, k) ELL, ascending, kInvalid pad
    std::vector<double> dist;   // (v, k)
    std::vector<double> points; // (v, 3)
};

// One full coarsening step; returns the coarse LevelGraph and fills U.
// Optionally exports the discrete hierarchy (samples, parents) for
// cross-implementation compat checks at scale.
LevelGraph coarsen_level(const LevelGraph& g, double reduction_ratio,
                         int scheme, std::vector<int32_t>& u_cols,
                         std::vector<double>& u_weights,
                         std::vector<int32_t>* out_samples = nullptr,
                         std::vector<int32_t>* out_parents = nullptr) {
    const int64_t v = g.v;
    const int32_t k = g.k;

    // C5 radius (`test/main.cpp:23,74`).
    double total = 0.0;
    int64_t ne = 0;
    for (int64_t i = 0; i < v * k; ++i)
        if (g.nbr[i] != kInvalid) { total += g.dist[i]; ++ne; }
    const double radius = std::cbrt(reduction_ratio)
        * (ne ? total / static_cast<double>(ne) : 0.0);

    // C4 sampling + C6 parents.
    std::vector<int32_t> samples(v);
    const int64_t nc = gmg_disc_sample(v, k, g.nbr.data(), g.dist.data(),
                                       radius, samples.data());
    samples.resize(nc);
    std::vector<int32_t> parents(v);
    std::vector<double> pdist(v);
    gmg_assign_parents(v, k, g.nbr.data(), g.points.data(), samples.data(),
                       nc, parents.data(), pdist.data());
    if (out_samples) *out_samples = samples;
    if (out_parents) *out_parents = parents;

    // C7 coarse adjacency pattern (only the pattern matters downstream,
    // SURVEY.md §2.1-C7): sorted unique neighbor lists.
    std::vector<std::vector<int32_t>> adj(nc);
    for (int64_t i = 0; i < v; ++i) {
        const int32_t p = parents[i];
        for (int32_t a = 0; a < k; ++a) {
            const int32_t n = g.nbr[i * k + a];
            if (n == kInvalid) continue;
            const int32_t q = parents[n];
            if (p != q) adj[p].push_back(q);
        }
    }
    for (auto& l : adj) {
        std::sort(l.begin(), l.end());
        l.erase(std::unique(l.begin(), l.end()), l.end());
    }

    // C8 placement: mean of children, lonely-cell patch.
    std::vector<std::vector<int32_t>> children(nc);
    for (int64_t i = 0; i < v; ++i)
        children[parents[i]].push_back(static_cast<int32_t>(i));
    std::vector<double> cpoints(nc * 3, 0.0);
    for (int64_t c = 0; c < nc; ++c) {
        auto cs = children[c];
        if (cs.size() == 1) {
            const int32_t seed = cs[0];
            for (int32_t a = 0; a < k; ++a) {
                const int32_t n = g.nbr[seed * k + a];
                if (n != kInvalid) cs.push_back(n);
            }
            std::sort(cs.begin(), cs.end());
            cs.erase(std::unique(cs.begin(), cs.end()), cs.end());
        }
        double m[3] = {0, 0, 0};
        for (const int32_t f : cs)
            for (int d = 0; d < 3; ++d) m[d] += g.points[f * 3 + d];
        for (int d = 0; d < 3; ++d)
            cpoints[c * 3 + d] = m[d] / static_cast<double>(cs.size());
    }

    // C9 Voronoi triangles in exact enumeration order + assoc lists.
    std::vector<std::array<int32_t, 3>> tris;
    std::vector<Vec3> tnormals;
    std::vector<std::vector<int32_t>> assoc(nc);
    for (int32_t v0 = 0; v0 < nc; ++v0) {
        const auto& nl = adj[v0];
        for (size_t ai = 0; ai < nl.size(); ++ai) {
            const int32_t v1 = nl[ai];
            if (v1 < v0) continue;
            for (size_t bi = ai + 1; bi < nl.size(); ++bi) {
                const int32_t v2 = nl[bi];
                if (v2 < v0) continue;
                if (!std::binary_search(adj[v1].begin(), adj[v1].end(), v2))
                    continue;
                const Vec3 e01 = vat(cpoints.data(), v1)
                    - vat(cpoints.data(), v0);
                const Vec3 e02 = vat(cpoints.data(), v2)
                    - vat(cpoints.data(), v0);
                Vec3 n = e01.cross(e02);
                const double nn = n.norm();
                if (nn > 0) n = n * (1.0 / nn);
                const int32_t tid = static_cast<int32_t>(tris.size());
                tris.push_back({v0, v1, v2});
                tnormals.push_back(n);
                assoc[v0].push_back(tid);
                assoc[v1].push_back(tid);
                assoc[v2].push_back(tid);
            }
        }
    }

    // C12 prolongation: the 5-case analysis with exact tie-breaks.
    u_cols.assign(v * 3, 0);
    u_weights.assign(v * 3, 0.0);
    auto emit = [&](int64_t i, int slot, int32_t col, double w) {
        u_cols[i * 3 + slot] = col;
        u_weights[i * 3 + slot] = w;
    };
    for (int64_t i = 0; i < v; ++i) {
        const Vec3 p = vat(g.points.data(), i);
        const int32_t c = parents[i];
        const Vec3 pc = vat(cpoints.data(), c);
        const auto& nl = adj[c];
        if (nl.empty()) {                       // case 1
            emit(i, 0, c, 1.0);
            emit(i, 1, c, 0.0);
            emit(i, 2, c, 0.0);
            continue;
        }
        if (nl.size() == 1) {                   // case 2
            const int32_t nb = nl[0];
            const Vec3 seg = vat(cpoints.data(), nb) - pc;
            const double seg_len = std::max(seg.norm(), 1e-8);
            double t = (p - pc).dot(seg * (1.0 / seg.norm())) / seg_len;
            t = std::min(std::max(t, 0.0), 1.0);
            if (scheme == 0) {
                emit(i, 0, c, 1.0 - t); emit(i, 1, nb, t);
            } else if (scheme == 1) {
                emit(i, 0, c, 0.5); emit(i, 1, nb, 0.5);
            } else {
                int32_t cols2[2] = {c, nb};
                double w[2];
                invdist_weights(cpoints.data(), p, cols2, 2, w);
                emit(i, 0, c, w[0]); emit(i, 1, nb, w[1]);
            }
            emit(i, 2, c, 0.0);
            continue;
        }
        // case 3: first containing triangle in association order.
        std::map<int32_t, double> inside_edge;
        bool found = false;
        std::array<int32_t, 3> ctri{};
        double bary[3];
        for (const int32_t tid : assoc[c]) {
            std::array<int32_t, 3> tri = tris[tid];
            while (tri[0] != c) {               // rotate c into slot 0
                const int32_t t0 = tri[0];
                tri[0] = tri[1]; tri[1] = tri[2]; tri[2] = t0;
            }
            const double d = in_triangle(p, tri, tnormals[tid],
                                         cpoints.data(), inside_edge, bary);
            if (d >= 0.0) { found = true; ctri = tri; break; }
        }
        if (found) {
            if (scheme == 0) {
                for (int s = 0; s < 3; ++s) emit(i, s, ctri[s], bary[s]);
            } else if (scheme == 1) {
                for (int s = 0; s < 3; ++s) emit(i, s, ctri[s], 1.0 / 3.0);
            } else {
                double w[3];
                invdist_weights(cpoints.data(), p, ctri.data(), 3, w);
                for (int s = 0; s < 3; ++s) emit(i, s, ctri[s], w[s]);
            }
            continue;
        }
        // case 4 (fallback A): first surviving entry in ascending-key
        // map order (`src/multigrid.cpp:414-421` break semantics).
        int32_t chosen = -1;
        for (const auto& [e, score] : inside_edge)
            if (score >= 0.0) { chosen = e; break; }
        if (chosen >= 0) {
            const Vec3 seg = vat(cpoints.data(), chosen) - pc;
            const double seg_len = std::max(seg.norm(), 1e-8);
            double t = (p - pc).dot(seg * (1.0 / seg.norm())) / seg_len;
            t = std::min(std::max(t, 0.0), 1.0);
            if (scheme == 0) {
                emit(i, 0, c, 1.0 - t); emit(i, 1, chosen, t);
            } else if (scheme == 1) {
                emit(i, 0, c, 0.5); emit(i, 1, chosen, 0.5);
            } else {
                int32_t cols2[2] = {c, chosen};
                double w[2];
                invdist_weights(cpoints.data(), p, cols2, 2, w);
                emit(i, 0, c, w[0]); emit(i, 1, chosen, w[1]);
            }
            emit(i, 2, c, 0.0);
            continue;
        }
        // case 5 (fallback B): parent + two nearest; always inverse
        // distance regardless of scheme (`src/multigrid.cpp:476-481`).
        std::vector<std::pair<double, int32_t>> cand;
        cand.reserve(nl.size());
        for (const int32_t n : nl)
            cand.emplace_back((p - vat(cpoints.data(), n)).norm(), n);
        std::sort(cand.begin(), cand.end());
        const std::array<int32_t, 3> tri = {c, cand[0].second,
                                            cand[1].second};
        double w[3];
        invdist_weights(cpoints.data(), p, tri.data(), 3, w);
        for (int s = 0; s < 3; ++s) emit(i, s, tri[s], w[s]);
    }

    // Coarse LevelGraph: adjacency pattern + recomputed Euclidean
    // distances (the library's convention; the reference's coarse edge
    // weights are dead values, SURVEY.md §2.1-C7).
    LevelGraph cg;
    cg.v = nc;
    int32_t kc = 0;
    for (const auto& l : adj)
        kc = std::max<int32_t>(kc, static_cast<int32_t>(l.size()));
    cg.k = std::max<int32_t>(kc, 1);
    cg.nbr.assign(nc * cg.k, kInvalid);
    cg.dist.assign(nc * cg.k, std::numeric_limits<double>::infinity());
    cg.points = cpoints;
    for (int64_t c = 0; c < nc; ++c)
        for (size_t a = 0; a < adj[c].size(); ++a) {
            cg.nbr[c * cg.k + a] = adj[c][a];
            cg.dist[c * cg.k + a] = (vat(cpoints.data(), c)
                                     - vat(cpoints.data(), adj[c][a])).norm();
        }
    return cg;
}

}  // namespace

extern "C" {

// Full multilevel hierarchy build (sampling through prolongation per
// level, stopping below `threshold` coarse vertices).  Writes per-level
// coarse counts to out_level_sizes and a checksum of all prolongation
// weights to out_u_checksum (sanity anchor for cross-implementation
// comparisons).  Returns the number of coarsening steps performed.
int32_t gmg_build_hierarchy(int64_t v, int32_t k, const int32_t* nbr,
                            const double* dist, const double* points,
                            double reduction_ratio, int64_t threshold,
                            int32_t max_levels, int32_t scheme,
                            int64_t* out_level_sizes,
                            double* out_u_checksum) {
    LevelGraph g;
    g.v = v;
    g.k = k;
    g.nbr.assign(nbr, nbr + v * k);
    g.dist.assign(dist, dist + v * k);
    g.points.assign(points, points + v * 3);

    double checksum = 0.0;
    int32_t levels = 0;
    while (levels < max_levels && g.v > threshold) {
        std::vector<int32_t> u_cols;
        std::vector<double> u_weights;
        LevelGraph cg = coarsen_level(g, reduction_ratio, scheme, u_cols,
                                      u_weights);
        if (cg.v >= g.v || cg.v < 8) break;
        for (const double w : u_weights) checksum += w;
        out_level_sizes[levels++] = cg.v;
        g = std::move(cg);
    }
    if (out_u_checksum) *out_u_checksum = checksum;
    return levels;
}

// Single coarsening step with full export -- the golden-oracle surface
// for at-scale compat verification (BASELINE: prolongation weights
// match the reference to 1e-6 given the same hierarchy; the NumPy
// oracle is exact but too slow past ~10k vertices).
//
// Inputs mirror the library layout (see file header).  Outputs:
//   out_n_samples:  number of selected coarse vertices (<= v)
//   out_samples:    (v) int32 buffer; first *out_n_samples entries used
//   out_parents:    (v) int32 fine -> coarse index
//   out_u_cols:     (v*3) int32; out_u_w: (v*3) f64 (slot-aligned with
//                   the emission order of `coarsen_level`)
//   out_cpoints:    (v*3) f64 buffer; first nc*3 used
//   out_cnbr:       (v*kc_cap) int32 coarse adjacency, kInvalid pad
// Returns nc, or -1 if some coarse vertex exceeds kc_cap neighbors.
int32_t gmg_coarsen_level(int64_t v, int32_t k, const int32_t* nbr,
                          const double* dist, const double* points,
                          double reduction_ratio, int32_t scheme,
                          int32_t kc_cap, int64_t* out_n_samples,
                          int32_t* out_samples, int32_t* out_parents,
                          int32_t* out_u_cols, double* out_u_w,
                          double* out_cpoints, int32_t* out_cnbr) {
    LevelGraph g;
    g.v = v;
    g.k = k;
    g.nbr.assign(nbr, nbr + v * k);
    g.dist.assign(dist, dist + v * k);
    g.points.assign(points, points + v * 3);

    std::vector<int32_t> u_cols;
    std::vector<double> u_weights;
    std::vector<int32_t> samples, parents;
    LevelGraph cg = coarsen_level(g, reduction_ratio, scheme, u_cols,
                                  u_weights, &samples, &parents);
    if (cg.k > kc_cap) return -1;
    *out_n_samples = static_cast<int64_t>(samples.size());
    std::copy(samples.begin(), samples.end(), out_samples);
    std::copy(parents.begin(), parents.end(), out_parents);
    std::copy(u_cols.begin(), u_cols.end(), out_u_cols);
    std::copy(u_weights.begin(), u_weights.end(), out_u_w);
    std::copy(cg.points.begin(), cg.points.end(), out_cpoints);
    std::fill(out_cnbr, out_cnbr + cg.v * kc_cap, kInvalid);
    for (int64_t c = 0; c < cg.v; ++c)
        for (int32_t a = 0; a < cg.k; ++a)
            out_cnbr[c * kc_cap + a] = cg.nbr[c * cg.k + a];
    return static_cast<int32_t>(cg.v);
}

}  // extern "C"
