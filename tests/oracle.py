"""Sequential NumPy oracle reproducing the reference algorithm semantics.

An independent re-implementation (from the behavioral contract documented
in SURVEY.md §2.1, quirks included) of the reference pipeline
reference `src/{sampling,multigrid}.cpp`, used as the golden
baseline for exact-compat tests of the vectorized implementation.

It consumes the same padded ELL graph representation as the library
(neighbors ascending per row, INVALID_INDEX padding, no self-loops) so
comparisons isolate *algorithm* semantics from *representation* choices.
Neighbor iteration in ascending index order matches Eigen's CSC inner
iterator, which is the order every reference loop uses.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

INVALID = np.int32(2**31 - 1)


def _row(neighbors, i):
    r = neighbors[i]
    return r[r != INVALID]


def disc_sample(points, neighbors, distances, radius):
    """Sequential greedy disc sampling (C4, `src/sampling.cpp:7-53`)."""
    v = points.shape[0]
    visited = np.zeros(v, dtype=bool)
    selection = []
    for i in range(v):
        if visited[i]:
            continue
        selection.append(i)
        for a, n1 in enumerate(neighbors[i]):
            if n1 == INVALID:
                continue
            d1 = distances[i, a]
            if d1 < radius:
                visited[n1] = True
                for b, n2 in enumerate(neighbors[n1]):
                    if n2 == INVALID:
                        continue
                    if d1 + distances[n1, b] < radius:
                        visited[n2] = True
    return np.array(selection, dtype=np.int32)


def assign_parents(points, neighbors, distances, samples):
    """Multi-source Dijkstra (C6, `src/multigrid.cpp:77-125`), including
    the reference's no-stale-skip processing (same fixpoint)."""
    v = points.shape[0]
    parent = np.zeros(v, dtype=np.int32)
    dist = np.full(v, np.inf)
    heap = []
    for ci, s in enumerate(samples):
        parent[s] = ci
        dist[s] = 0.0
        heapq.heappush(heap, (0.0, int(s)))
    while heap:
        d_i, i = heapq.heappop(heap)
        for a, n in enumerate(neighbors[i]):
            if n == INVALID:
                continue
            nd = d_i + np.linalg.norm(points[i] - points[n])
            if nd < dist[n]:
                parent[n] = parent[i]
                dist[n] = nd
                heapq.heappush(heap, (nd, int(n)))
    return parent, dist


def coarse_edge_pattern(neighbors, parents, n_coarse):
    """Coarse adjacency pattern (C7, `src/multigrid.cpp:135-169`).
    Only the pattern matters downstream (SURVEY.md §2.1-C7)."""
    adj = [set() for _ in range(n_coarse)]
    v = neighbors.shape[0]
    for i in range(v):
        p = parents[i]
        for n in _row(neighbors, i):
            q = parents[n]
            if p != q:
                adj[p].add(int(q))
    return [np.array(sorted(s), dtype=np.int32) for s in adj]


def coarse_placement(points, neighbors, parents, samples):
    """Mean of children with lonely-cell patch (C8,
    `src/multigrid.cpp:171-207`)."""
    c = len(samples)
    children: List[set] = [set() for _ in range(c)]
    for i in range(points.shape[0]):
        children[parents[i]].add(i)
    for cs in children:
        if len(cs) == 1:
            seed = next(iter(cs))
            for n in _row(neighbors, seed):
                cs.add(int(n))
    out = np.zeros((c, points.shape[1]))
    for ci, cs in enumerate(children):
        out[ci] = points[sorted(cs)].mean(axis=0)
    return out


def voronoi_triangles(coarse_points, coarse_adj):
    """Triangle enumeration (C9, `src/multigrid.cpp:209-263`) in exact
    reference order; returns (tris, normals, assoc)."""
    tris = []
    normals = []
    c = coarse_points.shape[0]
    assoc: List[List[int]] = [[] for _ in range(c)]
    adjsets = [set(map(int, a)) for a in coarse_adj]
    for v0 in range(c):
        nbrs = coarse_adj[v0]
        for ai in range(len(nbrs)):
            v1 = int(nbrs[ai])
            if v1 < v0:
                continue
            for bi in range(ai + 1, len(nbrs)):
                v2 = int(nbrs[bi])
                if v2 < v0:
                    continue
                if v2 in adjsets[v1]:
                    e01 = coarse_points[v1] - coarse_points[v0]
                    e02 = coarse_points[v2] - coarse_points[v0]
                    n = np.cross(e01, e02)
                    nn = np.linalg.norm(n)
                    n = n / nn if nn > 0 else n
                    tid = len(tris)
                    tris.append((v0, v1, v2))
                    normals.append(n)
                    assoc[v0].append(tid)
                    assoc[v1].append(tid)
                    assoc[v2].append(tid)
    return tris, normals, assoc


def _in_triangle(p, tri, normal, pos, inside_edge: Dict[int, float]):
    """C10 (`src/multigrid.cpp:18-55`), including the side-channel map
    protocol: first-encounter score, unconditional kill overwrite."""
    v1, v2, v3 = pos[tri[0]], pos[tri[1]], pos[tri[2]]
    v1_to_p = p - v1
    e12 = v2 - v1
    e13 = v3 - v1
    dist_to_plane = np.dot(p - v1, normal)
    p_proj = p - dist_to_plane * normal
    double_area = np.dot(np.cross(v2 - v1, v3 - v1), normal)
    b0 = np.dot(np.cross(v3 - v2, p_proj - v2), normal) / double_area
    b1 = np.dot(np.cross(v1 - v3, p_proj - v3), normal) / double_area
    b2 = 1.0 - b0 - b1
    if tri[1] not in inside_edge:
        inside_edge[tri[1]] = np.linalg.norm(
            v1_to_p - np.dot(v1_to_p, e12) * e12)
    if tri[2] not in inside_edge:
        inside_edge[tri[2]] = np.linalg.norm(
            v1_to_p - np.dot(v1_to_p, e13) * e13)
    if b0 < 0.0 or b1 < 0.0:
        inside_edge[tri[1]] = -1.0
    if b0 < 0.0 or b2 < 0.0:
        inside_edge[tri[2]] = -1.0
    bary = np.array([b0, b1, b2])
    if b0 >= 0.0 and b1 >= 0.0 and b2 >= 0.0:
        return abs(dist_to_plane), bary
    return -1.0, bary


def _uniform(n):
    return np.full(n, 1.0 / n)


def _invdist(pos, p, cols):
    w = np.array([1.0 / max(1e-8, np.linalg.norm(p - pos[e])) for e in cols])
    return w / w.sum()


BARYCENTRIC, UNIFORM, INVDIST = 0, 1, 2


def construct_prolongation(fine_points, parents, coarse_points, coarse_adj,
                           tris, normals, assoc, scheme=BARYCENTRIC):
    """C12 (`src/multigrid.cpp:265-498`) with exact tie-breaking.

    Returns (rows dict fine -> list[(col, weight)], case_counts).
    """
    out = {}
    n_hit = n_edge = n_fb = 0
    for i in range(fine_points.shape[0]):
        p = fine_points[i]
        c = int(parents[i])
        pc = coarse_points[c]
        nbrs = coarse_adj[c]
        if len(nbrs) == 0:
            out[i] = [(c, 1.0)]
            continue
        if len(nbrs) == 1:
            nb = int(nbrs[0])
            seg = coarse_points[nb] - pc
            seg_len = max(np.linalg.norm(seg), 1e-8)
            wn = np.dot(p - pc, seg / np.linalg.norm(seg)) / seg_len
            wn = min(max(wn, 0.0), 1.0)
            if scheme == BARYCENTRIC:
                out[i] = [(c, 1.0 - wn), (nb, wn)]
            elif scheme == UNIFORM:
                out[i] = [(c, 0.5), (nb, 0.5)]
            else:
                w = _invdist(coarse_points, p, [c, nb])
                out[i] = [(c, w[0]), (nb, w[1])]
            continue

        inside_edge: Dict[int, float] = {}
        found = False
        chosen_tri = None
        chosen_bary = None
        for tid in assoc[c]:
            tri = list(tris[tid])
            while tri[0] != c:
                tri = tri[1:] + tri[:1]
            d, bary = _in_triangle(p, tri, normals[tid], coarse_points,
                                   inside_edge)
            if d >= 0.0:
                found = True
                chosen_tri = tri
                chosen_bary = bary
                break
        if found:
            n_hit += 1
            if scheme == BARYCENTRIC:
                out[i] = list(zip(chosen_tri, chosen_bary))
            elif scheme == UNIFORM:
                out[i] = [(t, 1.0 / 3.0) for t in chosen_tri]
            else:
                w = _invdist(coarse_points, p, chosen_tri)
                out[i] = list(zip(chosen_tri, w))
            continue

        # Fallback A: first surviving entry in ascending-key map order.
        chosen_edge = None
        for e in sorted(inside_edge):
            if inside_edge[e] >= 0.0:
                chosen_edge = e
                break
        if chosen_edge is not None:
            n_edge += 1
            seg = coarse_points[chosen_edge] - pc
            seg_len = max(np.linalg.norm(seg), 1e-8)
            w2 = np.dot(p - pc, seg / np.linalg.norm(seg)) / seg_len
            w2 = min(max(w2, 0.0), 1.0)
            if scheme == BARYCENTRIC:
                out[i] = [(c, 1.0 - w2), (chosen_edge, w2)]
            elif scheme == UNIFORM:
                out[i] = [(c, 0.5), (chosen_edge, 0.5)]
            else:
                w = _invdist(coarse_points, p, [c, chosen_edge])
                out[i] = [(c, w[0]), (chosen_edge, w[1])]
            continue

        # Fallback B: parent + two nearest neighbors; always inverse
        # distance (`src/multigrid.cpp:476-481`).
        n_fb += 1
        cand = sorted((np.linalg.norm(p - coarse_points[int(n)]), int(n))
                      for n in nbrs)
        tri = [c, cand[0][1], cand[1][1]]
        w = _invdist(coarse_points, p, tri)
        out[i] = list(zip(tri, w))
    return out, (n_hit, n_edge, n_fb)


def projected_points(rows, coarse_points, n_fine):
    out = np.zeros((n_fine, coarse_points.shape[1]))
    for i, entries in rows.items():
        for c, w in entries:
            out[i] += w * coarse_points[c]
    return out
