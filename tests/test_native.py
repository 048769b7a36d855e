"""Native host runtime (csrc/gravomg_host.cpp) vs the NumPy oracle.

The C++ build is the measured CPU baseline for the BASELINE
"hierarchy construction" metric, so it must reproduce the sequential
reference semantics exactly (same checks the device pipeline passes in
test_compat.py, here against the multi-level C++ driver).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.io import native
from gravomg_tpu.types import INVALID_INDEX as INVALID

import oracle

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _oracle_build(pts, nbr, dist, ratio, threshold, max_levels):
    """Multi-level sequential build driven by the per-stage oracle."""
    level_sizes = []
    checksum = 0.0
    points = pts.astype(np.float64)
    while len(level_sizes) < max_levels and points.shape[0] > threshold:
        mask = nbr != INVALID
        radius = np.cbrt(ratio) * dist[mask].mean()
        sel = oracle.disc_sample(points, nbr, dist, radius)
        nc = len(sel)
        if nc >= points.shape[0] or nc < 8:
            break
        par, _ = oracle.assign_parents(points, nbr, dist, sel)
        adj = oracle.coarse_edge_pattern(nbr, par, nc)
        cp = oracle.coarse_placement(points, nbr, par, sel)
        tris, normals, assoc = oracle.voronoi_triangles(cp, adj)
        rows, _ = oracle.construct_prolongation(points, par, cp, adj,
                                                tris, normals, assoc)
        checksum += sum(w for ents in rows.values() for _, w in ents)
        level_sizes.append(nc)
        # Next-level ELL graph: pattern + Euclidean distances.
        kc = max(max((len(a) for a in adj), default=1), 1)
        nbr = np.full((nc, kc), INVALID, np.int32)
        dist = np.full((nc, kc), np.inf)
        for c, a in enumerate(adj):
            nbr[c, :len(a)] = a
            dist[c, :len(a)] = np.linalg.norm(cp[c] - cp[a], axis=1)
        points = cp
    return level_sizes, checksum


def test_native_hierarchy_matches_oracle():
    pts = torus_points(900, seed=5)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    nbr = np.asarray(graph.neighbors)
    dist = np.asarray(graph.distances)

    sizes_c, csum_c = native.build_hierarchy(
        nbr, dist, pts, reduction_ratio=2.0, threshold=60, max_levels=8)
    sizes_o, csum_o = _oracle_build(pts, nbr.copy(), dist.copy(), 2.0,
                                    60, 8)
    assert list(sizes_c) == list(sizes_o)
    np.testing.assert_allclose(csum_c, csum_o, rtol=1e-9)
    # Rows sum to ~1 -> checksum ~ total fine rows across levels.
    total_rows = 900 + sum(sizes_o[:-1])
    np.testing.assert_allclose(csum_c, total_rows, rtol=1e-6)


def test_native_stage_kernels_match_oracle():
    pts = torus_points(600, seed=9)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    nbr = np.asarray(graph.neighbors)
    dist = np.asarray(graph.distances)
    radius = float(g.sampling_radius(graph))

    sel_c = native.disc_sample(nbr, dist, radius)
    sel_o = oracle.disc_sample(pts, nbr, dist, radius)
    np.testing.assert_array_equal(sel_c, sel_o)

    par_c, dist_c = native.assign_parents(nbr, pts, sel_c)
    par_o, dist_o = oracle.assign_parents(pts, nbr, dist, sel_o)
    np.testing.assert_array_equal(par_c, par_o)
    np.testing.assert_allclose(dist_c, dist_o, rtol=1e-12, atol=1e-12)


def test_native_coarsen_level_export_matches_oracle():
    """The per-level export surface (gmg_coarsen_level) used by the
    at-scale compat script (scripts/compat_scale.py) matches the NumPy
    oracle stage by stage."""
    pts = torus_points(900, seed=5)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    nbr = np.asarray(graph.neighbors)
    dist = np.asarray(graph.distances)

    exp = native.coarsen_level(nbr, dist, pts, reduction_ratio=2.0,
                               scheme=0, kc_cap=64)

    mask = nbr != INVALID
    radius = np.cbrt(2.0) * dist[mask].mean()
    sel_o = oracle.disc_sample(pts, nbr, dist, radius)
    np.testing.assert_array_equal(exp["samples"], sel_o)
    par_o, _ = oracle.assign_parents(pts, nbr, dist, sel_o)
    np.testing.assert_array_equal(exp["parents"], par_o)

    nc = len(sel_o)
    adj_o = oracle.coarse_edge_pattern(nbr, par_o, nc)
    for c in range(nc):
        got = exp["coarse_nbr"][c]
        got = got[got != INVALID]
        np.testing.assert_array_equal(got, adj_o[c])
    cp_o = oracle.coarse_placement(pts, nbr, par_o, sel_o)
    np.testing.assert_allclose(exp["coarse_points"], cp_o, atol=1e-12)

    tris_o, normals_o, assoc_o = oracle.voronoi_triangles(cp_o, adj_o)
    rows_o, _ = oracle.construct_prolongation(
        pts.astype(np.float64), par_o, cp_o, adj_o, tris_o, normals_o,
        assoc_o)
    for i in range(900):
        got = {}
        for cc, ww in zip(exp["u_cols"][i], exp["u_weights"][i]):
            if abs(ww) > 0:
                got[int(cc)] = got.get(int(cc), 0.0) + ww
        ref = {int(c): w for c, w in rows_o[i] if abs(w) > 0}
        assert set(got) == set(ref), i
        for cc, ww in got.items():
            np.testing.assert_allclose(ww, ref[cc], atol=1e-12)
