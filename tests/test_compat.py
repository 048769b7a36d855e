"""Exact-compat tests: vectorized pipeline vs the sequential NumPy
oracle (reference semantics, SURVEY.md §2.1), at f64.

The north-star requirement is prolongation weights matching the
reference to 1e-6 given the same hierarchy (BASELINE.md); at f64 the
vectorized implementation should agree to ~1e-12.  Random (jittered)
point clouds avoid exact distance ties, whose resolution order is the
only undefined corner of the reference algorithm.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import icosphere, random_points_on_mesh, \
    cube_mesh, torus_points
from gravomg_tpu.types import INVALID_INDEX

import oracle


def _make_graph(points, k=10):
    return g.knn_graph(jnp.asarray(points), k=k)


def _clouds():
    v, f = cube_mesh()
    yield "cube600", random_points_on_mesh(600, v, f, seed=3)
    sv, sf = icosphere(3)
    yield "sphere642", sv + np.random.default_rng(7).normal(
        scale=1e-3, size=sv.shape)
    yield "torus500", torus_points(500, seed=11)


@pytest.mark.parametrize("name,pts", list(_clouds()),
                         ids=[n for n, _ in _clouds()])
def test_pipeline_matches_oracle(name, pts):
    graph = _make_graph(pts)
    nbr = np.asarray(graph.neighbors)
    dist = np.asarray(graph.distances)
    radius = float(g.sampling_radius(graph))

    # --- C4 sampling ---
    sel = g.fast_disc_sample(graph, radius)
    sel_oracle = oracle.disc_sample(pts, nbr, dist, radius)
    np.testing.assert_array_equal(sel, sel_oracle)

    # --- C6 parents ---
    par, pdist = g.assign_parents(graph, jnp.asarray(sel))
    par = np.asarray(par)
    par_o, dist_o = oracle.assign_parents(pts, nbr, dist, sel_oracle)
    np.testing.assert_allclose(np.asarray(pdist), dist_o, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(par, par_o)

    # --- C7 coarse pattern ---
    n_coarse = len(sel)
    cols, ovf = g.extract_coarse_edges(graph, jnp.asarray(par), n_coarse, 64)
    assert not bool(ovf)
    cols = np.asarray(cols)
    adj_o = oracle.coarse_edge_pattern(nbr, par, n_coarse)
    for c in range(n_coarse):
        mine = cols[c][cols[c] != INVALID_INDEX]
        np.testing.assert_array_equal(mine, adj_o[c])

    # --- C8 placement ---
    cp = np.asarray(g.coarse_from_mean_of_fine_children(
        graph, jnp.asarray(par), jnp.asarray(sel)))
    cp_o = oracle.coarse_placement(pts, nbr, par, sel_oracle)
    np.testing.assert_allclose(cp, cp_o, rtol=1e-12, atol=1e-12)

    # --- C9 triangles ---
    cg = g.coarse_graph(jnp.asarray(cols), jnp.asarray(cp))
    tris_o, normals_o, assoc_o = oracle.voronoi_triangles(cp, adj_o)
    tmax = ((4 * n_coarse + 63) // 64) * 64
    tris, ovf2 = g.construct_voronoi_triangles(cg, tmax, 96)
    assert not bool(ovf2)
    tv = np.asarray(tris.vertices)
    n_tris = int(np.sum(tv[:, 0] != INVALID_INDEX))
    assert n_tris == len(tris_o)
    np.testing.assert_array_equal(tv[:n_tris],
                                  np.array(tris_o, dtype=np.int32))
    np.testing.assert_allclose(np.asarray(tris.normals)[:n_tris],
                               np.array(normals_o), rtol=1e-12, atol=1e-12)
    assoc = np.asarray(tris.assoc)
    for c in range(n_coarse):
        mine = assoc[c][assoc[c] != INVALID_INDEX]
        np.testing.assert_array_equal(mine, np.array(assoc_o[c], np.int32))

    # --- C12 prolongation, all three weighting schemes ---
    for scheme in (g.BARYCENTRIC, g.UNIFORM, g.INVDIST):
        u, counts, _ = g.construct_prolongation(
            jnp.asarray(pts), jnp.asarray(par), jnp.asarray(cp),
            cg.neighbors, tris, scheme=scheme)
        rows_o, counts_o = oracle.construct_prolongation(
            pts, par, cp, adj_o, tris_o, normals_o, assoc_o, scheme)
        np.testing.assert_array_equal(np.asarray(counts), counts_o)
        uc = np.asarray(u.cols)
        uw = np.asarray(u.weights)
        for i in range(pts.shape[0]):
            mine = {}
            for c, w in zip(uc[i], uw[i]):
                mine[c] = mine.get(c, 0.0) + w
            theirs = {}
            for c, w in rows_o[i]:
                theirs[c] = theirs.get(c, 0.0) + w
            mine = {c: w for c, w in mine.items() if abs(w) > 0 or c in theirs}
            assert set(mine) == set(theirs), (scheme, i, mine, theirs)
            for c in theirs:
                assert abs(mine[c] - theirs[c]) < 1e-12, (scheme, i, c)

    # --- C13 projection ---
    u, _, _ = g.construct_prolongation(
        jnp.asarray(pts), jnp.asarray(par), jnp.asarray(cp),
        cg.neighbors, tris, scheme=g.BARYCENTRIC)
    proj = np.asarray(g.projected_points(u, jnp.asarray(cp)))
    rows_o, _ = oracle.construct_prolongation(
        pts, par, cp, adj_o, tris_o, normals_o, assoc_o, g.BARYCENTRIC)
    proj_o = oracle.projected_points(rows_o, cp, pts.shape[0])
    np.testing.assert_allclose(proj, proj_o, rtol=1e-12, atol=1e-12)
