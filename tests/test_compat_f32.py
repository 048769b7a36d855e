"""f32 prolongation-weight validation (BASELINE north star; SURVEY.md
§7 risk item #1).

The BASELINE requires prolongation weights matching the reference to
1e-6 *given the same hierarchy*.  The reference is f64 throughout
(`include/gravomg/utility.h:11-18`); the device kernels run f32.  This test
runs the vectorized pipeline at f32 and compares its placement and
prolongation weights against the f64 NumPy oracle fed the *same*
discrete hierarchy (the f32 pipeline's samples and parents), bounding
the floating-point error of the weight math itself.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.types import INVALID_INDEX

import oracle


@pytest.mark.parametrize("n", [2000, 8000])
def test_f32_weights_match_f64_oracle(n):
    pts64 = torus_points(n, seed=13)
    graph64 = g.knn_graph(jnp.asarray(pts64), k=10)

    # f32 pipeline: same neighbors, f32 positions/distances.
    graph = g.Graph(
        neighbors=graph64.neighbors,
        distances=graph64.distances.astype(jnp.float32),
        points=graph64.points.astype(jnp.float32))

    radius32 = g.sampling_radius(graph)
    sel = g.fast_disc_sample(graph, radius32)
    par, _ = g.assign_parents(graph, jnp.asarray(sel))
    par_np = np.asarray(par)
    n_coarse = len(sel)

    cols, ovf = g.extract_coarse_edges(graph, par, n_coarse, 64)
    assert not bool(ovf)
    cp32 = g.coarse_from_mean_of_fine_children(graph, par,
                                               jnp.asarray(sel))
    cg = g.coarse_graph(cols, cp32)
    tris, t_ovf = g.construct_voronoi_triangles(cg, 8 * n_coarse, 256)
    assert not bool(t_ovf)
    u32, counts, _ = g.construct_prolongation(
        graph.points, par, cp32, cg.neighbors, tris,
        scheme=g.BARYCENTRIC)
    assert u32.weights.dtype == jnp.float32
    # Precise mode: f64 weight arithmetic on the same (f32) hierarchy,
    # rounded back to f32 -- the path that meets the 1e-6 target.
    u32p, _, _ = g.construct_prolongation(
        graph.points, par, cp32, cg.neighbors, tris,
        scheme=g.BARYCENTRIC, precise_weights=True)
    assert u32p.weights.dtype == jnp.float32

    # f64 oracle on the SAME hierarchy: the BASELINE criterion is
    # "weights match to 1e-6 given the same hierarchy", which includes
    # the coarse positions -- barycentric ratios on thin triangles
    # amplify position perturbations, so the f32-vs-f64 *placement*
    # difference is checked separately below and the weight oracle
    # consumes the f32 positions (as f64 values).
    nbr = np.asarray(graph64.neighbors)
    adj_o = oracle.coarse_edge_pattern(nbr, par_np, n_coarse)
    cp_same = np.asarray(cp32, np.float64)
    tris_o, normals_o, assoc_o = oracle.voronoi_triangles(cp_same, adj_o)
    rows_o, _ = oracle.construct_prolongation(
        np.asarray(graph.points, np.float64), par_np, cp_same, adj_o,
        tris_o, normals_o, assoc_o, scheme=oracle.BARYCENTRIC)

    # Placement property: f32 segment-mean vs f64 oracle placement.
    cp_o = oracle.coarse_placement(pts64, nbr, par_np, sel)
    cp_err = np.abs(cp_same - cp_o).max()
    scale = np.abs(cp_o).max()
    assert cp_err / scale < 1e-5, cp_err

    # Weight comparison row by row against the f64 oracle.
    def max_weight_err(u):
        w = np.asarray(u.weights, np.float64)
        c = np.asarray(u.cols)
        err = 0.0
        flipped = 0
        for i in range(n):
            ref = dict(rows_o[i])
            got = {}
            for cc, ww in zip(c[i], w[i]):
                if abs(ww) > 0:
                    got[int(cc)] = got.get(int(cc), 0.0) + ww
            if set(got) != {k for k, v in ref.items() if abs(v) > 1e-12}:
                # f32 geometry can flip a borderline triangle-
                # containment test, switching the discrete case.
                flipped += 1
                continue
            for cc, ww in got.items():
                err = max(err, abs(ww - ref[cc]))
        return err, flipped

    err32, flip32 = max_weight_err(u32)
    errp, flipp = max_weight_err(u32p)
    # Pure f32 weight arithmetic: measured 2e-6 - 6e-6 (documented miss
    # of the 1e-6 target; the precise mode below is the compliant path).
    assert err32 < 1e-5, err32
    # Precise mode meets the BASELINE 1e-6 bound.
    assert errp < 1e-6, errp
    # Borderline containment flips must stay rare (<0.5%).
    assert max(flip32, flipp) <= max(2, n // 200), (flip32, flipp)
