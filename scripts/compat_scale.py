"""At-scale exact-compat verification against the csrc build.

Ties the BASELINE 1e-6 weight-compat claim to a >=200k-vertex build:
the exact lex-first-MIS sampling cannot run on-device at this scale
(its dependency chains under a spatial order are O(V/spacing) rounds),
so the reference greedy's output is taken from the csrc sequential
oracle (`csrc/gravomg_host.cpp::gmg_coarsen_level`, reference C4/C6
semantics, oracle-equivalence-tested at small scale) and INJECTED into
the vectorized device pipeline, which then runs parents, coarse graph,
placement, triangles, and prolongation itself.  Per level, against the
csrc build of the same level:

  * parents: exact match count (multi-source shortest-path Voronoi;
    both sides recompute f64 Euclidean relaxations from the same f32
    point values, so generic clouds match exactly);
  * U: per-row support + weight comparison at f64 (the BASELINE
    criterion is "weights match the reference to 1e-6 given the same
    hierarchy"; the pipeline itself is f64 here, as in tests/
    test_compat.py, isolating algorithmic compat from f32 storage,
    which tests/test_compat_f32.py bounds separately).

Runs on any backend (the pipeline is the same XLA program everywhere;
chip_smoke.py runs the level-0 check on the GPU).  Emits one JSON line
per level plus a summary; exits nonzero on any compat failure.

Usage: JAX_PLATFORMS=cpu python scripts/compat_scale.py [N]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import jax.numpy as jnp

import gravomg_tpu as g
import gravomg_tpu.io.native as native
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.types import Graph, INVALID_INDEX

N = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
THRESHOLD = 1000


def emit(obj):
    print(json.dumps(obj), flush=True)


def compare_u(u_dev, csrc, n):
    """Max |w_dev - w_csrc| over rows with identical support; rows with
    different support are counted (must be zero at f64)."""
    cols_d = np.asarray(u_dev.cols)
    w_d = np.asarray(u_dev.weights, np.float64)
    cols_c = csrc["u_cols"]
    w_c = csrc["u_weights"]
    err = 0.0
    support_mismatch = 0
    for i in range(n):
        got = {}
        for cc, ww in zip(cols_d[i], w_d[i]):
            if abs(ww) > 0:
                got[int(cc)] = got.get(int(cc), 0.0) + ww
        ref = {}
        for cc, ww in zip(cols_c[i], w_c[i]):
            if abs(ww) > 0:
                ref[int(cc)] = ref.get(int(cc), 0.0) + ww
        if set(got) != set(ref):
            support_mismatch += 1
            continue
        for cc, ww in got.items():
            err = max(err, abs(ww - ref[cc]))
    return err, support_mismatch


def level0_graph(n: int) -> Graph:
    """The bench cloud's level-0 kNN graph at f64 (both sides see the
    same f32 point values).  Call with x64 enabled."""
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph32, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
    assert not bool(short)
    return Graph(neighbors=graph32.neighbors,
                 distances=graph32.distances.astype(jnp.float64),
                 points=graph32.points.astype(jnp.float64))


def check_level(graph: Graph, level: int = 0):
    """Coarsen one level on the device from the csrc sampling and
    compare with the csrc build.  Returns (record, ok, coarse graph)."""
    v = graph.num_vertices
    nbr_np = np.asarray(graph.neighbors)
    dist_np = np.asarray(graph.distances)
    pts_np = np.asarray(graph.points)

    csrc = native.coarsen_level(nbr_np, dist_np, pts_np,
                                reduction_ratio=2.0, scheme=0,
                                kc_cap=96)
    samples = jnp.asarray(csrc["samples"])
    nc = len(csrc["samples"])

    # Device stages on the injected exact sampling.
    par, _ = g.assign_parents(graph, samples)
    par_mismatch = int(np.sum(np.asarray(par) != csrc["parents"]))

    # Downstream consumes the csrc parents so the weight check is
    # "same hierarchy" by construction even if a tie flipped.
    par_c = jnp.asarray(csrc["parents"])
    cols, e_ovf = g.extract_coarse_edges(graph, par_c, nc, 96)
    assert not bool(e_ovf)
    cp = g.coarse_from_mean_of_fine_children(graph, par_c, samples)
    cp_err = float(np.abs(np.asarray(cp) - csrc["coarse_points"]).max())
    cg = g.coarse_graph(cols, cp)

    # Coarse adjacency pattern must match csrc exactly.
    nbr_dev = np.asarray(cg.neighbors)
    kc = min(nbr_dev.shape[1], 96)
    adj_mismatch = int(
        np.sum(nbr_dev[:, :kc] != csrc["coarse_nbr"][:, :kc]))

    tris, t_ovf = g.construct_voronoi_triangles(
        cg, max(8 * nc, 1024), 256)
    assert not bool(t_ovf)
    u, counts, _ = g.construct_prolongation(
        graph.points, par_c, cp, cg.neighbors, tris,
        scheme=g.BARYCENTRIC)
    w_err, supp = compare_u(u, csrc, v)

    rec = {"level": level, "v": v, "nc": nc,
           "parents_mismatch": par_mismatch,
           "coarse_adj_mismatch": adj_mismatch,
           "coarse_point_err": cp_err,
           "weight_err": w_err, "support_mismatch": supp}
    ok = (w_err < 1e-6 and supp == 0 and adj_mismatch == 0
          and par_mismatch == 0)
    return rec, ok, cg


def main():
    jax.config.update("jax_enable_x64", True)
    graph = level0_graph(N)
    ok = True
    level = 0
    while graph.num_vertices > THRESHOLD:
        rec, lvl_ok, graph = check_level(graph, level)
        emit(rec)
        ok = ok and lvl_ok
        level += 1

    emit({"summary": "compat_scale", "n": N, "levels": level,
          "ok": ok, "bound": 1e-6})
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
