"""Property tests over the hierarchy (SURVEY.md §4's implied oracles):
row-stochastic U, <=3 nnz/row, parent-adjacency support, partition
sanity, projection residual bounded by the sampling radius."""

import numpy as np
import jax.numpy as jnp

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.types import INVALID_INDEX


def _build(rng, n=800):
    pts = torus_points(n, seed=5)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    lap, mass = g.graph_laplacian(graph)
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    h = g.build_hierarchy(graph, spd, g.MultigridConfig(coarse_threshold=50))
    return pts, graph, h


def test_hierarchy_invariants(rng):
    pts, graph, h = _build(rng)
    assert len(h.levels) >= 2
    for li, ld in enumerate(h.levels):
        fine_graph = h.graphs[li]
        n_fine = int(ld.stats.n_fine)        # real fine count (pre-pad)
        n_real = int(ld.stats.n_coarse)      # bucket-padded beyond this
        n_coarse = ld.coarse.num_vertices

        # Partition sanity (`test/main.cpp:80-85` oracle 2).  Parents
        # always land on real coarse ids, never on bucket phantoms.
        par = np.asarray(ld.parents)[:n_fine]
        assert par.min() >= 0 and par.max() < n_real
        # Every coarse cell owns its seed.
        np.testing.assert_array_equal(par[ld.samples[:n_real]],
                                      np.arange(n_real))
        # Phantom rows are empty.
        cn_all = np.asarray(ld.coarse.neighbors)
        assert (cn_all[n_real:] == g.INVALID_INDEX).all()

        # Row-stochastic U, 1-3 nnz (oracle 3; §2.1-C12 invariants).
        w = np.asarray(ld.u.weights)[:n_fine]
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-10)
        cols = np.asarray(ld.u.cols)[:n_fine]
        assert cols.min() >= 0 and cols.max() < n_real

        # Support: each row's columns are the parent or its coarse
        # neighbors (§2.1-C12 invariant).
        cn = np.asarray(ld.coarse.neighbors)
        for i in rng.choice(n_fine, size=min(100, n_fine), replace=False):
            p = par[i]
            allowed = {p} | set(cn[p][cn[p] != INVALID_INDEX])
            used = {int(c) for c, wt in zip(cols[i], w[i]) if abs(wt) > 0}
            assert used <= allowed, (li, i, used, allowed)

        # Projection residual bounded by a few sampling radii
        # (oracle 1, `test/main.cpp:147-156`).
        proj = np.asarray(g.projected_points(ld.u, ld.coarse.points))
        res = np.linalg.norm((proj - np.asarray(fine_graph.points))[:n_fine],
                             axis=1)
        assert res.max() < 5.0 * float(ld.stats.radius)

        # Coarse graph nonempty and symmetric (oracle 4).
        deg = np.asarray(ld.coarse.degrees)
        assert deg[:n_real].min() > 0
        for c in range(n_real):
            for q in cn[c][cn[c] != INVALID_INDEX]:
                assert c in set(cn[q][cn[q] != INVALID_INDEX])


def test_coarsening_ratio(rng):
    pts, graph, h = _build(rng)
    # radius = cbrt(2) * mean edge targets ~2x reduction per level
    # (`test/main.cpp:23,74`); accept a broad band.
    for ld in h.levels:
        ratio = ld.stats.n_fine / ld.stats.n_coarse
        assert 1.5 < ratio < 8.0


def test_hierarchy_serialization_roundtrip(rng, tmp_path):
    import pickle
    pts, graph, h = _build(rng)
    blob = pickle.dumps(jax.tree_util.tree_map(np.asarray, h))
    h2 = pickle.loads(blob)
    w0 = np.asarray(h.levels[0].u.weights)
    np.testing.assert_array_equal(w0, h2.levels[0].u.weights)


import jax  # noqa: E402  (used in serialization test)


def test_device_resident_build_matches_staged(rng):
    from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                              check_diagnostics)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(1500, seed=6)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=60)
    # exact_sampling: this test checks bit-equivalence with the staged
    # (reference-greedy) builder.
    h1, diags = build_hierarchy_device(graph, spd, cfg,
                                       exact_sampling=True)
    check_diagnostics(diags)
    h2 = g.build_hierarchy(graph, spd, cfg)
    b = jnp.asarray(rng.normal(size=1500))
    x1, rel1, it1 = g.solve(h1.solver, b, cfg)
    x2, rel2, it2 = g.solve(h2.solver, b, cfg)
    assert int(it1) == int(it2)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                               rtol=1e-10, atol=1e-12)


def test_sort_local_build_matches_plain(rng):
    """sort_local=True (lane-merge coarse edges + two-phase RAP, no
    global sorts, no host syncs) must produce the same hierarchy
    operators as the default builder on the same sampling."""
    from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                              check_diagnostics)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(1500, seed=6)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=60)
    h1, d1 = build_hierarchy_device(graph, spd, cfg, exact_sampling=True)
    check_diagnostics(d1)
    h2, d2 = build_hierarchy_device(graph, spd, cfg, exact_sampling=True,
                                    sort_local=True)
    check_diagnostics(d2)
    assert len(h1.solver.levels) == len(h2.solver.levels)
    for l1, l2 in zip(h1.solver.levels, h2.solver.levels):
        np.testing.assert_allclose(np.asarray(l1.op.as_dense()),
                                   np.asarray(l2.op.as_dense()),
                                   rtol=1e-6, atol=1e-8)


def test_compact_solver_preserves_solution(rng):
    """Compaction (tight row/degree slicing) changes no real result:
    same iterate on real rows, strictly smaller padded shapes."""
    from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                              check_diagnostics,
                                              compact_solver)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(1500, seed=6)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=60)
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    hc = compact_solver(h.solver, diags, row_multiple=64)
    for lc, lp, d in zip(hc.levels[1:], h.solver.levels[1:], diags):
        assert lc.op.num_vertices <= lp.op.num_vertices
        assert lc.op.num_vertices >= int(d.n_real)
        assert lc.op.max_degree <= lp.op.max_degree
    b = jnp.asarray(rng.normal(size=1500))
    x1 = g.v_cycle(h.solver, jnp.zeros(1500), b, cfg)
    x2 = g.v_cycle(hc, jnp.zeros(1500), b, cfg)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=1e-10, atol=1e-12)


def test_rounds_sampling_matches_whileloop(rng):
    from gravomg_tpu.coarsen.sampling import (fast_disc_sample_mask,
                                              fast_disc_sample_rounds)
    pts = torus_points(2000, seed=3)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    r = g.sampling_radius(graph)
    m1 = np.asarray(fast_disc_sample_mask(graph, r))
    m2, undec = fast_disc_sample_rounds(graph, r, rounds=24)
    assert not bool(undec)
    np.testing.assert_array_equal(np.asarray(m2), m1)


def test_blockdense_sampling_exact(rng):
    """Conflict-operator (gather-free) sampling equals the reference
    greedy fixpoint bit-for-bit; parents from min-plus sweeps + pointer
    jumping equal the Bellman-Ford sweeps on a generic cloud."""
    from gravomg_tpu.coarsen.sampling import (fast_disc_sample_bd,
                                              fast_disc_sample_mask)
    from gravomg_tpu.coarsen.parents import (assign_parents,
                                             assign_parents_bd)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(3000, seed=4)
    pts = pts[morton_order(pts)]     # bd paths assume spatial ordering
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    r = g.sampling_radius(graph)
    m_ref = np.asarray(fast_disc_sample_mask(graph, r))
    m_bd, invalid = fast_disc_sample_bd(graph, r)
    assert not bool(invalid)
    np.testing.assert_array_equal(np.asarray(m_bd), m_ref)

    samples = jnp.asarray(np.nonzero(m_ref)[0].astype(np.int32))
    par_ref, dist_ref = assign_parents(graph, samples)
    par_bd, dist_bd, ovf = assign_parents_bd(graph, samples,
                                             escape_cap=3000 * 8)
    assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(dist_bd), np.asarray(dist_ref),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(par_bd),
                                  np.asarray(par_ref))


def test_pruned_sampling_exact(rng):
    """Radius-pruned conflict tables give the identical greedy mask when
    the static cap holds, and flag overflow when it doesn't."""
    from gravomg_tpu.coarsen.sampling import (fast_disc_sample_mask,
                                              fast_disc_sample_rounds,
                                              prune_overflow)
    pts = torus_points(2000, seed=3)
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    r = g.sampling_radius(graph)
    m1 = np.asarray(fast_disc_sample_mask(graph, r))
    in_radius = np.asarray(jnp.sum(graph.mask
                                   & (graph.distances < r), axis=1))
    cap = int(in_radius.max())
    assert cap < graph.max_degree, "test needs a non-trivial prune"
    assert not bool(prune_overflow(graph, r, cap))
    m2 = np.asarray(fast_disc_sample_mask(graph, r, prune_cap=cap))
    np.testing.assert_array_equal(m2, m1)
    m3, undec = fast_disc_sample_rounds(graph, r, rounds=24,
                                        prune_cap=cap)
    assert not bool(undec)
    np.testing.assert_array_equal(np.asarray(m3), m1)
    # A cap one below the max in-radius degree must flag.
    assert bool(prune_overflow(graph, r, cap - 1))
    _, undec_bad = fast_disc_sample_rounds(graph, r, rounds=24,
                                           prune_cap=cap - 1)
    assert bool(undec_bad)


def test_priority_sampling_is_valid_mis(rng):
    """Random-priority disc sampling returns a maximal independent set
    of the exact conflict relation: no two selected vertices conflict,
    and every rejected vertex has a selected conflict."""
    from gravomg_tpu.coarsen.sampling import (conflict_ell,
                                              fast_disc_sample_priority)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(3000, seed=8)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    r = g.sampling_radius(graph)
    m, invalid = fast_disc_sample_priority(graph, r, seed=3)
    assert not bool(invalid)
    m = np.asarray(m)
    assert 0 < m.sum() < 3000
    cols, cmask, ovf = conflict_ell(graph, r, graph.max_degree, 192,
                                    lower_only=False)
    assert not bool(ovf)
    cols = np.asarray(cols)
    cmask = np.asarray(cmask)
    for i in range(3000):
        conf = cols[i][cmask[i]]
        if m[i]:
            assert not m[conf].any(), i       # independent
        else:
            assert m[conf].any(), i           # maximal
    # determinism
    m2, _ = fast_disc_sample_priority(graph, r, seed=3)
    np.testing.assert_array_equal(np.asarray(m2), m)


def test_chained_sampling_matches_priority(rng):
    """The chained-1-hop-gate sampler must return the BIT-IDENTICAL
    MIS as the materialized-2-hop-table sampler for the same seed (same
    priorities, same greedy-by-priority fixpoint; the unweighted <=2-hop
    wait gate is a superset relation, which only delays decisions, never
    changes them), on several clouds and seeds."""
    from gravomg_tpu.coarsen.sampling import (fast_disc_sample_chained,
                                              fast_disc_sample_priority)
    from gravomg_tpu.geometry.order import morton_order
    for n, k, seed in ((3000, 8, 3), (5000, 12, 0), (2000, 16, 7)):
        pts = torus_points(n, seed=seed + 20)
        pts = pts[morton_order(pts)]
        graph = g.knn_graph(jnp.asarray(pts), k=k)
        r = g.sampling_radius(graph)
        m1, inv1 = fast_disc_sample_priority(graph, r, seed=seed)
        m2, inv2 = fast_disc_sample_chained(graph, r, seed=seed)
        assert not bool(inv1) and not bool(inv2)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))


def test_chained_sampling_in_builder(rng):
    """build_hierarchy_device's default (chained) and the priority-table
    path must produce the same hierarchy end-to-end."""
    from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                              check_diagnostics)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(2500, seed=11)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=100)
    h1, d1 = build_hierarchy_device(graph, spd, cfg,
                                    chained_sampling=True)
    check_diagnostics(d1)
    h2, d2 = build_hierarchy_device(graph, spd, cfg,
                                    chained_sampling=False)
    check_diagnostics(d2)
    for l1, l2 in zip(h1.solver.levels, h2.solver.levels):
        np.testing.assert_allclose(np.asarray(l1.op.as_dense()),
                                   np.asarray(l2.op.as_dense()),
                                   rtol=1e-6, atol=1e-8)


def test_priority_bitcast_distinct_beyond_f32_ints():
    """MIS priorities must stay pairwise distinct above 2^24 vertices:
    the int32->f32 bitcast (offset 2^23) is strictly monotone and
    collision-free where a plain float cast collapses."""
    import jax
    # Values straddling 2^24 where float32 cast collides.
    vals = np.array([2**24 - 2, 2**24 - 1, 2**24, 2**24 + 1, 2**24 + 2,
                     0, 1, 2, 3, 2**26, 2**26 + 1], np.int32)
    plain = vals.astype(np.float32)
    assert len(np.unique(plain)) < len(vals)          # the failure mode
    pr = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(vals) + jnp.int32(2**23), jnp.float32))
    assert len(np.unique(pr)) == len(vals)
    order = np.argsort(vals)
    assert (np.diff(pr[order]) > 0).all()             # monotone
    assert np.isfinite(pr).all() and (pr > 0).all()   # normal floats


def test_largev_narrow_geometry_paths_match(rng):
    """The scale-adaptive narrow-window/bf16 build-operator geometry
    (engaged above large_v vertices; forced here with large_v=0) is
    exact: min is order-free, bf16 holds 0/1/inf exactly, and escaped
    entries combine identically -- so sampling masks and parents match
    the small-scale wide-geometry path bit-for-bit."""
    from gravomg_tpu.coarsen.sampling import (fast_disc_sample_bd,
                                              fast_disc_sample_mask,
                                              fast_disc_sample_priority)
    from gravomg_tpu.coarsen.parents import (assign_parents,
                                             assign_parents_bd)
    from gravomg_tpu.geometry.order import morton_order
    pts = torus_points(3000, seed=4)
    pts = pts[morton_order(pts)]
    graph = g.knn_graph(jnp.asarray(pts), k=8)
    r = g.sampling_radius(graph)

    m_ref = np.asarray(fast_disc_sample_mask(graph, r))
    m_n, inv = fast_disc_sample_bd(graph, r, large_v=0)
    assert not bool(inv)
    np.testing.assert_array_equal(np.asarray(m_n), m_ref)

    m_w, _ = fast_disc_sample_priority(graph, r, seed=3)
    m_p, inv = fast_disc_sample_priority(graph, r, seed=3, large_v=0)
    assert not bool(inv)
    np.testing.assert_array_equal(np.asarray(m_p), np.asarray(m_w))

    samples = jnp.asarray(np.nonzero(m_ref)[0].astype(np.int32))
    par_ref, dist_ref = assign_parents(graph, samples)
    par_n, dist_n, ovf = assign_parents_bd(graph, samples, large_v=0)
    assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(dist_n), np.asarray(dist_ref),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(par_n), np.asarray(par_ref))
