"""Solver stack tests: SpMV, RAP, smoothers, V-cycle, MG-PCG
(SURVEY.md CS-5; BASELINE.json configs 1-2 at test scale)."""

import numpy as np
import jax
import jax.numpy as jnp

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import icosphere
from gravomg_tpu.solve.smoothers import ChebyshevParams, chebyshev
from gravomg_tpu.solve.coarse import factor_coarse, coarse_solve


def _random_ell_spd(rng, n=50, k=6):
    """Random symmetric diagonally-dominant ELL operator."""
    dense = np.zeros((n, n))
    for i in range(n):
        for j in rng.choice(n, size=k, replace=False):
            if i != j:
                w = rng.random() + 0.1
                dense[i, j] -= w
                dense[j, i] -= w
    np.fill_diagonal(dense, -dense.sum(axis=1) + 0.5)
    # to ELL
    kmax = int((dense != 0).sum(axis=1).max())
    from gravomg_tpu.ops.segment import build_ell_rows
    rows, cols = np.nonzero(dense * (1 - np.eye(n)))
    res = build_ell_rows(jnp.asarray(rows, jnp.int32),
                         jnp.asarray(cols, jnp.int32),
                         jnp.ones(len(rows), bool), n, kmax + 2,
                         values=jnp.asarray(dense[rows, cols]))
    op = g.EllOperator(res.columns,
                       jnp.where(res.columns != g.INVALID_INDEX,
                                 res.values, 0.0),
                       jnp.asarray(np.diag(dense)))
    return op, dense


def test_spmv_matches_dense(rng):
    op, dense = _random_ell_spd(rng)
    x = rng.normal(size=dense.shape[0])
    np.testing.assert_allclose(np.asarray(g.spmv(op, jnp.asarray(x))),
                               dense @ x, rtol=1e-12)
    xm = rng.normal(size=(dense.shape[0], 3))
    np.testing.assert_allclose(np.asarray(g.spmv(op, jnp.asarray(xm))),
                               dense @ xm, rtol=1e-12)


def test_ell_as_dense_roundtrip(rng):
    op, dense = _random_ell_spd(rng)
    np.testing.assert_allclose(np.asarray(op.as_dense()), dense, rtol=1e-12)


def test_galerkin_rap_matches_dense(rng):
    op, dense = _random_ell_spd(rng, n=60)
    n, nc = 60, 20
    cols = rng.integers(0, nc, size=(n, 3)).astype(np.int32)
    w = rng.random(size=(n, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    u_dense = np.asarray(u.as_dense())
    expect = u_dense.T @ dense @ u_dense
    coarse, ovf = g.galerkin_rap(op, u, nc)
    assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(coarse.as_dense()), expect,
                               rtol=1e-10, atol=1e-12)


def test_prolong_restrict_adjoint(rng):
    n, nc = 40, 12
    cols = rng.integers(0, nc, size=(n, 3)).astype(np.int32)
    w = rng.normal(size=(n, 3))
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    x = jnp.asarray(rng.normal(size=nc))
    y = jnp.asarray(rng.normal(size=n))
    # <U x, y> == <x, U^T y>
    lhs = float(jnp.vdot(g.prolong(u, x), y))
    rhs = float(jnp.vdot(x, g.restrict(u, y)))
    assert abs(lhs - rhs) < 1e-10


def test_restriction_gather_matches_scatter(rng):
    """Gather-form U^T (children table) is exactly the scatter form."""
    from gravomg_tpu.prolong.operator import (build_restriction,
                                              restrict_gather)
    n, nc = 200, 30
    cols = rng.integers(0, nc, size=(n, 3)).astype(np.int32)
    w = rng.normal(size=(n, 3))
    w[rng.random(size=(n, 3)) < 0.2] = 0.0      # exercise dropped zeros
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    rt, ovf = build_restriction(u, 64)
    assert not bool(ovf)
    y = jnp.asarray(rng.normal(size=n))
    np.testing.assert_allclose(np.asarray(restrict_gather(rt, y)),
                               np.asarray(g.restrict(u, y)),
                               rtol=1e-12, atol=1e-12)
    ym = jnp.asarray(rng.normal(size=(n, 3)))
    np.testing.assert_allclose(np.asarray(restrict_gather(rt, ym)),
                               np.asarray(g.restrict(u, ym)),
                               rtol=1e-12, atol=1e-12)
    # Overflow detection: a cap below the max children count flags.
    counts = np.bincount(cols.reshape(-1)[w.reshape(-1) != 0],
                         minlength=nc)
    _, ovf2 = build_restriction(u, int(counts.max()) - 1)
    assert bool(ovf2)


def test_attach_restrictions_roundtrip(rng):
    """attach_restrictions populates every level; v_cycle result is
    unchanged vs the scatter-form path."""
    op, dense = _random_ell_spd(rng, n=60)
    nc = 20
    cols = rng.integers(0, nc, size=(60, 3)).astype(np.int32)
    w = rng.random(size=(60, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    coarse, _ = g.galerkin_rap(op, u, nc)
    cfg = g.MultigridConfig()
    h = g.SolverHierarchy(
        levels=(g.SolverLevel(op=op, u=u, cheb=None),
                g.SolverLevel(op=coarse, u=None, cheb=None)),
        coarse_chol=factor_coarse(coarse))
    hg = g.attach_restrictions(h)
    assert hg.levels[0].ut is not None
    b = jnp.asarray(rng.normal(size=60))
    x_scatter = g.v_cycle(h, jnp.zeros(60), b, cfg)
    x_gather = g.v_cycle(hg, jnp.zeros(60), b, cfg)
    np.testing.assert_allclose(np.asarray(x_gather),
                               np.asarray(x_scatter),
                               rtol=1e-12, atol=1e-12)


def test_jacobi_and_chebyshev_reduce_error(rng):
    op, dense = _random_ell_spd(rng, n=80)
    x_true = rng.normal(size=80)
    b = jnp.asarray(dense @ x_true)
    x0 = jnp.zeros(80)
    e0 = np.linalg.norm(x_true)
    xj = g.weighted_jacobi(op, x0, b, 30)
    assert np.linalg.norm(np.asarray(xj) - x_true) < 0.7 * e0
    params = ChebyshevParams.from_operator(op, ratio=30.0)
    xc = chebyshev(op, x0, b, params, 20)
    assert np.linalg.norm(np.asarray(xc) - x_true) < 0.5 * e0


def test_coarse_cholesky(rng):
    op, dense = _random_ell_spd(rng, n=30)
    chol = factor_coarse(op)
    b = jnp.asarray(rng.normal(size=30))
    x = coarse_solve(chol, b)
    np.testing.assert_allclose(np.asarray(g.spmv(op, x)), np.asarray(b),
                               rtol=1e-8, atol=1e-8)


def _sphere_hierarchy(rng, smoother="jacobi"):
    v, f = icosphere(3)
    v = v + rng.normal(scale=1e-3, size=v.shape)
    graph = g.knn_graph(jnp.asarray(v), k=8)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=64, smoother=smoother)
    return g.build_hierarchy(graph, spd, cfg), cfg, spd


def test_vcycle_solver_converges(rng):
    h, cfg, spd = _sphere_hierarchy(rng)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    x, rel, it = g.solve(h.solver, b, cfg)
    assert float(rel) < cfg.tolerance
    assert int(it) < 40
    true_rel = float(jnp.linalg.norm(g.spmv(spd, x) - b)
                     / jnp.linalg.norm(b))
    assert true_rel < 10 * cfg.tolerance


def test_mg_pcg_converges(rng):
    h, cfg, spd = _sphere_hierarchy(rng)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    x, rel, it = g.mg_pcg(h.solver, b, cfg)
    assert float(rel) < cfg.tolerance
    assert int(it) < 25


def test_chebyshev_hierarchy_converges(rng):
    h, cfg, spd = _sphere_hierarchy(rng, smoother="chebyshev")
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    x, rel, it = g.solve(h.solver, b, cfg)
    assert float(rel) < cfg.tolerance
    assert int(it) < 40


def test_galerkin_rap_chunked_matches_full(rng):
    from gravomg_tpu.solve.rap import _galerkin_rap_chunked
    op, dense = _random_ell_spd(rng, n=300)
    nc = 40
    cols = rng.integers(0, nc, size=(300, 3)).astype(np.int32)
    w = rng.random(size=(300, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    full, o1 = g.galerkin_rap(op, u, nc)
    chunked, o2 = _galerkin_rap_chunked(op, u, nc, 64)
    assert not bool(o1) and not bool(o2)
    np.testing.assert_allclose(np.asarray(chunked.as_dense()),
                               np.asarray(full.as_dense()),
                               rtol=1e-10, atol=1e-12)


def test_multi_rhs_vcycle_solve(rng):
    h, cfg, spd = _sphere_hierarchy(rng)
    bs = jnp.asarray(rng.normal(size=(spd.num_vertices, 3)))
    xs, rel, it = g.solve(h.solver, bs, cfg)
    assert float(rel) < cfg.tolerance
    for d in range(3):
        xd, _, _ = g.solve(h.solver, bs[:, d], cfg)
        r = float(jnp.linalg.norm(g.spmv(spd, xs[:, d]) - bs[:, d])
                  / jnp.linalg.norm(bs[:, d]))
        assert r < 10 * cfg.tolerance


def test_mg_fcg_converges_like_pcg(rng):
    """Flexible CG matches plain MG-PCG with an exact (f32) V-cycle
    preconditioner: same fixed point, comparable iteration count."""
    h, cfg, spd = _sphere_hierarchy(rng)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    x, rel, it = g.mg_fcg(h.solver, b, cfg)
    assert float(rel) < cfg.tolerance
    assert int(it) < 25
    true_rel = float(jnp.linalg.norm(g.spmv(spd, x) - b)
                     / jnp.linalg.norm(b))
    assert true_rel < 10 * cfg.tolerance


def test_mg_fcg_bf16_preconditioner(rng):
    """A bf16-cast V-cycle is a valid FCG preconditioner: the flexible
    beta absorbs the rounding-induced nonsymmetry
    while CG's own matvec/residual stay f32.  Iterations must stay
    within ~1.5x of the f32-preconditioned run."""
    from gravomg_tpu.solve.vcycle import (attach_fast_operators,
                                          cast_fast_operators)
    h, cfg, spd = _sphere_hierarchy(rng, smoother="chebyshev")
    sol = attach_fast_operators(h.solver, block=32, window=64)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    _, rel32, it32 = g.mg_fcg(sol, b, cfg)
    sol16 = cast_fast_operators(sol, jnp.bfloat16)
    x, rel16, it16 = g.mg_fcg(sol16, b, cfg, h_outer=sol)
    assert float(rel32) < cfg.tolerance
    assert float(rel16) < cfg.tolerance
    assert int(it16) <= max(int(1.5 * int(it32)), int(it32) + 3)


def test_wcycle_contracts_at_least_as_fast_as_v(rng):
    # gamma=2 (W-cycle) must converge in no more stationary cycles than
    # the V-cycle on the same hierarchy (it does strictly more coarse
    # work per cycle).
    h, cfg, spd = _sphere_hierarchy(rng)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    cfg_w = g.MultigridConfig(coarse_threshold=64, cycle_gamma=2)
    _, rel_v, it_v = g.solve(h.solver, b, cfg)
    x, rel_w, it_w = g.solve(h.solver, b, cfg_w)
    assert float(rel_w) < cfg_w.tolerance
    assert int(it_w) <= int(it_v)
    true_rel = float(jnp.linalg.norm(g.spmv(spd, x) - b)
                     / jnp.linalg.norm(b))
    assert true_rel < 10 * cfg_w.tolerance


def test_fmg_initial_guess_cuts_pcg_iterations(rng):
    h, cfg, spd = _sphere_hierarchy(rng, smoother="chebyshev")
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    x0 = g.fmg(h.solver, b, cfg)
    # One FMG pass must already be a decent solve (well under the
    # smooth-error floor of the zero guess)...
    rel0 = float(jnp.linalg.norm(b - g.spmv(spd, x0))
                 / jnp.linalg.norm(b))
    assert rel0 < 0.05
    # ...and seeding PCG with it must not lose iterations.
    _, rel_a, it_a = g.mg_pcg(h.solver, b, cfg)
    _, rel_b, it_b = g.mg_pcg(h.solver, b, cfg, x0=x0)
    assert float(rel_b) < cfg.tolerance
    assert int(it_b) <= int(it_a)


def test_galerkin_rap_local_matches_full(rng):
    # Sort-local two-phase RAP (lane merges + children table) must
    # equal the global-sort baseline as a dense operator, including on
    # a hierarchy-shaped U (3 nnz/row, random columns) and with padded
    # coarse rows (phantom identity diagonal).
    from gravomg_tpu.solve.rap2 import galerkin_rap_local
    op, dense = _random_ell_spd(rng, n=300)
    nc = 40
    cols = rng.integers(0, nc, size=(300, 3)).astype(np.int32)
    w = rng.random(size=(300, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc + 5)
    full, o1 = g.galerkin_rap(op, u, nc + 5)
    local, o2 = galerkin_rap_local(op, u, nc + 5)
    assert not bool(o1) and not bool(o2)
    np.testing.assert_allclose(np.asarray(local.as_dense()),
                               np.asarray(full.as_dense()),
                               rtol=1e-10, atol=1e-12)
    # Deferred-cap path: must trace under jit (no host sync) and agree.
    # Random U columns are non-local, so the phase-1 width needs the
    # full coarse size (real hierarchies are local; the builder default
    # suffices there and overflow is surfaced via diagnostics).
    loc2, o3 = jax.jit(
        lambda o_, u_: galerkin_rap_local(o_, u_, nc + 5,
                                          y_width=nc + 5,
                                          sync_retry=False))(op, u)
    assert not bool(o3)
    np.testing.assert_allclose(np.asarray(loc2.as_dense()),
                               np.asarray(full.as_dense()),
                               rtol=1e-10, atol=1e-12)


def test_galerkin_rap_2phase_matches_full(rng):
    """Two-phase RAP (lane-merged Y + one small sort) must equal the
    single-stream baseline as a dense operator, including phantom rows
    and under jit."""
    from gravomg_tpu.solve.rap2 import galerkin_rap_2phase
    op, dense = _random_ell_spd(rng, n=300)
    nc = 40
    cols = rng.integers(0, nc, size=(300, 3)).astype(np.int32)
    w = rng.random(size=(300, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc + 5)
    full, o1 = g.galerkin_rap(op, u, nc + 5)
    # Random U columns are non-local: y_width needs the full coarse
    # size here (real hierarchies are local; builder default applies).
    two, o2 = galerkin_rap_2phase(op, u, nc + 5, y_width=nc + 5)
    assert not bool(o1) and not bool(o2)
    np.testing.assert_allclose(np.asarray(two.as_dense()),
                               np.asarray(full.as_dense()),
                               rtol=1e-10, atol=1e-12)
    # Width overflow is flagged, not silent.
    _, o3 = galerkin_rap_2phase(op, u, nc + 5, y_width=4)
    assert bool(o3)
    # Chunked phase 2 (the >chunk_rows path used at 1M) is the same
    # operator, including with a ragged final chunk.
    for chunk in (100, 128):
        chk, o4 = galerkin_rap_2phase(op, u, nc + 5, y_width=nc + 5,
                                      chunk_rows=chunk)
        assert not bool(o4)
        np.testing.assert_allclose(np.asarray(chk.as_dense()),
                                   np.asarray(full.as_dense()),
                                   rtol=1e-10, atol=1e-12)


def test_lane_merge_oracle(rng):
    from gravomg_tpu.solve.rap2 import lane_merge
    r, w, ncol = 50, 24, 12
    cols = rng.integers(0, ncol, size=(r, w)).astype(np.int32)
    vals = rng.normal(size=(r, w))
    absent = rng.random((r, w)) < 0.3
    cols = np.where(absent, g.INVALID_INDEX, cols)
    vals = np.where(absent, 0.0, vals)
    oc, ov, ovf = lane_merge(jnp.asarray(cols), jnp.asarray(vals), ncol)
    assert not bool(ovf)
    got = np.zeros((r, ncol))
    oc, ov = np.asarray(oc), np.asarray(ov)
    for i in range(r):
        for j in range(oc.shape[1]):
            if oc[i, j] != g.INVALID_INDEX:
                got[i, oc[i, j]] += ov[i, j]
        # distinct columns per row
        live = oc[i][oc[i] != g.INVALID_INDEX]
        assert len(set(live.tolist())) == len(live)
    expect = np.zeros((r, ncol))
    for i in range(r):
        for j in range(w):
            if not absent[i, j]:
                expect[i, cols[i, j]] += vals[i, j]
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)
    # Overflow flag: out_width smaller than distinct count must trip.
    _, _, ovf2 = lane_merge(jnp.asarray(cols), jnp.asarray(vals), 2)
    assert bool(ovf2)


def test_extract_coarse_edges_local_matches_baseline(rng):
    from gravomg_tpu.coarsen.graph import (extract_coarse_edges,
                                           extract_coarse_edges_local)
    from gravomg_tpu.geometry.meshes import torus_points

    pts = jnp.asarray(torus_points(1500, seed=7))
    graph = g.knn_graph(pts, k=10)
    nc = 200
    parents = jnp.asarray(
        rng.integers(0, nc, size=graph.num_vertices).astype(np.int32))
    fv = jnp.asarray(rng.random(graph.num_vertices) < 0.95)
    a, o1 = extract_coarse_edges(graph, parents, nc, nc, fine_valid=fv)
    b, o2 = extract_coarse_edges_local(graph, parents, nc, nc,
                                       fine_valid=fv)
    assert not bool(o1) and not bool(o2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Deferred-cap path: must trace under jit (no host sync) and agree.
    c, o3 = jax.jit(
        lambda g_, p_, f_: extract_coarse_edges_local(
            g_, p_, nc, nc, fine_valid=f_, sync_retry=False))(
                graph, parents, fv)
    assert not bool(o3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_galerkin_rap_2phase_wide_k_grouped(rng):
    """K > _AU_GROUP exercises the grouped phase-1 merge (the one-shot
    3K+3-lane sort at build-time K=128 levels ran its compile out of
    memory); the grouped result must still equal the stream baseline,
    chunked or not."""
    from gravomg_tpu.solve.rap2 import _AU_GROUP, galerkin_rap_2phase
    op, dense = _random_ell_spd(rng, n=220, k=70)
    assert op.neighbors.shape[1] > _AU_GROUP
    nc = 30
    cols = rng.integers(0, nc, size=(220, 3)).astype(np.int32)
    w = rng.random(size=(220, 3))
    w /= w.sum(axis=1, keepdims=True)
    u = g.Prolongation(jnp.asarray(cols), jnp.asarray(w), nc)
    full, o1 = g.galerkin_rap(op, u, nc)
    assert not bool(o1)
    for chunk in (10 ** 9, 100):
        two, o2 = galerkin_rap_2phase(op, u, nc, y_width=nc,
                                      chunk_rows=chunk)
        assert not bool(o2)
        np.testing.assert_allclose(np.asarray(two.as_dense()),
                                   np.asarray(full.as_dense()),
                                   rtol=1e-10, atol=1e-12)


def test_default_chebyshev_contraction_at_most_quarter(rng):
    """Regression pin for the contraction-sweep defaults: with the shipped chebyshev_degree/chebyshev_ratio the
    stationary V-cycle must contract the residual by at least 4x per
    cycle (SWEEP_contraction_50k.json: rho=0.135 at degree 4 / ratio 16;
    the pre-sweep ratio-4 default measured 0.251)."""
    h, cfg, spd = _sphere_hierarchy(rng, smoother="chebyshev")
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    _, _, _, hist = g.solve_with_history(h.solver, b, cfg)
    hist = np.asarray(hist)
    hist = hist[np.isfinite(hist) & (hist > 1e-4)]  # above the f32 floor
    assert len(hist) >= 3, hist
    rho = (hist[-1] / hist[0]) ** (1.0 / (len(hist) - 1))
    assert rho <= 0.25, f"contraction {rho:.3f} > 0.25"


def test_mg_solve_default_dispatch(rng):
    """mg_solve (the default solve) picks f32 MG-PCG below
    cfg.bf16_threshold and bf16-FCG at/above it, both converging to the
    1e-8 target with the bf16 path within 1.5x of f32 iterations
    (the 1M scale evidence comes from chip_smoke.py; this pins the
    dispatch contract)."""
    import dataclasses
    from gravomg_tpu.solve.vcycle import attach_fast_operators
    h, cfg, spd = _sphere_hierarchy(rng, smoother="chebyshev")
    sol = attach_fast_operators(h.solver, block=32, window=64)
    b = jnp.asarray(rng.normal(size=spd.num_vertices))
    # Below threshold: identical to mg_pcg.
    x_small, rel_s, it_s = g.mg_solve(sol, b, cfg)
    x_ref, rel_ref, it_ref = g.mg_pcg(sol, b, cfg)
    assert float(rel_s) < cfg.tolerance and int(it_s) == int(it_ref)
    np.testing.assert_array_equal(np.asarray(x_small), np.asarray(x_ref))
    # Force the threshold below the mesh size: bf16-FCG path.
    cfg16 = dataclasses.replace(cfg, bf16_threshold=spd.num_vertices)
    x16, rel16, it16 = g.mg_solve(sol, b, cfg16)
    assert float(rel16) < cfg.tolerance
    assert int(it16) <= max(int(1.5 * int(it_ref)), int(it_ref) + 3)


def test_vcycle_x0_zero_bit_exact(rng):
    """v_cycle(x0_zero=True) skips the pre-smoother's first matvec on
    an exactly-zero initial guess (A 0 = 0): the result must be
    BIT-identical to the plain cycle, for both smoother families.
    Every coarse correction and every preconditioner application take
    this path (one fewer full matvec per level per cycle)."""
    for smoother in ("chebyshev", "jacobi"):
        h, cfg, spd = _sphere_hierarchy(rng, smoother=smoother)
        b = jnp.asarray(rng.normal(size=spd.num_vertices))
        x_plain = g.v_cycle(h.solver, jnp.zeros_like(b), b, cfg)
        x_fast = g.v_cycle(h.solver, jnp.zeros_like(b), b, cfg,
                           x0_zero=True)
        np.testing.assert_array_equal(np.asarray(x_plain),
                                      np.asarray(x_fast))
