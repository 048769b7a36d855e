"""Bucketed variable-window (slab) operator tests: exactness vs the
uniform block-dense form and the dense oracle, and V-cycle integration
(ops/slab.py)."""

import numpy as np
import jax.numpy as jnp

import gravomg_tpu as g
from gravomg_tpu.ops.blockdense import (blockdense_from_ell,
                                        blockdense_matvec)
from gravomg_tpu.ops.slab import (slab_from_ell, slab_matvec,
                                  window_counts)


def _tailed_ell(rng, r=1000, k=10, nc=1000, far_p=0.03):
    """Locality-ordered ELL columns with a heavy far-column tail (the
    Morton-seam pattern that motivates bucketing)."""
    base = (np.arange(r) * nc // r)[:, None]
    cols = np.clip(base + rng.integers(-80, 80, size=(r, k)), 0, nc - 1)
    far = rng.random((r, k)) < far_p
    cols = np.where(far, rng.integers(0, nc, size=(r, k)),
                    cols).astype(np.int32)
    vals = rng.normal(size=(r, k)).astype(np.float32)
    valid = rng.random((r, k)) < 0.9
    return cols, vals, valid


def _dense(cols, vals, valid, r, nc, diag=None):
    d = np.zeros((r, nc), np.float32)
    for i in range(r):
        for j in range(cols.shape[1]):
            if valid[i, j] and vals[i, j] != 0:
                d[i, cols[i, j]] += vals[i, j]
    if diag is not None:
        d[np.arange(r), np.arange(r)] += diag
    return d


def test_slab_matches_uniform_and_dense(rng):
    r = nc = 1000
    cols, vals, valid = _tailed_ell(rng, r=r, nc=nc)
    diag = rng.normal(size=r).astype(np.float32) + 5
    x = rng.normal(size=nc).astype(np.float32)

    sop = slab_from_ell(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.asarray(valid), nc, diag=jnp.asarray(diag),
                        block=8, window=128)
    uop, ovf = blockdense_from_ell(jnp.asarray(cols), jnp.asarray(vals),
                                   jnp.asarray(valid), nc,
                                   diag=jnp.asarray(diag), block=8,
                                   window=128, nw=12, escape_cap=8192,
                                   window0=128)
    assert not bool(ovf)
    # The whole point: the slab form is much smaller than uniform.
    assert sop.m_bytes < 0.5 * uop.m.size * 4

    y_u = np.asarray(blockdense_matvec(uop, jnp.asarray(x)))
    y_s = np.asarray(slab_matvec(sop, jnp.asarray(x)))
    y_d = _dense(cols, vals, valid, r, nc, diag) @ x
    scale = np.abs(y_d).max()
    np.testing.assert_allclose(y_s, y_u, atol=2e-6 * scale)
    np.testing.assert_allclose(y_s, y_d, atol=2e-5 * scale)


def test_slab_rectangular(rng):
    """Rectangular (transfer-shaped) slab operator vs dense."""
    r, nc = 1200, 400
    cols = np.clip((np.arange(r) * nc // r)[:, None]
                   + rng.integers(-30, 30, size=(r, 3)), 0,
                   nc - 1).astype(np.int32)
    vals = rng.normal(size=(r, 3)).astype(np.float32)
    valid = np.ones((r, 3), bool)
    x = rng.normal(size=nc).astype(np.float32)
    sop = slab_from_ell(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.asarray(valid), nc, block=8, window=128)
    y_s = np.asarray(slab_matvec(sop, jnp.asarray(x)))
    y_d = _dense(cols, vals, valid, r, nc) @ x
    np.testing.assert_allclose(y_s, y_d, atol=1e-5 * np.abs(y_d).max())


def test_window_counts_aligned_cover(rng):
    """Aligned greedy counts: every valid column is covered by the
    windows the count implies (the slab converter's invariant)."""
    cols, vals, valid = _tailed_ell(rng, r=256, k=6, nc=512)
    counts, first, ovf = window_counts(jnp.asarray(cols),
                                       jnp.asarray(valid), 8, 128,
                                       align=128)
    assert not bool(ovf)
    counts = np.asarray(counts)
    # Re-run the aligned greedy in NumPy and compare.
    for b in range(32):
        cb = np.sort(cols[b * 8:(b + 1) * 8][valid[b * 8:(b + 1) * 8]])
        n = 0
        i = 0
        while i < len(cb):
            s = (cb[i] // 128) * 128
            i = np.searchsorted(cb, s + 128)
            n += 1
        assert counts[b] == n, b


def test_slab_vcycle_matches_plain(rng):
    """A slab-attached hierarchy produces the same V-cycle (up to f32
    add order) and converges under FCG."""
    from gravomg_tpu.geometry.meshes import torus_points
    from gravomg_tpu.geometry.order import morton_order
    from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                              check_diagnostics,
                                              compact_solver)
    pts = torus_points(4000, seed=2).astype(np.float32)
    pts = jnp.asarray(pts[morton_order(pts)])
    graph = g.knn_graph(pts, k=12)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=200, smoother="chebyshev")
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    hc = compact_solver(h.solver, diags, row_multiple=64)
    b = jnp.asarray(np.random.default_rng(0).normal(size=4000),
                    jnp.float32)
    x0 = g.v_cycle(hc, jnp.zeros_like(b), b, cfg)
    sol = g.attach_slab_operators(hc, block=8, window=128, min_rows=512)
    sol = g.attach_fast_operators(sol, block=64, window=128)
    assert any(lvl.banded is not None and hasattr(lvl.banded, "buckets")
               for lvl in sol.levels)
    x1 = g.v_cycle(sol, jnp.zeros_like(b), b, cfg)
    rel = float(jnp.linalg.norm(x1 - x0) / jnp.linalg.norm(x0))
    assert rel < 2e-5, rel
    _, r2, it = g.mg_fcg(sol, b, cfg)
    assert float(r2) < cfg.tolerance
    assert int(it) < 25
