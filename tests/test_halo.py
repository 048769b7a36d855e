"""Halo-decomposed sharded SpMV + solve (parallel/halo.py).

The sharded matvec must move O(edge-cut) halo
segments per device instead of all-gathering the full vector.  Asserts
(a) exactness of every halo matvec against the unsharded forms,
(b) a converged halo-sharded MG-PCG solve, and (c) the communication
bound -- statically from the exchange plan AND from the compiled HLO
(all-to-all present, no full-vector all-gather on the fine level).
Runs on the 8-virtual-device CPU mesh (conftest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gravomg_tpu as g
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.parallel.sharding import make_mesh, pad_solver_levels
from gravomg_tpu.parallel.halo import (build_halo_ell, halo_matvec,
                                       halo_shard_solver, halo_solve,
                                       halo_v_cycle)
from gravomg_tpu.prolong.operator import prolong, restrict_gather
from gravomg_tpu.solve.spmv import spmv

ND = 8


@pytest.fixture(scope="module")
def setup():
    n = 6000
    pts = torus_points(n, seed=3).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 14, margin=2.4)
    assert not bool(short)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=400, smoother="chebyshev")
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    hs = compact_solver(h.solver, diags)
    hp = pad_solver_levels(hs, ND, pad_coarse=True)
    mesh = make_mesh(ND)
    hh = halo_shard_solver(hp, mesh)
    b = jnp.asarray(np.random.default_rng(0).normal(size=n), jnp.float32)
    return hs, hp, hh, mesh, b, cfg


def test_halo_matvec_exact_all_levels(setup):
    """Every level's halo op/U/U^T matvec matches the unsharded form."""
    hs, hp, hh, mesh, b, cfg = setup
    rng = np.random.default_rng(1)
    for lvl, hl in zip(hp.levels, hh.levels):
        v = lvl.op.num_vertices
        x = jnp.asarray(rng.normal(size=v), jnp.float32)
        want = spmv(lvl.op, x)
        got = halo_matvec(hl.op, x, mesh, "data")
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-5)
        if lvl.u is not None:
            e = jnp.asarray(rng.normal(size=lvl.u.n_coarse), jnp.float32)
            np.testing.assert_allclose(
                np.asarray(halo_matvec(hl.u, e, mesh, "data")),
                np.asarray(prolong(lvl.u, e)), rtol=0, atol=1e-5)
        if lvl.ut is not None:
            r = jnp.asarray(rng.normal(size=lvl.ut.n_fine), jnp.float32)
            np.testing.assert_allclose(
                np.asarray(halo_matvec(hl.ut, r, mesh, "data")),
                np.asarray(restrict_gather(lvl.ut, r)), rtol=0, atol=1e-5)


def test_halo_exchange_is_small(setup):
    """The static exchange plan moves far less than the full vector:
    per device and per matvec, nd*S elements vs n_src for all-gather."""
    hs, hp, hh, mesh, b, cfg = setup
    frac0 = hh.levels[0].op.halo_frac
    assert frac0 < 0.25, f"fine-level halo fraction {frac0:.3f}"
    # Spatial (Morton) ordering keeps large levels' cuts small; tiny
    # coarse levels (~128 rows/device here) have no surface/volume
    # separation to exploit, so only bound them by the all-gather cost
    # they replace.  The scaling claim is about the levels that matter:
    # the fine level carries ~all the per-cycle traffic.
    for hl in hh.levels[:-1]:
        if hl.op.n_src >= 4096:
            assert hl.op.halo_frac < 0.5, hl.op.halo_frac
        else:
            assert hl.op.halo_frac <= 1.25, hl.op.halo_frac


def test_halo_hlo_has_no_full_allgather(setup):
    """The compiled fine-level matvec exchanges halo segments
    (all-to-all) and never all-gathers the full source vector."""
    hs, hp, hh, mesh, b, cfg = setup
    op = hh.levels[0].op
    vp = op.n_src
    x = jax.device_put(jnp.zeros((vp,), jnp.float32),
                       jax.sharding.NamedSharding(
                           mesh, jax.sharding.PartitionSpec("data")))
    fn = jax.jit(lambda o, y: halo_matvec(o, y, mesh, "data"))
    txt = fn.lower(op, x).compile().as_text()
    assert "all-to-all" in txt
    for line in txt.splitlines():
        if "all-gather" in line and f"f32[{vp}]" in line:
            raise AssertionError(f"full-vector all-gather: {line}")


def test_halo_vcycle_matches_unsharded(setup):
    hs, hp, hh, mesh, b, cfg = setup
    n = b.shape[0]
    vp = hh.levels[0].op.n_rows
    bp = jnp.zeros((vp,), b.dtype).at[:n].set(b)
    x_ref = g.v_cycle(hs, jnp.zeros_like(b), b, cfg)
    x = halo_v_cycle(hh, jnp.zeros_like(bp), bp, cfg, mesh)
    scale = float(jnp.max(jnp.abs(x_ref)))
    np.testing.assert_allclose(np.asarray(x[:n]), np.asarray(x_ref),
                               atol=2e-5 * scale)
    assert not np.any(np.asarray(x[n:]))


def test_halo_solve_converges(setup):
    hs, hp, hh, mesh, b, cfg = setup
    x, rel, it = halo_solve(hh, b, cfg, mesh)
    assert float(rel) < cfg.tolerance
    assert int(it) < 40
    x_ref, rel_ref, it_ref = g.mg_pcg(hs, b, cfg)
    assert abs(int(it) - int(it_ref)) <= 2
    scale = float(jnp.max(jnp.abs(x_ref)))
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               atol=1e-4 * scale)


def test_build_halo_ell_rejects_misaligned():
    cols = np.zeros((10, 2), np.int32)
    vals = np.ones((10, 2), np.float32)
    with pytest.raises(ValueError):
        build_halo_ell(cols, vals, np.ones_like(cols, bool), 16, 8)


def test_halo_matvec_multi_rhs(setup):
    """The halo exchange also carries (V, D) blocks (the spectral /
    batched-RHS pattern): matches the unsharded multi-RHS SpMV."""
    hs, hp, hh, mesh, b, cfg = setup
    lvl, hl = hp.levels[0], hh.levels[0]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(lvl.op.num_vertices, 3)),
                    jnp.float32)
    want = spmv(lvl.op, x)
    got = halo_matvec(hl.op, x, mesh, "data")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-5)


def test_halo_frac_shrinks_at_scale():
    """The O(edge-cut) claim at a scale where it bites: exchange plans
    built by the same build_halo_ell the solver uses, over a 50k
    exact-greedy hierarchy (csrc + SciPy, no device build -- the plan
    is a pure function of the column tables).  Committed evidence at
    200k/1M: HALO_200K.json / HALO_1M.json (level-0 A halo_frac 0.033 /
    0.014, scripts/halo_evidence.py)."""
    import gravomg_tpu.io.native as native
    if not native.available():
        pytest.skip("csrc native library unavailable")
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    from halo_evidence import main as halo_main
    rep = halo_main(50_000, ND)
    l0 = rep["levels"][0]
    # Measured 0.069 / 0.103 / 0.060 at 50k (2026-08-20); margin for
    # generator drift.
    assert l0["A"]["halo_frac"] < 0.12, l0
    assert l0["U"]["halo_frac"] < 0.18, l0
    assert l0["Ut"]["halo_frac"] < 0.12, l0
    # Monotone shrink vs the 6k in-solver bound (0.25 pinned above).
    assert l0["A"]["halo_frac"] < 0.25 / 2
