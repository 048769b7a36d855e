"""Full vertex-sharded MG-PCG solve on the 8-virtual-device mesh.

Every level's rows sharded (not just the finest),
and a converged solve to 1e-8 -- not a single step.  Runs on the CPU
backend with --xla_force_host_platform_device_count=8 (conftest).
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
from gravomg_tpu.parallel.sharding import (make_mesh, pad_solver_levels,
                                           shard_solver, sharded_solve)


@pytest.fixture(scope="module")
def solver():
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
    b = jnp.asarray(np.random.default_rng(0).normal(size=n), jnp.float32)
    return hs, b, cfg


def test_pad_solver_levels_preserves_solution(solver):
    hs, b, cfg = solver
    hp = pad_solver_levels(hs, 8)
    for li, lvl in enumerate(hp.levels[:-1]):
        assert lvl.op.num_vertices % 8 == 0
        if lvl.u is not None:
            assert lvl.u.n_coarse == hp.levels[li + 1].op.num_vertices
            assert lvl.u.cols.shape[0] == lvl.op.num_vertices
        if lvl.ut is not None:
            assert lvl.ut.rows.shape[0] \
                == hp.levels[li + 1].op.num_vertices
            assert lvl.ut.n_fine == lvl.op.num_vertices
    # Coarsest untouched (its Cholesky factor must stay valid).
    assert (hp.levels[-1].op.num_vertices
            == hs.levels[-1].op.num_vertices)

    n = b.shape[0]
    vp = hp.levels[0].op.num_vertices
    bp = jnp.zeros((vp,), b.dtype).at[:n].set(b)
    x_ref = g.v_cycle(hs, jnp.zeros_like(b), b, cfg)
    x_pad = g.v_cycle(hp, jnp.zeros_like(bp), bp, cfg)
    # Padded rows are decoupled: real rows bit-match, pad rows stay 0.
    np.testing.assert_array_equal(np.asarray(x_pad[:n]),
                                  np.asarray(x_ref))
    assert not np.any(np.asarray(x_pad[n:]))


def test_sharded_solve_converges(solver):
    hs, b, cfg = solver
    nd = len(jax.devices())
    assert nd >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(8)
    hp = shard_solver(pad_solver_levels(hs, 8), mesh)

    # Every non-coarsest level's row arrays really are sharded.
    for lvl in hp.levels[:-1]:
        spec = lvl.op.diag.sharding.spec
        assert spec and spec[0] == "data", spec

    x, rel, it = sharded_solve(hp, b, cfg, mesh)
    assert float(rel) < cfg.tolerance
    assert int(it) < 40

    # Matches the unsharded solve's convergence (same preconditioner).
    x_ref, rel_ref, it_ref = g.mg_pcg(hs, b, cfg)
    assert abs(int(it) - int(it_ref)) <= 2
    scale = float(jnp.max(jnp.abs(x_ref)))
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               atol=1e-5 * scale)


def test_sharded_fcg_converges(solver):
    hs, b, cfg = solver
    mesh = make_mesh(8)
    hp = shard_solver(pad_solver_levels(hs, 8), mesh)
    x, rel, it = sharded_solve(hp, b, cfg, mesh, method="mg_fcg")
    assert float(rel) < cfg.tolerance
    assert int(it) < 40


def test_sharded_fast_operators_solve(solver):
    """Fast (block-dense) forms attached AFTER padding with mesh-aligned
    blocks shard their window matrix M over the row-block axis; the
    sharded fast solve converges and matches the sharded ELL solve."""
    hs, b, cfg = solver
    mesh = make_mesh(8)
    hp = pad_solver_levels(hs, 8)
    v0 = hp.levels[0].op.num_vertices
    hf = g.attach_fast_operators(hp, block=v0 // 8)
    hf = shard_solver(hf, mesh)

    # The fine level's M really is sharded over the mesh axis.
    bop = hf.levels[0].banded
    assert bop is not None and bop.m.shape[0] % 8 == 0
    spec = bop.m.sharding.spec
    assert spec and spec[0] == "data", spec

    x, rel, it = sharded_solve(hf, b, cfg, mesh)
    assert float(rel) < cfg.tolerance

    hp_ell = shard_solver(hp, mesh)
    x_ref, rel_ref, it_ref = sharded_solve(hp_ell, b, cfg, mesh)
    assert abs(int(it) - int(it_ref)) <= 2
    # Different f32 preconditioners (fast vs ELL add order) satisfy the
    # same 1e-8 residual at solutions separated by up to cond(A)*tol;
    # measured ~1.4e-4 relative here.
    scale = float(jnp.max(jnp.abs(x_ref)))
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               atol=1e-3 * scale)
