"""Geodesic distance via the heat method (BASELINE config 3).

Two successive linear solves on a reused hierarchy (the pattern the
armadillo config exercises):
  1. heat step:      (M + t L) u = delta_source
  2. Poisson step:   L phi = div(X), X = -normalized graph gradient of u

Graph-native formulation (the library operates on kNN/ELL graphs, not
FEM meshes): the gradient lives on directed edges,
g_ij = (u_j - u_i)/d_ij; X normalizes g per edge; divergence at i sums
w_ij * X_ij over incident edges.  phi is shifted to phi[source] = 0.
Both solves reuse one multigrid hierarchy -- rebuilding operators only,
never re-coarsening.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.types import EllOperator, Graph
from gravomg_tpu.geometry.laplacian import graph_laplacian
from gravomg_tpu.hierarchy import Hierarchy
from gravomg_tpu.solve.rap import galerkin_rap
from gravomg_tpu.solve.coarse import factor_coarse
from gravomg_tpu.solve.vcycle import SolverHierarchy, SolverLevel
from gravomg_tpu.solve.smoothers import ChebyshevParams


def refit_hierarchy(h, new_fine_op: EllOperator,
                    cfg: MultigridConfig) -> SolverHierarchy:
    """Re-Galerkin an existing hierarchy for a new fine operator
    (hierarchy reuse: coarsening, parents, U all unchanged).

    ``h`` is a :class:`SolverHierarchy` (preferred -- pass the
    COMPACTED solver so the RAP chain runs on tight shapes and the
    multi-GB uncompacted build hierarchy need not stay resident; at
    170k keeping both ran a 16 GB device out of memory) or
    a full :class:`Hierarchy` (its solver stack is used).
    """
    hs = h.solver if isinstance(h, Hierarchy) else h
    ops = [new_fine_op]
    us = [lvl.u for lvl in hs.levels if lvl.u is not None]
    for li, u in enumerate(us):
        # The previous coarse operator's degree is only a starting guess:
        # a new fine operator with different sparsity can need wider
        # Galerkin rows, so retry with staged doubling on overflow
        # (mirrors build_hierarchy's loop) instead of silently dropping
        # entries.
        kc2 = hs.levels[li + 1].op.max_degree
        coarse_op, ovf = galerkin_rap(ops[-1], u, kc2)
        while bool(ovf) and kc2 < u.n_coarse:
            kc2 = min(2 * kc2, u.n_coarse)
            coarse_op, ovf = galerkin_rap(ops[-1], u, kc2)
        ops.append(coarse_op)
    levels = []
    for i, o in enumerate(ops):
        u = us[i] if i < len(us) else None
        # U (hence U^T) is unchanged by a refit; reuse the gather tables
        # AND their fast (block-dense/slab) forms -- only the operator
        # values changed, so `banded` is dropped but uw/utw stay valid.
        ut = hs.levels[i].ut if i < len(hs.levels) else None
        uw = hs.levels[i].uw if i < len(hs.levels) else None
        utw = hs.levels[i].utw if i < len(hs.levels) else None
        cheb = (ChebyshevParams.from_operator(o, cfg.chebyshev_ratio)
                if cfg.smoother == "chebyshev" else None)
        levels.append(SolverLevel(op=o, u=u, cheb=cheb, ut=ut,
                                  uw=uw, utw=utw))
    return SolverHierarchy(levels=tuple(levels),
                           coarse_chol=factor_coarse(ops[-1]))


def heat_geodesics(graph: Graph, h, source: int,
                   t_factor: float = 1.0,
                   cfg: MultigridConfig = MultigridConfig()) -> jax.Array:
    """Approximate geodesic distance from ``source`` to all vertices.

    ``h``: a SolverHierarchy (pass the compacted solver) or a full
    Hierarchy -- see :func:`refit_hierarchy`."""
    lap, mass = graph_laplacian(graph, "invdist")
    mean_edge = jnp.sum(jnp.where(graph.mask, graph.distances, 0.0)) \
        / jnp.sum(graph.mask)
    t = t_factor * mean_edge ** 2

    # Step 1: heat diffusion (M + t L) u = delta.
    heat_op = lap._replace(diag=lap.diag * t + mass,
                           offdiag=lap.offdiag * t)
    sh = refit_hierarchy(h, heat_op, cfg)
    delta = jnp.zeros(graph.num_vertices, graph.points.dtype)
    delta = delta.at[source].set(1.0)
    # MG-PCG, not the stationary solve: f32 stationary cycles stall at
    # ~4e-5 relative residual, so a 1e-8 tolerance exhausts max_cycles
    # inside ONE while_loop launch.  PCG exits in ~10 iterations.
    from gravomg_tpu.solve.cg import mg_pcg
    u, _, _ = mg_pcg(sh, mass * delta, cfg)

    # Step 2: normalized-gradient divergence and Poisson solve.
    mask = graph.mask
    safe = graph.safe_neighbors()
    d = jnp.where(mask, graph.distances, jnp.inf)
    grad = (u[safe] - u[:, None]) / d                 # (V, K) edge gradient
    xdir = -jnp.sign(grad)                            # unit edge field
    w = jnp.where(mask, 1.0 / jnp.maximum(d, 1e-8), 0.0)
    div = jnp.sum(w * xdir, axis=1)
    # Shifted SPD Poisson solve (L is singular on constants).  The
    # shift uses the same f32-representability floor as
    # screened_poisson_operator(alpha="auto"): a FIXED eps*mass falls
    # below f32 resolution of the ~1/h invdist diagonal as the mesh
    # densifies (measured: 1e-6*mass at 170k -> indefinite RAP chain,
    # PCG NaN), while 1e-4 of the mean diagonal
    # stays ~1e2 above f32 RAP noise at every level.
    eps = 1e-4 * jnp.mean(lap.diag) / jnp.mean(mass)
    pois_op = lap._replace(diag=lap.diag + eps * mass)
    ph = refit_hierarchy(h, pois_op, cfg)
    phi, _, _ = mg_pcg(ph, div - jnp.mean(div), cfg)
    phi = phi[source] - phi          # orient increasing away from source
    # Calibrate to unit speed: rescale so the mean |edge gradient| is 1
    # (the graph Laplacian's weighting skews the raw scale).
    gphi = jnp.abs(phi[safe] - phi[:, None]) / d
    mean_grad = (jnp.sum(jnp.where(mask, gphi, 0.0))
                 / jnp.maximum(jnp.sum(mask), 1))
    return phi / jnp.maximum(mean_grad, 1e-12)
