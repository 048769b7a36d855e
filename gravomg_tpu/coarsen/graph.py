"""Coarse-graph extraction from the fine graph + parent partition.

Reference C7 ``extractCoarseEdges`` (`src/multigrid.cpp:135-169`): every
fine edge whose endpoints have different parents induces a coarse edge
between those parents.  The reference's stored edge *weights* use a buggy
formula (`fine_edge_matrix.coeff(fine, parent)` indexes the fine matrix
by a coarse index, `src/multigrid.cpp:151`; SURVEY.md §2.1-C7 quirk 1)
and are never read downstream -- only the sparsity *pattern* matters
(`src/multigrid.cpp:237` tests existence; C12 uses pattern + positions).
We therefore build the exact same pattern with a one-shot sort/scatter
(replacing the O(nnz)-per-insert ``coeffRef`` hot spot, quirk 2) and
store clean Euclidean coarse-point distances as the values.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows


@functools.partial(jax.jit, static_argnames=("n_coarse", "max_degree"))
def extract_coarse_edges(graph: Graph, parents: jax.Array, n_coarse: int,
                         max_degree: int,
                         fine_valid=None) -> Tuple[jax.Array, jax.Array]:
    """Build the coarse adjacency pattern.

    ``fine_valid``: optional (V,) bool marking real (non-phantom) fine
    vertices; phantom rows contribute no coarse edges (their parents are
    unset garbage in the fully-device-resident build).

    Returns:
      (columns (n_coarse, max_degree) int32 ascending with INVALID_INDEX
       padding, overflow () bool).
    """
    v, k = graph.neighbors.shape
    rows = jnp.broadcast_to(parents[:, None], (v, k))
    cols = parents[graph.safe_neighbors()]
    valid = graph.mask & (rows != cols)
    if fine_valid is not None:
        valid &= fine_valid[:, None]
    res = build_ell_rows(rows.reshape(-1), cols.reshape(-1),
                         valid.reshape(-1), n_coarse, max_degree)
    return res.columns, res.overflow


@jax.jit
def coarse_graph(columns: jax.Array, coarse_points: jax.Array) -> Graph:
    """Assemble a Graph for the coarse level with Euclidean distances."""
    mask = columns != INVALID_INDEX
    safe = jnp.where(mask, columns, 0)
    dist = jnp.linalg.norm(
        coarse_points[:, None, :] - coarse_points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(coarse_points.dtype), jnp.inf)
    return Graph(neighbors=columns, distances=dist, points=coarse_points)


@functools.partial(jax.jit, static_argnames=("n_coarse", "max_degree",
                                             "max_children"))
def _ece_local(graph: Graph, parents: jax.Array, fine_valid: jax.Array,
               n_coarse: int, max_degree: int, max_children: int):
    from gravomg_tpu.ops.segment import group_ordered
    from gravomg_tpu.solve.rap2 import lane_merge

    v, k = graph.neighbors.shape
    ids = jnp.arange(v, dtype=jnp.int32)
    table, _, t_ovf = group_ordered(parents.astype(jnp.int32), ids,
                                    fine_valid, n_coarse, max_children)
    # Parents of each fine vertex's neighbors, invalid slots masked, so
    # one row gather per child slot suffices below.
    pn = jnp.where(graph.mask, parents[graph.safe_neighbors()],
                   INVALID_INDEX)
    tmask = table != INVALID_INDEX
    safe = jnp.where(tmask, table, 0)
    row_p = jnp.arange(n_coarse, dtype=jnp.int32)[:, None]
    # Child slots are consumed in groups and lane-merged into a running
    # (max_degree) accumulator: the one-shot (nc, mc*K) candidate
    # matrix was (423808, 1216) at 1M -- multi-GB sort transients that
    # pushed the full build over device memory (RESOURCE_EXHAUSTED on a
    # 16 GB device); grouped, the
    # widest sort is max_degree + ~256 lanes.  Distinct-count is
    # monotone, so per-step overflow == final overflow.
    gsz = max(1, 256 // k)
    acc = None
    m_ovf = jnp.bool_(False)
    for g0 in range(0, max_children, gsz):
        cand_l = [] if acc is None else [acc]
        for j in range(g0, min(g0 + gsz, max_children)):
            cj = pn[safe[:, j]]                            # (nc, K)
            cj = jnp.where(tmask[:, j][:, None] & (cj != row_p), cj,
                           INVALID_INDEX)
            cand_l.append(cj)
        cand = jnp.concatenate(cand_l, axis=1)
        acc, _, o = lane_merge(cand, jnp.zeros(cand.shape, jnp.float32),
                               max_degree)
        m_ovf = m_ovf | o
    return acc, t_ovf, m_ovf


def extract_coarse_edges_local(graph: Graph, parents: jax.Array,
                               n_coarse: int, max_degree: int,
                               fine_valid=None, max_children: int = 0,
                               sync_retry: bool = True
                               ) -> Tuple[jax.Array, jax.Array]:
    """Sort-local variant of :func:`extract_coarse_edges`.

    Groups fine vertices by parent (a V-element sort instead of the
    V*K-element global sort) and lane-merges each coarse row's
    candidate neighbor-parents (``max_children * K`` wide; see
    solve/rap2.py for the merge).  Identical pattern contract; the
    children cap doubles on overflow (data-dependent cell sizes).

    ``sync_retry=False`` runs one pass at the given/default cap and
    defers the overflow flag (no host sync; safe in the zero-D2H
    builder and under an enclosing ``jit``).
    """
    v, _ = graph.neighbors.shape
    if fine_valid is None:
        fine_valid = jnp.ones((v,), bool)
    # n_coarse is the PADDED cap (~2x the real count in the builder's
    # steady-slack level plan), so v/n_coarse underestimates real cell
    # sizes; hub cells run ~3.5x the mean.  12x headroom covers both
    # factors (2.06 * 3.5 = 7.2 measured at 1M) with ~1.7x margin;
    # overflow doubles the cap and retries (or flags, sync_retry=False).
    mc = (max_children if max_children > 0
          else min(max(16, -(-12 * v // max(n_coarse, 1))), v))
    if not sync_retry:
        cols, t_ovf, m_ovf = _ece_local(graph, parents, fine_valid,
                                        n_coarse, max_degree, mc)
        return cols, t_ovf | m_ovf
    for _ in range(4):
        cols, t_ovf, m_ovf = _ece_local(graph, parents, fine_valid,
                                        n_coarse, max_degree, mc)
        if not bool(t_ovf):
            # A merge overflow means the coarse row genuinely exceeds
            # max_degree -- the caller's cap decision, same contract as
            # the baseline's returned overflow flag.
            return cols, m_ovf
        mc *= 2
    return cols, t_ovf | m_ovf
