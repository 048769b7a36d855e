"""Symmetric kNN graph construction.

The reference outsources graph construction to an external robust
point-cloud Laplacian library (`test/main.cpp:68`,
`test/CMakeLists.txt:35-40`); the library itself only consumes the
resulting sparse "edge matrix" (SURVEY.md §0).  This package provides
graph construction natively: a blocked brute-force top-k with a
running-top-k merge so memory stays O(B * tile), then a sort-based
symmetrization into the padded ELL :class:`~gravomg_tpu.types.Graph`
layout.

Squared distances are summed from coordinate differences, as in the grid
kNN (geometry/gridknn.py), not from the ||x||^2 + ||y||^2 - 2<x,y>
expansion: the expansion cancels to ~1e-7 * ||x||^2 absolute error,
which flips near-ties of the k-th neighbour (4 rows of 20k torus points
differed from exact f64 neighbours at relative gaps up to 9e-5, even in
full f32), and its matmul is one TF32 may round.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(jax.jit, static_argnames=("k", "block", "tile"))
def knn_indices(points: jax.Array, k: int, block: int = 1024,
                tile: int = 8192) -> jax.Array:
    """Indices of the k nearest neighbors of every point (self excluded).

    Returns (V, k) int32, each row sorted by ascending distance.
    """
    v = points.shape[0]
    p32 = points.astype(jnp.float32)
    vpad = _round_up(v, block)
    qpad = jnp.pad(p32, ((0, vpad - v), (0, 0)))
    tpad = _round_up(v, tile)
    cols = jnp.pad(p32, ((0, tpad - v), (0, 0)))
    n_tiles = tpad // tile

    def per_block(qblock_idx):
        q = jax.lax.dynamic_slice(qpad, (qblock_idx * block, 0), (block, 3))
        q_ids = qblock_idx * block + jnp.arange(block, dtype=jnp.int32)

        def scan_tile(carry, t):
            best_d, best_i = carry
            c = jax.lax.dynamic_slice(cols, (t * tile, 0), (tile, 3))
            ids = (t * tile + jnp.arange(tile)).astype(jnp.int32)
            d2 = jnp.sum((q[:, None, :] - c[None, :, :]) ** 2, axis=-1)
            # Mask padding columns and the self column.
            bad = (ids[None, :] >= v) | (ids[None, :] == q_ids[:, None])
            d2 = jnp.where(bad, jnp.inf, d2)
            cand_d = jnp.concatenate([best_d, d2], axis=1)
            cand_i = jnp.concatenate(
                [best_i, jnp.broadcast_to(ids[None, :], d2.shape)], axis=1)
            neg_top, pos = jax.lax.top_k(-cand_d, k)
            return (-neg_top, jnp.take_along_axis(cand_i, pos, axis=1)), None

        init = (jnp.full((block, k), jnp.inf, jnp.float32),
                jnp.full((block, k), INVALID_INDEX, jnp.int32))
        (best_d, best_i), _ = jax.lax.scan(
            scan_tile, init, jnp.arange(n_tiles))
        return best_i

    idx = jax.lax.map(per_block, jnp.arange(vpad // block))
    return idx.reshape(vpad, k)[:v]


def knn_graph(points: jax.Array, k: int, max_degree: int | None = None,
              block: int = 1024, tile: int = 8192) -> Graph:
    """Build a symmetrized kNN graph with Euclidean edge lengths.

    The union-symmetrization (an edge exists if either endpoint selected
    the other) mirrors the symmetric edge matrix the reference consumes
    (`include/gravomg/utility.h:15`).  Distances are recomputed exactly as
    ``||p_i - p_j||`` from positions -- the reference's convention
    everywhere it matters (`src/utility.cpp:53`, `src/multigrid.cpp:107`).
    Rows are sorted ascending by neighbor index (Eigen CSC inner order).

    Args:
      max_degree: K of the output ELL table; defaults to 2k.  A row's
        union degree is its k out-links plus its (unbounded) in-degree,
        so hub vertices can exceed any fixed K; on overflow the table is
        rebuilt with a doubled K (staged doubling, as in
        hierarchy.build_hierarchy) until every edge fits.
    """
    v = points.shape[0]
    if max_degree is None:
        max_degree = 2 * k
    idx = knn_indices(points, k, block=block, tile=tile)
    rows = jnp.repeat(jnp.arange(v, dtype=jnp.int32), k)
    cols = idx.reshape(-1)
    valid = cols != INVALID_INDEX
    # Both directions -> union symmetrization with dedup.
    all_rows = jnp.concatenate([rows, jnp.where(valid, cols, 0)])
    all_cols = jnp.concatenate([cols, jnp.where(valid, rows, 0)])
    all_valid = jnp.concatenate([valid, valid])
    res = build_ell_rows(all_rows, all_cols, all_valid, v, max_degree)
    while bool(res.overflow) and max_degree < v - 1:
        max_degree = min(2 * max_degree, v - 1)
        res = build_ell_rows(all_rows, all_cols, all_valid, v, max_degree)
    if bool(res.overflow):
        raise ValueError("knn_graph: symmetrized degree exceeds V-1")
    mask = res.columns != INVALID_INDEX
    safe = jnp.where(mask, res.columns, 0)
    dist = jnp.linalg.norm(points[:, None, :] - points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(points.dtype), jnp.inf)
    return Graph(neighbors=res.columns, distances=dist, points=points)


def graph_from_edges(points: jax.Array, edges: jax.Array,
                     max_degree: int) -> Graph:
    """Build a Graph from an explicit undirected (E, 2) edge list.

    Used for triangle meshes (edges from faces) and tests.  Self loops are
    dropped (the reference's explicit zero diagonals are a quirk we
    deliberately do not carry, `src/utility.cpp:50-56`, SURVEY.md §2.2).
    """
    v = points.shape[0]
    e0 = edges[:, 0].astype(jnp.int32)
    e1 = edges[:, 1].astype(jnp.int32)
    valid = e0 != e1
    all_rows = jnp.concatenate([e0, e1])
    all_cols = jnp.concatenate([e1, e0])
    all_valid = jnp.concatenate([valid, valid])
    res = build_ell_rows(all_rows, all_cols, all_valid, v, max_degree)
    if bool(res.overflow):
        raise ValueError(
            f"graph_from_edges: some vertex degree exceeds max_degree="
            f"{max_degree}; pass a larger max_degree")
    mask = res.columns != INVALID_INDEX
    safe = jnp.where(mask, res.columns, 0)
    dist = jnp.linalg.norm(points[:, None, :] - points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(points.dtype), jnp.inf)
    return Graph(neighbors=res.columns, distances=dist, points=points)
