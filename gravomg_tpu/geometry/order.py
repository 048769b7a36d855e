"""Vertex reordering for memory locality (Morton / Z-order).

ELL SpMV gathers x[neighbors]; after Morton-ordering the vertices,
neighbors lie nearby in memory, which improves gather locality and
shrinks the working set per row block.  A pure host-side
renumbering: applied once at graph construction, transparent to all
downstream semantics except vertex numbering (the compat oracle must be
fed the same ordering).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from gravomg_tpu.types import Graph, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits (for 3-D Morton)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """Permutation sorting points along a 3-D Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    scale = (2**bits - 1) / np.maximum(hi - lo, 1e-30)
    q = ((p - lo) * scale).astype(np.uint64)
    code = (_spread_bits(q[:, 0]) << np.uint64(2)) \
        | (_spread_bits(q[:, 1]) << np.uint64(1)) | _spread_bits(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def permute_graph(graph: Graph, perm: np.ndarray) -> Graph:
    """Renumber a graph: new vertex i = old vertex perm[i].

    Rows are re-sorted ascending by (new) neighbor index to preserve the
    Eigen inner-iterator ordering contract.
    """
    v, k = graph.neighbors.shape
    inv = np.empty(v, np.int32)
    inv[perm] = np.arange(v, dtype=np.int32)
    inv_j = jnp.asarray(inv)
    perm_j = jnp.asarray(perm)

    old_nbr = graph.neighbors[perm_j]            # rows in new order
    mask = old_nbr != INVALID_INDEX
    new_nbr = jnp.where(mask, inv_j[jnp.where(mask, old_nbr, 0)],
                        INVALID_INDEX)
    rows = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[:, None],
                            (v, k)).reshape(-1)
    res = build_ell_rows(rows, new_nbr.reshape(-1), mask.reshape(-1), v, k)
    new_points = graph.points[perm_j]
    m2 = res.columns != INVALID_INDEX
    safe = jnp.where(m2, res.columns, 0)
    dist = jnp.linalg.norm(new_points[:, None, :] - new_points[safe],
                           axis=-1)
    dist = jnp.where(m2, dist.astype(new_points.dtype), jnp.inf)
    return Graph(neighbors=res.columns, distances=dist, points=new_points)


def bandwidth(graph: Graph) -> int:
    """Max |i - j| over edges — the locality figure of merit."""
    nbr = np.asarray(graph.neighbors)
    mask = nbr != INVALID_INDEX
    rows = np.broadcast_to(np.arange(nbr.shape[0])[:, None], nbr.shape)
    return int(np.abs(np.where(mask, nbr, rows) - rows).max())
