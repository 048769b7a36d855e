"""Laplacian operators in padded ELL form.

The reference obtains its stiffness/mass matrices from an external
point-cloud Laplacian library (`test/main.cpp:68`) and only consumes
their sparsity as a distance graph (C2 `toEdgeDistanceMatrix`,
`src/utility.cpp:50-56`).  The solver half of the build (SURVEY.md CS-5,
BASELINE.json) needs the operators themselves, so this package provides
them natively: a weighted graph Laplacian for point clouds and a cotan
Laplacian for triangle meshes, both emitted as
:class:`~gravomg_tpu.types.EllOperator` (fixed-shape, mask-padded).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.types import EllOperator, Graph, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows


def graph_laplacian(graph: Graph, weighting: str = "invdist",
                    sigma: float | None = None) -> Tuple[EllOperator, jax.Array]:
    """Weighted graph Laplacian L = D - W plus a lumped mass vector.

    Weight choices:
      * "uniform":  w_ij = 1
      * "invdist":  w_ij = 1 / max(d_ij, 1e-8)   (the reference's distance
        clamp constant, `src/multigrid.cpp:68`)
      * "gaussian": w_ij = exp(-d_ij^2 / sigma^2), sigma defaults to the
        mean edge length.

    Returns (L, mass) where mass is a simple lumped vertex mass
    (mean squared neighbor distance, a local-area proxy for point clouds).
    """
    mask = graph.mask
    d = jnp.where(mask, graph.distances, 0.0)
    if weighting == "uniform":
        w = jnp.where(mask, 1.0, 0.0)
    elif weighting == "invdist":
        w = jnp.where(mask, 1.0 / jnp.maximum(d, 1e-8), 0.0)
    elif weighting == "gaussian":
        if sigma is None:
            sigma = jnp.sum(d) / jnp.maximum(jnp.sum(mask), 1)
        w = jnp.where(mask, jnp.exp(-(d * d) / (sigma * sigma)), 0.0)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    diag = jnp.sum(w, axis=1)
    lap = EllOperator(neighbors=graph.neighbors, offdiag=-w, diag=diag)
    deg = jnp.maximum(jnp.sum(mask, axis=1), 1)
    mass = jnp.sum(d * d, axis=1) / deg
    mass = jnp.maximum(mass, 1e-12)
    return lap, mass


def cotan_laplacian(points: jax.Array, faces: jax.Array,
                    max_degree: int) -> Tuple[EllOperator, jax.Array]:
    """Cotan-weighted Laplacian and barycentric lumped mass of a mesh.

    Standard FEM stiffness matrix: L_ij = -(cot a + cot b)/2 over the one
    or two triangles incident to edge (i, j); diagonal = -sum of the row.
    Mass_i = sum of incident triangle areas / 3.
    """
    v = points.shape[0]
    f = faces.astype(jnp.int32)
    p0, p1, p2 = points[f[:, 0]], points[f[:, 1]], points[f[:, 2]]

    def cot(a, b):
        # cot of angle between vectors a, b
        cross = jnp.linalg.norm(jnp.cross(a, b), axis=-1)
        return jnp.sum(a * b, axis=-1) / jnp.maximum(cross, 1e-12)

    # Angle at vertex k is opposite edge (i, j).
    cot0 = cot(p1 - p0, p2 - p0)   # opposite edge (1, 2)
    cot1 = cot(p0 - p1, p2 - p1)   # opposite edge (0, 2)
    cot2 = cot(p0 - p2, p1 - p2)   # opposite edge (0, 1)

    rows = jnp.concatenate([f[:, 1], f[:, 2], f[:, 0], f[:, 2],
                            f[:, 0], f[:, 1]])
    cols = jnp.concatenate([f[:, 2], f[:, 1], f[:, 2], f[:, 0],
                            f[:, 1], f[:, 0]])
    w = 0.5 * jnp.concatenate([cot0, cot0, cot1, cot1, cot2, cot2])
    valid = jnp.ones_like(rows, dtype=bool)
    res = build_ell_rows(rows, cols, valid, v, max_degree,
                         values=-w.astype(points.dtype), combine="add")
    while bool(res.overflow) and max_degree < v - 1:
        max_degree = min(2 * max_degree, v - 1)
        res = build_ell_rows(rows, cols, valid, v, max_degree,
                             values=-w.astype(points.dtype), combine="add")
    mask = res.columns != INVALID_INDEX
    offdiag = jnp.where(mask, res.values, 0.0)
    diag = -jnp.sum(offdiag, axis=1)

    area = 0.5 * jnp.linalg.norm(jnp.cross(p1 - p0, p2 - p0), axis=-1)
    mass = jnp.zeros((v,), points.dtype)
    for k in range(3):
        mass = mass.at[f[:, k]].add(area / 3.0)
    return EllOperator(res.columns, offdiag, diag), jnp.maximum(mass, 1e-12)


def to_edge_distance_graph(op: EllOperator, points: jax.Array) -> Graph:
    """Reference C2 `toEdgeDistanceMatrix` (`src/utility.cpp:50-56`):
    reuse an operator's sparsity pattern, values = Euclidean distances.

    Unlike the reference we carry no explicit zero diagonal (its quirk,
    SURVEY.md §2.2); self-loops never enter the ELL table.
    """
    mask = op.mask
    safe = op.safe_neighbors()
    dist = jnp.linalg.norm(points[:, None, :] - points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(points.dtype), jnp.inf)
    return Graph(neighbors=op.neighbors, distances=dist, points=points)


def extract_edges(graph: Graph):
    """Reference C3 `extractEdges` (`src/utility.cpp:58-71`): flatten to a
    COO list.  Returns (edges (V*K, 2) int32, lengths (V*K,), valid mask).
    Directed; each undirected edge appears twice, like the reference's
    full symmetric matrix traversal.
    """
    v, k = graph.neighbors.shape
    rows = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[:, None], (v, k))
    edges = jnp.stack([rows.reshape(-1),
                       graph.safe_neighbors().reshape(-1)], axis=1)
    return edges, graph.distances.reshape(-1), graph.mask.reshape(-1)
