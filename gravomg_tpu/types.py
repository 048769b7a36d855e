"""Core fixed-shape data structures for the Gravo MG framework.

Design stance (see SURVEY.md §7): every irregular structure in the reference
(`Eigen::SparseMatrix` graphs, prolongation operators with <=3 nnz/row,
ragged triangle association lists) becomes a fixed-shape, masked, padded
array ("ELL"-style layout).  This is what lets every stage trace once under
`jax.jit` and vectorize with static shapes.

Reference type vocabulary being replaced (cited for parity):
  - ``EdgeMatrix`` = ``Eigen::SparseMatrix<double>`` (reference
    `include/gravomg/utility.h:15`)            -> :class:`Graph`
  - ``ProlongationOperator`` (<=3 nnz/row, reference
    `include/gravomg/utility.h:18`)            -> :class:`Prolongation`
  - triangle lists + per-vertex association (reference
    `src/multigrid.cpp:209-263`)               -> :class:`TriangleSet`

Conventions:
  * Invalid neighbor slots hold ``INVALID_INDEX`` and the row is sorted
    ascending, so valid entries are a prefix... NOT guaranteed; always use
    the explicit validity mask (``Graph.mask``).  Rows *are* sorted
    ascending by neighbor index among valid entries, mirroring Eigen CSC
    inner-iterator order that the reference's tie-breaking semantics
    depend on (`src/multigrid.cpp:356`, `:414`).
  * Distances use the same Euclidean recomputed-from-positions convention
    as the reference (`src/multigrid.cpp:107`).
  * No self-loops are stored (the reference carries explicit zero
    diagonals, a quirk it has to work around twice --
    `src/multigrid.cpp:156-159`; we use masks instead, as its own comment
    at `src/multigrid.cpp:158` wishes for).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel for empty neighbor slots.  Large positive so ascending sorts put
# padding last (preserving Eigen inner-iterator ordering for valid entries).
INVALID_INDEX = np.int32(2**31 - 1)


def _is_valid(idx: jax.Array) -> jax.Array:
    return idx != INVALID_INDEX


def safe_gather_index(idx: jax.Array) -> jax.Array:
    """Replace INVALID_INDEX slots with 0 so gathers stay in bounds."""
    return jnp.where(_is_valid(idx), idx, 0)


class Graph(NamedTuple):
    """Symmetric neighborhood graph in padded ELL layout.

    Attributes:
      neighbors: (V, K) int32, ascending per row among valid entries,
        padding = INVALID_INDEX.
      distances: (V, K) float, Euclidean edge lengths; +inf in padding.
      points:    (V, 3) float vertex positions.
    """

    neighbors: jax.Array
    distances: jax.Array
    points: jax.Array

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def mask(self) -> jax.Array:
        return _is_valid(self.neighbors)

    @property
    def degrees(self) -> jax.Array:
        return jnp.sum(self.mask, axis=1)

    @property
    def num_edges(self) -> jax.Array:
        """Directed edge count (each undirected edge counted twice)."""
        return jnp.sum(self.degrees)

    def safe_neighbors(self) -> jax.Array:
        return safe_gather_index(self.neighbors)


@jax.tree_util.register_pytree_node_class
class Prolongation(NamedTuple):
    """Blocked-ELL prolongation operator U: (n_fine, n_coarse), <=3 nnz/row.

    Mirrors the reference invariant that every row of U holds 1-3 weights
    over coarse vertices summing to 1 (`src/multigrid.cpp:265-498`).
    Unused slots duplicate slot 0's column with weight 0 (harmless for
    SpMV / RAP; dedup before comparing sparsity patterns).

    Attributes:
      cols:    (V_f, 3) int32 coarse column indices.
      weights: (V_f, 3) float row weights (sum to 1 per row).
      n_coarse: static int (pytree aux data), number of coarse vertices.
    """

    cols: jax.Array
    weights: jax.Array
    n_coarse: int

    def tree_flatten(self):
        return (self.cols, self.weights), self.n_coarse

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    @property
    def n_fine(self) -> int:
        return self.cols.shape[0]

    def as_dense(self) -> jax.Array:
        """Materialize dense (n_fine, n_coarse); for tests/small levels."""
        u = jnp.zeros((self.n_fine, self.n_coarse), self.weights.dtype)
        rows = jnp.arange(self.n_fine)[:, None]
        return u.at[rows, self.cols].add(self.weights)


@jax.tree_util.register_pytree_node_class
class Restriction(NamedTuple):
    """Gather-form U^T: children-ELL table per coarse vertex.

    Restriction is U^T in the Gravo MG method (reference `README.md:1`;
    never materialized there).  Instead of a scatter-form
    `out.at[cols].add`, this precomputed transpose makes
    restriction a fixed-shape gather + row-reduce exactly like SpMV:
        coarse[c] = sum_j weights[c, j] * fine[rows[c, j]].

    Attributes:
      rows:    (n_coarse, C) int32 fine-vertex indices, INVALID_INDEX pad.
      weights: (n_coarse, C) float U[rows[c, j], c]; 0 in padding.
      n_fine:  static int (aux), number of fine rows of U.
    """

    rows: jax.Array
    weights: jax.Array
    n_fine: int

    def tree_flatten(self):
        return (self.rows, self.weights), self.n_fine

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    @property
    def n_coarse(self) -> int:
        return self.rows.shape[0]

    @property
    def max_children(self) -> int:
        return self.rows.shape[1]

    @property
    def mask(self) -> jax.Array:
        return _is_valid(self.rows)

    def safe_rows(self) -> jax.Array:
        return safe_gather_index(self.rows)


class EllOperator(NamedTuple):
    """Square sparse symmetric operator (e.g. a Laplacian) in ELL form.

    ``A x = diag * x + segment-gather(offdiag * x[neighbors])``.

    Attributes:
      neighbors: (V, K) int32, padding = INVALID_INDEX.
      offdiag:   (V, K) float, 0 in padding.
      diag:      (V,)   float.
    """

    neighbors: jax.Array
    offdiag: jax.Array
    diag: jax.Array

    @property
    def num_vertices(self) -> int:
        return self.diag.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def mask(self) -> jax.Array:
        return _is_valid(self.neighbors)

    def safe_neighbors(self) -> jax.Array:
        return safe_gather_index(self.neighbors)

    def as_dense(self) -> jax.Array:
        v = self.num_vertices
        a = jnp.zeros((v, v), self.diag.dtype)
        rows = jnp.arange(v)[:, None]
        cols = self.safe_neighbors()
        vals = jnp.where(self.mask, self.offdiag, 0.0)
        a = a.at[rows, cols].add(vals)
        return a + jnp.diag(self.diag)


class TriangleSet(NamedTuple):
    """All triangles of a coarse graph + per-vertex association lists.

    Fixed-shape replacement for the reference's
    ``vector<TriangleWithNormal>`` + ``vector<vector<size_t>>``
    (`src/multigrid.cpp:209-263`).  Triangles are enumerated in the same
    lexicographic (v0 < v1 < v2) order as the reference's nested
    inner-iterator loops, so triangle ids and the ordering of association
    lists match Eigen semantics exactly (required for the first-hit
    tie-break in prolongation, `src/multigrid.cpp:374-380`).

    Attributes:
      vertices:  (T, 3) int32, each row sorted ascending; padding rows are
        INVALID_INDEX.
      normals:   (T, 3) float, normalize((p1-p0) x (p2-p0)).
      assoc:     (V, A) int32 triangle ids incident to each vertex,
        ascending; padding = INVALID_INDEX.
      assoc_rot: (V, A) int32 in {0, 1, 2}, or None: which slot of
        ``vertices[assoc[v, a]]`` equals v.  The prolongation rotates
        each candidate triangle so the parent sits in slot 0
        (`src/multigrid.cpp:360`); carrying the slot here lets the fast
        path gather precomputed per-rotation coefficients instead of
        re-deriving the rotation per (fine point, candidate) pair.
        Zero for padding slots.
    """

    vertices: jax.Array
    normals: jax.Array
    assoc: jax.Array
    assoc_rot: Optional[jax.Array] = None

    @property
    def max_triangles(self) -> int:
        return self.vertices.shape[0]

    @property
    def mask(self) -> jax.Array:
        return _is_valid(self.vertices[:, 0])

    @property
    def assoc_mask(self) -> jax.Array:
        return _is_valid(self.assoc)


class HierarchyStats(NamedTuple):
    """Per-level diagnostics.

    The reference computes `notrisfound` / `edgesfound` / `fallbackCount`
    but never reports them (`src/multigrid.cpp:282-284,423,482-484`;
    printing commented out at `:489-490`).  We return them as first-class
    data, converting its crash-guard `assert` (`src/multigrid.cpp:488`)
    into an inspectable diagnostic (SURVEY.md §5).
    """

    n_fine: int
    n_coarse: int
    n_triangles: jax.Array
    triangle_hits: jax.Array
    edge_fallbacks: jax.Array
    point_fallbacks: jax.Array
    radius: jax.Array


class Level(NamedTuple):
    """One level of the multigrid hierarchy."""

    graph: Graph                      # coarse graph at this level
    operator: EllOperator             # Galerkin operator A_l
    prolongation: Optional[Prolongation]  # U mapping this level <- next-coarser
    parents: Optional[jax.Array]      # (V,) int32 fine -> coarse map
    stats: Optional[HierarchyStats]
