"""Coarse point placement: mean of fine children.

Reference C8 ``coarseFromMeanOfFineChildren`` (`src/multigrid.cpp:171-207`):
each coarse point moves to the mean of the fine points in its Voronoi
cell; a "lonely" cell containing only its seed additionally absorbs the
seed's fine-graph neighbors into the average (`src/multigrid.cpp:183-191`,
the reference's own `todo: is this actually helpful?`).

Fixed-shape form: one segment-sum / segment-count pass plus a masked fix-up for
singleton cells (SURVEY.md §2.1-C8).  The reference's ``std::set`` dedup
is a no-op for us: ELL neighbor rows hold distinct non-self entries, so
the patched cell is exactly {seed} ∪ neighbors(seed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph

import functools


@functools.partial(jax.jit, static_argnames=("n_valid_fine",))
def coarse_from_mean_of_fine_children(
        graph: Graph, parents: jax.Array, coarse_samples: jax.Array,
        n_valid_fine: int | None = None, fine_valid=None,
) -> jax.Array:
    """Returns (C, 3) coarse positions.

    ``n_valid_fine`` (static prefix length) or ``fine_valid`` (dynamic
    (V,) bool mask, used by the device-resident build) excludes
    bucket-phantom fine vertices from every cell average.
    """
    points = graph.points
    c = coarse_samples.shape[0]
    v = points.shape[0]
    if fine_valid is not None:
        scatter_par = jnp.where(fine_valid, parents, c)
    elif n_valid_fine is not None and n_valid_fine < v:
        fine_ok = jnp.arange(v) < n_valid_fine
        scatter_par = jnp.where(fine_ok, parents, c)
    else:
        scatter_par = parents
    sums = jnp.zeros((c + 1, points.shape[1]), points.dtype)
    sums = sums.at[scatter_par].add(points)[:c]
    counts = jnp.zeros((c + 1,), jnp.int32).at[scatter_par].add(1)[:c]

    # Lonely-cell patch: a 1-child cell's only child is its seed (the seed
    # always maps to itself at distance 0).  Samples may carry
    # INVALID_INDEX padding (phantom coarse slots, bucketed builds);
    # phantoms have counts == 0, never "lonely", so the patched values
    # computed from the clamped seed index are discarded.
    from gravomg_tpu.types import INVALID_INDEX
    seeds = jnp.where(coarse_samples == INVALID_INDEX, 0, coarse_samples)
    nbr_mask = graph.mask[seeds]                       # (C, K)
    nbr_pts = points[graph.safe_neighbors()[seeds]]    # (C, K, 3)
    patched_sum = points[seeds] + jnp.sum(
        jnp.where(nbr_mask[:, :, None], nbr_pts, 0.0), axis=1)
    patched_count = 1 + jnp.sum(nbr_mask, axis=1)

    lonely = counts == 1
    final_sum = jnp.where(lonely[:, None], patched_sum, sums)
    final_count = jnp.where(lonely, patched_count, jnp.maximum(counts, 1))
    return final_sum / final_count[:, None].astype(points.dtype)
