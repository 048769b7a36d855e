"""Fine-to-coarse parent assignment: graph Voronoi clustering.

Reference C6 ``assignParents`` (`src/multigrid.cpp:77-125`) runs a
multi-source Dijkstra with a binary heap, seeded at each coarse sample
with distance 0 and parent = the sample's *coarse-side* index
(`src/multigrid.cpp:89-93`), relaxing with Euclidean edge lengths
recomputed from positions (`src/multigrid.cpp:107`).

The fixed-shape equivalent (SURVEY.md CS-3) is iterated masked gather-min
relaxation (Bellman-Ford / label propagation) to a fixpoint: each sweep
is one fixed-shape (V, K) gather + min-reduce, and convergence takes
O(cell hop-diameter) sweeps -- small, since cells have radius on the
order of the sampling radius.  The fixpoint is the same shortest-path
Voronoi partition Dijkstra computes; exact-arithmetic distance ties
(measure-zero for generic point clouds) are broken toward the
lowest-index neighbor slot.

The reference's missing stale-entry skip (`src/multigrid.cpp:96-101`) is
pure redundant work with no semantic effect (SURVEY.md §2.1-C6) and is
not replicated.  Unreached vertices keep parent 0, matching the
reference's default initialization (`src/multigrid.cpp:82`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
def assign_parents(graph: Graph, coarse_samples: jax.Array,
                   max_sweeps: int = 10_000) -> Tuple[jax.Array, jax.Array]:
    """Compute the nearest coarse parent of every fine vertex.

    Args:
      graph: fine-level graph.
      coarse_samples: (C,) int32 fine-vertex ids of the coarse seeds,
        ascending (output of fast_disc_sample).

    Returns:
      (parents (V,) int32 in [0, C), distances (V,) float): the coarse
      index of the shortest-path-nearest seed and the path length.
    """
    v = graph.num_vertices
    nbr = graph.safe_neighbors()
    m = graph.mask
    d = jnp.where(m, graph.distances, jnp.inf)

    # Samples may be padded with INVALID_INDEX (bucketed coarse sizes for
    # recompile-free builds); padded seeds scatter into a dump row.
    from gravomg_tpu.types import INVALID_INDEX
    valid_s = coarse_samples != INVALID_INDEX
    scatter_idx = jnp.where(valid_s, coarse_samples, v)
    dist0 = jnp.full((v + 1,), jnp.inf, graph.distances.dtype)
    dist0 = dist0.at[scatter_idx].set(
        jnp.where(valid_s, 0.0, jnp.inf))[:v]
    par0 = jnp.zeros((v + 1,), jnp.int32)
    par0 = par0.at[scatter_idx].set(
        jnp.arange(coarse_samples.shape[0], dtype=jnp.int32))[:v]

    def sweep(state):
        dist, par, changed, it = state
        cand = dist[nbr] + d                    # (V, K) path via neighbor
        best_k = jnp.argmin(cand, axis=1)       # first min slot on ties
        best = jnp.take_along_axis(cand, best_k[:, None], axis=1)[:, 0]
        best_par = par[jnp.take_along_axis(nbr, best_k[:, None],
                                           axis=1)[:, 0]]
        improved = best < dist
        return (jnp.where(improved, best, dist),
                jnp.where(improved, best_par, par),
                jnp.any(improved), it + 1)

    def cond(state):
        _, _, changed, it = state
        return changed & (it < max_sweeps)

    dist, par, _, _ = jax.lax.while_loop(
        cond, sweep, (dist0, par0, jnp.bool_(True), jnp.int32(0)))
    return par, dist


def _seed_init(graph: Graph, coarse_samples: jax.Array):
    from gravomg_tpu.types import INVALID_INDEX

    v = graph.num_vertices
    valid_s = coarse_samples != INVALID_INDEX
    scatter_idx = jnp.where(valid_s, coarse_samples, v)
    dist0 = jnp.full((v + 1,), jnp.inf, graph.distances.dtype)
    dist0 = dist0.at[scatter_idx].set(
        jnp.where(valid_s, 0.0, jnp.inf))[:v]
    par0 = jnp.zeros((v + 1,), jnp.int32)
    par0 = par0.at[scatter_idx].set(
        jnp.arange(coarse_samples.shape[0], dtype=jnp.int32))[:v]
    return dist0, par0


@functools.partial(jax.jit, static_argnames=("block", "window", "nw",
                                             "escape_cap", "large_v"))
def graph_minplus_operator(graph: Graph, block: int = 256,
                           window: int = 512, nw: int = 4,
                           escape_cap: int | None = None,
                           large_v: int = 300_000):
    """The fine graph's 1-hop distances as a block-dense min-plus
    operator (+inf empty slots).  Shared by parent assignment
    (shortest-path sweeps) and chained-gate disc sampling -- build it
    once per level and pass it to both.

    Scale-adaptive geometry: the wide uniform windows cost
    V * nww * 4 bytes (8.2 GB at 1M with w0=512, w=512, nw=4 -- the
    round-3 OOM).  Measured at 1M (scripts/probe_1m_spread.py):
    128-row blocks with w0=256 + 3x128 windows cover 91% of the fine
    graph at nww=640 (2.6 GB); the tail rides the escape chute, whose
    cap must scale past V (1.56M escapes measured at 1M).  Distances
    stay f32: bf16 rounding would desynchronize the min-plus fixpoint
    from the f32 predecessor recovery in assign_parents_bd.

    Returns (bd, overflow).
    """
    from gravomg_tpu.ops.blockdense import blockdense_from_ell

    v = graph.num_vertices
    if v > large_v:
        block, window, nw, window0 = 128, 128, 4, 256
        cap = escape_cap or max(4096, 2 * v)
    else:
        window0 = window
        cap = escape_cap or max(4096, v)
    dmat = jnp.where(graph.mask, graph.distances, jnp.inf)
    return blockdense_from_ell(
        graph.safe_neighbors(), dmat, graph.mask, v, combine="min",
        block=min(block, max(v // 8, 8)), window=min(window, v), nw=nw,
        window0=min(window0, v), escape_cap=cap)


@functools.partial(jax.jit, static_argnames=("max_sweeps", "block",
                                             "window", "nw",
                                             "escape_cap", "large_v"))
def assign_parents_bd(graph: Graph, coarse_samples: jax.Array,
                      max_sweeps: int = 10_000, block: int = 256,
                      window: int = 512, nw: int = 4,
                      escape_cap: int | None = None,
                      large_v: int = 300_000, bd=None, bd_ovf=None
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Gather-free parent assignment: min-plus block-dense relaxation
    sweeps to the shortest-path fixpoint, then one predecessor argmin
    and logarithmic pointer jumping to recover the seed labels.

    Identical distances to :func:`assign_parents` (min is order-free);
    identical parents for generic (tie-free) clouds.  Returns
    (parents, distances, overflow) -- overflow means the block-dense
    caps were too small and the result is invalid.

    ``bd``/``bd_ovf``: optionally a prebuilt
    :func:`graph_minplus_operator` result to reuse (the builder shares
    one operator between sampling and parent assignment per level).
    """
    v = graph.num_vertices
    from gravomg_tpu.ops.blockdense import blockdense_minplus

    if bd is None:
        bd, ovf = graph_minplus_operator(
            graph, block=block, window=window, nw=nw,
            escape_cap=escape_cap, large_v=large_v)
    else:
        ovf = jnp.bool_(False) if bd_ovf is None else bd_ovf

    dist0, par0 = _seed_init(graph, coarse_samples)

    def sweep(state):
        dist, changed, it = state
        new = jnp.minimum(dist, blockdense_minplus(bd, dist))
        return new, jnp.any(new < dist), it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < max_sweeps)

    dist, _, _ = jax.lax.while_loop(
        cond, sweep, (dist0, jnp.bool_(True), jnp.int32(0)))

    # Predecessor of each vertex on its shortest path (first-min slot on
    # exact ties, as in the sweep formulation); seeds point to
    # themselves.
    nbr = graph.safe_neighbors()
    d = jnp.where(graph.mask, graph.distances, jnp.inf)
    cand = dist[nbr] + d
    best_k = jnp.argmin(cand, axis=1)
    pred = jnp.take_along_axis(nbr, best_k[:, None], axis=1)[:, 0]
    is_seed = dist == 0.0
    me = jnp.arange(v, dtype=jnp.int32)
    unreached = jnp.isinf(dist)
    pred = jnp.where(is_seed | unreached, me, pred)

    # Pointer jumping: pi <- pi[pi] until every chain hits its seed.
    hops = max(1, int(v).bit_length())

    def jump(_, pi):
        return pi[pi]

    pi = jax.lax.fori_loop(0, hops, jump, pred)
    parents = jnp.where(unreached, 0, par0[pi])
    return parents, dist, ovf
