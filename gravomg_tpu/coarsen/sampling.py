"""Coarse-node selection: fast disc sampling as fixed-shape array code.

Reference C4 ``fastDiscSample`` (`src/sampling.cpp:7-53`, decl
`include/gravomg/sampling.h:14-18`) is a sequential greedy scan: visit
vertices in index order, select if not yet covered, and mark as covered
every 1-hop neighbor within ``radius`` plus every 2-hop neighbor whose
summed hop distance is under ``radius`` (`src/sampling.cpp:31-46`).

**Equivalence theorem used here** (SURVEY.md CS-4): define the conflict
relation  i ~ j  iff  d(i,j) < r  with (i,j) a graph edge, or there is a
common graph neighbor n with d(i,n) + d(n,j) < r.  Both clauses are
symmetric (the 2-hop sum is direction-independent and a sum < r implies
each hop < r, so the intermediate vertex is scanned from either side).
The reference's greedy output is then exactly the *lexicographically
first maximal independent set* of the conflict graph: a vertex is
selected iff no smaller-indexed selected vertex conflicts with it.  That
fixpoint is computable by deterministic parallel rounds (each round
decides every vertex whose smaller-indexed conflict neighbors are all
decided), which converges in O(longest dependency chain) fixed-shape
sweeps -- bit-identical to the sequential scan, with no sequential loop
over vertices.

The dead ``distances`` / ``nearest_source`` allocations of the reference
(`src/sampling.cpp:15-17`) are intentionally not replicated.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph

_UNDECIDED, _SELECTED, _REJECTED = 0, 1, 2


@functools.partial(jax.jit, static_argnames=("k_cap",))
def _prune_for_radius(graph: Graph, radius: jax.Array, k_cap: int):
    """Keep only edges with d < radius, compacted to a (V, k_cap) prefix.

    Exactness: both conflict clauses of the disc-sampling relation
    (`src/sampling.cpp:31-46`) require every participating hop to be
    individually shorter than ``radius`` (the 1-hop clause directly;
    the 2-hop clause because the summed positive hops are < radius), so
    the lex-first-MIS fixpoint over the pruned graph is identical.
    Rows keep ascending neighbor order (stable compaction).  Returns
    (neighbors, mask, distances, overflow); overflow means some row had
    more than ``k_cap`` in-radius edges and the result is invalid.
    """
    keep = graph.mask & (graph.distances < radius)
    # Stable sort pushes dropped entries to the end, preserving the
    # ascending order of kept neighbors.
    order = jnp.argsort(~keep, axis=1, stable=True)
    nbr = jnp.take_along_axis(graph.safe_neighbors(), order, axis=1)
    dist = jnp.take_along_axis(graph.distances, order, axis=1)
    kept = jnp.take_along_axis(keep, order, axis=1)
    counts = jnp.sum(keep, axis=1)
    overflow = jnp.any(counts > k_cap)
    return (jnp.where(kept, nbr, 0)[:, :k_cap], kept[:, :k_cap],
            jnp.where(kept, dist, jnp.inf)[:, :k_cap], overflow)


@jax.jit
def prune_overflow(graph: Graph, radius: jax.Array,
                   k_cap: int) -> jax.Array:
    """Device-side bool: True if some row has more than ``k_cap``
    in-radius edges (i.e. a pruned sampling at that cap is invalid).
    O(V K) counting only -- callers that cannot sync fold this into
    their deferred diagnostics."""
    counts = jnp.sum(graph.mask & (graph.distances < radius), axis=1)
    return jnp.any(counts > k_cap)


def average_edge_length(graph: Graph) -> jax.Array:
    """Reference C5 ``averageEdgeLength`` (`src/multigrid.cpp:127-133`).

    The reference divides the summed edge lengths by (nnz - V), i.e. it
    subtracts the one zero-length self-loop per vertex its edge matrix
    carries (comment at `src/multigrid.cpp:132`).  Our ELL graph stores no
    self-loops, so this is simply the masked mean; both directions of each
    undirected edge are counted, exactly as in the reference.
    """
    mask = graph.mask
    total = jnp.sum(jnp.where(mask, graph.distances, 0.0))
    return total / jnp.sum(mask)


def sampling_radius(graph: Graph, reduction_ratio: float = 2.0) -> jax.Array:
    """Demo convention: radius = cbrt(ratio) * mean edge length
    (`test/main.cpp:23,74`).  The cube-root law is a tunable, per the
    reference's own `todo` at `test/main.cpp:23`."""
    return jnp.cbrt(reduction_ratio) * average_edge_length(graph)


def _round_update(nbr, m, d, radius, status, chunk):
    """One lex-first-MIS round over pruned (V, Kr) conflict tables.

    The (chunk, Kr, Kr) two-hop tensor is never materialized globally:
    each round recomputes it per ``chunk`` rows, keeping peak memory
    O(chunk * Kr^2) regardless of V.
    """
    v = nbr.shape[0]
    vpad = ((v + chunk - 1) // chunk) * chunk
    pad = vpad - v
    nbr_p = jnp.pad(nbr, ((0, pad), (0, 0)))
    m_p = jnp.pad(m, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=jnp.inf)
    idx_p = jnp.arange(vpad, dtype=jnp.int32)

    def per_chunk(c0):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c0 * chunk, chunk)
        cn, cm, cd, cidx = sl(nbr_p), sl(m_p), sl(d_p), sl(idx_p)
        low1 = cm & (cd < radius) & (cn < cidx[:, None])
        nn = jnp.where(cm[:, :, None], nbr[cn], 0)
        nn_mask = cm[:, :, None] & m[cn]
        d2 = cd[:, :, None] + jnp.where(nn_mask, d[cn], jnp.inf)
        low2 = nn_mask & (d2 < radius) & (nn < cidx[:, None, None])
        s1 = status[cn]
        s2 = status[nn]
        sel_lower = (jnp.any(low1 & (s1 == _SELECTED), axis=1)
                     | jnp.any(low2 & (s2 == _SELECTED), axis=(1, 2)))
        undec_lower = (jnp.any(low1 & (s1 == _UNDECIDED), axis=1)
                       | jnp.any(low2 & (s2 == _UNDECIDED), axis=(1, 2)))
        cstat = status[cidx]
        undecided = cstat == _UNDECIDED
        return jnp.where(
            undecided & sel_lower, _REJECTED,
            jnp.where(undecided & ~undec_lower, _SELECTED,
                      cstat)).astype(jnp.int8)

    return jax.lax.map(per_chunk, jnp.arange(vpad // chunk)).reshape(vpad)[:v]


@functools.partial(jax.jit,
                   static_argnames=("max_rounds", "chunk", "prune_cap"))
def fast_disc_sample_mask(graph: Graph, radius: jax.Array,
                          max_rounds: int = 4096,
                          chunk: int = 8192,
                          prune_cap: int | None = None) -> jax.Array:
    """Greedy Poisson-disc selection mask, parallel lex-first-MIS rounds.

    Returns a (V,) bool mask; `mask.nonzero()` (ascending) equals the
    reference's selection list, which is also emitted in ascending vertex
    order (`src/sampling.cpp:22-28`).

    Conflict edges all have length < radius, so the rounds run over the
    radius-pruned (V, Kr) tables of :func:`_prune_for_radius`; with
    ``prune_cap=None`` Kr = K and overflow is impossible (exact for any
    graph).  A smaller static ``prune_cap`` cuts the dominant
    (chunk, Kr, Kr) two-hop cost quadratically; rows with more than
    ``prune_cap`` in-radius edges would make the result invalid, so
    that variant is only used by callers that check the pruning
    overflow flag (hierarchy_static folds it into the deferred
    diagnostics).  Termination is guaranteed: dependencies point
    strictly toward smaller indices, so the smallest undecided vertex
    is decidable every round.
    """
    k_cap = graph.max_degree if prune_cap is None else prune_cap
    nbr, m, d, _ = _prune_for_radius(graph, radius, k_cap)

    def round_body(state):
        status, _, it = state
        return _round_update(nbr, m, d, radius, status, chunk), status, it + 1

    def cond(state):
        status, prev, it = state
        return (jnp.any(status == _UNDECIDED) & jnp.any(status != prev)
                & (it < max_rounds))

    v = graph.num_vertices
    init = (jnp.zeros((v,), jnp.int8), jnp.full((v,), -1, jnp.int8),
            jnp.int32(0))
    status, _, _ = jax.lax.while_loop(cond, round_body, init)
    return status == _SELECTED


@functools.partial(jax.jit, static_argnames=("chunk",))
def _disc_round(nbr, m, d, radius: jax.Array, status: jax.Array,
                chunk: int = 8192):
    """One lex-first-MIS round as a standalone single-launch program
    over pruned conflict tables.

    Used by :func:`fast_disc_sample_rounds`, which drives rounds from
    Python: the fused while_loop variant is one launch of rounds x
    chunks at large V, while per-round launches stay short.
    """
    new_status = _round_update(nbr, m, d, radius, status, chunk)
    return new_status, jnp.any(new_status == _UNDECIDED)


def fast_disc_sample_rounds(graph: Graph, radius, rounds: int = 24,
                            chunk: int = 8192,
                            prune_cap: int | None = None):
    """Watchdog-safe sampling: a fixed number of short per-round
    launches (idempotent once converged).  Returns (mask, undecided)
    where ``undecided`` is a device-side bool diagnostic: True means
    ``rounds`` was too small for this graph's dependency chains (or,
    with a ``prune_cap``, that the pruned tables overflowed)."""
    v = graph.num_vertices
    k_cap = graph.max_degree if prune_cap is None else prune_cap
    nbr, m, d, p_ovf = _prune_for_radius(graph, radius, k_cap)
    status = jnp.zeros((v,), jnp.int8)
    undec = jnp.bool_(True)
    for _ in range(rounds):
        status, undec = _disc_round(nbr, m, d, radius, status, chunk=chunk)
    return status == _SELECTED, undec | p_ovf


@functools.partial(jax.jit, static_argnames=("k_prune", "kc_cap",
                                             "chunk", "lower_only"))
def conflict_ell(graph: Graph, radius: jax.Array, k_prune: int,
                 kc_cap: int, chunk: int = 8192,
                 lower_only: bool = True):
    """Lower-index conflict lists of the disc-sampling relation.

    Row i holds the deduplicated j < i with  (edge(i,j) and d < radius)
    or (2-hop path i-n-j with d(i,n) + d(n,j) < radius) -- exactly the
    dependency the greedy scan's rejection uses (`src/sampling.cpp:
    31-46`).  Built once per level; the lex-first-MIS rounds then
    reduce over this fixed structure instead of re-gathering the
    (V, Kr, Kr) two-hop tensor every round.

    Returns (cols (V, kc_cap) int32 ascending with INVALID_INDEX pad,
    mask, overflow) -- overflow means kc_cap or k_prune too small.
    """
    from gravomg_tpu.types import INVALID_INDEX

    nbr, m, d, p_ovf = _prune_for_radius(graph, radius, k_prune)
    v, kr = nbr.shape
    vpad = ((v + chunk - 1) // chunk) * chunk
    pad = vpad - v
    nbr_p = jnp.pad(nbr, ((0, pad), (0, 0)))
    m_p = jnp.pad(m, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=jnp.inf)
    idx_p = jnp.arange(vpad, dtype=jnp.int32)
    imax = jnp.iinfo(jnp.int32).max

    def per_chunk(c0):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c0 * chunk, chunk)
        cn, cm, cd, cidx = sl(nbr_p), sl(m_p), sl(d_p), sl(idx_p)
        low1 = cm
        nn = jnp.where(cm[:, :, None], nbr[cn], 0)
        nn_mask = cm[:, :, None] & m[cn]
        d2 = cd[:, :, None] + jnp.where(nn_mask, d[cn], jnp.inf)
        low2 = nn_mask & (d2 < radius)
        if lower_only:
            low1 = low1 & (cn < cidx[:, None])
            low2 = low2 & (nn < cidx[:, None, None])
        else:
            # Symmetric variant: exclude self (2-hop paths i-n-i).
            low2 = low2 & (nn != cidx[:, None, None])
        cols = jnp.concatenate(
            [jnp.where(low1, cn, imax),
             jnp.where(low2, nn, imax).reshape(chunk, kr * kr)], axis=1)
        # Per-row dedup + compaction: ascending sort, drop repeats,
        # stable-compact the keepers to a prefix.
        cols = jnp.sort(cols, axis=1)
        prev = jnp.concatenate(
            [jnp.full((chunk, 1), -1, cols.dtype), cols[:, :-1]], axis=1)
        keep = (cols != imax) & (cols != prev)
        order = jnp.argsort(~keep, axis=1, stable=True)
        cols_c = jnp.take_along_axis(cols, order, axis=1)[:, :kc_cap]
        keep_c = jnp.take_along_axis(keep, order, axis=1)[:, :kc_cap]
        ovf = jnp.any(jnp.sum(keep, axis=1) > kc_cap)
        return jnp.where(keep_c, cols_c, INVALID_INDEX), keep_c, ovf

    cols, mask, ovfs = jax.lax.map(per_chunk,
                                   jnp.arange(vpad // chunk))
    return (cols.reshape(vpad, kc_cap)[:v],
            mask.reshape(vpad, kc_cap)[:v],
            jnp.any(ovfs) | p_ovf)


def fast_disc_sample_bd(graph: Graph, radius, k_prune: int | None = None,
                        kc_cap: int = 96, max_rounds: int = 256,
                        block: int = 256, window: int = 512,
                        nw: int = 2, escape_cap: int | None = None,
                        large_v: int = 300_000):
    """Greedy disc sampling via the conflict operator: each lex-first-
    MIS round is two gather-free block-dense matvecs over indicator
    vectors instead of a (V, Kr, Kr) re-gather.  Bit-identical
    fixpoint.

    Returns (mask, invalid) where ``invalid`` is a deferred device-side
    bool: caps were too small and the result must not be used.
    """
    from gravomg_tpu.ops.blockdense import (blockdense_from_ell,
                                            blockdense_matvec)

    v = graph.num_vertices
    if k_prune is None:
        k_prune = graph.max_degree
    # Scale-adaptive geometry + bf16 indicator entries (0/1 exact in
    # bf16; the matvec accumulates in f32): the uniform wide windows
    # would cost V * nww * 4 bytes of device memory at 1M (see
    # fast_disc_sample_priority).
    if v > large_v:
        window, nw, window0 = 128, 6, 512
    else:
        window0 = window
    cols, mask, c_ovf = conflict_ell(graph, radius,
                                     min(k_prune, graph.max_degree),
                                     kc_cap)
    ones = jnp.ones(cols.shape, jnp.bfloat16)
    cbd, b_ovf = blockdense_from_ell(
        cols, ones, mask, v, block=min(block, max(v // 8, 8)),
        window=min(window, v), nw=nw, window0=min(window0, v),
        escape_cap=escape_cap or max(4096, v))

    def round_body(state):
        status, _, it = state
        a = (status == _SELECTED).astype(jnp.float32)
        b = (status == _UNDECIDED).astype(jnp.float32)
        # An UNDECIDED vertex's selected conflicts are necessarily
        # lower-indexed (a selected vertex requires every lower
        # conflict decided), so the lower-triangular operator serves
        # both reductions.
        sel_l = blockdense_matvec(cbd, a) > 0.5
        und_l = blockdense_matvec(cbd, b) > 0.5
        und = status == _UNDECIDED
        new = jnp.where(und & sel_l, _REJECTED,
                        jnp.where(und & ~und_l, _SELECTED,
                                  status)).astype(jnp.int8)
        return new, status, it + 1

    def cond(state):
        status, prev, it = state
        return (jnp.any(status == _UNDECIDED) & jnp.any(status != prev)
                & (it < max_rounds))

    init = (jnp.zeros((v,), jnp.int8), jnp.full((v,), -1, jnp.int8),
            jnp.int32(0))
    status, _, it = jax.lax.while_loop(cond, round_body, init)
    invalid = c_ovf | b_ovf | jnp.any(status == _UNDECIDED)
    return status == _SELECTED, invalid


def fast_disc_sample_priority(graph: Graph, radius, seed: int = 0,
                              k_prune: int | None = None,
                              kc_cap: int = 192, max_rounds: int = 128,
                              block: int = 256, window: int = 512,
                              nw: int = 3, escape_cap: int | None = None,
                              large_v: int = 300_000):
    """Random-priority maximal-independent-set disc sampling (fast mode).

    The reference's greedy is the lexicographically-first MIS of the
    conflict graph (module docstring); under a *spatial* vertex order
    its dependency chains run along the curve, so the exact parallel
    fixpoint needs O(chain length) rounds -- hundreds at bench scale.
    This variant runs the same fixpoint under an i.i.d. random priority
    (Luby-style), converging in O(log V) rounds with probability 1,
    and returns a *different but equally valid* maximal independent set
    of the identical conflict relation (same minimum-distance and
    coverage guarantees; SURVEY.md CS-4 blesses the parallel variant
    for the fast path, the exact mode remains for compat).

    Deterministic given ``seed``.  Returns (mask, invalid).
    """
    from gravomg_tpu.ops.blockdense import (blockdense_from_ell,
                                            blockdense_minplus)

    v = graph.num_vertices
    if k_prune is None:
        k_prune = graph.max_degree
    # Above ~300k vertices the uniform wide-window geometry stops
    # fitting a 16 GB device (V * nww * 4 bytes: 6.1 GB per operator at
    # 1M with w0=512, w=512, nw=3).  Measured coverage at
    # 1M (scripts/probe_1m_spread.py): w0=512 + 5x128 windows covers
    # 96.4% of the 2-hop conflict entries at nww=1152; the rest ride
    # the escape chute (~0.5 V entries, gathered every round).  The
    # 2-hop relation is also wider than kc_cap=192 at this scale.
    if v > large_v:
        window, nw, window0 = 128, 6, 512
    else:
        window0 = window
    cols, mask, c_ovf = conflict_ell(graph, radius,
                                     min(k_prune, graph.max_degree),
                                     kc_cap, lower_only=False)
    # Escape fill measured at 0.88*V for the standard radius at 50k
    # (wide geometry) and 0.47*V at 1M (narrow) -- a 1*V cap was one
    # bad radius away from an invalid build; 2*V covers the swept
    # reduction ratios (1.7*V at ratio 4.0); every slot costs a gather
    # per round.
    cap = escape_cap or max(4096, 2 * v)
    # ONE min-plus operator serves both reductions (the round-2 design
    # carried a second indicator operator -- 2x the dominant memory):
    #   min_j (0 + gate_j)  over conflicts, gate = 0 iff selected,
    # is 0 iff a selected conflict exists, inf otherwise; priorities
    # reduce the same way.  Entries are exactly 0/inf, so bf16 storage
    # is EXACT (the tropical add promotes to f32 against the input) and
    # halves the stream again.
    zeros = jnp.zeros(cols.shape, jnp.bfloat16)
    cbd_min, m_ovf = blockdense_from_ell(
        cols, zeros, mask, v, combine="min",
        block=min(block, max(v // 8, 8)), window=min(window, v), nw=nw,
        window0=min(window0, v), escape_cap=cap)

    # Priorities must be pairwise DISTINCT f32 values: above 2^24 a
    # plain float cast collapses permutation values and two conflicting
    # vertices could both SELECT in one round (neither sees
    # min_und < pr), silently breaking MIS independence.  A monotone
    # int32 -> f32 BITCAST keeps them distinct for any V < 2^31: for
    # non-negative ints the IEEE-754 bit-pattern order equals float
    # order, and offsetting by 2^23 keeps every value a *normal* float
    # (devices may flush denormals to zero, which would collapse small
    # ints).
    perm = jax.random.permutation(jax.random.PRNGKey(seed), v)
    pr = jax.lax.bitcast_convert_type(
        perm.astype(jnp.int32) + jnp.int32(2 ** 23), jnp.float32)

    def round_body(state):
        status, _, it = state
        # Rejection: any conflicting selected vertex (priority-free) --
        # min over conflicts of a 0/inf selected gate.
        gate = jnp.where(status == _SELECTED, 0.0, jnp.inf)
        sel_any = blockdense_minplus(cbd_min, gate) < jnp.inf
        # Wait condition: a higher-priority (smaller pr) undecided
        # conflict exists -- a min-reduce of undecided priorities over
        # the conflict rows.
        gpr = jnp.where(status == _UNDECIDED, pr, jnp.inf)
        min_und = blockdense_minplus(cbd_min, gpr)
        und = status == _UNDECIDED
        new = jnp.where(und & sel_any, _REJECTED,
                        jnp.where(und & ~(min_und < pr), _SELECTED,
                                  status)).astype(jnp.int8)
        return new, status, it + 1

    def cond(state):
        status, prev, it = state
        return (jnp.any(status == _UNDECIDED) & jnp.any(status != prev)
                & (it < max_rounds))

    init = (jnp.zeros((v,), jnp.int8), jnp.full((v,), -1, jnp.int8),
            jnp.int32(0))
    status, _, it = jax.lax.while_loop(cond, round_body, init)
    invalid = c_ovf | m_ovf | jnp.any(status == _UNDECIDED)
    return status == _SELECTED, invalid


@functools.partial(jax.jit, static_argnames=("seed", "max_rounds"))
def fast_disc_sample_chained(graph: Graph, radius, seed: int = 0,
                             max_rounds: int = 256, bd=None,
                             bd_ovf=None):
    """Random-priority MIS disc sampling with CHAINED 1-hop gates.

    Computes the SAME maximal independent set as
    :func:`fast_disc_sample_priority` (same seed, same priorities, same
    greedy-by-priority fixpoint) without ever materializing the 2-hop
    conflict table -- the dominant build cost (measured 8.0 s of the
    32 s 200k build: a (V, 192) table + a 38M-element conversion
    argsort/scatter per level).  Both gates factor through the 1-HOP
    min-plus operator D (d_ij entries, +inf empty):

      reject (exact conflict relation, reference semantics
      `src/sampling.cpp:31-46`): r1 = minplus(D, y) with y = 0 iff
      selected gives min distance to a selected 1-hop neighbor;
      r2 = minplus(D, r1) gives min 2-hop path sums d(i,n1)+d(n1,j)
      to selected j.  Conflict iff r1 < radius or r2 < radius.

      wait: the minimum priority among undecided vertices within <= 2
      hops where EACH HOP is shorter than ``radius`` -- two
      neighborhood-min reductions gated by a per-entry threshold on the
      same operator.  This relation contains every exact conflict (both
      terms of a sum < radius are each < radius) while excluding the
      long edges an unweighted gate would wait on, so rounds converge
      faster; any wait SUPERSET of the conflict relation changes
      nothing: a vertex only defers to non-conflicting nearby vertices
      until they decide, and its eventual decision -- no selected
      exact-conflict -- still equals the greedy-by-priority MIS of the
      exact relation (tested bit-identical vs the table variant).

    Each round runs TWO fused dual reductions
    (:func:`~gravomg_tpu.ops.blockdense.blockdense_minplus2`): the
    distance relaxation and the priority gate share one stream of the
    operator, halving the dominant M traffic of the former
    4-matvec round (and dropping the materialized zeroed copy of the
    operator, 2.6 GB at 1M).

    ``bd``/``bd_ovf``: optionally reuse a prebuilt
    :func:`~gravomg_tpu.coarsen.parents.graph_minplus_operator` (the
    builder shares one with parent assignment).  Returns
    (mask, invalid).
    """
    from gravomg_tpu.coarsen.parents import graph_minplus_operator
    from gravomg_tpu.ops.blockdense import blockdense_minplus2

    v = graph.num_vertices
    if bd is None:
        bd, bd_ovf = graph_minplus_operator(graph)
    elif bd_ovf is None:
        bd_ovf = jnp.bool_(False)

    # Distinct priorities for any V < 2^31 via monotone int->f32
    # bitcast (see fast_disc_sample_priority).
    perm = jax.random.permutation(jax.random.PRNGKey(seed), v)
    pr = jax.lax.bitcast_convert_type(
        perm.astype(jnp.int32) + jnp.int32(2 ** 23), jnp.float32)

    def round_body(state):
        status, _, it = state
        y = jnp.where(status == _SELECTED, 0.0, jnp.inf)
        gpr = jnp.where(status == _UNDECIDED, pr, jnp.inf)
        r1, u1 = blockdense_minplus2(bd, y, gpr, radius)
        r2, u2 = blockdense_minplus2(bd, r1, jnp.minimum(u1, gpr),
                                     radius)
        sel_conflict = (r1 < radius) | (r2 < radius)
        und = status == _UNDECIDED
        new = jnp.where(und & sel_conflict, _REJECTED,
                        jnp.where(und & ~(u2 < pr), _SELECTED,
                                  status)).astype(jnp.int8)
        return new, status, it + 1

    def cond(state):
        status, prev, it = state
        return (jnp.any(status == _UNDECIDED) & jnp.any(status != prev)
                & (it < max_rounds))

    init = (jnp.zeros((v,), jnp.int8), jnp.full((v,), -1, jnp.int8),
            jnp.int32(0))
    status, _, it = jax.lax.while_loop(cond, round_body, init)
    invalid = bd_ovf | jnp.any(status == _UNDECIDED)
    return status == _SELECTED, invalid


def fast_disc_sample(graph: Graph, radius, max_samples: int | None = None):
    """Host-facing wrapper: returns ascending selected indices (NumPy).

    Matches the return convention of the reference (`sampling.h:14-18`).
    The count is data-dependent, so this syncs to host -- hierarchy
    construction is staged (SURVEY.md §7); all solver paths stay jitted.
    """
    import numpy as np

    mask = np.asarray(fast_disc_sample_mask(graph, radius))
    sel = np.nonzero(mask)[0].astype(np.int32)
    if max_samples is not None:
        sel = sel[:max_samples]
    return sel
