"""Device-resident hierarchy construction: zero host synchronization.

Rationale: the staged builder (hierarchy.py) syncs sizes to the host
between levels, so every level waits for a device-to-host read before it
can enqueue the next.  This builder instead fixes all shapes **up front**
from a conservative static level plan and keeps every intermediate --
including data-dependent coarse counts -- on device as padded arrays
with dynamic validity masks.  Nothing is transferred until the caller
inspects the returned diagnostics, so the whole build is enqueued
without a host round trip.

Semantics are identical to the staged builder given sufficient caps:
real entries occupy validity-masked prefixes, phantoms are inert
(no edges, no children, zero U rows, identity Galerkin rows).  Cap
overflows are accumulated in a device-side diagnostics pytree; callers
check it once at the end (and fall back to the staged builder if it
fired).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.config import BuildCaps, DEFAULT_CAPS, MultigridConfig
from gravomg_tpu.types import (EllOperator, Graph, Prolongation,
                               INVALID_INDEX)
from gravomg_tpu.coarsen.sampling import (fast_disc_sample_bd,
                                          fast_disc_sample_mask,
                                          fast_disc_sample_priority,
                                          fast_disc_sample_rounds,
                                          prune_overflow,
                                          sampling_radius)
from gravomg_tpu.coarsen.parents import assign_parents, assign_parents_bd
from gravomg_tpu.coarsen.graph import coarse_graph, extract_coarse_edges
from gravomg_tpu.coarsen.placement import coarse_from_mean_of_fine_children
from gravomg_tpu.prolong.triangles import construct_voronoi_triangles
from gravomg_tpu.prolong.operator import (build_restriction,
                                          construct_prolongation)
from gravomg_tpu.solve.rap import galerkin_rap
from gravomg_tpu.solve.coarse import factor_coarse
from gravomg_tpu.solve.smoothers import ChebyshevParams
from gravomg_tpu.solve.vcycle import SolverHierarchy, SolverLevel
from gravomg_tpu.hierarchy import Hierarchy, LevelData, size_bucket
from gravomg_tpu.types import HierarchyStats


class LevelDiagnostics(NamedTuple):
    """Device-side per-level health flags; read once, at the end."""
    n_real: jax.Array           # () int32 actual coarse count
    cap_overflow: jax.Array     # () bool: coarse cap too small
    edge_overflow: jax.Array    # () bool: kc_cap too small
    tri_overflow: jax.Array     # () bool: triangle/assoc caps too small
    rap_overflow: jax.Array     # () bool: rap_cap too small
    point_fallbacks: jax.Array  # () int32
    sampling_undecided: jax.Array = np.bool_(False)  # rounds cap too small
    rt_overflow: jax.Array = np.bool_(False)  # U^T children cap too small
    bd_overflow: jax.Array = np.bool_(False)  # gather-free build caps


def rap_y_width_for_level(num_vertices: int, max_degree: int,
                          rap_y_width: int = DEFAULT_CAPS.rap_y_width
                          ) -> int:
    """Lane-merged Y width (distinct coarse columns per fine row of
    A U) for a level with ``num_vertices`` rows of degree
    ``max_degree``.

    A row can touch up to 3*(K+1) distinct coarse columns, but the
    measured requirement at 1M (scripts/diag_build1m.py, 2026-08-20)
    is far smaller and GROWS with depth: y_req_max = 18 / 23 / 25 /
    27 / 27 at transitions 0-4.  Width is expensive on the big level
    (phase-2 sort volume is 3*y_w*Vf and its triplet emission unrolls
    3*y_w HLO slices), so tier it: the finest level keeps the narrow
    default, mid levels get 32 (the old one-threshold rule kept 24
    down to 65k rows -- one short of the measured 25 at the 71k-row
    transition: a default-build failure at 1M), small levels go
    to the 3*(K+1) bound capped at 48 (an uncapped deep-level width
    compiled for tens of minutes).  Overflow past the pad is always
    detected (y_ovf -> diagnostics -> caller escalation); adequacy of
    this exact rule is pinned by tests/test_caps.py.
    """
    if num_vertices > 300_000:
        return rap_y_width
    if num_vertices > 16384:
        return max(rap_y_width, 32)
    return min(3 * (max_degree + 1), max(rap_y_width, 48))


def rap_cap_for_level(cap: int, rap_cap: int) -> int:
    """Effective Galerkin degree cap for a level with coarse cap ``cap``.

    Small/deep levels densify under the Galerkin product (hub cells
    couple many parents; measured >128 on a 170k torus at level 3), and
    a wider ELL there is nearly free (nc * degree words, and
    :func:`compact_solver` re-slices columns to the observed max
    afterwards).  Large levels keep the caller's ``rap_cap`` -- their
    degree is bounded by geometry and their row count makes width
    expensive.
    """
    if cap <= 2048:
        return cap - 1           # overflow-proof: degree <= nc - 1
    if cap <= 32768:
        return min(cap - 1, max(rap_cap, 256))
    return min(cap - 1, rap_cap)


def plan_levels(v: int, cfg: MultigridConfig,
                min_reduction: Optional[float] = None) -> List[int]:
    """Static coarse-size caps per level.

    Disc sampling selects an MIS of the radius-r conflict relation with
    r = cbrt(reduction_ratio) * mean_edge; the mean kNN edge length is
    itself ~2-3x the nearest-neighbor spacing (it averages over all K
    ring radii), so selected points sit >= ~2.5 spacings apart and the
    surface-area argument gives reductions of ~5-13x (measured: 7.6x on
    a 1M torus at the default ratio, K=16; similar on spheres/bunnies
    in the BASELINE configs).  The old flat min_reduction=2.5 planned a
    423808-row level-1 cap for a 131k-row real level at 1M -- and every
    level-1+ build stage pays the cap as its padded ROW count, a
    measured ~3.2x multiplier on the whole coarse tail of the build,
    plus the cap enters the level-0 Galerkin product as its coarse row
    count.  4.0 still carries ~1.9x headroom over the measured
    reduction; a pathological mesh that beats it surfaces as
    ``cap_overflow`` in :func:`check_diagnostics` (the nonzero
    compaction is size-clamped, never silent), and callers retry with
    escalated caps.
    """
    if min_reduction is None:
        min_reduction = DEFAULT_CAPS.min_reduction
    # Divide CAPS by min_reduction each level and estimate REAL rows as
    # cap / 2 for the stop test: measured per-level reductions are
    # ~3.9-4.2 on coarse graphs (the 1M bench levels), so a flat /4 cap
    # recursion holds the cap/real slack steady at ~2x.  (The earlier
    # cap[i+1] = cap[i] / 5 recursion shrank slack by 0.8x per level
    # and needed the huge 2.5-planned first cap to stay safe.)
    caps = []
    cap = v      # row bound of the current level (exact for level 0)
    est = v      # estimated REAL rows of the current level
    while est > cfg.coarse_threshold and len(caps) < cfg.max_levels - 1:
        nxt = size_bucket(max(int(cap / min_reduction), 8))
        if nxt >= cap:
            break
        caps.append(nxt)
        cap = nxt
        est = cap // 2
    return caps


def build_hierarchy_device(
        graph: Graph, fine_op: EllOperator,
        cfg: MultigridConfig = MultigridConfig(),
        level_caps: Optional[Sequence[int]] = None,
        kc_cap: Optional[int] = None, assoc_factor: Optional[int] = None,
        tri_factor: Optional[int] = None,
        rap_cap: Optional[int] = None,
        sampling_rounds: Optional[int] = None,
        sample_prune_cap: Optional[int] = None,
        gather_free: bool = True, exact_sampling: bool = False,
        sampling_seed: int = 0, sort_local: bool = False,
        rap_y_width: Optional[int] = None, chained_sampling: bool = True,
        rap_mode: str = "2phase", ece_local: bool = True,
        caps: Optional[BuildCaps] = None,
) -> Tuple[Hierarchy, List[LevelDiagnostics]]:
    """Build the hierarchy without a single device-to-host transfer.

    Returns (hierarchy, per-level diagnostics).  Call
    :func:`check_diagnostics` afterwards (it syncs) to validate caps.

    **Preconditions & semantics of the defaults.**  The default path
    (``gather_free=True``) requires the input cloud to be **spatially
    ordered** (e.g. ``points[morton_order(points)]``, see
    ``geometry/order.py``): the block-dense conflict/min-plus operators
    band only under index locality, and an unordered cloud overflows
    their windows -- surfaced as ``bd_overflow`` by
    :func:`check_diagnostics`, not as a wrong-but-silent result, but
    only if the caller checks.  The default sampling
    (``exact_sampling=False``) is a random-priority maximal independent
    set of the *same* conflict relation as the reference greedy
    (reference `src/sampling.cpp:7-53`) -- a valid disc sampling
    with identical spacing guarantees, but a *different hierarchy* than
    the reference's index-order greedy.  Pass ``exact_sampling=True``
    (or ``gather_free=False``) for reference-compatible coarsening.

    Cap defaults resolve from ``caps`` (default
    :data:`gravomg_tpu.config.DEFAULT_CAPS` -- the single source of
    truth, validated by tests/test_caps.py); explicit keyword arguments
    override individual fields.
    """
    caps = caps or DEFAULT_CAPS
    kc_cap = caps.kc_cap if kc_cap is None else kc_cap
    assoc_factor = (caps.assoc_factor if assoc_factor is None
                    else assoc_factor)
    tri_factor = caps.tri_factor if tri_factor is None else tri_factor
    rap_cap = caps.rap_cap if rap_cap is None else rap_cap
    rap_y_width = (caps.rap_y_width if rap_y_width is None
                   else rap_y_width)
    if level_caps is None:
        level_caps = plan_levels(graph.num_vertices, cfg,
                                 min_reduction=caps.min_reduction)

    # GRAVOMG_VERBOSE=1: stderr breadcrumb before each stage DISPATCH
    # (stages are async; on a device crash the last line names the
    # stage group in flight -- the only attribution available without
    # paying the D2H dispatch tax).
    import os as _os
    import sys as _sys
    if _os.environ.get("GRAVOMG_VERBOSE") == "1":
        def _note(msg):
            print(f"# build: {msg}", file=_sys.stderr, flush=True)
    else:
        def _note(msg):
            pass

    g = graph
    fine_valid = jnp.ones((graph.num_vertices,), bool)
    op = fine_op
    graphs = [graph]
    level_data: List[LevelData] = []
    ops = [fine_op]
    diags: List[LevelDiagnostics] = []

    for cap in level_caps:
        _note(f"level v={g.num_vertices} cap={cap}: sampling")
        radius = sampling_radius(g, cfg.reduction_ratio)
        bd_ovf = jnp.bool_(False)
        shared_bd = shared_bd_ovf = None
        if gather_free:
            # Conflict-operator sampling: rounds are block-dense
            # indicator matvecs, not per-round (V, Kr, Kr) re-gathers.
            # Requires a spatially ordered cloud; overflow joins the
            # deferred diagnostics (no sync).  Default is the random-
            # priority MIS (O(log V) rounds; a spatial order makes the
            # exact index-order fixpoint's chains run along the curve);
            # exact_sampling keeps the reference-greedy output.
            if exact_sampling:
                mask, s_undec = fast_disc_sample_bd(g, radius)
            elif chained_sampling:
                # Chained 1-hop gates: same MIS as the priority table
                # variant without the (V, kc) 2-hop conflict table (its
                # build + conversion measured 8 s of the 32 s 200k
                # build); the 1-hop min-plus operator is shared with
                # parent assignment below.
                from gravomg_tpu.coarsen.parents import \
                    graph_minplus_operator
                from gravomg_tpu.coarsen.sampling import \
                    fast_disc_sample_chained
                shared_bd, shared_bd_ovf = graph_minplus_operator(g)
                mask, s_undec = fast_disc_sample_chained(
                    g, radius, seed=sampling_seed, bd=shared_bd,
                    bd_ovf=shared_bd_ovf)
            else:
                mask, s_undec = fast_disc_sample_priority(
                    g, radius, seed=sampling_seed)
        else:
            # Radius-pruned conflict tables cut the dominant
            # (chunk, Kr, Kr) sampling cost quadratically.
            p_cap = (min(sample_prune_cap, g.max_degree)
                     if sample_prune_cap is not None else None)
            p_ovf = (prune_overflow(g, radius, p_cap)
                     if p_cap is not None else jnp.bool_(False))
            if sampling_rounds is not None:
                # Fixed short per-round launches instead of the fused
                # while_loop's single long launch at large V.
                mask, s_undec = fast_disc_sample_rounds(
                    g, radius, rounds=sampling_rounds, prune_cap=p_cap)
            else:
                mask = fast_disc_sample_mask(g, radius, prune_cap=p_cap)
                s_undec = jnp.bool_(False)
            s_undec = s_undec | p_ovf
        if gather_free:
            # Conflict-table overflow (kc_cap/k_prune/escape) and round
            # non-convergence belong to the gather-free machinery, not
            # to the sampling_rounds knob (unused on this path): route
            # them into bd_overflow so check_diagnostics names the
            # right caps.
            bd_ovf = bd_ovf | s_undec
            s_undec = jnp.bool_(False)
        mask = mask & fine_valid
        n_real = jnp.sum(mask).astype(jnp.int32)
        raw = jnp.nonzero(mask, size=cap, fill_value=g.num_vertices)[0]
        samples = jnp.where(raw < g.num_vertices, raw,
                            INVALID_INDEX).astype(jnp.int32)
        cap_overflow = n_real > cap

        if gather_free:
            _note("parents")
            parents, _, p_ovf2 = assign_parents_bd(
                g, samples, bd=shared_bd, bd_ovf=shared_bd_ovf)
            bd_ovf = bd_ovf | p_ovf2
        else:
            parents, _ = assign_parents(g, samples)
        if sort_local or ece_local:
            # Sort-local extraction: identical pattern contract
            # (lane merges over per-parent child groups instead of the
            # V*K global sort).  Independent of the sort-local RAP
            # below, which stays opt-in (its wide merge OOMs the
            # compiler at scale).
            from gravomg_tpu.coarsen.graph import \
                extract_coarse_edges_local
            columns, e_ovf = extract_coarse_edges_local(
                g, parents, cap, min(kc_cap, cap - 1),
                fine_valid=fine_valid, sync_retry=False)
        else:
            columns, e_ovf = extract_coarse_edges(
                g, parents, cap, min(kc_cap, cap - 1),
                fine_valid=fine_valid)
        _note("coarse edges + placement")
        coarse_points = coarse_from_mean_of_fine_children(
            g, parents, samples, fine_valid=fine_valid)
        cg = coarse_graph(columns, coarse_points)

        # Triangle caps: measured at 1M,
        # real triangles ~2x the real coarse count (cap already carries
        # ~2x slack) and per-vertex association counts are mean 4.4 /
        # max 31 at kc=48 -- while prolongation cost is LINEAR in the
        # assoc pad A (A=192 measured 6.7 s, A=32 1.2 s at 1M).  Both
        # caps overflow-flag through construct_voronoi_triangles into
        # the level diagnostics, so undershooting a pathological mesh
        # is a retry, never silence.
        t_max = tri_factor * cap
        a_max = assoc_factor * min(kc_cap, cap - 1)
        _note("voronoi triangles")
        triangles, t_ovf = construct_voronoi_triangles(cg, t_max, a_max)

        _note("prolongation")
        u, counts, p_ovf = construct_prolongation(
            g.points, parents, coarse_points, cg.neighbors, triangles,
            scheme=cfg.weighting)
        t_ovf = t_ovf | p_ovf
        u = u._replace(
            cols=jnp.where(fine_valid[:, None], u.cols, 0),
            weights=jnp.where(fine_valid[:, None], u.weights, 0.0))

        _note("galerkin rap")
        r_cap = rap_cap_for_level(cap, rap_cap)
        y_w = rap_y_width_for_level(op.num_vertices, op.max_degree,
                                    rap_y_width)
        if sort_local:
            # Sort-local two-phase RAP (solve/rap2.py): lane merges
            # instead of the 9*nnz global lexsort; same operator.
            # NOTE: its mc*yw-lane phase-2 merge OOMs the remote
            # compiler above ~100k rows -- small levels only.
            from gravomg_tpu.solve.rap2 import galerkin_rap_local
            coarse_op, r_ovf = galerkin_rap_local(
                op, u, r_cap, y_width=y_w,
                sync_retry=False)
        elif rap_mode == "2phase":
            # Lane-merged Y then ONE small sort (3*y_width*Vf vs the
            # stream mode's 9*K*Vf): the largest measured build stage
            # (11.6 s of the 32 s 200k build) shrinks ~3x in sort
            # volume.  Same operator up to f32 add order.
            from gravomg_tpu.solve.rap2 import galerkin_rap_2phase
            coarse_op, r_ovf = galerkin_rap_2phase(
                op, u, r_cap, y_width=y_w)
        else:
            coarse_op, r_ovf = galerkin_rap(op, u, r_cap)

        stats = HierarchyStats(
            n_fine=g.num_vertices, n_coarse=n_real,
            n_triangles=jnp.sum(triangles.mask),
            triangle_hits=counts[0], edge_fallbacks=counts[1],
            point_fallbacks=counts[2], radius=radius)
        level_data.append(LevelData(
            samples=samples, parents=parents, coarse=cg, u=u,
            stats=stats))
        diags.append(LevelDiagnostics(
            n_real=n_real, cap_overflow=cap_overflow, edge_overflow=e_ovf,
            tri_overflow=t_ovf, rap_overflow=r_ovf,
            point_fallbacks=counts[2], sampling_undecided=s_undec,
            bd_overflow=bd_ovf))
        graphs.append(cg)
        ops.append(coarse_op)
        fine_valid = samples != INVALID_INDEX
        g = cg
        op = coarse_op

    solver_levels = []
    for i, o in enumerate(ops):
        u = level_data[i].u if i < len(level_data) else None
        ut = None
        if u is not None:
            # Gather-form U^T with a static children cap (no sync; the
            # overflow flag joins the deferred diagnostics).  The mean
            # children count is 3 * Vf / n_real; hub cells run ~3.5x
            # the mean (measured max 26 children at mean 7.6), so the
            # cap uses a 12x headroom factor over the padded-size mean.
            hr = caps.children_headroom
            cap = min(-(-max(8, hr * 3 * u.n_fine // u.n_coarse) // 8)
                      * 8, u.n_fine)
            _note("restriction")
            ut, rt_ovf = build_restriction(u, cap)
            diags[i] = diags[i]._replace(rt_overflow=rt_ovf)
        cheb = (ChebyshevParams.from_operator(o, cfg.chebyshev_ratio)
                if cfg.smoother == "chebyshev" else None)
        solver_levels.append(SolverLevel(op=o, u=u, cheb=cheb, ut=ut))
    _note("coarse factorization")
    chol = factor_coarse(ops[-1])
    solver = SolverHierarchy(levels=tuple(solver_levels), coarse_chol=chol)
    return (Hierarchy(graphs=tuple(graphs), levels=tuple(level_data),
                      solver=solver), diags)


def compact_solver(solver: SolverHierarchy,
                   diags: Sequence[LevelDiagnostics],
                   row_multiple: int = 256,
                   col_multiple: int = 8) -> SolverHierarchy:
    """Slice the solver hierarchy down to tight per-level buckets.

    The device-resident builder plans conservative static caps
    (plan_levels, ~2.5x reduction) while disc sampling actually reduces
    by ~4-13x, so coarse levels carry up to ~3x phantom rows and padded
    96-wide operators -- wasted SpMV work in every cycle.  Because real
    coarse vertices always occupy a slot *prefix* (samples come from
    ``jnp.nonzero(..., size=cap)``) and every ELL row keeps its valid
    entries in an ascending prefix, compaction is pure slicing:

      * rows of each coarse operator / U / U^T to the real count
        (rounded up to ``row_multiple``; phantom rows are decoupled
        identity rows so keeping a few is harmless),
      * ELL columns to the observed max degree (rounded to
        ``col_multiple``),
      * the dense Cholesky factor to its leading block -- valid because
        phantoms are decoupled identity rows, making the padded operator
        block-diagonal ``[[A_real, 0], [0, I]]``.

    Syncs the diagnostics (n_real + per-level degree counts) to the
    host: call after the performance-critical build phase.  The returned
    hierarchy gives identical V-cycle results on real rows (phantom rows
    never couple to real ones) at a fraction of the per-cycle FLOPs.
    """
    def r_up(x, m):
        return -(-x // m) * m

    levels = list(solver.levels)
    n_levels = len(levels)
    # Tight row counts per level (level 0 = fine, never padded).
    rows = [levels[0].op.num_vertices]
    for d in diags:
        rows.append(int(d.n_real))
    rows = rows[:n_levels]
    tight = [rows[0]] + [
        min(r_up(r, row_multiple), levels[i + 1].op.num_vertices)
        for i, r in enumerate(rows[1:])]

    new_levels = []
    for i, lvl in enumerate(levels):
        t = tight[i]
        op = lvl.op
        valid_counts = jnp.sum(op.mask[:t], axis=1)
        d_max = int(jnp.max(valid_counts))
        kd = min(r_up(max(d_max, 1), col_multiple), op.max_degree)
        op = EllOperator(neighbors=op.neighbors[:t, :kd],
                         offdiag=op.offdiag[:t, :kd],
                         diag=op.diag[:t])
        u = lvl.u
        ut = lvl.ut
        if u is not None:
            tc = tight[i + 1]
            u = Prolongation(cols=u.cols[:t], weights=u.weights[:t],
                             n_coarse=tc)
            if ut is not None:
                c_max = int(jnp.max(jnp.sum(ut.mask[:tc], axis=1)))
                kc = min(r_up(max(c_max, 1), col_multiple),
                         ut.max_children)
                ut = ut._replace(rows=ut.rows[:tc, :kc],
                                 weights=ut.weights[:tc, :kc],
                                 n_fine=t)
        new_levels.append(lvl._replace(op=op, u=u, ut=ut))

    tl = tight[-1]
    chol = solver.coarse_chol[:tl, :tl]
    return SolverHierarchy(levels=tuple(new_levels), coarse_chol=chol)


def check_diagnostics(diags: Sequence[LevelDiagnostics]) -> None:
    """Validate cap adequacy.  This syncs to host -- call only after all
    performance-critical work is done."""
    for i, d in enumerate(diags):
        problems = []
        if bool(d.cap_overflow):
            problems.append(f"coarse cap < real count {int(d.n_real)}")
        if bool(d.edge_overflow):
            problems.append("coarse-degree cap (kc_cap) overflow")
        if bool(d.tri_overflow):
            problems.append("triangle/assoc cap overflow")
        if bool(d.rap_overflow):
            problems.append(
                "Galerkin cap overflow (rap_cap degree pad or the "
                "rap_y_width lane-merge pad -- the flag covers both)")
        if bool(d.sampling_undecided):
            problems.append("sampling_rounds too small (undecided left)")
        if bool(d.rt_overflow):
            problems.append("U^T children cap overflow")
        if bool(d.bd_overflow):
            problems.append(
                "gather-free build invalid: conflict/min-plus "
                "block-dense caps overflowed or sampling rounds did "
                "not converge -- raise kc_cap / escape_cap / nw, and "
                "check the cloud is spatially (Morton) ordered")
        if problems:
            raise RuntimeError(
                f"device-resident build level {i}: " + "; ".join(problems)
                + " -- raise the caps or use the staged builder")
