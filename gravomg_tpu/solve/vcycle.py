"""V-cycle driver over a multigrid hierarchy (SURVEY.md CS-5).

The hierarchy is a static pytree of per-level operators and prolongation
operators; the V-cycle unrolls over it inside one jit trace with padded
fixed shapes (BASELINE.json north star).  Smoother selection is static
(compile-time), matching the config-dataclass design of SURVEY.md §5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.compile_cache import run_concurrently
from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.types import EllOperator, Prolongation, Restriction
from gravomg_tpu.solve.spmv import spmv
from gravomg_tpu.solve.smoothers import (ChebyshevParams, chebyshev,
                                         weighted_jacobi)
from gravomg_tpu.solve.coarse import coarse_solve


class SolverLevel(NamedTuple):
    op: EllOperator
    u: Optional[Prolongation]           # maps next-coarser level -> this one
    cheb: Optional[ChebyshevParams]
    # Gather-form U^T (children table).  Optional: scatter-form restrict
    # is the fallback; the hot path wants this populated (a fixed-shape
    # gather + row reduce instead of a scatter-add).
    ut: Optional[Restriction] = None
    # Window-form operators (ops/blockdense.py, ops/slab.py), built by
    # attach_slab_operators / attach_fast_operators for spatially
    # ordered hierarchies.  When present they replace the ELL gather
    # matvec/transfers for 1-D vectors.
    banded: Optional["BlockDenseOperator"] = None   # A_l   # noqa: F821
    uw: Optional["BlockDenseOperator"] = None       # U     # noqa: F821
    utw: Optional["BlockDenseOperator"] = None      # U^T   # noqa: F821


def apply_fast(op, x: jax.Array) -> jax.Array:
    """Dispatch a fast-form operator (uniform block-dense or bucketed
    slab) on a 1-D vector."""
    from gravomg_tpu.ops.blockdense import (BlockDenseOperator,
                                            blockdense_matvec)
    from gravomg_tpu.ops.slab import SlabOperator, slab_matvec
    if isinstance(op, SlabOperator):
        return slab_matvec(op, x)
    return blockdense_matvec(op, x)


def level_matvec(level: SolverLevel, x: jax.Array) -> jax.Array:
    """A_l @ x through the fastest available representation."""
    if level.banded is not None and x.ndim == 1:
        return apply_fast(level.banded, x)
    return spmv(level.op, x)


class SolverHierarchy(NamedTuple):
    levels: Tuple[SolverLevel, ...]
    coarse_chol: jax.Array


def _smooth(level: SolverLevel, x, b, iters: int, cfg: MultigridConfig,
            x0_zero: bool = False):
    mv = None
    if level.banded is not None and x.ndim == 1:
        mv = functools.partial(level_matvec, level)
    if cfg.smoother == "chebyshev":
        return chebyshev(level.op, x, b, level.cheb, cfg.chebyshev_degree,
                         mv=mv, x0_zero=x0_zero)
    return weighted_jacobi(level.op, x, b, iters, cfg.jacobi_omega, mv=mv,
                           x0_zero=x0_zero)


def _restrict_level(level: SolverLevel, r: jax.Array,
                    one_d: bool) -> jax.Array:
    """U^T r through the fastest available representation."""
    from gravomg_tpu.prolong.operator import restrict, restrict_gather
    if level.utw is not None and one_d:
        return apply_fast(level.utw, r)
    if level.ut is not None:
        return restrict_gather(level.ut, r)
    return restrict(level.u, r)


def _prolong_level(level: SolverLevel, ec: jax.Array,
                   one_d: bool) -> jax.Array:
    """U ec through the fastest available representation."""
    from gravomg_tpu.prolong.operator import prolong
    if level.uw is not None and one_d:
        return apply_fast(level.uw, ec)
    return prolong(level.u, ec)


def _descend(h: SolverHierarchy, lvl: int, x: jax.Array, b: jax.Array,
             cfg: MultigridConfig, one_d: bool,
             x0_zero: bool = False) -> jax.Array:
    """One multigrid cycle starting (and ending) at level ``lvl``."""
    level = h.levels[lvl]
    if lvl == len(h.levels) - 1:
        return coarse_solve(h.coarse_chol, b)
    x = _smooth(level, x, b, cfg.pre_smooth, cfg, x0_zero=x0_zero)
    if level.banded is not None and one_d:
        r = b - level_matvec(level, x)
    else:
        r = b - spmv(level.op, x)
    rc = _restrict_level(level, r, one_d)
    # Coarse corrections always start from zero: x0_zero saves their
    # pre-smooth's first matvec (A 0 = 0, bit-exact).
    ec = _descend(h, lvl + 1, jnp.zeros_like(rc), rc, cfg, one_d,
                  x0_zero=True)
    # gamma-cycle: revisit the coarser level gamma-1 more times,
    # continuing from the previous correction (gamma=2 is the W-cycle).
    # Repeats directly above the coarsest level are skipped -- the
    # Cholesky solve there is exact, so they would be no-ops.
    if lvl + 1 < len(h.levels) - 1:
        for _ in range(cfg.cycle_gamma - 1):
            ec = _descend(h, lvl + 1, ec, rc, cfg, one_d)
    x = x + _prolong_level(level, ec, one_d)
    return _smooth(level, x, b, cfg.post_smooth, cfg)


def v_cycle(h: SolverHierarchy, x: jax.Array, b: jax.Array,
            cfg: MultigridConfig, x0_zero: bool = False) -> jax.Array:
    """One cycle on the finest level: V(pre, post) by default,
    W-cycle and deeper gamma-cycles via ``cfg.cycle_gamma``.

    ``x0_zero=True`` (static) asserts ``x`` is exactly zero -- the
    preconditioner pattern z = M^{-1} r -- and saves the fine pre-
    smooth's first matvec (bit-exact; see solve/smoothers.py)."""
    return _descend(h, 0, x, b, cfg, x.ndim == 1, x0_zero=x0_zero)


def fmg(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
        cycles_per_level: int = 1) -> jax.Array:
    """Full multigrid (F-cycle): nested iteration from the coarsest
    level up, ``cycles_per_level`` gamma-cycles after each refinement.

    Restricts b down the hierarchy, solves exactly on the coarsest
    level, then alternates prolongation with cycles at every level.
    One FMG pass costs about twice a V-cycle and lands within the
    smooth-error floor of A^{-1}b -- use it as the initial guess for
    :func:`gravomg_tpu.mg_pcg` / :func:`solve` to save early
    iterations.  The standard nested-iteration construction; the
    reference has no solver (SURVEY.md §0), so there is no semantic
    contract to match here.
    """
    one_d = b.ndim == 1
    bs = [b]
    for level in h.levels[:-1]:
        bs.append(_restrict_level(level, bs[-1], one_d))
    x = coarse_solve(h.coarse_chol, bs[-1])
    for lvl in range(len(h.levels) - 2, -1, -1):
        x = _prolong_level(h.levels[lvl], x, one_d)
        for _ in range(cycles_per_level):
            x = _descend(h, lvl, x, bs[lvl], cfg, one_d)
    return x


import functools


def attach_restrictions(h: SolverHierarchy,
                        max_children: Optional[int] = None,
                        _sync: bool = True) -> SolverHierarchy:
    """Populate every level's gather-form U^T table.

    Host-level: reads the overflow flag and retries with a doubled
    children cap (staged doubling) until the table fits.  ``max_children``
    seeds the cap; default is 4x the mean children count (3 entries per
    fine vertex spread over n_coarse), rounded to a multiple of 8.
    """
    from gravomg_tpu.prolong.operator import build_restriction

    levels = []
    for lvl in h.levels:
        if lvl.u is None or lvl.ut is not None:
            levels.append(lvl)
            continue
        vf, nc = lvl.u.n_fine, lvl.u.n_coarse
        cap = max_children or max(8, -(-4 * 3 * vf // nc))
        cap = min(-(-cap // 8) * 8, vf)
        rt, ovf = build_restriction(lvl.u, cap)
        while _sync and bool(ovf) and cap < vf:
            cap = min(2 * cap, vf)
            rt, ovf = build_restriction(lvl.u, cap)
        levels.append(lvl._replace(ut=rt))
    return h._replace(levels=tuple(levels))


def attach_fast_operators(h: SolverHierarchy,
                          block: int = 256, window: int = 128,
                          dtype=None,
                          escape_cap: Optional[int] = None,
                          trim: bool = True,
                          geometry: Optional[dict] = None,
                          used_geometry: Optional[dict] = None
                          ) -> SolverHierarchy:
    """Populate gather-free block-dense operator forms on every level.

    Requires a spatially (e.g. Morton) ordered hierarchy -- coarse
    levels inherit the fine order, so all levels band.  Window
    geometry: a wide window 0 covering each row block's diagonal band
    plus several narrow (``window``-wide) far windows for fold
    clusters; retries with more far windows / larger escape capacity
    on overflow (host-level).  The coarsest level keeps only its dense
    factor (no smoothing there).  ``dtype`` optionally down-casts the
    dense window matrices (e.g. bf16 for the V-cycle preconditioner);
    default keeps the operator dtype (exact: same products, different
    add order).

    Collection hooks (parallel/batch.py::attach_collection): ``trim``
    False keeps the full escape-chute capacity so shapes are a pure
    function of the (nw, cap) geometry; ``geometry`` maps
    ``(level, slot)`` -> (nw, cap) floors for the retry loop (slots:
    "a", "u", "ut"); ``used_geometry`` (a dict) receives the final
    (nw, cap) each conversion settled on.
    """
    from gravomg_tpu.ops.blockdense import (block_anchors,
                                            blockdense_from_ell,
                                            blockdense_from_operator)
    from gravomg_tpu.types import INVALID_INDEX

    def convert(build, *args, start_nw, start_cap, key, **kw):
        from gravomg_tpu.ops.blockdense import trim_escape
        cur_nw, cap = (geometry or {}).get(key, (start_nw, start_cap))
        cur_nw, cap = max(cur_nw, start_nw), max(cap, start_cap)
        while True:
            bop, ovf = build(*args, nw=cur_nw, escape_cap=cap, **kw)
            if not bool(ovf):
                break
            cur_nw = min(cur_nw + 2, 24)
            cap = cap * 4
        if used_geometry is not None:
            used_geometry[key] = (cur_nw, cap)
        if trim:
            # Drop empty chute padding: static escape slots cost a
            # gather each per matvec whether filled or not (host sync,
            # fine here).  Skipped for collections, where shapes must be
            # a function of geometry alone.
            bop = trim_escape(bop)
        if dtype is not None:
            bop = bop._replace(m=bop.m.astype(dtype))
        return bop

    jobs, slots = [], []
    for li, lvl in enumerate(h.levels):
        v = lvl.op.num_vertices
        blk = min(block, max(v // 8, 8))
        if (lvl.banded is not None or lvl.uw is not None
                or lvl.utw is not None):
            # Already populated (e.g. by attach_slab_operators for the
            # large levels) -- leave as-is.
            continue
        if li < len(h.levels) - 1:
            # Diagonal band: block +- 2*block covers the near spread.
            w0 = min(-(-3 * blk // 128) * 128, v)
            jobs.append(functools.partial(
                convert, blockdense_from_operator, lvl.op, start_nw=6,
                start_cap=escape_cap or max(1024, v // 8),
                key=(li, "a"),
                block=blk, window=min(window, v), window0=w0))
            slots.append((li, "banded"))
        if lvl.u is not None:
            u = lvl.u
            nc = u.n_coarse
            # U columns cluster around row/ratio: a block of BLK fine
            # rows spans ~BLK/ratio coarse columns plus cell adjacency.
            ratio = max(u.n_fine // max(nc, 1), 1)
            w0 = min(-(-max(4 * blk // ratio, 128) // 64) * 64, nc)
            anch = block_anchors(u.cols, jnp.ones_like(u.cols, bool),
                                 blk)
            jobs.append(functools.partial(
                convert, blockdense_from_ell, u.cols, u.weights,
                jnp.ones_like(u.cols, bool), nc,
                start_nw=4,
                start_cap=escape_cap or max(1024, u.n_fine // 16),
                key=(li, "u"),
                block=blk, window=min(window, nc), window0=w0,
                anchors=anch))
            slots.append((li, "uw"))
        if lvl.ut is not None:
            rt = lvl.ut
            # A block of coarse rows spans ~block*ratio fine columns.
            ratio = max(rt.n_fine // max(rt.n_coarse, 1), 1)
            blk_r = min(64, max(rt.n_coarse // 8, 8))
            w0 = min(-(-3 * blk_r * ratio // 128) * 128, rt.n_fine)
            vmask = rt.rows != INVALID_INDEX
            anch = block_anchors(rt.safe_rows(), vmask, blk_r)
            jobs.append(functools.partial(
                convert, blockdense_from_ell, rt.safe_rows(), rt.weights,
                vmask, rt.n_fine,
                start_nw=4,
                start_cap=escape_cap or max(1024, rt.n_coarse),
                key=(li, "ut"),
                block=blk_r, window=min(window, rt.n_fine),
                window0=w0, anchors=anch))
            slots.append((li, "utw"))
    return _fill_levels(h, slots, run_concurrently(jobs))


def _fill_levels(h: SolverHierarchy, slots, results) -> SolverHierarchy:
    """Set ``results[i]`` into field ``slots[i] = (level, name)``."""
    levels = list(h.levels)
    for (li, field), res in zip(slots, results):
        levels[li] = levels[li]._replace(**{field: res})
    return h._replace(levels=tuple(levels))


def attach_slab_operators(h: SolverHierarchy,
                          block: int = 8, window: int = 128,
                          dtype=None, min_rows: int = 4096,
                          escape_cap: int = 65536) -> SolverHierarchy:
    """Populate bucketed variable-window (slab) operator forms on every
    level large enough to profit (ops/slab.py).

    The uniform block-dense format must size every block for the p99
    window-count tail (~13 windows vs a median of ~3 at 200k,
    scripts/analyze_spread.py), ~1.1 GB of level-0 window matrix at ~1%
    density; the slab form pays only for the windows each block needs
    (~280 MB).  Levels below ``min_rows`` keep whatever they have
    -- run :func:`attach_fast_operators` afterwards to fill those with
    uniform forms (it skips already-populated levels).

    Host-interactive (syncs per-block window counts); call post
    ``check_diagnostics``/``compact_solver`` like attach_fast_operators.
    Requires a spatially (Morton) ordered hierarchy.
    """
    from gravomg_tpu.ops.slab import slab_from_ell, slab_from_operator
    from gravomg_tpu.types import INVALID_INDEX

    def convert(build, *args, **kw):
        # Escape capacity scales with problem size, not a fixed guess;
        # retry with 4x on overflow (mirrors attach_fast_operators).
        # Returns None if the slab form can't cover the block windows
        # (pathological ordering) -- the caller leaves the level for
        # attach_fast_operators' uniform path.
        cap = escape_cap
        for _ in range(4):
            try:
                return build(*args, escape_cap=cap, dtype=dtype,
                             block=block, window=window, **kw)
            except ValueError as e:
                if "escape overflow" in str(e):
                    cap *= 4
                    continue
                return None
        return None

    jobs, slots = [], []
    for li, lvl in enumerate(h.levels):
        if li < len(h.levels) - 1 and lvl.op.num_vertices >= min_rows:
            jobs.append(functools.partial(convert, slab_from_operator,
                                          lvl.op))
            slots.append((li, "banded"))
        if lvl.u is not None and lvl.u.n_fine >= min_rows \
                and lvl.u.n_coarse >= window:
            u = lvl.u
            jobs.append(functools.partial(
                convert, slab_from_ell, u.cols, u.weights,
                jnp.ones_like(u.cols, bool), u.n_coarse))
            slots.append((li, "uw"))
        if lvl.ut is not None and lvl.ut.n_coarse >= min_rows:
            rt = lvl.ut
            vmask = rt.rows != INVALID_INDEX
            jobs.append(functools.partial(
                convert, slab_from_ell, rt.safe_rows(), rt.weights, vmask,
                rt.n_fine))
            slots.append((li, "utw"))
    # Conversions are independent and compile-bound; they run
    # concurrently so their compiles overlap.
    return _fill_levels(h, slots, run_concurrently(jobs))


def attach_operators(h: SolverHierarchy, dtype=None,
                     slab_min_rows: int = 4096) -> SolverHierarchy:
    """The blessed single-chip attach path (docs/DESIGN.md §7): slab
    forms on levels >= ``slab_min_rows`` rows, uniform block-dense on
    the rest.  Order matters and is encapsulated here: slab first
    (claims the large levels), uniform second (fills what is left --
    it skips populated levels).  Under sharding use
    ``parallel.halo.halo_shard_solver`` instead."""
    h = attach_slab_operators(h, dtype=dtype, min_rows=slab_min_rows)
    return attach_fast_operators(h, dtype=dtype)


def cast_fast_operators(h: SolverHierarchy, dtype) -> SolverHierarchy:
    """Cheap copy of a fast-operator hierarchy with the dense window
    matrices cast to ``dtype`` (e.g. bf16 for preconditioner duty;
    halves the bytes of the window matrices).  Diagonals, escape chutes,
    and the exact ELL operators keep their precision."""
    from gravomg_tpu.ops.slab import SlabOperator

    def cast(bop):
        if isinstance(bop, SlabOperator):
            return bop._replace(buckets=tuple(
                b._replace(m=b.m.astype(dtype)) for b in bop.buckets))
        return bop._replace(m=bop.m.astype(dtype))

    levels = []
    for lvl in h.levels:
        new = lvl
        for field in ("banded", "uw", "utw"):
            bop = getattr(lvl, field)
            if bop is not None:
                new = new._replace(**{field: cast(bop)})
        levels.append(new)
    return h._replace(levels=tuple(levels))


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
          x0: Optional[jax.Array] = None):
    """Stationary V-cycle iteration to cfg.tolerance relative residual.

    Returns (x, relative_residual, iterations).  Jitted with the
    hierarchy as an argument (closure-captured arrays would be baked as
    HLO constants and re-materialized per call) and the frozen config as
    a static argument; the iteration runs in a while_loop with a
    residual-based exit.
    """
    a0 = h.levels[0].op
    if x0 is None:
        x0 = jnp.zeros_like(b)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)

    def cond(state):
        x, it, rel = state
        return (rel > cfg.tolerance) & (it < cfg.max_cycles)

    def body(state):
        x, it, _ = state
        x = v_cycle(h, x, b, cfg)
        rel = jnp.linalg.norm(b - level_matvec(h.levels[0], x)) / bnorm
        return x, it + 1, rel

    rel0 = jnp.linalg.norm(b - level_matvec(h.levels[0], x0)) / bnorm
    x, it, rel = jax.lax.while_loop(cond, body, (x0, jnp.int32(0), rel0))
    return x, rel, it


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve_with_history(h: SolverHierarchy, b: jax.Array,
                       cfg: MultigridConfig):
    """Like :func:`solve`, additionally returning the per-cycle relative
    residual trace (length cfg.max_cycles, +inf beyond convergence) --
    the solver-observability surface SURVEY.md §5 calls for."""
    a0 = h.levels[0].op
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)
    hist0 = jnp.full((cfg.max_cycles,), jnp.inf, b.dtype)

    def cond(state):
        x, it, rel, hist = state
        return (rel > cfg.tolerance) & (it < cfg.max_cycles)

    def body(state):
        x, it, _, hist = state
        x = v_cycle(h, x, b, cfg)
        rel = jnp.linalg.norm(b - level_matvec(h.levels[0], x)) / bnorm
        return x, it + 1, rel, hist.at[it].set(rel)

    x0 = jnp.zeros_like(b)
    rel0 = jnp.linalg.norm(b) / bnorm
    x, it, rel, hist = jax.lax.while_loop(
        cond, body, (x0, jnp.int32(0), rel0, hist0))
    return x, rel, it, hist


@functools.partial(jax.jit, static_argnames=("cfg", "inner_cycles"))
def solve_refined(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
                  inner_cycles: int = 2):
    """Mixed-precision solve: f64 residual accumulation around f32
    V-cycle corrections (iterative refinement).

    The reference is f64 throughout (SURVEY.md §2.2); here the hot path
    (smoothing, SpMV, transfers) runs in f32 while only the outer
    residual r = b - A x and the solution accumulate in f64.  This
    reaches the BASELINE 1e-8 relative-residual target at f32 kernel
    speed; requires x64 enabled.

    Returns (x (f64), relative_residual, outer_iterations).
    """
    a0 = h.levels[0].op
    a0_64 = EllOperator(a0.neighbors, a0.offdiag.astype(jnp.float64),
                        a0.diag.astype(jnp.float64))
    b64 = b.astype(jnp.float64)
    bnorm = jnp.maximum(jnp.linalg.norm(b64), 1e-300)

    def inner(r32):
        x = v_cycle(h, jnp.zeros_like(r32), r32, cfg, x0_zero=True)
        for _ in range(inner_cycles - 1):
            x = v_cycle(h, x, r32, cfg)
        return x

    def cond(state):
        x, it, rel = state
        return (rel > cfg.tolerance) & (it < cfg.max_cycles)

    def body(state):
        x, it, _ = state
        r = b64 - spmv(a0_64, x)
        d = inner(r.astype(jnp.float32))
        x = x + d.astype(jnp.float64)
        rel = jnp.linalg.norm(b64 - spmv(a0_64, x)) / bnorm
        return x, it + 1, rel

    x0 = jnp.zeros_like(b64)
    state = (x0, jnp.int32(0), jnp.float64(jnp.inf))
    x, it, rel = jax.lax.while_loop(cond, body, state)
    return x, rel, it
