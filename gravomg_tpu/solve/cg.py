"""Conjugate gradients, optionally preconditioned by one V-cycle
(MG-preconditioned CG, BASELINE.json configs 2-4)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.types import EllOperator
from gravomg_tpu.solve.spmv import spmv
from gravomg_tpu.solve.vcycle import SolverHierarchy, v_cycle


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Inner product at full f32 (no TF32 passes): the 1e-8 target is
    certified through these."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def pcg(op: EllOperator, b: jax.Array,
        precond: Callable[[jax.Array], jax.Array],
        tol: float = 1e-8, max_iters: int = 500,
        x0: Optional[jax.Array] = None,
        mv: Optional[Callable[[jax.Array], jax.Array]] = None
        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Preconditioned CG.  Returns (x, relative_residual, iterations).

    ``mv`` overrides the operator matvec (banded gather-free form)."""
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    if x0 is None:
        x0 = jnp.zeros_like(b)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)
    r0 = b - mv(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = _dot(r0, z0)

    def cond(state):
        x, r, z, p, rz, it, rel = state
        return (rel > tol) & (it < max_iters)

    def body(state):
        x, r, z, p, rz, it, _ = state
        ap = mv(p)
        tiny = jnp.asarray(jnp.finfo(rz.dtype).tiny, rz.dtype)
        alpha = rz / jnp.maximum(_dot(p, ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.maximum(rz, tiny)
        p = z + beta * p
        rel = jnp.linalg.norm(r) / bnorm
        return x, r, z, p, rz_new, it + 1, rel

    rel0 = jnp.linalg.norm(r0) / bnorm
    state = (x0, r0, z0, p0, rz0, jnp.int32(0), rel0)
    x, _, _, _, _, it, rel = jax.lax.while_loop(cond, body, state)
    return x, rel, it


def fcg(op: EllOperator, b: jax.Array,
        precond: Callable[[jax.Array], jax.Array],
        tol: float = 1e-8, max_iters: int = 500,
        x0: Optional[jax.Array] = None,
        mv: Optional[Callable[[jax.Array], jax.Array]] = None
        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Flexible preconditioned CG (Notay's FCG / IPCG).

    Identical to :func:`pcg` except the direction update uses the
    Polak-Ribiere form  beta = z_{k+1}.(r_{k+1} - r_k) / (z_k.r_k),
    which re-orthogonalizes against the previous direction and stays
    convergent when the preconditioner varies between iterations or is
    only approximately symmetric -- e.g. a bf16 V-cycle, whose rounding
    makes M slightly nonsymmetric and iteration-dependent.  Fixed-beta
    PCG diverged under that violation (measured at 200k);
    FCG costs one extra dot product per iteration.

    Returns (x, relative_residual, iterations).
    """
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    if x0 is None:
        x0 = jnp.zeros_like(b)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-30)
    r0 = b - mv(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = _dot(r0, z0)

    def cond(state):
        x, r, z, p, rz, it, rel = state
        return (rel > tol) & (it < max_iters)

    def body(state):
        x, r, z, p, rz, it, _ = state
        ap = mv(p)
        tiny = jnp.asarray(jnp.finfo(rz.dtype).tiny, rz.dtype)
        alpha = rz / jnp.maximum(_dot(p, ap), tiny)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        rz_new = _dot(r_new, z)
        # Polak-Ribiere: subtract the stale-residual component so the
        # new direction is A-orthogonal to p even when M changed.
        beta = (rz_new - _dot(r, z)) / jnp.maximum(rz, tiny)
        p = z + beta * p
        rel = jnp.linalg.norm(r_new) / bnorm
        return x, r_new, z, p, rz_new, it + 1, rel

    rel0 = jnp.linalg.norm(r0) / bnorm
    state = (x0, r0, z0, p0, rz0, jnp.int32(0), rel0)
    x, _, _, _, _, it, rel = jax.lax.while_loop(cond, body, state)
    return x, rel, it


import functools


@functools.partial(jax.jit, static_argnames=("cfg",))
def mg_fcg(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
           x0: Optional[jax.Array] = None,
           h_outer: Optional[SolverHierarchy] = None):
    """Flexible CG preconditioned by one V-cycle on ``h``.

    The flexible update makes a reduced-precision (bf16) V-cycle a
    usable preconditioner: pass the bf16-cast hierarchy as ``h`` and
    the exact one as ``h_outer`` (CG's own matvec and residuals stay
    f32).  See :func:`fcg`."""
    import functools as _ft

    from gravomg_tpu.solve.vcycle import level_matvec
    outer = h_outer if h_outer is not None else h
    op = outer.levels[0].op

    def precond(r):
        return v_cycle(h, jnp.zeros_like(r), r, cfg,
                       x0_zero=True).astype(r.dtype)

    return fcg(op, b, precond, tol=cfg.tolerance,
               max_iters=cfg.max_cycles, x0=x0,
               mv=_ft.partial(level_matvec, outer.levels[0]))


def mg_solve(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
             x0: Optional[jax.Array] = None):
    """Default MG-accelerated solve to ``cfg.tolerance``.

    Below ``cfg.bf16_threshold`` fine rows: f32 MG-PCG (fewer
    iterations win at small scale).  At or above it, when fast-form
    operators are attached: flexible CG preconditioned by a bf16-cast
    V-cycle -- halves the bytes of the window matrices; CG's own
    matvec and residuals stay f32 on the exact operators.  Returns
    (x, relative_residual, iterations).
    """
    from gravomg_tpu.solve.vcycle import cast_fast_operators

    lvl0 = h.levels[0]
    has_fast = lvl0.banded is not None
    if lvl0.op.num_vertices >= cfg.bf16_threshold and has_fast:
        h16 = cast_fast_operators(h, jnp.bfloat16)
        return mg_fcg(h16, b, cfg, x0=x0, h_outer=h)
    return mg_pcg(h, b, cfg, x0=x0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def mg_pcg(h: SolverHierarchy, b: jax.Array, cfg: MultigridConfig,
           x0: Optional[jax.Array] = None,
           h_outer: Optional[SolverHierarchy] = None):
    """CG on the finest operator, preconditioned by one V-cycle.

    Jitted with the hierarchy as an argument and the config static.
    ``h_outer`` optionally supplies a higher-precision fine operator for
    CG's own matvec while ``h`` runs the (bf16-tolerant) preconditioner
    -- CG absorbs preconditioner error but needs the true residual."""
    import functools as _ft

    from gravomg_tpu.solve.vcycle import level_matvec
    outer = h_outer if h_outer is not None else h
    op = outer.levels[0].op

    def precond(r):
        return v_cycle(h, jnp.zeros_like(r), r, cfg,
                       x0_zero=True).astype(r.dtype)

    return pcg(op, b, precond, tol=cfg.tolerance,
               max_iters=cfg.max_cycles, x0=x0,
               mv=_ft.partial(level_matvec, outer.levels[0]))
