"""Smoothers: weighted Jacobi and Chebyshev (BASELINE.json north star).

Absent from the reference fork (SURVEY.md §0); standard multigrid
components driven by the hierarchy's operators.  Both are branch-free
fixed-shape iterations (fori_loop) suitable for jit/vmap/pjit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import EllOperator
from gravomg_tpu.solve.spmv import spmv


def weighted_jacobi(op: EllOperator, x: jax.Array, b: jax.Array,
                    iterations: int, omega: float = 2.0 / 3.0,
                    mv=None, x0_zero: bool = False) -> jax.Array:
    """x <- x + omega D^{-1} (b - A x), ``iterations`` times.

    ``mv`` overrides the matvec (e.g. the banded gather-free SpMV);
    defaults to the ELL gather form.  ``x0_zero=True`` (static) asserts
    the incoming ``x`` is exactly zero and skips the first iteration's
    matvec (A 0 = 0 bit-exactly): every coarse level of a V-cycle and
    every preconditioner application starts from zero, so this saves
    one full matvec per smoother call on those paths.
    """
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    dinv = 1.0 / op.diag
    if x.ndim > 1:
        dinv = dinv[:, None]

    def body(_, x):
        return x + omega * dinv * (b - mv(x))

    if x0_zero and iterations >= 1:
        x = omega * dinv * b
        return jax.lax.fori_loop(0, iterations - 1, body, x)
    return jax.lax.fori_loop(0, iterations, body, x)


def estimate_lambda_max(op: EllOperator, iterations: int = 30,
                        seed: int = 0) -> jax.Array:
    """Power iteration on D^{-1} A (the Jacobi-preconditioned operator),
    used to scale the Chebyshev interval.  Runs at setup time."""
    dinv = 1.0 / op.diag
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (op.num_vertices,), op.diag.dtype)

    def body(_, x):
        y = dinv * spmv(op, x)
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-30)

    x = jax.lax.fori_loop(0, iterations, body, x)
    y = dinv * spmv(op, x)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.vdot(x, y, precision=hi)
            / jnp.maximum(jnp.vdot(x, x, precision=hi), 1e-30))


def gershgorin_lambda_max(op: EllOperator) -> jax.Array:
    """Gershgorin upper bound on lambda_max(D^{-1} A): one row-sum pass.

    max_i (1 + sum_j |a_ij| / a_ii) >= lambda_max ALWAYS (no power-
    iteration underestimate risk), and for Jacobi-scaled Laplacian-like
    operators (|offdiag| row sum ~ diagonal) it is TIGHT: measured 2.0
    vs the true 1.977 at the 1M bench level 0, where 31-step power
    iteration x1.1 safety gave a LOOSER 2.135 for 1.4 s of SpMVs."""
    absrow = jnp.sum(jnp.where(op.mask, jnp.abs(op.offdiag), 0.0), axis=1)
    safe_d = jnp.where(op.diag > 0, op.diag, 1.0)
    return jnp.max(jnp.where(op.diag > 0, 1.0 + absrow / safe_d, 0.0))


class ChebyshevParams(NamedTuple):
    """Precomputed smoothing interval [lambda_max/ratio, lambda_max] of
    D^{-1} A.  ratio=4 targets the upper part of the spectrum (the
    standard multigrid smoothing range)."""
    lam_min: jax.Array
    lam_max: jax.Array

    @staticmethod
    def from_operator(op: EllOperator, ratio: float = 4.0,
                      safety: float = 1.1,
                      method: str = "gershgorin") -> "ChebyshevParams":
        if method == "gershgorin":
            lmax = gershgorin_lambda_max(op)
        else:
            lmax = estimate_lambda_max(op) * safety
        return ChebyshevParams(lam_min=lmax / ratio, lam_max=lmax)


def chebyshev(op: EllOperator, x: jax.Array, b: jax.Array,
              params: ChebyshevParams, degree: int, mv=None,
              x0_zero: bool = False) -> jax.Array:
    """Chebyshev polynomial smoother of given degree on D^{-1} A.

    Standard three-term recurrence over the interval
    [lam_min, lam_max]; equivalent to `degree` matrix applications.
    ``mv`` overrides the matvec (banded gather-free form).
    ``x0_zero=True`` (static) asserts ``x`` is exactly zero and skips
    the first matvec (A 0 = 0 bit-exactly) -- the pre-smooth of every
    coarse V-cycle level and of every preconditioner application
    starts from zero, so this drops one of ``degree`` matvecs there.
    """
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    dinv = 1.0 / op.diag
    if x.ndim > 1:
        dinv = dinv[:, None]
    theta = 0.5 * (params.lam_max + params.lam_min)
    delta = 0.5 * (params.lam_max - params.lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = dinv * b if x0_zero else dinv * (b - mv(x))
    d = r / theta
    x = x + d

    def body(_, carry):
        x, d, rho = carry
        r = dinv * (b - mv(x))
        rho_next = 1.0 / (2.0 * sigma - rho)
        d = rho_next * rho * d + (2.0 * rho_next / delta) * r
        return x + d, d, rho_next

    x, _, _ = jax.lax.fori_loop(0, degree - 1, body, (x, d, rho))
    return x
