"""Coarsest-level direct solve: dense Cholesky on chip.

BASELINE.json: "The coarsest level falls back to a dense Cholesky solve
on-chip."  The coarsest operator is at most a few thousand vertices, so
the dense factor is small and the triangular solves are small batched
ops.  A small diagonal shift keeps semi-definite operators (pure Neumann
Laplacians) factorizable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gravomg_tpu.types import EllOperator


def factor_coarse(op: EllOperator,
                  shift_scales=(1e-10, 1e-6, 1e-4)) -> jax.Array:
    """Cholesky factor (lower) of the densified coarsest operator.

    Deep f32 Galerkin chains accumulate enough rounding that the
    coarsest operator can be slightly asymmetric and indefinite at the
    last digits (observed at 1M vertices: SciPy rejects the 548-th
    leading minor at a 1e-10 relative shift).  Symmetrize, then pick
    the smallest shift whose factorization is NaN-free -- selection is
    done entirely on device (jnp.linalg.cholesky yields NaNs rather
    than raising), so the device-resident builder stays sync-free.
    """
    a = op.as_dense()
    a = 0.5 * (a + a.T)
    base = jnp.max(jnp.abs(op.diag))
    eye = jnp.eye(a.shape[0], dtype=a.dtype)
    chol = jnp.linalg.cholesky(a + (shift_scales[0] * base) * eye)
    for s in shift_scales[1:]:
        alt = jnp.linalg.cholesky(a + (s * base) * eye)
        bad = jnp.any(jnp.isnan(chol))
        chol = jnp.where(bad, alt, chol)
    return chol


def coarse_solve(chol: jax.Array, b: jax.Array) -> jax.Array:
    y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    return jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)
