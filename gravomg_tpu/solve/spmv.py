"""ELL sparse matrix-vector products.

The solver half is absent from the reference fork (SURVEY.md §0); its
contract is fixed by the hierarchy semantics plus BASELINE.json (blocked
ELL SpMV, north star).  The padded ELL layout makes SpMV a fixed-shape
gather + multiply + row-reduce that XLA fuses into one kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gravomg_tpu.types import EllOperator


def spmv(op: EllOperator, x: jax.Array) -> jax.Array:
    """y = A x for (V,) or (V, D) x."""
    safe = op.safe_neighbors()
    w = jnp.where(op.mask, op.offdiag, 0.0)
    if x.ndim == 1:
        return op.diag * x + jnp.sum(w * x[safe], axis=1)
    return (op.diag[:, None] * x
            + jnp.einsum("vk,vkd->vd", w, x[safe],
                         precision=jax.lax.Precision.HIGHEST))


def residual(op: EllOperator, x: jax.Array, b: jax.Array) -> jax.Array:
    return b - spmv(op, x)
