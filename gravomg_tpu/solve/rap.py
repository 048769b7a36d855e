"""Galerkin coarse-operator assembly: A_c = U^T A U.

Not present in the reference fork (SURVEY.md §0, CS-5); required by
BASELINE.json.  Exploits U's <=3 nnz/row invariant
(`src/multigrid.cpp:265-498`): every fine vertex i contributes
  diag:     A_ii * U[i,a] * U[i,b]           (3x3 pairs)
  offdiag:  A_ij * U[i,a] * U[j,b]           (K * 3x3 pairs)
to A_c[col_a, col_b].  All contributions are emitted as one flat triplet
stream and merged with a single sort-based scatter (ops/segment.py) --
the one-shot, fixed-shape replacement for incremental sparse insertion.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import EllOperator, Prolongation, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows


def galerkin_rap(op: EllOperator, u: Prolongation, max_degree: int,
                 chunk_rows: int = 150_000) -> Tuple[EllOperator, jax.Array]:
    """Compute A_c = U^T A U as an ELL operator with static max_degree.

    Dispatches to the single-shot kernel when the triplet stream fits a
    memory budget, else to a chunked variant that processes fine rows in
    blocks and merges partial ELL accumulators (peak memory O(chunk * K)
    instead of O(V * K)).  Returns (A_c, overflow flag).
    """
    vf, k = op.neighbors.shape
    if vf <= chunk_rows:
        out, ovf = _galerkin_rap_full(op, u, max_degree)
        out = out._replace(diag=_phantom_identity(out))
        return out, ovf
    return _galerkin_rap_chunked(op, u, max_degree, chunk_rows)


def _phantom_identity(out: EllOperator) -> jax.Array:
    """Identity diagonal for bucket-phantom rows only.

    Phantom rows receive no contributions at all (no U column points at
    them), so they are identified by an entirely empty row -- not by a
    zero diagonal, which a real degenerate row could also produce via
    cancellation; such a row keeps its zero diagonal and surfaces in the
    coarse factorization instead of being silently rewritten."""
    empty = (out.diag == 0.0) & ~jnp.any(out.mask, axis=1)
    return jnp.where(empty, 1.0, out.diag)


def _merge_ell(cols_a, vals_a, cols_b, vals_b, num_rows, out_cols):
    """Merge two ELL accumulators (same row space) with add-combine."""
    cat_cols = jnp.concatenate([cols_a, cols_b], axis=1)
    cat_vals = jnp.concatenate([vals_a, vals_b], axis=1)
    kk = cat_cols.shape[1]
    rows = jnp.broadcast_to(
        jnp.arange(num_rows, dtype=jnp.int32)[:, None], (num_rows, kk))
    valid = cat_cols != INVALID_INDEX
    res = build_ell_rows(rows.reshape(-1), cat_cols.reshape(-1),
                         valid.reshape(-1), num_rows, out_cols,
                         values=cat_vals.reshape(-1), combine="add")
    return res.columns, res.values, res.overflow


@functools.partial(jax.jit, static_argnames=("max_degree",))
def _rap_chunk_merge(acc_cols, acc_vals, ovf, sub_nbr, sub_off, sub_diag,
                     sub_uc, sub_uw, all_uc, all_uw, max_degree: int):
    """One chunk's RAP contributions merged into the accumulator.

    Padded rows have zero U weights and masked neighbors -> no
    contribution; their diag contributes to (0, 0) with value 0.
    Column-side U gathers must use the FULL U (neighbor ids are
    global), only the row side is chunk-local.
    """
    nc = acc_cols.shape[0]
    sub = EllOperator(sub_nbr, sub_off, sub_diag)
    sub_u = Prolongation(sub_uc, sub_uw, nc)
    part, o1 = _rap_rows(sub, sub_u, all_uc, all_uw, max_degree)
    part_cols = jnp.concatenate(
        [jnp.where(part.diag != 0.0,
                   jnp.arange(nc, dtype=jnp.int32),
                   INVALID_INDEX)[:, None], part.neighbors], axis=1)
    part_vals = jnp.concatenate(
        [jnp.where(part.diag != 0.0, part.diag, 0.0)[:, None],
         part.offdiag], axis=1)
    cols2, vals2, o2 = _merge_ell(acc_cols, acc_vals, part_cols,
                                  part_vals, nc, max_degree + 1)
    return cols2, vals2, ovf | o1 | o2


@functools.partial(jax.jit, static_argnames=("max_degree",))
def _rap_finalize(acc_cols, acc_vals, max_degree: int):
    nc = acc_cols.shape[0]
    cmask = acc_cols != INVALID_INDEX
    is_diag = cmask & (acc_cols
                       == jnp.arange(nc, dtype=jnp.int32)[:, None])
    diag = jnp.sum(jnp.where(is_diag, acc_vals, 0.0), axis=1)
    off_cols = jnp.where(is_diag, INVALID_INDEX, acc_cols)
    off_vals = jnp.where(is_diag, 0.0, acc_vals)
    order = jnp.argsort(off_cols, axis=1, stable=True)
    off_cols = jnp.take_along_axis(off_cols, order, axis=1)[:, :max_degree]
    off_vals = jnp.take_along_axis(off_vals, order, axis=1)[:, :max_degree]
    out = EllOperator(neighbors=off_cols, offdiag=off_vals, diag=diag)
    return out._replace(diag=_phantom_identity(out))


def _galerkin_rap_chunked(op: EllOperator, u: Prolongation,
                          max_degree: int, chunk_rows: int):
    """Host-level chunk loop: ONE bounded launch per chunk.

    The previous lax.scan form fused every chunk's 9-pair triplet sort
    (~45M elements each at 1M vertices) into a single launch.  The
    Python loop issues the same jitted chunk body per slice -- identical
    math, no syncs, one compile (fixed chunk shape).
    """
    vf, k = op.neighbors.shape
    nc = u.n_coarse
    n_chunks = -(-vf // chunk_rows)
    vpad = n_chunks * chunk_rows

    def pad_rows(a, fill):
        return jnp.pad(a, ((0, vpad - vf),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    nbr_p = pad_rows(op.neighbors, INVALID_INDEX)
    off_p = pad_rows(op.offdiag, 0)
    diag_p = pad_rows(op.diag, 0)
    uc_p = pad_rows(u.cols, 0)
    uw_p = pad_rows(u.weights, 0)

    acc_cols = jnp.full((nc, max_degree + 1), INVALID_INDEX, jnp.int32)
    acc_vals = jnp.zeros((nc, max_degree + 1), op.offdiag.dtype)
    ovf = jnp.bool_(False)

    for c0 in range(n_chunks):
        s = slice(c0 * chunk_rows, (c0 + 1) * chunk_rows)
        acc_cols, acc_vals, ovf = _rap_chunk_merge(
            acc_cols, acc_vals, ovf, nbr_p[s], off_p[s], diag_p[s],
            uc_p[s], uw_p[s], u.cols, u.weights, max_degree)

    return _rap_finalize(acc_cols, acc_vals, max_degree), ovf


@functools.partial(jax.jit, static_argnames=("max_degree",))
def _galerkin_rap_full(op: EllOperator, u: Prolongation,
                       max_degree: int) -> Tuple[EllOperator, jax.Array]:
    return _rap_rows(op, u, u.cols, u.weights, max_degree)


@functools.partial(jax.jit, static_argnames=("max_degree",))
def _rap_rows(op: EllOperator, u: Prolongation, all_uc: jax.Array,
              all_uw: jax.Array,
              max_degree: int) -> Tuple[EllOperator, jax.Array]:
    """RAP contributions of ``op``'s rows.  ``u`` holds the row-side U
    entries (aligned with op's rows); ``all_uc``/``all_uw`` the full U
    table indexed by op's (global) neighbor ids."""
    vf, k = op.neighbors.shape
    nc = u.n_coarse
    safe = op.safe_neighbors()
    a_off = jnp.where(op.mask, op.offdiag, 0.0)

    uc = u.cols                                   # (Vf, 3)
    uw = u.weights                                # (Vf, 3)

    # Emit the 9 (a, b) U-pair contributions as flat 1-D streams.  A
    # fused (Vf, K, 3, 3) broadcast has tiny trailing (3, 3) dims that
    # tiled layouts pad many-fold; 1-D and (Vf, K) temps pad benignly.
    rows_l, cols_l, vals_l, valid_l = [], [], [], []
    flat_mask = op.mask.reshape(-1)
    for a in range(3):
        r_a = jnp.broadcast_to(uc[:, a][:, None], (vf, k)).reshape(-1)
        w_a = uw[:, a][:, None]
        for b in range(3):
            c_b = all_uc[:, b][safe].reshape(-1)
            v_ab = (a_off * w_a * all_uw[:, b][safe]).reshape(-1)
            rows_l.append(r_a)
            cols_l.append(c_b)
            vals_l.append(v_ab)
            valid_l.append(flat_mask)
    # Diagonal contributions.
    for a in range(3):
        for b in range(3):
            rows_l.append(uc[:, a])
            cols_l.append(uc[:, b])
            vals_l.append(op.diag * uw[:, a] * uw[:, b])
            valid_l.append(jnp.ones(vf, bool))
    rows = jnp.concatenate(rows_l)
    cols = jnp.concatenate(cols_l)
    vals = jnp.concatenate(vals_l)
    valid = jnp.concatenate(valid_l)

    res = build_ell_rows(rows, cols, valid, nc, max_degree + 1,
                         values=vals, combine="add")
    # Split out the diagonal (stored like any entry by the scatter).
    cmask = res.columns != INVALID_INDEX
    is_diag = cmask & (res.columns == jnp.arange(nc, dtype=jnp.int32)[:, None])
    diag = jnp.sum(jnp.where(is_diag, res.values, 0.0), axis=1)
    off_cols = jnp.where(is_diag, INVALID_INDEX, res.columns)
    off_vals = jnp.where(is_diag, 0.0, res.values)
    # Re-compact rows so valid off-diagonals form a sorted prefix again.
    order = jnp.argsort(off_cols, axis=1, stable=True)
    off_cols = jnp.take_along_axis(off_cols, order, axis=1)
    off_vals = jnp.take_along_axis(off_vals, order, axis=1)
    off_cols = off_cols[:, :max_degree]
    off_vals = off_vals[:, :max_degree]
    return (EllOperator(neighbors=off_cols, offdiag=off_vals, diag=diag),
            res.overflow)
