"""Sort-based fixed-shape group-by / scatter primitives.

The reference builds sparse matrices by repeated ``coeffRef`` insertion
(`src/multigrid.cpp:159-163` -- O(nnz) per insertion, a known hot spot,
SURVEY.md §2.1-C7 quirk 2) and by ``setFromTriplets``
(`src/multigrid.cpp:495`).  The fixed-shape equivalent is a one-shot
stable sort + segmented reduction + scatter, all with static shapes.

These helpers power coarse-graph extraction, triangle association lists,
and Galerkin RAP assembly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import INVALID_INDEX


def lexsort_pairs(primary: jax.Array, secondary: jax.Array) -> jax.Array:
    """Stable ascending sort order by (primary, secondary)."""
    return jnp.lexsort((secondary, primary))


class EllScatterResult(NamedTuple):
    columns: jax.Array          # (num_rows, K) int32, INVALID_INDEX padding
    values: Optional[jax.Array]  # (num_rows, K) float or None
    counts: jax.Array           # (num_rows,) int32 unique entries per row
    overflow: jax.Array         # () bool: some row exceeded K slots


def build_ell_rows(
    rows: jax.Array,
    cols: jax.Array,
    valid: jax.Array,
    num_rows: int,
    max_cols: int,
    values: Optional[jax.Array] = None,
    combine: str = "add",
) -> EllScatterResult:
    """Group (row, col[, value]) triplets into a padded ELL structure.

    Duplicate (row, col) pairs are merged: values are combined with
    ``combine`` in {"add", "min"} (the reference's coarse-edge relaxation
    keeps the min over contributing fine edges, `src/multigrid.cpp:156-164`;
    RAP assembly sums).  Output rows are sorted ascending by column index,
    matching Eigen CSC inner-iterator order that downstream tie-breaks
    depend on (`src/multigrid.cpp:294`, `:356`, `:414`).

    Args:
      rows, cols: (E,) int32 triplet coordinates.
      valid: (E,) bool.
      num_rows: static row count of the output.
      max_cols: static K; entries beyond K per row are dropped and flagged.
      values: optional (E,) payload.
      combine: duplicate-merge mode.

    Returns:
      EllScatterResult with fixed (num_rows, max_cols) shapes.
    """
    e = rows.shape[0]
    # Invalid entries sort to the end (and to an out-of-range row bucket).
    srows = jnp.where(valid, rows, num_rows).astype(jnp.int32)
    scols = jnp.where(valid, cols, INVALID_INDEX).astype(jnp.int32)
    # ONE variadic lexicographic sort carrying the payloads along:
    # jnp.lexsort runs two stable sort passes and every payload then
    # needs an order-gather -- at the Galerkin RAP's 72M-element stream
    # that was ~4 extra full-stream passes.
    operands = [srows, scols, valid.astype(jnp.int8)]
    if values is not None:
        operands.append(values)
    sorted_ops = jax.lax.sort(tuple(operands), dimension=0, num_keys=2,
                              is_stable=True)
    srows, scols = sorted_ops[0], sorted_ops[1]
    svalid = sorted_ops[2].astype(bool)

    prev_rows = jnp.concatenate([jnp.full((1,), -1, srows.dtype), srows[:-1]])
    prev_cols = jnp.concatenate([jnp.full((1,), -1, scols.dtype), scols[:-1]])
    row_change = srows != prev_rows
    is_new = svalid & (row_change | (scols != prev_cols))

    c = jnp.cumsum(is_new.astype(jnp.int32))
    # cumsum value just before each row's first element, propagated forward.
    base = jax.lax.cummax(jnp.where(row_change, c - is_new, 0))
    slot = c - 1 - base  # duplicates share their unique entry's slot

    in_range = svalid & (slot >= 0) & (slot < max_cols)
    overflow = jnp.any(svalid & (slot >= max_cols))
    flat = jnp.where(in_range, srows * max_cols + slot, num_rows * max_cols)

    columns = jnp.full((num_rows * max_cols + 1,), INVALID_INDEX, jnp.int32)
    columns = columns.at[flat].set(jnp.where(in_range, scols, INVALID_INDEX))
    columns = columns[:-1].reshape(num_rows, max_cols)

    out_values = None
    if values is not None:
        svals = sorted_ops[3]
        buf_init = jnp.inf if combine == "min" else 0.0
        buf = jnp.full((num_rows * max_cols + 1,), buf_init, values.dtype)
        if combine == "add":
            buf = buf.at[flat].add(jnp.where(in_range, svals, 0.0))
        elif combine == "min":
            buf = buf.at[flat].min(jnp.where(in_range, svals, jnp.inf))
        else:
            raise ValueError(f"unknown combine mode {combine!r}")
        out_values = buf[:-1].reshape(num_rows, max_cols)
        if combine == "min":
            out_values = jnp.where(
                columns != INVALID_INDEX, out_values, jnp.inf)
        else:
            out_values = jnp.where(columns != INVALID_INDEX, out_values, 0.0)

    counts = jnp.zeros((num_rows + 1,), jnp.int32)
    counts = counts.at[jnp.where(is_new & in_range, srows, num_rows)].add(1)
    counts = counts[:-1]

    return EllScatterResult(columns, out_values, counts, overflow)


def group_ordered(
    rows: jax.Array,
    payload: jax.Array,
    valid: jax.Array,
    num_rows: int,
    max_per_row: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Group payload ids by row, preserving ascending payload order.

    No dedup.  Used for per-vertex triangle association lists, which the
    reference builds in triangle-id order (`src/multigrid.cpp:253-256`);
    since triangle ids are assigned in enumeration order, grouping with an
    ascending payload sort reproduces the exact reference list order.

    Returns:
      (table (num_rows, max_per_row) int32 with INVALID_INDEX padding,
       counts (num_rows,) int32,
       overflow () bool)
    """
    srows = jnp.where(valid, rows, num_rows).astype(jnp.int32)
    spay = jnp.where(valid, payload, INVALID_INDEX).astype(jnp.int32)
    srows, spay, sv8 = jax.lax.sort(
        (srows, spay, valid.astype(jnp.int8)), dimension=0, num_keys=2,
        is_stable=True)
    svalid = sv8.astype(bool)

    prev_rows = jnp.concatenate([jnp.full((1,), -1, srows.dtype), srows[:-1]])
    row_change = srows != prev_rows
    c = jnp.cumsum(svalid.astype(jnp.int32))
    base = jax.lax.cummax(jnp.where(row_change, c - svalid, 0))
    slot = c - 1 - base

    in_range = svalid & (slot >= 0) & (slot < max_per_row)
    overflow = jnp.any(svalid & (slot >= max_per_row))
    flat = jnp.where(in_range, srows * max_per_row + slot,
                     num_rows * max_per_row)
    table = jnp.full((num_rows * max_per_row + 1,), INVALID_INDEX, jnp.int32)
    table = table.at[flat].set(jnp.where(in_range, spay, INVALID_INDEX))
    table = table[:-1].reshape(num_rows, max_per_row)

    counts = jnp.zeros((num_rows + 1,), jnp.int32)
    counts = counts.at[jnp.where(svalid & in_range, srows, num_rows)].add(1)
    counts = counts[:-1]
    return table, counts, overflow
