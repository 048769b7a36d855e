"""Sort-local Galerkin RAP: A_c = U^T (A U) with lane-axis merges.

The baseline :func:`gravomg_tpu.solve.rap.galerkin_rap` emits all
9 * nnz(A) triplet contributions into one flat stream and merges them
with a GLOBAL sort (~59M elements at 200k vertices; ~290M at 1M).
This variant never builds the global stream:

  Phase 1 (Y = A U):  each fine row's candidate (coarse col, value)
     pairs -- 3 per neighbor plus 3 diagonal terms, (K+1)*3 total --
     are merged *within the row* by a lane-axis co-sort
     (``lax.sort`` over axis 1, operands co-sorted, no gathers) plus a
     cumulative-sum run-total trick.  Cost: two bitonic lane sorts of
     width ~(K+1)*3 instead of a global sort of V*(K+1)*9 elements.

  Phase 2 (A_c = U^T Y):  the precomputed restriction children table
     (:func:`gravomg_tpu.prolong.operator.build_restriction`, the same
     gather-form U^T the V-cycle uses) groups fine rows by coarse row;
     each coarse row gathers its <= max_children Y rows (2-D row
     gathers, looped over the child slot to avoid 3-D tile padding)
     and lane-merges the max_children * y_width candidates.

All heavy steps are elementwise ops, lane-axis sorts, and row gathers
-- no scatters, no global sorts -- so each level's RAP is one bounded
launch.

Semantics are identical to ``galerkin_rap`` as a linear operator
(dense equality tested); ELL slot *order* may differ.  Solver context:
the reference fork has no solver (SURVEY.md section 0); the Galerkin
product is the standard construction over the reference's U
(`src/multigrid.cpp:265-498` fixes U's <=3 nnz/row invariant that
bounds every width here).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import (EllOperator, Prolongation, Restriction,
                               INVALID_INDEX)


def _ffill(vals: jax.Array, keep: jax.Array) -> jax.Array:
    """Forward-fill along axis 1: out[t] = vals[s] for the most recent
    s <= t with keep[s], else 0.  log-depth associative scan, all
    elementwise."""

    def comb(a, b):
        ma, va = a
        mb, vb = b
        return ma | mb, jnp.where(mb, vb, va)

    _, v = jax.lax.associative_scan(
        comb, (keep, jnp.where(keep, vals, 0.0)), axis=1)
    return v


def lane_merge(cols: jax.Array, vals: jax.Array,
               out_width: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-row dedup-and-add of (col, val) candidate pairs.

    cols: (R, W) int32, INVALID_INDEX marks absent slots (they sort to
    the end -- INVALID_INDEX is int32 max).  Returns (cols (R, out),
    vals (R, out), overflow) where overflow means some row had more
    than out_width distinct columns.
    """
    r, w = cols.shape
    vals = jnp.where(cols == INVALID_INDEX, 0.0, vals)
    key_s, val_s = jax.lax.sort((cols, vals), dimension=1, num_keys=1)
    valid = key_s != INVALID_INDEX
    tr = jnp.ones((r, 1), bool)
    first = jnp.concatenate([tr, key_s[:, 1:] != key_s[:, :-1]], axis=1)
    first = first & valid
    last = jnp.concatenate([key_s[:, :-1] != key_s[:, 1:], tr], axis=1)
    last = last & valid
    s = jnp.cumsum(val_s, axis=1)
    sprev = jnp.concatenate([jnp.zeros((r, 1), s.dtype), s[:, :-1]],
                            axis=1)
    base = _ffill(jnp.where(first, sprev, 0.0), first)
    totals = (s - base).astype(vals.dtype)         # meaningful at `last`
    seg = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1
    overflow = jnp.any(last & (seg >= out_width))
    outkey = jnp.where(last, seg, INVALID_INDEX)
    k2, c2, v2 = jax.lax.sort((outkey, key_s, totals), dimension=1,
                              num_keys=1)
    if w < out_width:
        pad = out_width - w
        k2 = jnp.pad(k2, ((0, 0), (0, pad)),
                     constant_values=INVALID_INDEX)
        c2 = jnp.pad(c2, ((0, 0), (0, pad)),
                     constant_values=INVALID_INDEX)
        v2 = jnp.pad(v2, ((0, 0), (0, pad)))
    live = k2[:, :out_width] != INVALID_INDEX
    cols_out = jnp.where(live, c2[:, :out_width], INVALID_INDEX)
    vals_out = jnp.where(live, v2[:, :out_width], 0.0)
    return cols_out, vals_out, overflow


_AU_GROUP = 32  # neighbor columns merged per lane sort (see _au_rows)


@functools.partial(jax.jit, static_argnames=("y_width",))
def _au_rows(neighbors: jax.Array, offdiag: jax.Array, diag: jax.Array,
             row_cols: jax.Array, row_weights: jax.Array,
             full_cols: jax.Array, full_weights: jax.Array, y_width: int):
    """Phase 1 over a block of fine rows: Y = A U as per-row merged ELL.

    ``neighbors/offdiag/diag/row_cols/row_weights`` hold the block's own
    rows; ``full_cols/full_weights`` are the WHOLE prolongation (neighbor
    ids are global fine indices).  Padding rows: neighbors INVALID, diag
    0, row_cols INVALID -- lane_merge then yields an all-INVALID Y row.

    Neighbor columns are consumed in groups of ``_AU_GROUP``, each
    group's 3 candidate blocks lane-merged into the running (y_width)
    accumulator: every sort stays <= y_width + 3*_AU_GROUP + 3 lanes
    wide no matter how wide the level's ELL is.  (The single
    3K+3-candidate sort at a build-time K=128 level was a 387-lane
    3-operand sort whose compile ran out of memory at (200k, 128).)
    For K <= _AU_GROUP this is
    bit-identical to the one-shot merge; otherwise equal up to f32 add
    order, the documented 2phase contract.  Dropped-entry behavior
    under y-overflow is unchanged: the flag is set and the result is
    invalid either way.
    """
    rows, k = neighbors.shape
    mask = neighbors != INVALID_INDEX
    safe = jnp.where(mask, neighbors, 0)
    a_off = jnp.where(mask, offdiag, 0.0)
    acc_cols = acc_vals = None
    ovf = jnp.bool_(False)
    for g0 in range(0, k, _AU_GROUP):
        sl = slice(g0, min(g0 + _AU_GROUP, k))
        cols_l = [] if acc_cols is None else [acc_cols]
        vals_l = [] if acc_vals is None else [acc_vals]
        for b in range(3):
            # 2-D temps only: a (Vf, K, 3) gather has a tiny minor dim
            # that tiled layouts pad many-fold.
            cb = full_cols[:, b][safe[:, sl]]          # (rows, <=32)
            cols_l.append(jnp.where(mask[:, sl], cb, INVALID_INDEX))
            vals_l.append(a_off[:, sl] * full_weights[:, b][safe[:, sl]])
        if g0 + _AU_GROUP >= k:                # last group: diag terms
            cols_l.append(row_cols)
            vals_l.append(diag[:, None] * row_weights)
        acc_cols, acc_vals, o = lane_merge(
            jnp.concatenate(cols_l, axis=1),
            jnp.concatenate(vals_l, axis=1), y_width)
        ovf = ovf | o
    return acc_cols, acc_vals, ovf


def _au_local(op: EllOperator, u: Prolongation, y_width: int):
    """Phase 1: Y = A U as per-fine-row (y_width) merged ELL."""
    return _au_rows(op.neighbors, op.offdiag, op.diag, u.cols, u.weights,
                    u.cols, u.weights, y_width)


@functools.partial(jax.jit, static_argnames=("n_coarse", "max_degree"))
def _uty_local(y_cols: jax.Array, y_vals: jax.Array, rt: Restriction,
               n_coarse: int, max_degree: int):
    """Phase 2: A_c = U^T Y via the children table."""
    m = rt.rows.shape[1]
    safe = rt.safe_rows()
    tmask = rt.rows != INVALID_INDEX
    cols_l, vals_l = [], []
    for j in range(m):                 # loop child slots: 2-D temps
        rows_j = safe[:, j]
        cj = y_cols[rows_j]                            # (nc, y_width)
        vj = y_vals[rows_j] * rt.weights[:, j][:, None]
        cols_l.append(jnp.where(tmask[:, j][:, None], cj, INVALID_INDEX))
        vals_l.append(vj)
    cand_cols = jnp.concatenate(cols_l, axis=1)        # (nc, m * yw)
    cand_vals = jnp.concatenate(vals_l, axis=1)
    cols, vals, ovf = lane_merge(cand_cols, cand_vals, max_degree + 1)
    # Split the diagonal out of the merged rows.
    nc = n_coarse
    is_diag = cols == jnp.arange(nc, dtype=jnp.int32)[:, None]
    diag = jnp.sum(jnp.where(is_diag, vals, 0.0), axis=1)
    off_cols = jnp.where(is_diag, INVALID_INDEX, cols)
    off_vals = jnp.where(is_diag, 0.0, vals)
    order = jnp.argsort(off_cols, axis=1, stable=True)
    off_cols = jnp.take_along_axis(off_cols, order, axis=1)[:, :max_degree]
    off_vals = jnp.take_along_axis(off_vals, order, axis=1)[:, :max_degree]
    out = EllOperator(neighbors=off_cols, offdiag=off_vals, diag=diag)
    return out, ovf


def _rap2_stream(u_cols, u_weights, y_cols, y_vals, nc: int,
                 max_degree: int):
    """Emit and merge the phase-2 triplet stream for a block of fine
    rows: (parent col a) x (Y col b) -> A_c[u_cols[:, a], y_cols[:, b]].
    Returns a (nc, max_degree + 1) partial ELL (diag kept inline)."""
    from gravomg_tpu.ops.segment import build_ell_rows

    y_width = y_cols.shape[1]
    rows_l, cols_l, vals_l, valid_l = [], [], [], []
    for a in range(3):
        for b in range(y_width):
            rows_l.append(u_cols[:, a])
            cols_l.append(y_cols[:, b])
            vals_l.append(u_weights[:, a] * y_vals[:, b])
            valid_l.append(y_cols[:, b] != INVALID_INDEX)
    rows = jnp.concatenate(rows_l)
    cols = jnp.concatenate(cols_l)
    vals = jnp.concatenate(vals_l)
    valid = jnp.concatenate(valid_l)
    return build_ell_rows(rows, cols, valid, nc, max_degree + 1,
                          values=vals, combine="add")


@functools.partial(jax.jit, static_argnames=("max_degree", "y_width"))
def _rap_2phase_full(op: EllOperator, u: Prolongation,
                     max_degree: int, y_width: int
                     ) -> Tuple[EllOperator, jax.Array]:
    from gravomg_tpu.solve.rap import _phantom_identity

    nc = u.n_coarse
    y_cols, y_vals, y_ovf = _au_local(op, u, y_width)
    res = _rap2_stream(u.cols, u.weights, y_cols, y_vals, nc, max_degree)
    cmask = res.columns != INVALID_INDEX
    is_diag = cmask & (res.columns
                       == jnp.arange(nc, dtype=jnp.int32)[:, None])
    diag = jnp.sum(jnp.where(is_diag, res.values, 0.0), axis=1)
    off_cols = jnp.where(is_diag, INVALID_INDEX, res.columns)
    off_vals = jnp.where(is_diag, 0.0, res.values)
    order = jnp.argsort(off_cols, axis=1, stable=True)
    off_cols = jnp.take_along_axis(off_cols, order, axis=1)[:, :max_degree]
    off_vals = jnp.take_along_axis(off_vals, order, axis=1)[:, :max_degree]
    out = EllOperator(neighbors=off_cols, offdiag=off_vals, diag=diag)
    out = out._replace(diag=_phantom_identity(out))
    return out, y_ovf | res.overflow


@functools.partial(jax.jit, static_argnames=("nc", "max_degree"))
def _uty_global(uc, uw, y_cols, y_vals, nc: int, max_degree: int):
    """Phase 2 over the WHOLE merged-Y stream in one sort-scatter.

    Emits all 3 * y_width candidate (coarse row, coarse col, value)
    triplets of every fine row and groups them with ONE global
    build_ell_rows (a single variadic lexicographic sort + scatter).
    Replaces the per-chunk accumulator lane merge, which re-sorted the
    full (nc, max_degree + 1) accumulator once per 200k-row chunk --
    measured 11.0 s PER CHUNK at 1M vertices (55 s of the 60 s RAP)
    versus 8.1 s for this whole-stream pass pre-cosort.
    """
    from gravomg_tpu.solve.rap import _phantom_identity

    res = _rap2_stream(uc, uw, y_cols, y_vals, nc, max_degree)
    cmask = res.columns != INVALID_INDEX
    is_diag = cmask & (res.columns
                       == jnp.arange(nc, dtype=jnp.int32)[:, None])
    diag = jnp.sum(jnp.where(is_diag, res.values, 0.0), axis=1)
    off_cols = jnp.where(is_diag, INVALID_INDEX, res.columns)
    off_vals = jnp.where(is_diag, 0.0, res.values)
    order = jnp.argsort(off_cols, axis=1, stable=True)
    off_cols = jnp.take_along_axis(off_cols, order, axis=1)[:, :max_degree]
    off_vals = jnp.take_along_axis(off_vals, order, axis=1)[:, :max_degree]
    out = EllOperator(neighbors=off_cols, offdiag=off_vals, diag=diag)
    return out._replace(diag=_phantom_identity(out)), res.overflow


@functools.partial(jax.jit, static_argnames=("max_degree",))
def _rap2_chunk_merge(acc_cols, acc_vals, ovf, uc, uw, yc, yv,
                      max_degree: int):
    from gravomg_tpu.solve.rap import _merge_ell

    nc = acc_cols.shape[0]
    part = _rap2_stream(uc, uw, yc, yv, nc, max_degree)
    cols2, vals2, o2 = _merge_ell(acc_cols, acc_vals, part.columns,
                                  part.values, nc, max_degree + 1)
    return cols2, vals2, ovf | part.overflow | o2


def galerkin_rap_2phase(op: EllOperator, u: Prolongation,
                        max_degree: int, y_width: int = 16,
                        chunk_rows: int = 200_000
                        ) -> Tuple[EllOperator, jax.Array]:
    """A_c = U^T (A U) with a lane-merged Y and one SMALL global sort.

    The single-stream RAP (solve/rap.py) sorts 9*K*Vf triplets (153M at
    1M vertices, measured 11.6 s at 200k level 0 -- the largest build
    stage).  Phase 1 merges each fine row's 3(K+1) candidates to
    y_width slots with lane sorts (~51 lanes, compiles at any scale,
    unlike the sort-local phase 2 whose mc*yw-lane merge OOMs the
    compiler at 200k).  Phase 2 then sorts only the 3*y_width*Vf merged
    stream (48M at 1M -- 3.2x smaller) through the standard
    build_ell_rows scatter.  Same operator as ``galerkin_rap`` up to
    f32 add order; returns (A_c, overflow).

    Above ``chunk_rows`` fine rows, phase 1 runs as a host-level chunk
    loop over row blocks (per-fine-row independent; the single
    whole-problem (1M, 3K+3) lane-merge program ran its compile out of
    memory) and the chunk Ys concatenate into one
    materialized (vpad, y_width) Y -- 192 MB at 1M, cheap.  Phase 2 is
    then ONE global sort-scatter over the full 3 * y_width * vpad
    stream (:func:`_uty_global`).  The earlier per-chunk design instead
    lane-merged each chunk's partial ELL into a (nc, max_degree + 1)
    accumulator, re-sorting all padded coarse rows once per chunk --
    most of the stage's time at 1M (nc cap 423808, degree 128).  As its
    own jit the 72M-element global sort compiles and runs cleanly.
    """
    vf = op.num_vertices
    if vf <= chunk_rows:
        return _rap_2phase_full(op, u, max_degree, y_width)

    nc = u.n_coarse
    n_chunks = -(-vf // chunk_rows)
    vpad = n_chunks * chunk_rows

    def pad_rows(a, fill):
        return jnp.pad(a, ((0, vpad - vf), (0, 0)), constant_values=fill)

    neigh_p = pad_rows(op.neighbors, INVALID_INDEX)
    offd_p = pad_rows(op.offdiag, 0)
    diag_p = jnp.pad(op.diag, (0, vpad - vf))
    uc_p = pad_rows(u.cols, 0)           # phase-2 row targets (masked
    uw_p = pad_rows(u.weights, 0)        # by Y validity)
    ucy_p = pad_rows(u.cols, INVALID_INDEX)  # phase-1 diag term: an
    #                                    all-INVALID row drops cleanly

    ycs, yvs = [], []
    ovf = jnp.bool_(False)
    for c0 in range(n_chunks):
        s = slice(c0 * chunk_rows, (c0 + 1) * chunk_rows)
        y_cols, y_vals, y_ovf = _au_rows(
            neigh_p[s], offd_p[s], diag_p[s], ucy_p[s], uw_p[s],
            u.cols, u.weights, y_width)
        ycs.append(y_cols)
        yvs.append(y_vals)
        ovf = ovf | y_ovf
    out, o2 = _uty_global(uc_p, uw_p, jnp.concatenate(ycs),
                          jnp.concatenate(yvs), nc, max_degree)
    return out, ovf | o2


def galerkin_rap_local(op: EllOperator, u: Prolongation, max_degree: int,
                       y_width: int = 0, max_children: int = 0,
                       sync_retry: bool = True
                       ) -> Tuple[EllOperator, jax.Array]:
    """Sort-local A_c = U^T A U.  Drop-in for ``galerkin_rap`` (same
    operator up to ELL slot order; phantom rows get the same identity
    diagonal).  y_width / max_children <= 0 pick working defaults and
    retry with doubled caps on overflow (each cap is data-dependent:
    distinct coarse parents per fine neighborhood, fine children per
    coarse cell).

    ``sync_retry=False`` runs ONE pass at the given/default caps and
    returns the combined overflow flag instead of host-syncing on it --
    required inside the zero-D2H builder (hierarchy_static.py) and under
    an enclosing ``jit``."""
    from gravomg_tpu.prolong.operator import build_restriction
    from gravomg_tpu.solve.rap import _phantom_identity

    vf = op.num_vertices
    nc = u.n_coarse
    yw = y_width if y_width > 0 else 16
    # nc is the PADDED coarse cap, so 3*vf/nc underestimates the real
    # mean children per coarse cell by the cap slack (~2.5x) and hubs
    # run ~3.5x the mean (hierarchy_static.py build_restriction note).
    # Use the same 12x headroom rule as the builder's own U^T table.
    mc = max_children if max_children > 0 else max(8, -(-12 * 3 * vf // nc))
    mc = min(mc, vf)
    if not sync_retry:
        rt, r_ovf = build_restriction(u, mc)
        y_cols, y_vals, y_ovf = _au_local(op, u, yw)
        out, ovf = _uty_local(y_cols, y_vals, rt, nc, max_degree)
        out = out._replace(diag=_phantom_identity(out))
        return out, r_ovf | y_ovf | ovf
    for _ in range(4):
        rt, r_ovf = build_restriction(u, mc)
        if bool(r_ovf):
            mc *= 2
            continue
        y_cols, y_vals, y_ovf = _au_local(op, u, yw)
        if bool(y_ovf):
            yw *= 2
            continue
        out, ovf = _uty_local(y_cols, y_vals, rt, nc, max_degree)
        out = out._replace(diag=_phantom_identity(out))
        return out, ovf
    # Caps kept overflowing: signal failure the way the baseline does
    # (an all-empty operator would corrupt the hierarchy silently).
    empty = EllOperator(
        neighbors=jnp.full((nc, max_degree), INVALID_INDEX, jnp.int32),
        offdiag=jnp.zeros((nc, max_degree), op.offdiag.dtype),
        diag=jnp.ones((nc,), op.diag.dtype))
    return empty, jnp.bool_(True)
