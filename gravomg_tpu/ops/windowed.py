"""Windowed rectangular sparse matvec (EXPERIMENTAL -- superseded).

Quarantined per docs/DESIGN.md §7: rectangular transfers ship on the
block-dense/slab forms (``ops/blockdense.py`` / ``ops/slab.py``),
which subsume this format's windows with per-block anchors.  Kept, with
its tests, until the per-level format choice settles (ROADMAP, Design 1).

Same idea as ops/banded.py: applying U (V_f x V_c, <=3 nnz/row) by
gathering coarse values per row costs 3*V_f gathered indices.  But the
hierarchy's coarse vertices inherit the fine spatial order (samples are
ascending fine ids), so row r's columns cluster around r * (n_cols /
n_rows): a handful of contiguous column windows per small row block
covers nearly everything.  The matvec becomes: gather NBLK*NW window
slices (negligible index count), resolve each entry by one-hot compare
inside its window, plus an exact sorted-COO escape chute.

Used for prolongation U, gather-form restriction U^T (children table),
and any other rectangular ELL operator over spatially ordered ids.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import INVALID_INDEX


class WindowedOperator(NamedTuple):
    """y[r] = sum_k w[r,k] * x[cols[r,k]] in windowed form.

    Arrays:
      win_start: (NBLK, NW) int32 window starts into the source vector.
      sel:       (R, KF) int8 window slot per entry (-1 pad/escape).
      lidx:      (R, KF) int32 index within the window.
      w:         (R, KF) float values (0 pad).
      esc_rows/esc_cols/esc_w: sorted-COO escape chute.
    Static aux: n_rows, n_cols, block, window.
    """

    win_start: jax.Array
    sel: jax.Array
    lidx: jax.Array
    w: jax.Array
    esc_rows: jax.Array
    esc_cols: jax.Array
    esc_w: jax.Array
    n_rows: int
    n_cols: int
    block: int
    window: int


jax.tree_util.register_pytree_node(
    WindowedOperator,
    lambda op: (tuple(op[:7]),
                (op.n_rows, op.n_cols, op.block, op.window)),
    lambda aux, ch: WindowedOperator(*ch, *aux),
)


@functools.partial(jax.jit, static_argnames=("n_cols", "block", "window",
                                             "nw", "escape_cap"))
def windowed_from_ell(cols: jax.Array, vals: jax.Array, valid: jax.Array,
                      n_cols: int, block: int = 16, window: int = 256,
                      nw: int = 2, escape_cap: int = 4096
                      ) -> Tuple[WindowedOperator, jax.Array]:
    """Build a WindowedOperator from (R, K) ELL columns/values/mask.

    Returns (op, overflow); overflow=True means the escape chute is too
    small and the operator is invalid.  Zero-value entries are treated
    as invalid (they contribute nothing).
    """
    r, k = cols.shape
    valid = valid & (vals != 0.0)
    nblk = -(-r // block)
    rpad = nblk * block

    safe_cols = jnp.where(valid, cols, jnp.iinfo(jnp.int32).max)
    cols_p = jnp.pad(safe_cols, ((0, rpad - r), (0, 0)),
                     constant_values=jnp.iinfo(jnp.int32).max)
    bc = cols_p.reshape(nblk, block * k)

    starts = []
    remaining = bc
    for _ in range(nw):
        s = jnp.min(remaining, axis=1)
        starts.append(s)
        remaining = jnp.where(remaining < s[:, None] + window,
                              jnp.iinfo(jnp.int32).max, remaining)
    win_start = jnp.stack(starts, axis=1)
    win_start = jnp.where(win_start > n_cols - 1, 0,
                          jnp.minimum(win_start,
                                      jnp.maximum(n_cols - window, 0)))
    win_start = jnp.maximum(win_start, 0).astype(jnp.int32)

    rows = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None],
                            (r, k))
    ws = win_start[rows // block]                       # (R, K, NW)
    c_s = jnp.where(valid, cols, 0)
    hit = (c_s[..., None] >= ws) & (c_s[..., None] < ws + window) & \
        valid[..., None]
    sel = jnp.argmax(hit, axis=-1).astype(jnp.int8)
    covered = jnp.any(hit, axis=-1)
    sel = jnp.where(covered, sel, -1)
    lidx = jnp.where(
        covered,
        c_s - jnp.take_along_axis(
            ws, jnp.maximum(sel, 0).astype(jnp.int32)[..., None],
            axis=-1)[..., 0],
        0).astype(jnp.int32)
    w = jnp.where(covered, vals, 0.0)

    esc = valid & ~covered
    n_esc = jnp.sum(esc)
    overflow = n_esc > escape_cap
    flat_rows = jnp.where(esc, rows, r).reshape(-1)
    order = jnp.argsort(flat_rows)[:escape_cap]
    esc_rows = flat_rows[order].astype(jnp.int32)
    esc_cols = jnp.where(esc, c_s, 0).reshape(-1)[order].astype(jnp.int32)
    esc_w = jnp.where(esc, vals, 0.0).reshape(-1)[order]

    return (WindowedOperator(win_start=win_start, sel=sel, lidx=lidx,
                             w=w, esc_rows=esc_rows, esc_cols=esc_cols,
                             esc_w=esc_w, n_rows=r, n_cols=n_cols,
                             block=block, window=window),
            overflow)


def windowed_matvec(op: WindowedOperator, x: jax.Array) -> jax.Array:
    """y = W x with x of length n_cols; returns (n_rows,)."""
    r, kf = op.w.shape
    nblk, nw = op.win_start.shape
    win = op.window
    blk = op.block
    rpad = nblk * blk

    xw = jnp.pad(x, (0, win))
    idx = op.win_start.reshape(-1)
    wins = jax.vmap(lambda s: jax.lax.dynamic_slice(xw, (s,), (win,)))(idx)
    wins = wins.reshape(nblk, 1, nw, win)

    def padb(a, fill):
        return jnp.pad(a, ((0, rpad - r),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    iota_w = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, win), 3)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, 1, nw, 1), 2)
    fsel = padb(op.sel, -1).reshape(nblk, blk, kf)
    flid = padb(op.lidx, 0).reshape(nblk, blk, kf)
    fw = padb(op.w, 0.0).reshape(nblk, blk, kf)
    acc = jnp.zeros((nblk, blk), x.dtype)
    for kslot in range(kf):
        sel = fsel[:, :, kslot].astype(jnp.int32)
        li = flid[:, :, kslot]
        onehot = ((iota_w == li[:, :, None, None])
                  & (iota_n == sel[:, :, None, None]))
        val = jnp.sum(jnp.where(onehot, wins, 0.0), axis=(2, 3))
        acc = acc + fw[:, :, kslot] * val
    y = acc.reshape(rpad)[:r]

    contrib = op.esc_w * x[jnp.minimum(op.esc_cols, op.n_cols - 1)]
    esc = jax.ops.segment_sum(contrib, jnp.minimum(op.esc_rows, r),
                              num_segments=r + 1,
                              indices_are_sorted=True)[:r]
    return y + esc
