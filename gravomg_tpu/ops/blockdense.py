"""Block-window dense SpMV: the gather-free sparse matvec.

The format was shaped by an accelerator on which every gathered index
cost far more than a streamed byte: it PRECOMPUTES the selection,
storing each row's sparse entries as a dense row over a small set of
per-block column windows, so a matvec gathers one index per window
instead of one per nonzero.  It pays for that in bytes (the windows are
mostly zeros); chip_smoke.py's per-level table sets those bytes and
times against the plain ELL product on the GPU.

For a row block b (BLK consecutive rows after spatial ordering):
  * NW column windows of width WIN each; window 0 is anchored on the
    block itself (the diagonal band), the rest greedily cover the
    block's remaining (fold) columns;
  * M[b] is a dense (BLK, NW*WIN) matrix holding A's off-diagonal
    entries at their window-local positions (zeros elsewhere), built
    ONCE at conversion;
  * uncovered stragglers go to an exact sorted-COO escape chute.

The matvec is then
  y = diag * x + einsum(M[b], gathered windows) + escape,
one (NBLK*NW)-index slice-gather plus a dense batched GEMV that streams
M -- no runtime index resolution at all.

Also used rectangularly (prolongation U, restriction U^T): pass the
source length explicitly; window 0 anchors at the scaled diagonal
(row * n_cols / n_rows).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.types import EllOperator, INVALID_INDEX


class BlockDenseOperator(NamedTuple):
    """y = diag*x + blockdense(M, x) + escape (see module doc).

    Arrays:
      diag:      (R,) or None (rectangular operators have no diagonal).
      m:         (NBLK, BLK, WIN0 + (NW-1)*WIN) dense window-local
                 entries; window 0 (the block's diagonal band) may be
                 wider than the far windows.
      win_start: (NBLK, NW) int32 window starts into the source vector.
      esc_rows/esc_cols/esc_w: sorted-COO escape chute.
    Static aux: n_rows, n_cols, block, window (far width), window0.
    """

    diag: Optional[jax.Array]
    m: jax.Array
    win_start: jax.Array
    esc_rows: jax.Array
    esc_cols: jax.Array
    esc_w: jax.Array
    n_rows: int
    n_cols: int
    block: int
    window: int
    window0: int
    align: int = 0      # static: window starts are multiples of this

    @property
    def nw(self) -> int:
        return self.win_start.shape[1]


jax.tree_util.register_pytree_node(
    BlockDenseOperator,
    lambda op: (tuple(op[:6]),
                (op.n_rows, op.n_cols, op.block, op.window, op.window0,
                 op.align)),
    lambda aux, ch: BlockDenseOperator(*ch, *aux),
)


@functools.partial(jax.jit, static_argnames=("n_cols", "block", "window",
                                             "nw", "escape_cap",
                                             "combine", "window0",
                                             "align"))
def blockdense_from_ell(cols: jax.Array, vals: jax.Array,
                        valid: jax.Array, n_cols: int,
                        diag: Optional[jax.Array] = None,
                        block: int = 64, window: int = 256, nw: int = 4,
                        escape_cap: int = 8192, combine: str = "add",
                        window0: Optional[int] = None,
                        anchors: Optional[jax.Array] = None,
                        align: int = 0
                        ) -> Tuple[BlockDenseOperator, jax.Array]:
    """Build a BlockDenseOperator from (R, K) ELL columns/values/mask.

    Window 0 anchors at the block's scaled diagonal and may be wider
    (``window0``, default = window) than the far windows: the diagonal
    band needs block + 2*bandwidth coverage while fold clusters are
    narrow, so wide-w0/narrow-far keeps coverage without inflating the
    per-row dense width.  Windows 1..NW-1 greedily cover the remaining
    columns.  Returns (op, overflow) -- overflow means the escape
    chute is too small (retry with larger nw / escape_cap).  One
    jittable pass; the dense M is built by a single scatter-add.

    ``align`` (e.g. 128) floors every window start to that multiple,
    which lets the matvec gather whole rows of a (NSEG, 128) view of x
    (see :func:`_gather_windows`).  Costs slightly more window
    coverage; semantics otherwise identical.
    """
    if window0 is None:
        window0 = window
    r, k = cols.shape
    if combine == "add":
        valid = valid & (vals != 0.0)   # zero entries contribute nothing
    nblk = -(-r // block)
    rpad = nblk * block
    imax = jnp.iinfo(jnp.int32).max

    safe_cols = jnp.where(valid, cols, imax)
    cols_p = jnp.pad(safe_cols, ((0, rpad - r), (0, 0)),
                     constant_values=imax)
    bc = cols_p.reshape(nblk, block * k)

    # Window 0 anchor: explicit per-block centers when provided (for
    # rectangular transfers the coarse<->fine index map is monotone but
    # NOT linear -- sampling-density drift puts the true center ~1e3
    # indices off the n_cols/r guess at bench scale), else the scaled
    # diagonal.
    ratio = n_cols / r
    if anchors is not None:
        anchor = anchors.astype(jnp.int32) - window0 // 2
    else:
        anchor = (jnp.arange(nblk) * block * ratio).astype(jnp.int32) \
            - (window0 - int(block * ratio)) // 2
    if align:
        assert align <= window, "alignment must not exceed window width"
        # x is padded past n_cols by the matvec, so w0 may run off the
        # right edge; clipping to n_cols - window0 would shift it off
        # its columns instead.
        w0 = jnp.clip(anchor, 0, max(n_cols - 1, 0))
        w0 = (w0 // align) * align
    else:
        w0 = jnp.clip(anchor, 0, max(n_cols - window0, 0))
    starts = [w0]
    remaining = jnp.where((bc >= w0[:, None])
                          & (bc < w0[:, None] + window0), imax, bc)
    for _ in range(nw - 1):
        s = jnp.min(remaining, axis=1)
        if align:
            # Flooring keeps coverage: s_al <= s = min(remaining) and
            # s - s_al < align <= window, so the window still covers s.
            s = jnp.where(s < imax, (s // align) * align, s)
        starts.append(s)
        remaining = jnp.where(remaining < s[:, None] + window, imax,
                              remaining)
    win_start = jnp.stack(starts, axis=1)
    if align:
        # No right-edge clipping needed: the matvec pads x by
        # max(window, window0) zeros, so any aligned start <= n_cols-1
        # slices in-bounds; clipping would shift windows off their
        # columns and inflate the escape chute.
        win_start = jnp.where(win_start > n_cols - 1, 0, win_start)
    else:
        widths = np.array([window0] + [window] * (nw - 1), np.int32)
        lims = jnp.asarray(np.maximum(n_cols - widths, 0))[None, :]
        win_start = jnp.where(win_start > n_cols - 1, 0,
                              jnp.minimum(win_start, lims))
    win_start = jnp.maximum(win_start, 0).astype(jnp.int32)

    rows = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None],
                            (r, k))
    c_s = jnp.where(valid, cols, 0)
    # First-hit window assignment, looped over the (small) window count
    # with 2-D temps only: an (R, K, NW) tensor has a tiny minor dim
    # that tiled layouts can pad many-fold.
    row_blk = jnp.arange(r, dtype=jnp.int32) // block   # (R,)
    sel = jnp.full((r, k), -1, jnp.int32)
    pos = jnp.zeros((r, k), jnp.int32)
    offsets = [0]
    for wi in range(nw - 1):
        offsets.append(window0 + wi * window)
    for wi in range(nw):
        width = window0 if wi == 0 else window
        ws_w = win_start[:, wi][row_blk][:, None]       # (R, 1)
        hit = valid & (sel < 0) & (c_s >= ws_w) & (c_s < ws_w + width)
        sel = jnp.where(hit, wi, sel)
        pos = jnp.where(hit, offsets[wi]
                        + jnp.clip(c_s - ws_w, 0, width - 1), pos)
    covered = sel >= 0

    # Dense M by one scatter into (rpad * NWW + 1,).  combine="min"
    # builds a min-plus operator: empty slots hold +inf so the tropical
    # matvec min_w(M + win) ignores them.
    nww = window0 + (nw - 1) * window
    flat = jnp.where(covered,
                     rows * nww + pos,
                     rpad * nww).reshape(-1)
    if combine == "add":
        m = jnp.zeros((rpad * nww + 1,), vals.dtype)
        m = m.at[flat].add(jnp.where(covered, vals, 0.0).reshape(-1))
    elif combine == "min":
        m = jnp.full((rpad * nww + 1,), jnp.inf, vals.dtype)
        m = m.at[flat].min(jnp.where(covered, vals,
                                     jnp.inf).reshape(-1))
    else:
        raise ValueError(f"unknown combine mode {combine!r}")
    m = m[:-1].reshape(nblk, block, nww)

    # Escape chute.
    esc = valid & ~covered
    n_esc = jnp.sum(esc)
    overflow = n_esc > escape_cap
    flat_rows = jnp.where(esc, rows, r).reshape(-1)
    order = jnp.argsort(flat_rows)[:escape_cap]
    esc_rows = flat_rows[order].astype(jnp.int32)
    esc_cols = jnp.where(esc, c_s, 0).reshape(-1)[order].astype(jnp.int32)
    esc_w = jnp.where(esc, vals, 0.0).reshape(-1)[order]

    return (BlockDenseOperator(diag=diag, m=m, win_start=win_start,
                               esc_rows=esc_rows, esc_cols=esc_cols,
                               esc_w=esc_w, n_rows=r, n_cols=n_cols,
                               block=block, window=window,
                               window0=window0, align=align),
            overflow)


def trim_escape(op: BlockDenseOperator,
                align: int = 128) -> BlockDenseOperator:
    """Host-level: slice the escape COO down to its actual fill
    (rounded up to ``align`` slots; sorted padding sits at the tail).

    The jittable build pads the chute to a static ``escape_cap``, and
    every slot costs a gather + segment-sum per matvec regardless of
    fill (the slab's per-bucket caps summed to 655k slots carrying a
    few thousand entries).  Syncs one scalar -- call only from the
    host-interactive attach phase, never under jit.
    """
    if not op.esc_rows.shape[0]:
        return op
    n = int(jnp.sum(op.esc_rows < op.n_rows))
    cap = 0 if n == 0 else min(-(-n // align) * align,
                               op.esc_rows.shape[0])
    if cap == op.esc_rows.shape[0]:
        return op
    return op._replace(esc_rows=op.esc_rows[:cap],
                       esc_cols=op.esc_cols[:cap],
                       esc_w=op.esc_w[:cap])


def _gather_windows(op: BlockDenseOperator, x: jax.Array) -> jax.Array:
    """(NBLK, 1, NWW) concatenated window contents of x.

    Aligned operators (align=128) gather ROWS of a (NSEG, 128) 2-D view
    of x instead of vmapped 1-D dynamic slices: one index per 128
    entries."""
    nblk, nw = op.win_start.shape
    win, win0 = op.window, op.window0
    if op.align == 128:
        pad = -(-(x.shape[0] + max(win, win0)) // 128) * 128 - x.shape[0]
        x2 = jnp.pad(x, (0, pad)).reshape(-1, 128)
        offs = []
        for wi in range(nw):
            w = win0 if wi == 0 else win
            offs.append(jnp.arange(w // 128, dtype=op.win_start.dtype))
        # (NBLK, NSEG_TOTAL) segment rows for every 128-wide piece.
        segs = jnp.concatenate(
            [op.win_start[:, wi:wi + 1] // 128 + offs[wi][None, :]
             for wi in range(nw)], axis=1)
        wins = x2[segs.reshape(-1)].reshape(nblk, 1, -1)
        return wins
    xw = jnp.pad(x, (0, max(win, win0)))
    w0 = jax.vmap(lambda s: jax.lax.dynamic_slice(xw, (s,), (win0,)))(
        op.win_start[:, 0])
    parts = [w0]
    if nw > 1:
        far = jax.vmap(lambda s: jax.lax.dynamic_slice(xw, (s,), (win,)))(
            op.win_start[:, 1:].reshape(-1))
        parts.append(far.reshape(nblk, (nw - 1) * win))
    return jnp.concatenate(parts, axis=1)[:, None, :]


def blockdense_matvec(op: BlockDenseOperator, x: jax.Array) -> jax.Array:
    """y = A x; x has length n_cols, result n_rows."""
    r = op.n_rows
    wins = _gather_windows(op, x).astype(op.m.dtype)

    # Broadcast-multiply + lane reduce rather than a batched
    # dot_general: the GEMV right-hand side is a vector, and this keeps
    # the f32 sum exact (no TF32 passes).
    acc_dt = jnp.promote_types(op.m.dtype, jnp.float32)
    y = jnp.sum(op.m * wins, axis=2, dtype=acc_dt)      # (NBLK, BLK)
    y = y.reshape(-1)[:r].astype(x.dtype)

    if op.esc_w.shape[0]:
        contrib = op.esc_w * x[jnp.minimum(op.esc_cols, op.n_cols - 1)]
        y = y + jax.ops.segment_sum(
            contrib.astype(x.dtype), jnp.minimum(op.esc_rows, r),
            num_segments=r + 1, indices_are_sorted=True)[:r]
    if op.diag is not None:
        y = y + op.diag * x
    return y


def blockdense_from_operator(op: EllOperator, **kw
                             ) -> Tuple[BlockDenseOperator, jax.Array]:
    """Square-operator convenience wrapper (keeps the diagonal exact)."""
    return blockdense_from_ell(op.neighbors, op.offdiag, op.mask,
                               op.num_vertices, diag=op.diag, **kw)


def block_anchors(cols: jax.Array, valid: jax.Array,
                  block: int) -> jax.Array:
    """Per-block window-0 anchor = median-ish center of each row
    block's valid columns (min+max)/2 -- cheap, robust to folds."""
    r, k = cols.shape
    nblk = -(-r // block)
    imax = jnp.iinfo(jnp.int32).max
    up = jnp.where(valid, cols, imax)
    lo = jnp.pad(up, ((0, nblk * block - r), (0, 0)),
                 constant_values=imax).reshape(nblk, block * k)
    cmin = jnp.min(lo, axis=1)
    dn = jnp.where(valid, cols, -1)
    hi = jnp.pad(dn, ((0, nblk * block - r), (0, 0)),
                 constant_values=-1).reshape(nblk, block * k)
    cmax = jnp.max(hi, axis=1)
    # Empty blocks: anchor 0.  min+max midpoint is fold-sensitive, so
    # use the MEDIAN of each block's first-valid-column per row instead
    # when available: rows' first columns are the parent-adjacent
    # cluster centers.
    first = jnp.where(valid[:, 0], cols[:, 0],
                      jnp.where(jnp.any(valid, 1),
                                jnp.max(jnp.where(valid, cols, -1), 1),
                                0))
    fb = jnp.pad(first, (0, nblk * block - r)).reshape(nblk, block)
    med = jnp.median(fb, axis=1).astype(jnp.int32)
    ok = cmin <= cmax
    return jnp.where(ok, med, 0).astype(jnp.int32)


def blockdense_minplus(op: BlockDenseOperator, x: jax.Array) -> jax.Array:
    """Tropical matvec y[r] = min_k (w[r,k] + x[cols[r,k]]).

    Requires an operator built with combine="min" (+inf padding).  Used
    for shortest-path relaxation sweeps (Bellman-Ford) in place of the
    plain one-gather-per-entry formulation.  The escape chute
    combines with min; a missing diagonal contributes nothing.
    """
    r = op.n_rows
    wins = _gather_windows(op, jnp.where(jnp.isinf(x), jnp.inf, x))
    # Padding beyond n_cols reads zeros from _gather_windows' pad; mask
    # them to +inf via the M entries (+inf in empty slots) -- a real
    # entry never points past n_cols, so zero-padded window slots only
    # meet +inf M slots.
    y = jnp.min(op.m + wins, axis=2)                    # (NBLK, BLK)
    y = y.reshape(-1)[:r]

    if op.esc_w.shape[0]:
        cand = op.esc_w + x[jnp.minimum(op.esc_cols, op.n_cols - 1)]
        esc = jax.ops.segment_min(cand, jnp.minimum(op.esc_rows, r),
                                  num_segments=r + 1,
                                  indices_are_sorted=True)[:r]
        y = jnp.minimum(y, esc)
    return y


def blockdense_minplus2(op: BlockDenseOperator, x_dist: jax.Array,
                        x_pri: jax.Array, thresh) -> tuple:
    """Two tropical reductions in ONE stream of M:

      yd[i] = min_j (m_ij + x_dist[j])                (distance min-plus)
      yp[i] = min over j with m_ij < thresh of x_pri[j]

    The chained-gate MIS sampler needs both a shortest-path relaxation
    (selected-conflict distances) and a neighborhood-min of priorities
    (the wait gate) per round; running them as two
    :func:`blockdense_minplus` calls streams M twice AND materializes a
    second full-size operator with its entries zeroed (2.6 GB at 1M).
    Here the gate is derived from M on the fly and both minima ride one
    variadic reduce, so XLA's input fusion reads M once.
    Requires a combine="min" operator (+inf empty slots; an empty slot
    fails the threshold, so it drops out of both reductions).
    """
    r = op.n_rows
    wd = _gather_windows(op, jnp.where(jnp.isinf(x_dist), jnp.inf, x_dist))
    wp = _gather_windows(op, x_pri)
    gate = jnp.where(op.m < thresh, 0.0, jnp.inf).astype(op.m.dtype)
    inf = jnp.asarray(jnp.inf, op.m.dtype)
    yd, yp = jax.lax.reduce((op.m + wd, gate + wp), (inf, inf),
                            lambda a, b: (jnp.minimum(a[0], b[0]),
                                          jnp.minimum(a[1], b[1])), (2,))
    yd = yd.reshape(-1)[:r]
    yp = yp.reshape(-1)[:r]

    if op.esc_w.shape[0]:
        seg = jnp.minimum(op.esc_rows, r)
        col = jnp.minimum(op.esc_cols, op.n_cols - 1)
        cd = op.esc_w + x_dist[col]
        cp = jnp.where(op.esc_w < thresh, x_pri[col], jnp.inf)
        yd = jnp.minimum(yd, jax.ops.segment_min(
            cd, seg, num_segments=r + 1, indices_are_sorted=True)[:r])
        yp = jnp.minimum(yp, jax.ops.segment_min(
            cp, seg, num_segments=r + 1, indices_are_sorted=True)[:r])
    return yd, yp
