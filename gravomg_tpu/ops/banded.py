"""Banded ELL SpMV (EXPERIMENTAL -- superseded, not shipped).

Quarantined per docs/DESIGN.md §7: the shipped formats are
``ops/slab.py`` (large levels) and ``ops/blockdense.py`` (small
levels).  Kept, with its tests, until the per-level format choice
settles (ROADMAP, Design 1).

The idea: replace the V*K scalar gathers of the plain ELL SpMV with
contiguous shifted reads wherever the index structure allows.  After a
spatial (Morton) vertex ordering, ~80-93% of neighbor offsets fall in a
narrow index band; the rest cluster into a handful of contiguous index
intervals per small row block (curve folds).  This module therefore
splits  A = D + B + F + E:

  * D   diagonal (V,)
  * B   in-band offdiagonals, |col-row| <= W: a (2W+1, V) diagonal
        sweep of shifted contiguous reads (bandwidth-bound, no gather);
  * F   far entries covered by up to NW per-block windows of width
        WIN: one row-gather of (NBLK*NW) window slices (~25k
        indices) + per-entry one-hot resolution against the
        2(WIN+NW) candidates (compares, no gather);
  * E   escape chute for entries in neither (rare fold pile-ups):
        exact sorted-COO, one small gather + segment-sum.

All shapes are static; conversion from :class:`EllOperator` is a
one-time jittable pass with overflow flags (no host sync).  The matvec
is numerically exact (same adds, different order).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import EllOperator, INVALID_INDEX


class BandedOperator(NamedTuple):
    """A = diag + bands + windowed-far + escape-COO (see module doc).

    Static aux: half_width W, block size BLK, window width WIN.
    Arrays:
      diag:      (V,)
      bands:     (2W+1, V); bands[j, r] = A[r, r + j - W]
      win_start: (NBLK, NW) int32 clamped window starts
      far_sel:   (V, KF) int8  window slot of each far entry (-1 pad)
      far_lidx:  (V, KF) int32 local index within the window
      far_w:     (V, KF) float entry values (0 pad)
      esc_rows:  (E,) int32 sorted row ids (V pad)
      esc_cols:  (E,) int32 column ids (0 pad)
      esc_w:     (E,) float values (0 pad)
    """

    diag: jax.Array
    bands: jax.Array
    win_start: jax.Array
    far_sel: jax.Array
    far_lidx: jax.Array
    far_w: jax.Array
    esc_rows: jax.Array
    esc_cols: jax.Array
    esc_w: jax.Array
    half_width: int
    block: int
    window: int

    @property
    def num_vertices(self) -> int:
        return self.diag.shape[0]


jax.tree_util.register_pytree_node(
    BandedOperator,
    lambda op: (tuple(op[:9]), (op.half_width, op.block, op.window)),
    lambda aux, ch: BandedOperator(*ch, *aux),
)


@functools.partial(jax.jit, static_argnames=("half_width", "block",
                                             "window", "nw", "kf",
                                             "escape_cap"))
def banded_from_ell(op: EllOperator, half_width: int = 128,
                    block: int = 16, window: int = 256, nw: int = 2,
                    kf: int | None = None, escape_cap: int | None = None
                    ) -> Tuple[BandedOperator, jax.Array]:
    """Convert an ELL operator to banded form.  Returns (op, overflow).

    overflow=True means the escape chute overflowed and the operator is
    invalid (retry with larger nw/escape_cap).  One-time cost: one
    scatter for the bands, one sort for the escape chute.
    """
    v, k = op.neighbors.shape
    w = half_width
    if kf is None:
        kf = k
    if escape_cap is None:
        escape_cap = max(1024, v // 16)
    nblk = -(-v // block)
    vpad = nblk * block

    rows = jnp.broadcast_to(jnp.arange(v, dtype=jnp.int32)[:, None],
                            (v, k))
    cols = op.safe_neighbors()
    vals = jnp.where(op.mask, op.offdiag, 0.0)
    valid = op.mask
    off = cols - rows
    in_band = valid & (jnp.abs(off) <= w)

    # --- B: scatter in-band entries into the (2W+1, V) band array ---
    flat = jnp.where(in_band, (off + w) * v + rows,
                     (2 * w + 1) * v).reshape(-1)
    bands = jnp.zeros(((2 * w + 1) * v + 1,), op.offdiag.dtype)
    bands = bands.at[flat].add(jnp.where(in_band, vals, 0.0).reshape(-1))
    bands = bands[:-1].reshape(2 * w + 1, v)

    # --- F: greedy per-block window cover of far entries ---
    far = valid & ~in_band
    fcols = jnp.where(far, cols, jnp.iinfo(jnp.int32).max)
    fcols_p = jnp.pad(fcols, ((0, vpad - v), (0, 0)),
                      constant_values=jnp.iinfo(jnp.int32).max)
    bc = fcols_p.reshape(nblk, block * k)

    starts = []
    remaining = bc
    for _ in range(nw):
        s = jnp.min(remaining, axis=1)                    # (NBLK,)
        starts.append(s)
        remaining = jnp.where(remaining < s[:, None] + window,
                              jnp.iinfo(jnp.int32).max, remaining)
    win_start = jnp.stack(starts, axis=1)                 # (NBLK, NW)
    # Clamp for gather validity; sentinel windows (no far entries) -> 0.
    win_start = jnp.where(win_start > v - 1,
                          0, jnp.minimum(win_start, v - window))
    win_start = jnp.maximum(win_start, 0).astype(jnp.int32)

    # Assign each far entry to a window slot (or -1 -> escape).
    blk_of_row = (rows // block)                          # (V, K)
    ws = win_start[blk_of_row]                            # (V, K, NW)
    hit = (cols[..., None] >= ws) & (cols[..., None] < ws + window)
    sel = jnp.argmax(hit, axis=-1).astype(jnp.int8)       # first hit
    covered = jnp.any(hit, axis=-1) & far
    sel = jnp.where(covered, sel, -1)
    lidx = jnp.where(covered,
                     cols - jnp.take_along_axis(
                         ws, jnp.maximum(sel, 0).astype(jnp.int32)[..., None],
                         axis=-1)[..., 0],
                     0).astype(jnp.int32)

    # Compact far entries to a (V, KF) prefix per row (stable order).
    keep = covered
    order = jnp.argsort(~keep, axis=1, stable=True)
    far_sel = jnp.take_along_axis(sel, order, axis=1)[:, :kf]
    far_lidx = jnp.take_along_axis(lidx, order, axis=1)[:, :kf]
    far_w = jnp.take_along_axis(jnp.where(keep, vals, 0.0), order,
                                axis=1)[:, :kf]
    kept_sorted = jnp.take_along_axis(keep, order, axis=1)
    far_sel = jnp.where(kept_sorted[:, :kf], far_sel, -1)
    far_w = jnp.where(kept_sorted[:, :kf], far_w, 0.0)
    kf_overflow = jnp.any(jnp.sum(keep, axis=1) > kf)

    # --- E: escape chute (valid & ~in_band & ~covered), sorted COO ---
    esc = valid & ~in_band & ~covered
    n_esc = jnp.sum(esc)
    esc_overflow = n_esc > escape_cap
    flat_rows = jnp.where(esc, rows, v).reshape(-1)
    sort_ix = jnp.argsort(flat_rows)[:escape_cap]
    esc_rows = flat_rows[sort_ix]
    esc_cols = jnp.where(esc, cols, 0).reshape(-1)[sort_ix]
    esc_w = jnp.where(esc, vals, 0.0).reshape(-1)[sort_ix]

    out = BandedOperator(
        diag=op.diag, bands=bands, win_start=win_start,
        far_sel=far_sel, far_lidx=far_lidx, far_w=far_w,
        esc_rows=esc_rows.astype(jnp.int32),
        esc_cols=esc_cols.astype(jnp.int32), esc_w=esc_w,
        half_width=w, block=block, window=window)
    return out, kf_overflow | esc_overflow


_BAND_GROUP = 64


def banded_spmv(op: BandedOperator, x: jax.Array) -> jax.Array:
    """y = A x, gather-free except ~(NBLK*NW + E) indices.

    The band sweep runs as a fori_loop over groups of ``_BAND_GROUP``
    unrolled shifted-FMA steps: fully unrolling hundreds of offsets
    blows past the compile-request size limit, while a flat per-offset
    loop pays loop overhead per V-element FMA.
    """
    v = op.num_vertices
    w = op.half_width
    blk, win = op.block, op.window
    nblk, nw = op.win_start.shape
    kf = op.far_w.shape[1]
    noff = 2 * w + 1

    # D + B: diagonal + shifted contiguous FMA sweep (grouped loop).
    g = _BAND_GROUP
    ng = -(-noff // g)
    xp = jnp.pad(x, (w, w + ng * g - noff))
    bands_p = (op.bands if ng * g == noff else
               jnp.pad(op.bands, ((0, ng * g - noff), (0, 0))))
    acc0 = op.diag * x

    def group(gi, acc):
        def step(t, acc):
            j = gi * g + t
            band = jax.lax.dynamic_slice(bands_p, (j, 0), (1, v))[0]
            return acc + band * jax.lax.dynamic_slice(xp, (j,), (v,))
        return jax.lax.fori_loop(0, g, step, acc, unroll=g)

    acc = jax.lax.fori_loop(0, ng, group, acc0)

    # F: gather (NBLK, NW, WIN) windows -- NBLK*NW indices only -- then
    # resolve each far entry by one-hot compare inside its own block's
    # windows (block-shaped, no per-row gather).
    xw = jnp.pad(x, (0, win))
    idx = op.win_start.reshape(-1)                        # (NBLK*NW,)
    wins = jax.vmap(lambda s: jax.lax.dynamic_slice(xw, (s,), (win,)))(idx)
    wins = wins.reshape(nblk, 1, nw, win)
    vpad = nblk * blk
    pad_rows = vpad - v

    def padb(a, fill):
        return jnp.pad(a, ((0, pad_rows),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    iota_w = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, win), 3)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (1, 1, nw, 1), 2)
    far = jnp.zeros((nblk, blk), x.dtype)
    fsel = padb(op.far_sel, -1).reshape(nblk, blk, kf)
    flid = padb(op.far_lidx, 0).reshape(nblk, blk, kf)
    fw = padb(op.far_w, 0.0).reshape(nblk, blk, kf)
    for kslot in range(kf):
        sel = fsel[:, :, kslot].astype(jnp.int32)         # (NBLK, BLK)
        li = flid[:, :, kslot]
        onehot = ((iota_w == li[:, :, None, None])
                  & (iota_n == sel[:, :, None, None]))    # (NBLK,BLK,NW,WIN)
        val = jnp.sum(jnp.where(onehot, wins, 0.0), axis=(2, 3))
        far = far + fw[:, :, kslot] * val
    acc = acc + far.reshape(vpad)[:v]

    # E: exact escape chute (sorted-COO gather + segment sum).
    contrib = op.esc_w * x[jnp.minimum(op.esc_cols, v - 1)]
    esc = jax.ops.segment_sum(contrib, jnp.minimum(op.esc_rows, v),
                              num_segments=v + 1,
                              indices_are_sorted=True)[:v]
    return acc + esc
