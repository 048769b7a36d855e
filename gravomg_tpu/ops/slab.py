"""Bucketed variable-window SpMV: pay only for the windows each row
block actually needs.

Motivation (scripts/analyze_spread.py, scripts/slab_totals.py at 200k):
after Morton ordering the median row block needs ~3 column windows but
the p99 block needs ~13 (torus seam rows), so the uniform block-dense
format (ops/blockdense.py) must size every block for the tail -- its
level-0 window matrix is ~1.1 GB at ~1% useful density.  Variable
windows cut that array to ~280-460 MB.

Design: partition row blocks into BUCKETS by their greedy first-fit
window count, permute blocks so each bucket is contiguous, and build
one uniform BlockDenseOperator per bucket (window count = bucket cap).
The matvec runs one XLA block-dense product per bucket and un-permutes
the output at BLOCK granularity (one (NBLK,)-row gather).

Everything except bucket sizing runs on device; the conversion is
meant for the post-`check_diagnostics` phase (the process has already
synced) like attach_fast_operators.

Reference context: execution form for the hierarchy operators of
the reference's `src/multigrid.cpp`; no reference counterpart (it is a
sequential Eigen library).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.compile_cache import run_concurrently
from gravomg_tpu.ops.blockdense import (BlockDenseOperator,
                                        blockdense_from_ell,
                                        blockdense_matvec, trim_escape)


class SlabOperator(NamedTuple):
    """y = diag*x + concat_k(bucket_k(x))[inv_block_perm] (module doc)."""

    diag: Optional[jax.Array]
    buckets: Tuple[BlockDenseOperator, ...]
    inv_block_perm: jax.Array       # (NBLK,) int32 into concat'd blocks
    n_rows: int
    n_cols: int
    block: int

    @property
    def m_bytes(self) -> int:
        return sum(b.m.size * b.m.dtype.itemsize for b in self.buckets)


jax.tree_util.register_pytree_node(
    SlabOperator,
    lambda op: ((op.diag, op.buckets, op.inv_block_perm),
                (op.n_rows, op.n_cols, op.block)),
    lambda aux, ch: SlabOperator(*ch, *aux),
)


@functools.partial(jax.jit, static_argnames=("block", "window", "nw_max",
                                             "align"))
def window_counts(cols: jax.Array, valid: jax.Array, block: int,
                  window: int, nw_max: int = 24, align: int = 0):
    """Per-block greedy first-fit window counts (same rule as
    blockdense_from_ell's far-window placement; ``align`` floors each
    start like blockdense_from_ell(align=...)).  Returns
    ((NBLK,) int32 counts, (NBLK,) int32 first-window start, overflow).
    """
    r, k = cols.shape
    nblk = -(-r // block)
    imax = jnp.iinfo(jnp.int32).max
    safe = jnp.where(valid, cols, imax)
    bc = jnp.pad(safe, ((0, nblk * block - r), (0, 0)),
                 constant_values=imax).reshape(nblk, block * k)
    remaining = bc
    counts = jnp.zeros((nblk,), jnp.int32)
    first = jnp.full((nblk,), 0, jnp.int32)
    for wi in range(nw_max):
        s = jnp.min(remaining, axis=1)
        if align:
            s = jnp.where(s < imax, (s // align) * align, s)
        has = s < imax
        if wi == 0:
            first = jnp.where(has, s, 0).astype(jnp.int32)
        counts = counts + has.astype(jnp.int32)
        remaining = jnp.where(remaining < s[:, None] + window, imax,
                              remaining)
    overflow = jnp.any(jnp.min(remaining, axis=1) < imax)
    return counts, first, overflow


# Bucket caps: counts round UP to the nearest entry, bounding both the
# number of compiled kernels and the padding waste (< ~25%).
_BUCKET_CAPS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24)


def slab_from_ell(cols: jax.Array, vals: jax.Array, valid: jax.Array,
                  n_cols: int, diag: Optional[jax.Array] = None,
                  block: int = 8, window: int = 128, nw_max: int = 24,
                  escape_cap: int = 4096, dtype=None,
                  align: int = 128) -> SlabOperator:
    """Build a SlabOperator from (R, K) ELL columns/values/mask.

    Host-interactive (syncs the per-block window counts); call after
    the device-resident build phase, like attach_fast_operators.
    Raises if nw_max windows cannot cover some block (pathological
    ordering) -- fall back to the uniform format in that case.
    """
    r, k = cols.shape
    if vals is not None:
        valid = valid & (vals != 0.0)
    counts, first, ovf = window_counts(cols, valid, block, window, nw_max,
                                       align=align)
    if bool(ovf):
        raise ValueError(
            f"slab_from_ell: >{nw_max} windows needed for some block; "
            "is the cloud spatially ordered?")
    counts_h = np.asarray(counts)
    nblk = counts_h.shape[0]
    caps = np.asarray(_BUCKET_CAPS, np.int32)
    caps = caps[caps <= max(nw_max, 1)]
    # Empty blocks (all-padding) ride in the smallest bucket.
    cap_idx = np.searchsorted(caps, np.maximum(counts_h, 1))
    perm = np.argsort(cap_idx, kind="stable").astype(np.int32)

    # Permute rows into bucket order (device gather, conversion-only).
    rpad = nblk * block
    cols_p = jnp.pad(jnp.where(valid, cols, 0), ((0, rpad - r), (0, 0)))
    valid_p = jnp.pad(valid, ((0, rpad - r), (0, 0)))
    vals_p = jnp.pad(vals, ((0, rpad - r), (0, 0)))
    row_perm = (jnp.asarray(perm)[:, None] * block
                + jnp.arange(block)[None, :]).reshape(-1)
    cols_s = cols_p[row_perm]
    vals_s = vals_p[row_perm]
    valid_s = valid_p[row_perm]
    first_s = np.asarray(first)[perm]

    def build_bucket(start, nb, cap):
        lo, hi = start * block, (start + nb) * block
        anch = first_s[start:start + nb]
        # Anchor window 0 at each block's first-fit start so the
        # placement matches window_counts exactly (blockdense's default
        # anchor is the scaled diagonal, which is not first-fit).
        bop, b_ovf = blockdense_from_ell(
            cols_s[lo:hi], vals_s[lo:hi], valid_s[lo:hi], n_cols,
            diag=None, block=block, window=window, nw=cap,
            escape_cap=escape_cap, window0=window,
            anchors=jnp.asarray(anch + window // 2), align=align)
        if bool(b_ovf):
            raise ValueError("slab_from_ell: escape overflow in bucket "
                             f"cap={cap} (escape_cap={escape_cap})")
        # Static escape_cap slots cost a gather per matvec even when
        # empty; slice to the actual fill (host sync, fine here -- this
        # whole builder is host-interactive).
        bop = trim_escape(bop)
        if dtype is not None:
            bop = bop._replace(m=bop.m.astype(dtype))
        return bop

    jobs = []
    start = 0
    inv = np.empty((nblk,), np.int32)
    for ci in range(len(caps)):
        nb = int(np.sum(cap_idx == ci))
        if nb == 0:
            continue
        jobs.append(functools.partial(build_bucket, start, nb,
                                      int(caps[ci])))
        inv[perm[start:start + nb]] = start + np.arange(nb)
        start += nb
    # Buckets are independent and each compiles its own shapes.
    buckets = run_concurrently(jobs)

    return SlabOperator(diag=diag, buckets=tuple(buckets),
                        inv_block_perm=jnp.asarray(inv), n_rows=r,
                        n_cols=n_cols, block=block)


def slab_matvec(op: SlabOperator, x: jax.Array) -> jax.Array:
    """y = A x via per-bucket block-dense products + block-level
    un-permutation."""
    parts = [blockdense_matvec(b, x).reshape(-1, op.block)
             for b in op.buckets]
    ycat = jnp.concatenate(parts, axis=0)            # (NBLK, BLK)
    y = ycat[op.inv_block_perm].reshape(-1)[:op.n_rows]
    if op.diag is not None:
        y = y + op.diag * x
    return y


def slab_from_operator(op, **kw) -> SlabOperator:
    """Square-operator convenience wrapper (keeps the diagonal exact)."""
    return slab_from_ell(op.neighbors, op.offdiag, op.mask,
                         op.num_vertices, diag=op.diag, **kw)
