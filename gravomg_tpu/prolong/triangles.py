"""Voronoi-triangle enumeration on the coarse graph.

Reference C9 ``constructVoronoiTriangles`` (`src/multigrid.cpp:209-263`):
for each vertex v0, every pair of its neighbors (v1, v2) with
v0 < v1 < v2 that are themselves adjacent forms a triangle; the normal is
``normalize((p1 - p0) x (p2 - p0))`` (`src/multigrid.cpp:240-242`;
winding, and hence normal sign, is arbitrary -- downstream math is
sign-robust, SURVEY.md §2.1-C9).  Triangle ids are assigned in
enumeration order and per-vertex association lists are therefore
ascending (`src/multigrid.cpp:253-256`); we reproduce both exactly, since
the prolongation's first-hit tie-break iterates association lists in
order (`src/multigrid.cpp:356,374-380`).

Fixed-shape form: the candidate tensor (C, K, K) over sorted neighbor-slot
pairs is evaluated with a vectorized adjacency membership test, compacted
with a static-size nonzero, and association lists are grouped with one
stable sort (SURVEY.md §7 step 3).

Launch structure: the per-anchor key extraction is issued as several
bounded launches of ``_SLAB`` rows each (a Python loop, no syncs)
rather than one fused launch of ~104 chunk sorts at 1M vertices, which
also bounds compile size.  Assembly (global ids,
normals, association lists) is one further launch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import Graph, TriangleSet, INVALID_INDEX
from gravomg_tpu.ops.segment import group_ordered

_SLAB = 32768          # rows per launch in the key-extraction phase
_CHUNK = 4096          # rows per lax.map step inside a launch


@functools.partial(jax.jit, static_argnames=("row_cap",))
def _anchored_keys_slab(nbrs: jax.Array, raws: jax.Array, ms: jax.Array,
                        idxs: jax.Array, raw_full: jax.Array,
                        row_cap: int):
    """Per-anchor compacted (k1, k2) pair codes for one row slab.

    nbrs/raws/ms: (S, K) safe-neighbors / raw (imax-pad) / mask rows;
    idxs: (S,) global row indices; raw_full: (C, K) full raw table for
    the membership gather.  Returns (keys (S, row_cap), counts (S,)).
    """
    s, k = nbrs.shape
    chunk = max(1, min(s, _CHUNK))
    slot_ok = (jnp.arange(k)[:, None] < jnp.arange(k)[None, :])[None]

    def anchored_chunk(args):
        nbrc, rawc, mc, idxc = args     # (cc, K) x3, (cc,)
        # Candidate (v0; slot k1 < slot k2).  Rows are ascending, so
        # slot order == index order and v2 > v1 automatically; the
        # reference's `vertex_1 < vertex_0 -> skip`
        # (`src/multigrid.cpp:225,232`) reduces to v1 > v0.
        pmc = mc[:, :, None] & mc[:, None, :] & slot_ok
        pmc &= nbrc[:, :, None] > idxc[:, None, None]
        # Adjacency membership: exists[c, k1, k2] = v2 in
        # neighbors(v1).  Dense equality over the inner slot --
        # O(K^3) compares but compare-bound, not gather-bound (the
        # earlier searchsorted form lowers to ~K^2 log K serial gathers
        # per vertex).  imax padding in rows_v1 can only
        # equal imax padding in rawc, and those slots are masked off by
        # pmc.
        rows_v1 = raw_full[nbrc]                       # (cc, K, K_inner)
        exists = None
        for ki in range(k):
            eq = rows_v1[:, :, ki][:, :, None] == rawc[:, None, :]
            exists = eq if exists is None else (exists | eq)
        tm = pmc & exists                              # (cc, K, K) bool
        # Compact each row's valid (k1, k2) pairs in lex order.
        code = (jnp.arange(k, dtype=jnp.int32)[:, None] * k
                + jnp.arange(k, dtype=jnp.int32)[None, :])[None]
        keys = jnp.where(tm, code, jnp.int32(k * k)).reshape(-1, k * k)
        keys = jnp.sort(keys, axis=1)[:, :row_cap]     # (cc, row_cap)
        counts = jnp.sum(tm, axis=(1, 2)).astype(jnp.int32)
        return keys, counts

    spad = ((s + chunk - 1) // chunk) * chunk
    pad = spad - s

    def padc(a, fill=0):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    keys, counts = jax.lax.map(
        anchored_chunk,
        (padc(nbrs).reshape(-1, chunk, k),
         padc(raws, 0).reshape(-1, chunk, k),
         padc(ms, False).reshape(-1, chunk, k),
         padc(idxs, 0).reshape(-1, chunk)))
    return (keys.reshape(spad, row_cap)[:s],
            counts.reshape(spad)[:s])


@functools.partial(jax.jit, static_argnames=("max_triangles", "max_assoc",
                                             "row_cap"))
def _assemble(keys: jax.Array, row_counts: jax.Array, nbr: jax.Array,
              points: jax.Array, max_triangles: int, max_assoc: int,
              row_cap: int):
    c, k = nbr.shape
    idx = jnp.arange(c, dtype=jnp.int32)
    row_overflow = jnp.any(row_counts > row_cap)
    row_counts = jnp.minimum(row_counts, row_cap)

    # Global triangle ids = exclusive row offsets + in-row slot: exactly
    # the reference's (v0, k1, k2) enumeration order.
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(row_counts, dtype=jnp.int32)])
    total = offsets[-1]
    overflow = (total > max_triangles) | row_overflow
    slot = jnp.arange(row_cap, dtype=jnp.int32)[None, :]
    valid_rc = slot < row_counts[:, None]
    tid_pos = jnp.where(valid_rc, offsets[:-1, None] + slot,
                        max_triangles)                 # (C, row_cap)
    t_v0_src = jnp.broadcast_to(idx[:, None], (c, row_cap))
    safe_keys = jnp.where(valid_rc, keys, 0)
    t_k1_src = safe_keys // k
    t_k2_src = safe_keys % k

    def scatter_flat(src):
        buf = jnp.full((max_triangles + 1,), 0, jnp.int32)
        return buf.at[tid_pos.reshape(-1)].set(
            src.reshape(-1))[:max_triangles]

    t_v0 = scatter_flat(t_v0_src)
    t_k1 = scatter_flat(t_k1_src)
    t_k2 = scatter_flat(t_k2_src)
    valid_t = jnp.arange(max_triangles) < total
    t_v1 = nbr[t_v0, t_k1]
    t_v2 = nbr[t_v0, t_k2]
    vertices = jnp.stack([t_v0, t_v1, t_v2], axis=1)
    vertices = jnp.where(valid_t[:, None], vertices, INVALID_INDEX)

    p0 = points[t_v0]
    p1 = points[t_v1]
    p2 = points[t_v2]
    cr = jnp.cross(p1 - p0, p2 - p0)
    normals = cr / jnp.maximum(
        jnp.linalg.norm(cr, axis=1, keepdims=True), 1e-30)

    # Association lists: triangle ids grouped per vertex, ascending.
    # Payload encodes 3*tid + slot-of-this-vertex; a vertex appears at
    # most once per triangle (v0 < v1 < v2 strict), so ordering by the
    # encoded payload equals ordering by tid and the decoded ``assoc``
    # is bit-identical to the plain-tid grouping.  The slot rides along
    # for free and feeds the affine prolongation path's per-rotation
    # coefficient gather.
    tid = jnp.arange(max_triangles, dtype=jnp.int32)
    rows = jnp.concatenate([t_v0, t_v1, t_v2])
    pay = jnp.concatenate([3 * tid, 3 * tid + 1, 3 * tid + 2])
    av = jnp.concatenate([valid_t, valid_t, valid_t])
    enc, _, assoc_overflow = group_ordered(rows, pay, av, c, max_assoc)
    aval = enc != INVALID_INDEX
    assoc = jnp.where(aval, enc // 3, INVALID_INDEX)
    assoc_rot = jnp.where(aval, enc % 3, 0)

    return (TriangleSet(vertices=vertices, normals=normals, assoc=assoc,
                        assoc_rot=assoc_rot),
            overflow | assoc_overflow)


def construct_voronoi_triangles(coarse: Graph, max_triangles: int,
                                max_assoc: int) -> Tuple[TriangleSet, jax.Array]:
    """Enumerate coarse-graph triangles.

    Args:
      coarse: coarse-level graph (rows ascending).
      max_triangles: static pad for the triangle list (planar-ish graphs
        have ~2C triangles; overflow is flagged).
      max_assoc: static pad for per-vertex association lists.

    Returns:
      (TriangleSet, overflow () bool).

    Host-level orchestrator (no sync): issues the key-extraction phase
    as ceil(C / 32768) bounded launches plus one assembly launch.  A
    per-anchor cap of ~2K pair codes keeps all compaction state at
    (C, cap) -- a (C, K, K) tensor tile-pads to GBs at 1M (measured).
    """
    c, k = coarse.neighbors.shape
    nbr = coarse.safe_neighbors()
    m = coarse.mask
    raw = coarse.neighbors                             # sorted, INT_MAX pad
    idx = jnp.arange(c, dtype=jnp.int32)
    row_cap = min(2 * k, k * (k - 1) // 2)

    slab = min(_SLAB, ((c + _CHUNK - 1) // _CHUNK) * _CHUNK)
    keys_l, counts_l = [], []
    for s0 in range(0, c, slab):
        s1 = min(s0 + slab, c)
        if s1 - s0 < slab:
            # Pad the tail slice to the slab shape (compile once).
            def padr(a, fill):
                return jnp.pad(a[s0:s1],
                               ((0, slab - (s1 - s0)),)
                               + ((0, 0),) * (a.ndim - 1),
                               constant_values=fill)
            ks, cs = _anchored_keys_slab(
                padr(nbr, 0), padr(raw, 0), padr(m, False),
                padr(idx, 0), raw, row_cap)
            ks, cs = ks[: s1 - s0], cs[: s1 - s0]
        else:
            ks, cs = _anchored_keys_slab(
                nbr[s0:s1], raw[s0:s1], m[s0:s1], idx[s0:s1], raw,
                row_cap)
        keys_l.append(ks)
        counts_l.append(cs)
    keys = keys_l[0] if len(keys_l) == 1 else jnp.concatenate(keys_l)
    row_counts = (counts_l[0] if len(counts_l) == 1
                  else jnp.concatenate(counts_l))

    return _assemble(keys, row_counts, nbr, coarse.points, max_triangles,
                     max_assoc, row_cap)
