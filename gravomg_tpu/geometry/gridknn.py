"""Spatial-hash kNN for large point clouds (BASELINE config 4 scale).

The blocked brute-force kNN (geometry/knn.py) is O(V^2) -- fine up to
~10^5 points, infeasible at 10^6.  This module bins points
into a uniform grid (cell edge chosen from the surface sampling density)
with one counting sort, then each point gathers candidates from its
3x3x3 cell neighborhood and top-k's them -- all fixed-shape:

  * cell ids:      one (V,) sort + searchsorted offsets (dense grid)
  * candidates:    (chunk, 27 * M) gathers, M = per-cell capacity
  * select:        top-k over masked squared distances

If any point sees fewer than k in-radius candidates the caller enlarges
the cell edge and retries (the same staged doubling used everywhere in
the hierarchy builder).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.types import Graph, INVALID_INDEX
from gravomg_tpu.ops.segment import build_ell_rows
from gravomg_tpu.geometry.knn import knn_graph


@functools.partial(jax.jit,
                   static_argnames=("k", "grid_dim", "cell_capacity",
                                    "chunk"))
def _grid_knn_indices(points: jax.Array, k: int, cell_edge: jax.Array,
                      origin: jax.Array, grid_dim: int,
                      cell_capacity: int, chunk: int = 4096):
    """Returns (idx (V, k) int32, shortfall () bool)."""
    v = points.shape[0]
    h = grid_dim
    coords = jnp.clip(((points - origin) / cell_edge).astype(jnp.int32),
                      0, h - 1)                               # (V, 3)
    cell = (coords[:, 0] * h + coords[:, 1]) * h + coords[:, 2]
    order = jnp.argsort(cell)
    sorted_cell = cell[order]
    sorted_ids = order.astype(jnp.int32)
    # Dense cell -> range map.
    counts = jnp.zeros((h * h * h + 1,), jnp.int32).at[sorted_cell].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts[:-1], dtype=jnp.int32)])
    over_capacity = jnp.max(counts) > cell_capacity

    offs = jnp.array([(dx, dy, dz) for dx in (-1, 0, 1)
                      for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                     jnp.int32)                               # (27, 3)
    m = cell_capacity
    slot = jnp.arange(m, dtype=jnp.int32)

    vpad = ((v + chunk - 1) // chunk) * chunk
    pts_pad = jnp.pad(points, ((0, vpad - v), (0, 0)))
    coords_pad = jnp.pad(coords, ((0, vpad - v), (0, 0)))
    ids_pad = jnp.arange(vpad, dtype=jnp.int32)

    def per_chunk(c0):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c0 * chunk, chunk)
        p = sl(pts_pad)
        cc = sl(coords_pad)
        my_id = sl(ids_pad)
        ncoords = cc[:, None, :] + offs[None, :, :]           # (B, 27, 3)
        in_grid = jnp.all((ncoords >= 0) & (ncoords < h), axis=-1)
        ncell = ((ncoords[..., 0] * h + ncoords[..., 1]) * h
                 + ncoords[..., 2])
        ncell = jnp.where(in_grid, ncell, 0)
        start = starts[ncell]                                 # (B, 27)
        cnt = counts[ncell]
        cand_pos = start[:, :, None] + slot[None, None, :]    # (B, 27, M)
        cand_ok = (in_grid[:, :, None] & (slot[None, None, :]
                                          < cnt[:, :, None]))
        cand_pos = jnp.where(cand_ok, cand_pos, v)
        ids_ext = jnp.concatenate([sorted_ids,
                                   jnp.full((1,), 0, jnp.int32)])
        cand_id = ids_ext[cand_pos.reshape(chunk, -1)]        # (B, 27M)
        cand_ok = cand_ok.reshape(chunk, -1)
        cand_ok &= cand_id != my_id[:, None]
        d2 = jnp.sum((p[:, None, :] - points[cand_id]) ** 2, axis=-1)
        d2 = jnp.where(cand_ok, d2, jnp.inf)
        neg, pos = jax.lax.top_k(-d2, k)
        idx = jnp.take_along_axis(cand_id, pos, axis=1)
        idx = jnp.where(jnp.isfinite(-neg), idx, INVALID_INDEX)
        # Correctness condition: the 27-cell window is guaranteed to
        # cover a ball of radius cell_edge around the query, so the
        # result is the true kNN only if the kth distance fits inside.
        kth_d2 = -neg[:, -1]
        short = jnp.any((~jnp.isfinite(kth_d2)
                         | (kth_d2 >= cell_edge * cell_edge))
                        & (my_id < v))
        return idx, short

    idx, short = jax.lax.map(per_chunk, jnp.arange(vpad // chunk))
    return (idx.reshape(vpad, k)[:v],
            jnp.any(short) | over_capacity)


def grid_knn_graph_nosync(points_np: np.ndarray, k: int,
                          max_degree: int | None = None,
                          margin: float = 2.0):
    """Grid kNN with all sizing decisions made host-side from the NumPy
    copy -- performs NO device-to-host transfer, so the build that
    follows is enqueued without a host round trip.

    Uses a single conservatively-sized attempt (cell edge = ``margin``
    x the expected kth-neighbor distance); returns (Graph, shortfall)
    where ``shortfall`` is a device-side bool diagnostic to check after
    the performance-critical phase.
    """
    v = points_np.shape[0]
    if max_degree is None:
        max_degree = 2 * k
    lo = points_np.min(axis=0)
    hi = points_np.max(axis=0)
    extent = float((hi - lo).max()) + 1e-12
    # Empirical kth-neighbor distance from a host-side query subsample
    # (bounding-box density proxies misestimate curved surfaces).
    rng = np.random.default_rng(0)
    nq = min(256, v)
    queries = points_np[rng.choice(v, nq, replace=False)].astype(np.float32)
    kth = np.empty(nq, np.float32)
    refs = points_np.astype(np.float32)
    for i in range(nq):
        d2 = np.sum((refs - queries[i]) ** 2, axis=1)
        kth[i] = np.sqrt(np.partition(d2, k)[k])
    edge = float(margin / 2.0 * 1.3 * kth.max())
    grid_dim = 1 << max(1, int(np.ceil(extent / edge)) + 1).bit_length()
    grid_dim = max(2, min(512, grid_dim))
    if grid_dim * edge < extent:
        edge = extent / grid_dim * 1.0001
    coords = np.clip(((points_np - lo) / edge).astype(np.int64),
                     0, grid_dim - 1)
    cid = (coords[:, 0] * grid_dim + coords[:, 1]) * grid_dim + coords[:, 2]
    cap = int(np.bincount(cid, minlength=grid_dim**3).max())
    cap = ((cap + 15) // 16) * 16

    points = jnp.asarray(points_np)
    idx, short = _grid_knn_indices(
        points, k, jnp.asarray(edge, points.dtype),
        jnp.asarray(lo, points.dtype), grid_dim, cap)
    rows = jnp.repeat(jnp.arange(v, dtype=jnp.int32), k)
    cols = idx.reshape(-1)
    valid = cols != INVALID_INDEX
    safe_cols = jnp.where(valid, cols, 0)
    res = build_ell_rows(jnp.concatenate([rows, safe_cols]),
                         jnp.concatenate([safe_cols, rows]),
                         jnp.concatenate([valid, valid]), v, max_degree)
    mask = res.columns != INVALID_INDEX
    safe = jnp.where(mask, res.columns, 0)
    dist = jnp.linalg.norm(points[:, None, :] - points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(points.dtype), jnp.inf)
    # Symmetrization overflow (hub in-degree > max_degree) folds into the
    # same deferred device-side diagnostic as the kNN shortfall -- checked
    # once after the performance-critical phase, no extra D2H here.
    return Graph(res.columns, dist, points), short | res.overflow


def grid_knn_graph(points: jax.Array, k: int,
                   max_degree: int | None = None,
                   target_per_cell: float = 3.0) -> Graph:
    """Symmetrized kNN graph via spatial hashing; falls back to the
    brute-force path for small inputs.  Same output contract as
    :func:`gravomg_tpu.geometry.knn.knn_graph` (union symmetrization,
    ascending rows, recomputed Euclidean distances)."""
    v = points.shape[0]
    if v <= 20000:
        return knn_graph(points, k, max_degree=max_degree)
    if max_degree is None:
        max_degree = 2 * k

    pts_np = np.asarray(points)
    lo = pts_np.min(axis=0)
    hi = pts_np.max(axis=0)
    extent = float((hi - lo).max()) + 1e-12
    # Surface point clouds are ~2D: density per area sets the edge so a
    # 3x3x3 neighborhood holds comfortably more than k candidates.
    area_density = v / (extent * extent)
    # Start at ~1.5x the expected kth-neighbor distance for a uniform
    # surface cloud, so the coverage condition usually holds first try.
    edge = float(1.5 * np.sqrt(max(k, 9) / (np.pi * area_density))
                 / max(target_per_cell / 3.0, 1e-6) ** 0.5)

    attempts = 0
    while True:
        attempts += 1
        if attempts > 12:
            return knn_graph(points, k, max_degree=max_degree)
        # Bucket the static grid parameters (powers of two for grid_dim,
        # multiples of 16 for capacity) so repeated builds at similar
        # scales reuse compiled kernels.  The cell edge follows the
        # continuous retry parameter exactly (tail cells beyond the
        # bounding box stay empty); grid_dim >= 512 instead clamps the
        # edge up so the grid still covers the cloud.
        grid_dim = 1 << max(1, int(np.ceil(extent / edge)) + 1
                            ).bit_length()
        grid_dim = max(2, min(512, grid_dim))
        if grid_dim * edge < extent:
            edge = extent / grid_dim * 1.0001
        cell_edge = jnp.asarray(edge, points.dtype)
        # Estimate capacity from the actual histogram (host-side, cheap).
        coords = np.clip(((pts_np - lo) / float(cell_edge)).astype(np.int64),
                         0, grid_dim - 1)
        cid = (coords[:, 0] * grid_dim + coords[:, 1]) * grid_dim \
            + coords[:, 2]
        occupancy = np.bincount(cid, minlength=grid_dim ** 3)
        cap = int(occupancy.max())
        if cap * 27 * 8 > 64 * 1024:   # keep candidate tensors sane
            edge *= 0.7
            continue
        idx, short = _grid_knn_indices(
            points, k, cell_edge, jnp.asarray(lo, points.dtype),
            grid_dim, ((cap + 15) // 16) * 16)
        if not bool(short):
            break
        edge *= 1.5   # not enough candidates in the 27-cell window

    rows = jnp.repeat(jnp.arange(v, dtype=jnp.int32), k)
    cols = idx.reshape(-1)
    valid = cols != INVALID_INDEX
    safe_cols = jnp.where(valid, cols, 0)
    all_rows = jnp.concatenate([rows, safe_cols])
    all_cols = jnp.concatenate([safe_cols, rows])
    all_valid = jnp.concatenate([valid, valid])
    res = build_ell_rows(all_rows, all_cols, all_valid, v, max_degree)
    # Hub vertices can exceed any fixed union degree; staged doubling on
    # the overflow flag (this path already syncs on `short` above).
    while bool(res.overflow) and max_degree < v - 1:
        max_degree = min(2 * max_degree, v - 1)
        res = build_ell_rows(all_rows, all_cols, all_valid, v, max_degree)
    mask = res.columns != INVALID_INDEX
    safe = jnp.where(mask, res.columns, 0)
    dist = jnp.linalg.norm(points[:, None, :] - points[safe], axis=-1)
    dist = jnp.where(mask, dist.astype(points.dtype), jnp.inf)
    return Graph(neighbors=res.columns, distances=dist, points=points)
