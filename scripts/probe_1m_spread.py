"""Measure window-coverage statistics of the build operators at scale.

For the 1M north-star build the gather-free sampling/parents operators
must fit device memory: M is rpad * nww * itemsize bytes, so the window geometry
has to be chosen from the measured per-block column spread, not guessed.
This probe builds the fine graph and the conflict ELL at N, then for
candidate (block, window0, window, nw) geometries counts, per block, how
many entries the greedy window assignment covers -- without ever
materializing M (counts only).  Prints coverage and projected M bytes.

Usage: python scripts/probe_1m_spread.py [N]
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.coarsen.sampling import conflict_ell, sampling_radius
from gravomg_tpu.types import INVALID_INDEX

import functools


@functools.partial(jax.jit, static_argnames=("block", "window", "nw",
                                             "window0", "n_cols"))
def coverage(cols, valid, n_cols, block, window, nw, window0):
    """Replicates blockdense_from_ell's greedy window selection, counts
    covered entries; returns (covered, total)."""
    imax = jnp.iinfo(jnp.int32).max
    r, k = cols.shape
    nblk = -(-r // block)
    rpad = nblk * block
    safe_cols = jnp.where(valid, cols, imax)
    cols_p = jnp.pad(safe_cols, ((0, rpad - r), (0, 0)),
                     constant_values=imax)
    bc = cols_p.reshape(nblk, block * k)
    ratio = n_cols / r
    anchor = (jnp.arange(nblk) * block * ratio).astype(jnp.int32) \
        - (window0 - int(block * ratio)) // 2
    w0 = jnp.clip(anchor, 0, max(n_cols - window0, 0))
    covered = jnp.sum((bc >= w0[:, None]) & (bc < w0[:, None] + window0))
    remaining = jnp.where((bc >= w0[:, None])
                          & (bc < w0[:, None] + window0), imax, bc)
    for _ in range(nw - 1):
        s = jnp.min(remaining, axis=1)
        hit = remaining < s[:, None] + window
        covered += jnp.sum(hit)
        remaining = jnp.where(hit, imax, remaining)
    total = jnp.sum(valid)
    return covered, total


def main(n):
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
    assert not bool(short)
    radius = sampling_radius(graph, 2.0)

    print("== fine graph (parents min-plus operator) ==", flush=True)
    gmask = graph.mask
    for geom in ((256, 512, 512, 4), (256, 256, 128, 4),
                 (256, 256, 128, 6), (256, 384, 128, 4),
                 (128, 256, 128, 4), (256, 512, 128, 3)):
        blk, w0, w, nw = geom
        c, t = coverage(graph.neighbors, gmask, n, blk, w, nw, w0)
        nww = w0 + (nw - 1) * w
        mb = (-(-n // blk)) * blk * nww * 4 / 1e9
        print(f"  blk={blk} w0={w0} w={w} nw={nw}: cover="
              f"{int(c)}/{int(t)} esc={int(t)-int(c)} M={mb:.2f}GB",
              flush=True)

    print("== conflict op (sampling min-plus) ==", flush=True)
    cols, cmask, ovf = conflict_ell(graph, radius, 16, 192,
                                    lower_only=False)
    print(f"  conflict ovf={bool(ovf)} "
          f"nnz={int(jnp.sum(cmask))}", flush=True)
    for geom in ((256, 512, 512, 3), (256, 512, 256, 4),
                 (256, 512, 128, 6), (256, 768, 128, 4),
                 (256, 1024, 256, 3), (512, 1024, 256, 4)):
        blk, w0, w, nw = geom
        c, t = coverage(cols, cmask, n, blk, w, nw, w0)
        nww = w0 + (nw - 1) * w
        mb = (-(-n // blk)) * blk * nww * 2 / 1e9   # bf16
        print(f"  blk={blk} w0={w0} w={w} nw={nw}: cover="
              f"{int(c)}/{int(t)} esc={int(t)-int(c)} "
              f"M(bf16)={mb:.2f}GB", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
