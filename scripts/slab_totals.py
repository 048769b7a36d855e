"""Total slab counts for the variable-window (CSR-of-slabs) SpMV form.

Builds only the level-0 operator (graph + Laplacian, no hierarchy) and
reports, per candidate (BLK, W): total window slabs under greedy
first-fit cover and the implied M bytes -- the data behind the slab
design in ops/slab.py.

Usage: JAX_PLATFORMS=cpu python scripts/slab_totals.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order

N = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000

pts = torus_points(N, seed=1).astype(np.float32)
pts = pts[morton_order(pts)]
graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
assert not bool(short)
lap, mass = g.graph_laplacian(graph, "invdist")
spd = lap._replace(diag=lap.diag + 0.5 * mass)

cols = np.asarray(spd.neighbors)
valid = np.asarray(spd.mask) & (np.asarray(spd.offdiag) != 0.0)
nnz = int(valid.sum())
print(f"n={N} nnz={nnz} ({nnz / N:.1f}/row)")


def slab_cover(cols, valid, blk, w):
    r, k = cols.shape
    nblk = -(-r // blk)
    pad = nblk * blk - r
    c = np.where(valid, cols, -1)
    c = np.pad(c, ((0, pad), (0, 0)), constant_values=-1)
    c = c.reshape(nblk, blk * k)
    counts = np.zeros(nblk, np.int64)
    for b in range(nblk):
        cb = np.sort(c[b][c[b] >= 0])
        i = 0
        nwin = 0
        while i < len(cb):
            hi = cb[b * 0 + i] + w  # first-fit window at cb[i]
            i = np.searchsorted(cb, hi)
            nwin += 1
        counts[b] = nwin
    return counts


for blk in (8, 16, 32, 64):
    for w in (128, 256):
        counts = slab_cover(cols, valid, blk, w)
        total = int(counts.sum())
        mbytes = total * blk * w * 4
        print(f" blk={blk:3d} W={w}: slabs total={total} "
              f"mean={counts.mean():.2f}/blk p99={np.percentile(counts, 99):.0f} "
              f"max={counts.max()} M={mbytes/1e6:.0f}MB "
              f"density={nnz*4/mbytes*100:.1f}%")
