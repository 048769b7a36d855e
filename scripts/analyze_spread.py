"""Measure the column-window geometry the block-dense operators need.

For each level's A / U / U^T at bench scale, and for candidate row-block
sizes, compute how many width-W windows (greedy first-fit, the same
assignment rule as ops/blockdense.py) cover each block's columns and
how many entries escape.  This replaces the fixed window0 = 3*blk
heuristic with measured geometry: the round-2 level-0 operator streamed
a ~2%-dense 1.1 GB window matrix per matvec; the
fix starts with knowing the real spread.

Runs on the CPU backend (structure only, no timing).
Usage: JAX_PLATFORMS=cpu python scripts/analyze_spread.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax.numpy as jnp

import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)
from gravomg_tpu.types import INVALID_INDEX

N = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000

pts = torus_points(N, seed=1).astype(np.float32)
pts = pts[morton_order(pts)]
cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
lap, mass = g.graph_laplacian(graph, "invdist")
spd = lap._replace(diag=lap.diag + 0.5 * mass)
h, diags = build_hierarchy_device(graph, spd, cfg)
check_diagnostics(diags)
sol = compact_solver(h.solver, diags)


def coverage(cols, valid, blk, widths):
    """Greedy window cover per block: how many windows of each width
    pattern are needed; returns per-block window counts and escapes."""
    r, k = cols.shape
    nblk = -(-r // blk)
    pad = nblk * blk - r
    c = np.where(valid, cols, -1)
    c = np.pad(c, ((0, pad), (0, 0)), constant_values=-1)
    c = c.reshape(nblk, blk * k)
    n_windows = np.zeros(nblk, np.int32)
    escapes = 0
    covered_total = 0
    for b in range(nblk):
        cb = np.sort(c[b][c[b] >= 0])
        covered_total += len(cb)
        wi = 0
        i = 0
        while i < len(cb):
            w = widths[min(wi, len(widths) - 1)]
            if wi >= len(widths):
                escapes += len(cb) - i
                break
            hi = cb[i] + w
            j = np.searchsorted(cb, hi)
            i = j
            wi += 1
        n_windows[b] = wi
    return n_windows, escapes, covered_total


def analyze(name, cols, valid, n_cols):
    cols = np.asarray(cols)
    valid = np.asarray(valid)
    r = cols.shape[0]
    print(f"\n== {name}: rows={r} n_cols={n_cols} "
          f"nnz={int(valid.sum())} ==")
    # Per-row spread.
    cmax = np.where(valid, cols, -1).max(1)
    cmin = np.where(valid, cols, 2**31 - 1).min(1)
    has = valid.any(1)
    spread = (cmax - cmin)[has]
    print(f" per-row spread: p50={np.percentile(spread, 50):.0f} "
          f"p90={np.percentile(spread, 90):.0f} "
          f"p99={np.percentile(spread, 99):.0f} max={spread.max()}")
    for blk in (32, 64, 128, 256):
        for widths in ([256] * 12, [512] + [128] * 12,
                       [384] + [128] * 12, [768] + [128] * 12):
            nw, esc, tot = coverage(cols, valid, blk, widths)
            w0 = widths[0]
            wf = widths[1] if len(widths) > 1 else widths[0]
            # Worst-case NWW if we size for p99.5 of block needs.
            nw_p = int(np.percentile(nw, 99.5))
            nww = w0 + max(nw_p - 1, 0) * wf
            mb = (-(-r // blk) * blk) * nww * 4 / 1e6
            dens = tot / max((-(-r // blk) * blk) * nww, 1) * 100
            print(f" blk={blk:4d} w0={w0:4d} wf={wf:4d}: "
                  f"nw p50={int(np.percentile(nw, 50))} "
                  f"p99.5={nw_p} max={nw.max()} esc={esc} "
                  f"-> NWW={nww} M={mb:.0f}MB dens={dens:.1f}%")


lvl0 = sol.levels[0]
analyze("A level0", lvl0.op.neighbors, np.asarray(lvl0.op.mask),
        lvl0.op.num_vertices)
if len(sol.levels) > 1:
    lvl1 = sol.levels[1]
    analyze("A level1", lvl1.op.neighbors, np.asarray(lvl1.op.mask),
            lvl1.op.num_vertices)
u = lvl0.u
analyze("U level0", u.cols, np.ones_like(np.asarray(u.cols), bool),
        u.n_coarse)
rt = lvl0.ut
analyze("Ut level0", rt.safe_rows(),
        np.asarray(rt.rows) != INVALID_INDEX, rt.n_fine)
