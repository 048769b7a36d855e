"""Generate assets/halo_hierarchy.npz -- the dryrun's halo-path fixture.

The old 2.5k entry fixture gives ~320 rows/device on the
8-device dryrun mesh, where the edge cut IS the shard (halo_frac 1.022)
-- no scale for the O(edge-cut) exchange to show its bound.  This
fixture is a 24k torus hierarchy (3k rows/device), where the measured
fine-level halo_frac sits well under 0.25 (tests/test_halo.py pins
<0.25 already at 6k; scripts/halo_evidence.py measures 0.069 at 50k).

Runs entirely on CPU JAX (no accelerator needed); regenerate with
  JAX_PLATFORMS=cpu python scripts/make_halo_fixture.py
"""

import os
import sys

sys.path.insert(0, ".")

import numpy as np
import jax.numpy as jnp

import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)
from gravomg_tpu.io.serialization import save_solver

N = 24_000

def main(path="assets/halo_hierarchy.npz"):
    pts = torus_points(N, seed=3).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 14, margin=2.4)
    assert not bool(short)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=400, smoother="chebyshev")
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    hs = compact_solver(h.solver, diags)
    save_solver(path, hs)
    print(f"wrote {path}: levels="
          f"{[l.op.num_vertices for l in hs.levels]}")


if __name__ == "__main__":
    main()
