"""V-cycle contraction sweep (SWEEP_contraction_50k.json).

Round 2's stationary V-cycle contracted at ~0.49/cycle (textbook
multigrid is 0.1-0.2); MG-PCG masked it.  Suspects: the aggressive
first-level reduction (~7.6x at 200k vs the reference's ~2x intent,
reference `test/main.cpp:23,74`) and a Chebyshev window
(lam_max/ratio, lam_max) too narrow for that reduction.

This sweep separates the two:
  * chebyshev_ratio x chebyshev_degree on a FIXED hierarchy -- interval
    params are runtime pytree leaves, so only `degree` recompiles;
  * reduction_ratio rebuilds (radius = cbrt(ratio) * avg_edge).

For each point: asymptotic contraction rho = (r_12 / r_4)^(1/8) from
the stationary residual history, PCG iterations to 1e-8, and the
per-cycle work proxy (degree+1 fine matvecs).  One JSON line per point.

Usage: python scripts/sweep_contraction.py [n]
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".bench_cache", "xla"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp
import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)

N = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(n, red):
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
    assert not bool(short)
    lap, mass = g.graph_laplacian(graph, "invdist")
    spd = lap._replace(diag=lap.diag + 0.5 * mass)
    cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev",
                            reduction_ratio=red)
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    sol = compact_solver(h.solver, diags)
    sol = g.attach_slab_operators(sol)
    sol = g.attach_fast_operators(sol)
    return cfg, sol, [int(d.n_real) for d in diags]


def with_ratio(sol, ratio):
    """Rescale every level's Chebyshev window on the SAME hierarchy
    (lam_max kept, lam_min = lam_max/ratio): pure runtime-leaf change."""
    levels = []
    for lvl in sol.levels:
        cheb = lvl.cheb
        if cheb is not None:
            cheb = cheb._replace(lam_min=cheb.lam_max / ratio)
        levels.append(lvl._replace(cheb=cheb))
    return sol._replace(levels=tuple(levels))


def measure(cfg, sol, b):
    _, rel, it, hist = g.solve_with_history(sol, b, cfg)
    hist = np.asarray(hist)
    hist = hist[np.isfinite(hist) & (hist > 0)]
    # f32 stationary cycles STALL around 1e-4 relative (known f32
    # plateau; mg_pcg is the 1e-8 path), so the asymptotic window must
    # stop ABOVE the plateau: fit rho on cycles while the residual is
    # still >30x the final stall level.
    if len(hist) >= 4:
        floor = 30.0 * hist.min()
        k = int(np.sum(hist > floor))
        k = max(min(k, len(hist) - 1), 2)
        rho = float((hist[k] / hist[0]) ** (1.0 / k))
    else:
        rho = float("nan")
    _, rel_p, it_p = g.mg_pcg(sol, b, cfg)
    return rho, int(it), float(rel), int(it_p), float(rel_p)


rng = np.random.default_rng(0)
b = jnp.asarray(rng.normal(size=N), jnp.float32)

cfg0, sol0, levels0 = build(N, 2.0)
emit({"sweep": "header", "n": N, "levels_red2": levels0})

for deg in (2, 4, 6):
    for ratio in (2.0, 4.0, 8.0, 16.0, 32.0):
        cfg = g.MultigridConfig(coarse_threshold=1000,
                                smoother="chebyshev",
                                chebyshev_degree=deg,
                                chebyshev_ratio=ratio, max_cycles=40)
        rho, it, rel, it_p, rel_p = measure(cfg, with_ratio(sol0, ratio),
                                            b)
        emit({"sweep": "cheb", "degree": deg, "ratio": ratio,
              "contraction": rho, "cycles": it, "rel": rel,
              "pcg_iters": it_p, "pcg_rel": rel_p})

for red in (1.2, 2.0, 4.0):
    cfg, sol, levels = build(N, red)
    cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev",
                            reduction_ratio=red, max_cycles=40)
    rho, it, rel, it_p, rel_p = measure(cfg, sol, b)
    emit({"sweep": "reduction", "reduction_ratio": red,
          "levels": levels, "contraction": rho, "cycles": it,
          "rel": rel, "pcg_iters": it_p, "pcg_rel": rel_p})
