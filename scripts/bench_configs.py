"""BASELINE workload configs 1/2/3/5 on the accelerator (config 4 = bench.py).

  c1_sphere5k    5k sphere, 2-level, Jacobi, MG-PCG to 1e-8
  c2_mesh35k     35k surface, 3-level, Chebyshev V-cycle + MG-PCG
  c3_heat170k    170k surface, heat geodesics: two solves on a reused
                 hierarchy (refit), the armadillo pattern
  c5_batch64     64 RHS vmapped V-cycles on one hierarchy (the batched
                 shape-collection pattern)

One JSON line per config on stdout, after a header line naming the
device.  Timings are wall times of single-launch jitted programs ending
in ``block_until_ready``, measured on the second (warm) call.  A config
that fails or runs out of budget prints an error row and makes the exit
code non-zero.

Usage: python scripts/bench_configs.py [config ...]
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

# GRAVOMG_SMOKE=1 shrinks every config ~20x: validates the script
# end-to-end on any backend without the full-size compile budget.
SMOKE = os.environ.get("GRAVOMG_SMOKE") == "1"


def sz(n):
    return max(2000, n // 20) if SMOKE else n


import jax.numpy as jnp
import gravomg_tpu as g
from gravomg_tpu.compile_cache import compile_cache_dir, enable_compile_cache
from gravomg_tpu.geometry.meshes import icosphere, torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)


# Every config checks the remaining wall budget before starting; an
# exhausted budget emits an error row instead of dying mid-config.
BUDGET_S = float(os.environ.get("GRAVOMG_BENCH_BUDGET_S", "7200"))
_T0 = time.monotonic()


def _remaining() -> float:
    return BUDGET_S - (time.monotonic() - _T0)


def _xla_cache_entries() -> int:
    """Persistent-cache entry count: every run records the cache state
    its cold numbers were measured under."""
    try:
        return len(os.listdir(compile_cache_dir()))
    except OSError:
        return 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed_call(fn, *args):
    """(warm_seconds, result): second call of a jitted single-launch
    program, up to ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def pipeline(pts, k, cfg, attach=True, keep_h=False, alpha="auto"):
    """Build graph -> operator -> hierarchy -> compacted fast solver.

    Device-memory hygiene: the uncompacted build hierarchy is dropped unless
    ``keep_h`` (its padded per-level arrays pin GBs at 100k+; only the
    hierarchy-reuse config needs it), and fast-form attachment is
    skipped for configs that never run the single-RHS hot path.
    """
    pts = pts[morton_order(pts)].astype(np.float32)
    graph, short = grid_knn_graph_nosync(pts, k, margin=2.4)
    # alpha="auto": a fixed screening shift falls below f32 resolution
    # as density grows (apps/poisson.py).
    # Callables (e.g. apps.spectral.spectral_alpha) pick the shift from
    # the built graph -- the eigensolver needs alpha ~ lam_1, not the
    # Poisson-tuned auto value.
    if callable(alpha):
        alpha = float(alpha(graph))
    spd, mass = g.screened_poisson_operator(graph, alpha=alpha)
    build_kw = {}
    t0 = time.perf_counter()
    h, diags = jax.block_until_ready(build_hierarchy_device(graph, spd, cfg))
    t_build = time.perf_counter() - t0
    assert not bool(short)
    try:
        check_diagnostics(diags)
    except RuntimeError as e:
        # One escalation retry: double the degree caps (the config
        # meshes are not the tuned-headline cloud; a wider build beats
        # an error row).  Timed fresh -- the retry is the real build.
        print(f"# cap escalation retry: {e}", file=sys.stderr)
        from gravomg_tpu.config import DEFAULT_CAPS
        build_kw = dict(caps=DEFAULT_CAPS.escalated(2))
        t0 = time.perf_counter()
        h, diags = jax.block_until_ready(
            build_hierarchy_device(graph, spd, cfg, **build_kw))
        t_build = time.perf_counter() - t0
        check_diagnostics(diags)
    # Warm rebuild: the first build's wall time is dominated by
    # compilation, which says nothing about the build itself.  Every
    # shape is now cached in-process, so a second build is the per-mesh
    # hierarchy cost (the quantity BASELINE's "hierarchy construction"
    # target tracks; bench.py separates the two the same way).
    t0 = time.perf_counter()
    h, diags = jax.block_until_ready(
        build_hierarchy_device(graph, spd, cfg, **build_kw))
    t_warm = time.perf_counter() - t0
    t_build = {"t_build_s": round(t_warm, 3),
               "t_build_cold_s": round(t_build, 3)}
    # Same operator stack as the headline bench: bucketed slab forms
    # on the large levels, uniform block-dense on the rest.
    sol = compact_solver(h.solver, diags)
    if attach:
        sol = g.attach_operators(sol)
    levels = [int(d.n_real) for d in diags]
    if not keep_h:
        h = None
        import gc
        gc.collect()
    return graph, spd, h, sol, t_build, levels


def c1_sphere5k():
    sv, _ = icosphere(5)                       # 10242 verts; sample 5k
    rng = np.random.default_rng(0)
    pts = sv[rng.choice(len(sv), sz(5000), replace=False)]
    cfg = g.MultigridConfig(coarse_threshold=800, smoother="jacobi",
                            max_levels=2)
    graph, spd, h, sol, t_build, levels = pipeline(pts, 12, cfg)
    b = jnp.asarray(rng.normal(size=pts.shape[0]), jnp.float32)
    t, (x, rel, it) = timed_call(
        lambda: g.mg_pcg(sol, b, cfg))
    emit({"config": "c1_sphere5k", "n": pts.shape[0], "levels": levels,
          **t_build, "solve_s": round(t, 4),
          "rel_residual": float(rel), "iters": int(it)})


def c2_mesh35k():
    pts = torus_points(sz(35_000), seed=2)
    cfg = g.MultigridConfig(coarse_threshold=600, smoother="chebyshev",
                            max_levels=3)
    rng = np.random.default_rng(1)
    graph, spd, h, sol, t_build, levels = pipeline(pts, 14, cfg)
    b = jnp.asarray(rng.normal(size=pts.shape[0]), jnp.float32)

    @functools.partial(jax.jit, static_argnames=("cycles",))
    def run_cycles(hs, b, cycles):
        def body(_, x):
            return g.v_cycle(hs, x, b, cfg)
        return jax.lax.fori_loop(0, cycles, body, jnp.zeros_like(b))

    t8, _ = timed_call(lambda: run_cycles(sol, b, 8))
    t_pcg, (x, rel, it) = timed_call(lambda: g.mg_pcg(sol, b, cfg))
    emit({"config": "c2_mesh35k", "n": pts.shape[0], "levels": levels,
          **t_build,
          "vcycle8_s": round(t8, 4),
          "pcg_solve_s": round(t_pcg, 4), "rel_residual": float(rel),
          "iters": int(it)})


def c3_heat170k():
    pts = torus_points(sz(170_000), seed=3)
    cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
    # attach=False: the heat app refits its own operators on the ELL
    # forms; slab/fast conversions would only pin device memory here.
    # The refit runs on the COMPACTED solver -- the uncompacted build
    # hierarchy holds several GB of padded per-level arrays at 170k.
    graph, spd, h, sol, t_build, levels = pipeline(pts, 16, cfg,
                                                   attach=False)
    from gravomg_tpu.apps.heat import heat_geodesics
    t, phi = timed_call(lambda: heat_geodesics(graph, sol, source=0,
                                               cfg=cfg))
    finite = bool(jnp.all(jnp.isfinite(phi)))
    emit({"config": "c3_heat170k", "n": pts.shape[0], "levels": levels,
          **t_build,
          "two_solve_heat_s": round(t, 4), "finite": finite})


def c5_batch64():
    pts = torus_points(sz(20_000), seed=4)
    cfg = g.MultigridConfig(coarse_threshold=600, smoother="chebyshev")
    rng = np.random.default_rng(2)
    # Same operator stack as the headline bench (vmap runs the ELL
    # forms: the attached forms serve 1-D vectors only).
    graph, spd, h, sol, t_build, levels = pipeline(pts, 12, cfg)
    bs = jnp.asarray(rng.normal(size=(64, pts.shape[0])), jnp.float32)

    @jax.jit
    def batch_cycle(hs, bs):
        return jax.vmap(lambda b: g.v_cycle(hs, jnp.zeros_like(b), b,
                                            cfg))(bs)

    @jax.jit
    def seq_cycle(hs, bs):
        # Same 64 V-cycles as a sequential fori_loop in ONE launch --
        # isolates the vmap batching win from dispatch constants.
        def body(i, acc):
            x = g.v_cycle(hs, jnp.zeros_like(bs[0]), bs[i], cfg)
            return acc.at[i].set(x)
        return jax.lax.fori_loop(0, bs.shape[0], body,
                                 jnp.zeros_like(bs))

    t, out = timed_call(lambda: batch_cycle(sol, bs))
    t_seq, _ = timed_call(lambda: seq_cycle(sol, bs))
    emit({"config": "c5_batch64", "n": pts.shape[0], "batch": 64,
          "levels": levels, **t_build,
          "batch64_vcycle_s": round(t, 4),
          "sequential64_vcycle_s": round(t_seq, 4),
          "batch_speedup": round(t_seq / max(t, 1e-9), 2),
          "per_rhs_ms": round(t / 64 * 1000, 3)})


def c5b_meshes64():
    """True shape collection: 64 deformed tori, one stacked hierarchy
    pytree, vmapped V-cycles across meshes (BASELINE config 5's
    "64-mesh shape collection").  Same-bucket hierarchies stack; the
    honest metric records how many of the 64 landed in the dominant
    bucket (geometric padding makes same-family meshes coincide)."""
    nmesh = 8 if SMOKE else 64
    n = sz(5000)
    cfg = g.MultigridConfig(coarse_threshold=400, smoother="chebyshev",
                            max_levels=3)
    rng = np.random.default_rng(5)
    solvers, t_build = [], 0.0
    for i in range(nmesh):
        pts = torus_points(n, seed=200 + i)
        # Per-mesh anisotropic deformation: a genuine collection, not
        # 64 copies.
        pts = pts * (1.0 + 0.25 * rng.random(3))
        pts = pts[morton_order(pts)].astype(np.float32)
        graph, short = grid_knn_graph_nosync(pts, 12, margin=2.4)
        assert not bool(short)
        spd, mass = g.screened_poisson_operator(graph, alpha="auto")
        t0 = time.perf_counter()
        h, diags = jax.block_until_ready(
            build_hierarchy_device(graph, spd, cfg))
        t_build += time.perf_counter() - t0
        check_diagnostics(diags)
        solvers.append(h.solver)

    # Stack the dominant same-shape group (plan buckets are geometric,
    # so same-family meshes coincide; report the count honestly).
    from gravomg_tpu.parallel.batch import attach_collection, stackable
    groups = {}
    for s in solvers:
        key = tuple(jax.tree_util.tree_map(lambda a: a.shape,
                                           jax.tree_util.tree_leaves(s)))
        groups.setdefault(key, []).append(s)
    biggest = max(groups.values(), key=len)
    # Shared-geometry fast forms: without them the vmapped cycle runs
    # batched ELL gathers.
    biggest = attach_collection(biggest)
    assert stackable(biggest)
    hb = g.stack_solvers(biggest)
    nb = len(biggest)
    v = biggest[0].levels[0].op.num_vertices
    bs = jnp.asarray(np.random.default_rng(3).normal(size=(nb, v)),
                     jnp.float32)

    t_batch, _ = timed_call(
        lambda: g.batched_v_cycle(hb, jnp.zeros_like(bs), bs, cfg))

    # Per-mesh dispatch loop over the SAME jitted single-mesh cycle
    # (shared compile): the cost batching removes.
    @jax.jit
    def one(hs, b):
        return g.v_cycle(hs, jnp.zeros_like(b), b, cfg)

    jax.block_until_ready(one(biggest[0], bs[0]))
    t0 = time.perf_counter()
    for i, s in enumerate(biggest):
        jax.block_until_ready(one(s, bs[i]))
    t_loop = time.perf_counter() - t0

    emit({"config": "c5b_meshes64", "n": n, "meshes": nmesh,
          "stacked": nb, "t_build_all_s": round(t_build, 3),
          "batched_vcycle_s": round(t_batch, 4),
          "permesh_loop_s": round(t_loop, 4),
          "batch_speedup": round(t_loop / max(t_batch, 1e-9), 2),
          "per_mesh_ms": round(t_batch / nb * 1000, 3)})


def c6_spectral():
    """MG-preconditioned block LOBPCG: 12 lowest Laplace eigenpairs on
    a 100k cloud (the other half of BASELINE config 5's "spectral /
    curvature-flow stepping")."""
    from gravomg_tpu.apps.spectral import laplace_eigs, spectral_alpha
    n = sz(100_000)
    k = 12
    pts = torus_points(n, seed=6)
    cfg = g.MultigridConfig(coarse_threshold=800, smoother="chebyshev")
    # attach=False: LOBPCG preconditions the whole (V, 3k) block, which
    # takes the multi-RHS ELL path; fast single-RHS forms never run.
    # alpha=spectral_alpha: the Poisson "auto" shift reaches 355 in
    # pencil units at 100k -- above lam_1 = 154 -- turning the V-cycle
    # preconditioner into a scaled identity on the target modes (the
    # round-4 max_resnorm 0.13 artifact); the spectral shift sizes it
    # to ~lam_1/4.
    graph, spd, h, sol, t_build, levels = pipeline(
        pts, 12, cfg, attach=False, alpha=spectral_alpha)
    t0 = time.perf_counter()
    lams, vecs, res = jax.block_until_ready(
        laplace_eigs(graph, k=k, cfg=cfg, h=sol, iters=40, tol=1e-5))
    t = time.perf_counter() - t0
    emit({"config": "c6_spectral", "n": n, "k": k,
          **t_build,
          "eigs_total_s": round(t, 3),
          "max_resnorm": float(jnp.max(res)),
          "lam_1": float(lams[1]), "lam_k": float(lams[-1]),
          "nullspace_lam": float(lams[0])})


ALL = {"c1": c1_sphere5k, "c2": c2_mesh35k, "c3": c3_heat170k,
       "c5": c5_batch64, "c5b": c5b_meshes64, "c6": c6_spectral}

if __name__ == "__main__":
    enable_compile_cache()
    names = sys.argv[1:] or list(ALL)
    dev = jax.devices()
    emit({"config": "header", "device": {"platform": dev[0].platform,
                                         "kind": dev[0].device_kind,
                                         "count": len(dev)},
          "when": time.strftime("%Y-%m-%d %H:%M:%S"),
          "budget_s": BUDGET_S,
          "xla_cache_entries": _xla_cache_entries()})
    failed = []
    for name in names:
        if _remaining() < 120:
            emit({"config": name,
                  "error": f"budget exhausted ({BUDGET_S:.0f}s)"})
            failed.append(name)
            continue
        try:
            ALL[name]()
        except Exception as e:  # noqa: BLE001
            emit({"config": name, "error": f"{type(e).__name__}: {e}"})
            failed.append(name)
    emit({"config": "footer",
          "xla_cache_entries_at_end": _xla_cache_entries(),
          "wall_s": round(time.monotonic() - _T0, 1), "failed": failed})
    sys.exit(1 if failed else 0)
