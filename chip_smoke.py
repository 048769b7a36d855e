"""Smoke run of the main screened-Poisson path on one GPU.

Drives the path a user calls -- Morton-ordered torus cloud, grid kNN,
``screened_poisson_operator(alpha="auto")``, ``build_hierarchy_device``,
``compact_solver``, slab + block-dense attach, ``mg_solve`` and
``mg_pcg`` -- at the 1M-vertex headline size, and checks each stage
against a plain reference on the host:

  1. device: the first JAX device must be a GPU (no CPU fallback);
  2. main path: reported and host-f64 true residuals of both solves,
     stage times, peak device memory;
  3. per-level SpMV table: the attached, bf16 and U / U^T forms against
     the plain ELL products and SciPy CSR in f64, with time, bytes and
     GB/s per matvec beside the measured streaming bandwidth;
  4. build kernels: the level-0 device coarsening against the csrc
     sequential build in f64 at 200k, and the brute-force kNN at 20k
     against exact f64 neighbours (the TF32 canary).

``--devices 4`` runs only the multi-card solves (``halo_solve`` and
``sharded_solve`` on a 1-D mesh) and the one-card ``mg_pcg`` they are
compared with.

Every failed check raises, so the process exits non-zero before the
last line.  The last stdout line is one JSON object naming the device.

Usage:  python chip_smoke.py [--n 1000000] [--devices 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Stated tolerances (printed with every check that uses them).
RTOL = 1e-8            # solver target (cfg.tolerance)
F32_TOL = 1e-5         # max|dy| / || |A| |x| ||_inf, f32 forms: add order
BF16_TOL = 1e-2        # same scale, bf16 window matrices
# Host-f64 true residual of an f32-stored solution: rounding x to f32
# (|dx| <= 2^-24 |x|) alone can move the residual by up to
# floor = 2^-24 || |A| |x| || / ||b|| (`x_f32_floor`, computed per run),
# and CG's f32 recurrence residual drifts from the true one by the same
# order.  Bound: true <= RTOL + TRUE_RES_FLOORS * floor.  CPU rehearsal
# at 50k: true 2.378e-6 against a floor of 3.242e-6 for both solves.
TRUE_RES_FLOORS = 2.0
# Multi-card x against the one-card x (relative 2-norm).  All three
# solves stop at a reported 1e-8 but keep x in f32, whose rounding alone
# moves the residual by about x_f32_floor; the 4-virtual-device CPU
# rehearsal at 20k differed by 5.5e-6 (halo) and 1.9e-7 (sharded).
# 1e-4 leaves 30x room and still sits far below the O(1) disagreement
# of a wrong exchange plan or sharding.
MULTI_XTOL = 1e-4


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- phase 1

def require_gpu(devices):
    """Refuse anything but a GPU: this script measures the card, and a
    CPU run would print numbers under the card's name."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {plat!r}")
    return devices


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 2

def bench_graph(n: int):
    """The bench cloud's kNN graph: Morton-ordered torus
    (``torus_points(n, seed=1)``), grid kNN with k=16, margin 2.4."""
    import numpy as np

    from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
    from gravomg_tpu.geometry.meshes import torus_points
    from gravomg_tpu.geometry.order import morton_order

    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
    if bool(short):
        raise RuntimeError("grid kNN shortfall")
    return graph


def build_pipeline(n: int, escalate: int = 0):
    """The bench settings on :func:`bench_graph`: alpha="auto",
    Chebyshev, coarse threshold 1000.  ``escalate`` widens every static
    cap (overflow retries).  Returns (cfg, graph, spd, hierarchy,
    diagnostics)."""
    import gravomg_tpu as g
    from gravomg_tpu.config import DEFAULT_CAPS
    from gravomg_tpu.hierarchy_static import build_hierarchy_device

    cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
    graph = bench_graph(n)
    # alpha="auto": a fixed alpha's screening term falls below f32
    # resolution at scale and the Galerkin levels go indefinite
    # (apps/poisson.py).
    spd, _ = g.screened_poisson_operator(graph, alpha="auto")
    kw = dict(caps=DEFAULT_CAPS.escalated(escalate)) if escalate else {}
    h, diags = build_hierarchy_device(graph, spd, cfg, **kw)
    return cfg, graph, spd, h, diags


def build_checked(n: int):
    """build_pipeline with the cap-escalation retry: a cloud the default
    plan undershoots costs a rebuild, not the run.
    Returns (cfg, graph, hierarchy, diags, escalate, seconds)."""
    import jax

    from gravomg_tpu.hierarchy_static import check_diagnostics

    max_escalate = 2
    for esc in range(max_escalate + 1):
        t0 = time.perf_counter()
        cfg, graph, _, h, diags = build_pipeline(n, esc)
        jax.block_until_ready(h)
        dt = time.perf_counter() - t0
        try:
            check_diagnostics(diags)
            return cfg, graph, h, diags, esc, dt
        except RuntimeError as e:
            if esc == max_escalate:
                raise
            log(f"# caps escalation {esc + 1}: {e}")
            h = diags = None
            gc.collect()


def ell_csr(op):
    """SciPy f64 CSR of an EllOperator (the host reference)."""
    import numpy as np
    import scipy.sparse as sp

    nbr = np.asarray(op.neighbors)
    v = nbr.shape[0]
    mask = np.asarray(op.mask)
    rows = np.repeat(np.arange(v), nbr.shape[1])[mask.ravel()]
    vals = np.asarray(op.offdiag, np.float64).ravel()[mask.ravel()]
    a = sp.csr_matrix((vals, (rows, nbr.ravel()[mask.ravel()])),
                      shape=(v, v))
    return (a + sp.diags(np.asarray(op.diag, np.float64))).tocsr()


def u_csr(u):
    import numpy as np
    import scipy.sparse as sp

    cols = np.asarray(u.cols)
    vf = cols.shape[0]
    return sp.csr_matrix(
        (np.asarray(u.weights, np.float64).ravel(),
         (np.repeat(np.arange(vf), cols.shape[1]), cols.ravel())),
        shape=(vf, u.n_coarse))


def true_residual(a64, x, b) -> float:
    import numpy as np

    x64 = np.asarray(x, np.float64)
    b64 = np.asarray(b, np.float64)
    return float(np.linalg.norm(b64 - a64 @ x64) / np.linalg.norm(b64))


def x_f32_floor(a64, x, b) -> float:
    """Largest residual change rounding x to f32 can cause (relative)."""
    import numpy as np

    absa = abs(a64)
    return float(2.0 ** -24 * np.linalg.norm(absa @ np.abs(
        np.asarray(x, np.float64))) / np.linalg.norm(np.asarray(b)))


def _best_time(fn, reps: int = 3):
    import jax

    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, out


def main_path(n: int, timed_reps: int = 3) -> dict:
    """Phase 2.  Returns the attached solver, rhs and the measurements;
    raises if either solve misses its residual bounds."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gravomg_tpu as g
    from gravomg_tpu.compile_cache import run_concurrently
    from gravomg_tpu.hierarchy_static import compact_solver

    res = {"n": n}
    t0 = time.perf_counter()
    jax.block_until_ready(bench_graph(n))
    res["t_graph_s"] = time.perf_counter() - t0          # compile included

    cfg, graph, h, diags, esc, t_cold = build_checked(n)
    res["t_build_cold_s"] = t_cold                       # graph + build
    res["escalate"] = esc
    h = diags = None
    gc.collect()
    t0 = time.perf_counter()
    cfg, graph, _, h, diags = build_pipeline(n, esc)
    jax.block_until_ready(h)
    res["t_build_warm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = g.attach_operators(compact_solver(h.solver, diags))
    jax.block_until_ready(sol)
    res["t_compact_attach_s"] = time.perf_counter() - t0
    res["levels"] = [int(lvl.op.num_vertices) for lvl in sol.levels]
    h = diags = graph = None
    gc.collect()

    b = jnp.asarray(np.random.default_rng(0).normal(size=n), jnp.float32)
    zeros = jnp.zeros_like(b)
    cycle = jax.jit(lambda hs, x, rhs: g.v_cycle(hs, x, rhs, cfg))
    h16 = g.cast_fast_operators(sol, jnp.bfloat16)
    # Compile the cycle and both solvers' programs concurrently (their
    # compiles overlap; the solver calls below find them in the
    # persistent cache when it is on).
    t0 = time.perf_counter()
    cycle_c = run_concurrently([
        lambda: cycle.lower(sol, zeros, b).compile(),
        lambda: g.mg_pcg.lower(sol, b, cfg).compile(),
        lambda: g.mg_fcg.lower(h16, b, cfg, h_outer=sol).compile()])[0]
    res["t_solve_compile_s"] = time.perf_counter() - t0
    h16 = None
    jax.block_until_ready(cycle_c(sol, zeros, b))
    res["t_vcycle_ms"] = 1e3 * _best_time(
        lambda: cycle_c(sol, zeros, b), max(timed_reps, 1))[0]

    a64 = ell_csr(sol.levels[0].op)
    # mg_solve's two paths: its default, and bf16-FCG opted in.
    cfg16 = dataclasses.replace(cfg, bf16_threshold=n)
    for name, fn, c in (("mg_solve", g.mg_solve, cfg),
                        ("mg_solve_bf16", g.mg_solve, cfg16),
                        ("mg_pcg", g.mg_pcg, cfg)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(sol, b, c))
        first = time.perf_counter() - t0
        t, (x, rel, it) = _best_time(lambda: fn(sol, b, c),
                                     max(timed_reps, 1))
        true = true_residual(a64, x, b)
        floor = x_f32_floor(a64, x, b)
        bound = RTOL + TRUE_RES_FLOORS * floor
        res[name] = {"rel": float(rel), "iters": int(it),
                     "true_rel_f64": true, "x_f32_floor": floor,
                     "true_bound": bound,
                     "t_first_s": first, "t_solve_s": t}
        res[name + "_x"] = x
        if not float(rel) <= RTOL:
            raise RuntimeError(f"{name}: reported residual {float(rel):.3e}"
                               f" > {RTOL}")
        if not true <= bound:
            raise RuntimeError(f"{name}: host-f64 true residual {true:.3e}"
                               f" > {bound:.3e}")
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes"] = stats.get("peak_bytes_in_use")
    res["sol"], res["b"], res["cfg"], res["a64"] = sol, b, cfg, a64
    return res


def print_main(res: dict):
    n = res["n"]
    log(f"main path n={n} levels={res['levels']} "
        f"escalate={res['escalate']}")
    log(f"  t_graph_s={res['t_graph_s']:.3f} (compile included) "
        f"t_build_cold_s={res['t_build_cold_s']:.3f} (graph + build, "
        f"compile included) t_build_warm_s={res['t_build_warm_s']:.3f} "
        f"t_compact_attach_s={res['t_compact_attach_s']:.3f} "
        f"t_solve_compile_s={res['t_solve_compile_s']:.3f} "
        f"t_vcycle_ms={res['t_vcycle_ms']:.4f}")
    for name in ("mg_solve", "mg_solve_bf16", "mg_pcg"):
        r = res[name]
        log(f"  {name}: rel={r['rel']:.3e} (<= {RTOL}) iters={r['iters']} "
            f"true_rel_f64={r['true_rel_f64']:.3e} "
            f"(<= {r['true_bound']:.3e} = {RTOL} + {TRUE_RES_FLOORS:g} * "
            f"x_f32_floor {r['x_f32_floor']:.3e}: x is stored in f32) "
            f"t_first_s={r['t_first_s']:.3f} t_solve_s={r['t_solve_s']:.4f}")
    peak = res["peak_bytes"]
    log(f"  peak_bytes_in_use={peak if peak is None else f'{peak:,}'}")


# ---------------------------------------------------------------- phase 3

def _nbytes(*trees) -> int:
    import jax

    return sum(int(leaf.nbytes) for t in trees
               for leaf in jax.tree_util.tree_leaves(t))


def _matvec_loop(fn):
    """One launch of ``iters`` chained ``fn(op, x)``.  Each step
    perturbs x by the carry, so nothing is hoisted; the carry update
    adds one reduction over y."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(op, x, iters):
        def body(_, s):
            return s + 1e-30 * jnp.sum(fn(op, x + s))
        return jax.lax.fori_loop(0, iters, body, jnp.zeros((), x.dtype))
    return run


def _slope_ms(loop, op, x, n1: int = 4, n2: int = 24) -> float:
    """ms per matvec from a compiled ``_matvec_loop`` at two trip
    counts (the slope cancels launch and readout constants)."""
    def timed(iters):
        loop(op, x, iters).block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            loop(op, x, iters).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(n2) - timed(n1)) / (n2 - n1) * 1e3


def spmv_table(sol, timed: bool = True, bw_gb_s=None):
    """Phase 3: per level, every form of A, U and U^T against the plain
    ELL product and SciPy CSR in f64.  Returns the rows; raises if a
    form is outside its tolerance."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gravomg_tpu as g
    from gravomg_tpu.compile_cache import run_concurrently
    from gravomg_tpu.prolong.operator import prolong, restrict_gather
    from gravomg_tpu.solve.vcycle import apply_fast

    sol16 = g.cast_fast_operators(sol, jnp.bfloat16)
    rng = np.random.default_rng(0)
    cases = []
    for li in range(len(sol.levels) - 1):
        lvl, l16 = sol.levels[li], sol16.levels[li]
        u = u_csr(lvl.u)
        for name, ref, plain, plain_fn, fast, fast16 in (
                ("A", ell_csr(lvl.op), lvl.op, g.spmv, lvl.banded,
                 l16.banded),
                ("U", u, lvl.u, prolong, lvl.uw, l16.uw),
                ("U^T", u.T.tocsr(), lvl.ut, restrict_gather, lvl.utw,
                 l16.utw)):
            forms = [("ell", plain, plain_fn, F32_TOL)]
            if fast is not None:
                forms.append(("attached", fast, apply_fast, F32_TOL))
                forms.append(("bf16", fast16, apply_fast, BF16_TOL))
            x_np = rng.standard_normal(ref.shape[1]).astype(np.float32)
            cases.append((li, name, ref, forms, x_np, jnp.asarray(x_np)))

    # Compile every product (and its timing loop) up front, concurrently.
    jobs = []
    for _, _, _, forms, _, x in cases:
        for _, fop, ffn, _ in forms:
            jobs.append(functools.partial(
                lambda f, o, v: jax.jit(f).lower(o, v).compile(),
                ffn, fop, x))
            if timed:
                jobs.append(functools.partial(
                    lambda f, o, v: _matvec_loop(f).lower(
                        o, v, jnp.int32(0)).compile(), ffn, fop, x))
    compiled = iter(run_concurrently(jobs))

    rows, failures = [], []
    for li, name, ref, forms, x_np, x in cases:
        x64 = x_np.astype(np.float64)
        y_ref = ref @ x64
        scale = float(np.max(abs(ref) @ np.abs(x64)))
        row = {"level": li, "op": name, "shape": ref.shape,
               "nnz": int(ref.nnz), "scale": scale, "forms": {}}
        y_plain = None
        for fname, fop, _, tol in forms:
            y = np.asarray(next(compiled)(fop, x), np.float64)
            loop = next(compiled) if timed else None
            if y_plain is None:
                y_plain = y
            e_sp = float(np.max(np.abs(y - y_ref))) / scale
            e_ell = float(np.max(np.abs(y - y_plain))) / scale
            rec = {"err_scipy": e_sp, "err_ell": e_ell, "tol": tol,
                   "bytes": _nbytes(fop) + 4 * (ref.shape[0]
                                                + ref.shape[1])}
            if timed:
                ms = _slope_ms(loop, fop, x)
                rec["ms"] = ms
                rec["gb_s"] = rec["bytes"] / ms / 1e6 if ms > 0 else None
            row["forms"][fname] = rec
            if not (e_sp <= tol and e_ell <= tol):
                failures.append(f"L{li} {name} {fname}: err_scipy="
                                f"{e_sp:.2e} err_ell={e_ell:.2e} > {tol}")
        rows.append(row)
        log(format_row(row, bw_gb_s))
    if failures:
        raise RuntimeError("SpMV check failed: " + "; ".join(failures))
    return rows


def format_row(row, bw_gb_s=None) -> str:
    parts = [f"L{row['level']} {row['op']:<3} {row['shape'][0]}x"
             f"{row['shape'][1]} nnz={row['nnz']}"]
    for fname, r in row["forms"].items():
        s = (f"{fname}: err_scipy={r['err_scipy']:.1e} "
             f"err_ell={r['err_ell']:.1e} (<= {r['tol']:g}) "
             f"MB={r['bytes'] / 1e6:.1f}")
        if "ms" in r:
            s += f" ms={r['ms']:.4f}"
            if r["gb_s"] is not None:
                s += f" GB/s={r['gb_s']:.0f}"
        parts.append(s)
    if bw_gb_s:
        parts.append(f"measured_bw_GB/s={bw_gb_s:.0f}")
    return " | ".join(parts)


# ---------------------------------------------------------------- phase 4

def compat_level0(n: int = 200_000) -> dict:
    """Level-0 device coarsening vs the csrc sequential build, in f64:
    parents and coarse adjacency exact, weights within 1e-6."""
    import jax

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import compat_scale
    import gravomg_tpu.io.native as native

    if not native.available():
        raise RuntimeError("csrc library did not build (make -C csrc)")
    with jax.enable_x64(True):
        rec, ok, _ = compat_scale.check_level(compat_scale.level0_graph(n))
    log(f"compat level 0 @ {n} (f64): {json.dumps(rec)} "
        f"(parents, coarse adjacency exact; weights <= 1e-6)")
    if not ok:
        raise RuntimeError(f"compat check failed: {rec}")
    return rec


def knn_canary(n: int = 20_000) -> int:
    """Brute-force knn_indices vs exact f64 neighbours.  Sets must be
    identical except where the f64 distances tie exactly.  Returns the
    number of rows that differ only by such ties."""
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial import cKDTree

    from gravomg_tpu.geometry.knn import knn_indices
    from gravomg_tpu.geometry.meshes import torus_points

    k = 16
    pts = torus_points(n, seed=3).astype(np.float32)
    got = np.asarray(knn_indices(jnp.asarray(pts), k))
    p64 = pts.astype(np.float64)
    _, ref = cKDTree(p64).query(p64, k=k + 1)      # column 0 is self
    differ = np.nonzero(np.any(np.sort(got, 1) != np.sort(ref[:, 1:], 1),
                               axis=1))[0]
    ties, bad = 0, []
    for i in differ:
        d = np.sum((p64 - p64[i]) ** 2, axis=1)
        d[i] = np.inf
        # Differing only at an exact tie: the same k smallest distances.
        if np.array_equal(np.sort(d[got[i]]), np.sort(d)[:k]):
            ties += 1
        else:
            bad.append(int(i))
    log(f"knn canary @ {n} k={k}: {len(bad)} rows differ from exact f64 "
        f"neighbours, {ties} rows differ only by exact ties")
    if bad:
        raise RuntimeError(f"kNN sets differ at rows {bad[:10]}")
    return ties


# ---------------------------------------------------------------- phase 5

def multi_device(n: int, nd: int) -> dict:
    """Phase 5: halo_solve and sharded_solve on a 1-D mesh of ``nd``
    devices against the one-card mg_pcg on the same hierarchy.

    Each multi-card solve must stop at a reported residual <= 1e-8 and
    agree with the one-card x to ``MULTI_XTOL`` (relative 2-norm)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gravomg_tpu as g
    from gravomg_tpu.compile_cache import run_concurrently
    from gravomg_tpu.hierarchy_static import compact_solver
    from gravomg_tpu.parallel.halo import halo_shard_solver, halo_solve
    from gravomg_tpu.parallel.sharding import (make_mesh, pad_solver_levels,
                                               shard_solver, sharded_solve)

    if len(jax.devices()) < nd:
        raise RuntimeError(f"need {nd} devices, have {len(jax.devices())}")
    cfg, graph, h, diags, esc, t_build = build_checked(n)
    plain = compact_solver(h.solver, diags)
    h = diags = graph = None
    gc.collect()
    log(f"# build @ {n} on one card: {t_build:.1f}s (compile included)")
    b = jnp.asarray(np.random.default_rng(0).normal(size=n), jnp.float32)
    a64 = ell_csr(plain.levels[0].op)

    # The one-card reference runs the same ELL hierarchy the sharded
    # paths shard (pad_solver_levels drops the window forms).
    mesh = make_mesh(nd)
    t0 = time.perf_counter()
    hh = halo_shard_solver(pad_solver_levels(plain, nd, pad_coarse=True),
                           mesh)
    t_setup = {"halo_solve": time.perf_counter() - t0}
    t0 = time.perf_counter()
    hs = shard_solver(pad_solver_levels(plain, nd), mesh)
    t_setup["sharded_solve"] = time.perf_counter() - t0
    runs = {"one_card": lambda: g.mg_pcg(plain, b, cfg),
            "halo_solve": lambda: halo_solve(hh, b, cfg, mesh),
            "sharded_solve": lambda: sharded_solve(hs, b, cfg, mesh)}
    # First calls run concurrently so their compiles overlap; the timed
    # calls after them run one at a time.
    t0 = time.perf_counter()
    first = dict(zip(runs, run_concurrently(
        [lambda f=f: jax.block_until_ready(f()) for f in runs.values()])))
    t_first = time.perf_counter() - t0
    x1, rel1, it1 = first["one_card"]
    r1 = true_residual(a64, x1, b)
    x1 = np.asarray(x1, np.float64)
    out = {"n": n, "devices": nd, "x_tol": MULTI_XTOL,
           "t_first_all_s": t_first,
           "one_card": {"rel": float(rel1), "iters": int(it1),
                        "true_rel_f64": r1}}
    failures = []
    for name in ("halo_solve", "sharded_solve"):
        t_solve, (x, rel, it) = _best_time(runs[name], 2)
        r = true_residual(a64, x, b)
        diff = float(np.linalg.norm(np.asarray(x, np.float64) - x1)
                     / np.linalg.norm(x1))
        out[name] = {"rel": float(rel), "iters": int(it),
                     "true_rel_f64": r, "rel_diff_vs_one_card": diff,
                     "t_setup_s": t_setup[name], "t_solve_s": t_solve}
        log(f"{name} on {nd} devices @ {n}: rel={float(rel):.3e} "
            f"(<= {RTOL}) iters={int(it)} true_rel_f64={r:.3e} "
            f"|x - x_one_card|/|x_one_card|={diff:.3e} (<= {MULTI_XTOL:g})"
            f" t_setup_s={t_setup[name]:.3f} t_solve_s={t_solve:.4f}")
        if not (float(rel) <= RTOL and diff <= MULTI_XTOL):
            failures.append(name)
    log(f"one card mg_pcg @ {n}: rel={float(rel1):.3e} iters={int(it1)} "
        f"true_rel_f64={r1:.3e}; first calls of all three (compile "
        f"included, concurrent) {t_first:.1f}s")
    if failures:
        raise RuntimeError(f"multi-device solves failed: {failures}")
    return out


# ---------------------------------------------------------------- main

def _device_json(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="vertices of the main-path cloud")
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the multi-card solve phase on this "
                         "many devices")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "gravomg_tpu")):
        raise SystemExit("chip_smoke: the gravomg_tpu package is not "
                         "beside this script")
    sys.path.insert(0, REPO)

    import jax

    from gravomg_tpu.compile_cache import enable_compile_cache

    devices = require_gpu(jax.devices())
    enable_compile_cache()
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__} devices={len(devices)} "
        f"kind={devices[0].device_kind}")

    t_all = time.perf_counter()

    def done(phase):
        log(f"# phase {phase} done at {time.perf_counter() - t_all:.1f}s")

    if args.devices > 1:
        multi_device(args.n, args.devices)
        done("multi-device")
        print(_device_json(devices[:args.devices]), flush=True)
        return 0

    res = main_path(args.n)
    print_main(res)
    done("2 main path")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import membw_probe

    bw = membw_probe.probe(1024)
    log("measured streaming bandwidth (scripts/membw_probe.py, 1 GiB): "
        + " ".join(f"{k}={v['gb_s']:.0f}GB/s" for k, v in bw.items()))
    spmv_table(res["sol"], timed=True, bw_gb_s=bw["rowsum"]["gb_s"])
    done("3 spmv table")
    res = None
    gc.collect()
    compat_level0(200_000)
    done("4 compat")
    knn_canary(20_000)
    done("4 knn canary")
    print(_device_json(devices[:1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
