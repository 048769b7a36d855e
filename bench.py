"""Benchmark driver: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}.

Headline metric (BASELINE.md): per-V-cycle wall time on a screened-
Poisson problem at GRAVOMG_BENCH_N vertices (default 1M), measured on
the accelerator with the fully device-resident pipeline (grid kNN ->
Laplacian -> hierarchy -> compaction -> attach -> V-cycles); the
pipeline is ``chip_smoke.build_pipeline``, shared with the smoke run.

Timing protocol: each measurement runs in a fresh subprocess that
executes the warm pipeline plus N chained V-cycles inside one jitted
loop; two runs with different N give the per-cycle slope
t_per_cycle = (T(N2) - T(N1)) / (N2 - N1), which cancels launch and
readout constants.  Slope linearity is cross-checked with a third
cycle count (``slope_r2`` in the stderr report).  A separate subprocess
measures the warm hierarchy build the same way.

``vs_baseline`` is the speedup over a SciPy-CSR CPU implementation of
the same V-cycle on the same hierarchy -- the stand-in for the
reference's C++/Eigen CPU execution model (the reference ships no solver
or benchmarks, BASELINE.md).

No fallbacks: a failed or timed-out measurement exits non-zero and
prints no result line.  The device script refuses to run on the CPU
unless ``JAX_PLATFORMS=cpu`` is set explicitly (small rehearsals), and
the result line names the device it ran on.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")

# Wall-clock budget for the whole bench: every subprocess gets the
# REMAINING budget as its timeout.
BUDGET_S = float(os.environ.get("GRAVOMG_BENCH_BUDGET_S", "3300"))
_T0 = time.monotonic()


def _remaining() -> float:
    return max(30.0, BUDGET_S - (time.monotonic() - _T0))


def _xla_cache_entries() -> int:
    """Persistent-XLA-cache entry count -- recorded so every timed
    number states the cache condition it was measured under."""
    from gravomg_tpu.compile_cache import compile_cache_dir

    try:
        return len(os.listdir(compile_cache_dir()))
    except OSError:
        return 0


BENCH_N = int(os.environ.get("GRAVOMG_BENCH_N", "1000000"))
N1 = int(os.environ.get("GRAVOMG_BENCH_C1", "2"))
N2 = int(os.environ.get("GRAVOMG_BENCH_C2", "12"))
N3 = int(os.environ.get("GRAVOMG_BENCH_C3", "32"))

_COMMON = r"""
import json, os, sys, time, gc, functools
import numpy as np
import jax
import jax.numpy as jnp
import gravomg_tpu as g
from gravomg_tpu.compile_cache import enable_compile_cache
from gravomg_tpu.config import DEFAULT_CAPS
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)
from chip_smoke import build_pipeline

dev = jax.devices()
if dev[0].platform == "cpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
    sys.exit("bench: no accelerator (set JAX_PLATFORMS=cpu to rehearse)")
enable_compile_cache()
DEVICE = {"platform": dev[0].platform, "kind": dev[0].device_kind,
          "count": len(dev)}
"""

_DEVICE_SCRIPT = _COMMON + r"""
n, n1, n2, n3 = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                 int(sys.argv[4]))
out = sys.argv[-1]
from chip_smoke import build_checked
# Cold build (compile included), with the cap-escalation retry; t_build
# times the build that passed its diagnostics.
cfg, graph, h, diags, escalate, t_build = build_checked(n)
# Compaction syncs the level diagnostics and slices every level to
# tight row/degree buckets -- the padded plan carries up to ~3x phantom
# rows otherwise.
sol = compact_solver(h.solver, diags)
# Window operator forms: bucketed variable-window (slab) forms on the
# large levels, uniform block-dense on the small ones.  Exact: same
# products, different add order.
sol = g.attach_operators(sol)
# Drop the uncompacted build hierarchy: its padded per-level arrays pin
# several GB of device memory at 1M and nothing below reads them.
h = None
gc.collect()
b = jnp.asarray(np.random.default_rng(0).normal(size=n), jnp.float32)

# All cycle measurements are SINGLE-launch programs (fori_loop inside
# one jit), so the constant per-launch cost cancels in the slope and
# the difference isolates true per-cycle execution.
@functools.partial(jax.jit, static_argnames=("cycles",))
def run_cycles(hs, b, cycles):
    def body(_, x):
        return g.v_cycle(hs, x, b, cfg)
    return jax.lax.fori_loop(0, cycles, body, jnp.zeros_like(b))

def timed(fn, arg, reps=5):
    x = fn(arg).block_until_ready()          # compile + first exec
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        x = fn(arg).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best, x

t1, _ = timed(lambda c: run_cycles(sol, b, c), n1)
t2, x = timed(lambda c: run_cycles(sol, b, c), n2)
t3, _ = timed(lambda c: run_cycles(sol, b, c), n3)

# Slope + linearity check over the three counts.
xs = np.array([n1, n2, n3], float); ys = np.array([t1, t2, t3])
slope, icept = np.polyfit(xs, ys, 1)
pred = slope * xs + icept
ss_res = float(((ys - pred) ** 2).sum())
ss_tot = float(((ys - ys.mean()) ** 2).sum())
r2 = 1.0 - ss_res / max(ss_tot, 1e-30)

rel = float(jnp.linalg.norm(b - g.spmv(sol.levels[0].op, x))
            / jnp.linalg.norm(b))

# MG-PCG: per-iteration slope + iterations to the BASELINE 1e-8 target.
from gravomg_tpu.solve.cg import _dot

@functools.partial(jax.jit, static_argnames=("iters",))
def run_pcg_iters(hs, b, iters):
    op = hs.levels[0].op
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = g.v_cycle(hs, jnp.zeros_like(r0), r0, cfg, x0_zero=True)
    def body(_, st):
        x, r, z, p, rz = st
        ap = g.level_matvec(hs.levels[0], p)
        alpha = rz / jnp.maximum(_dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = g.v_cycle(hs, jnp.zeros_like(r), r, cfg, x0_zero=True)
        rz2 = _dot(r, z)
        return x, r, z, z + (rz2 / jnp.maximum(rz, 1e-30)) * p, rz2
    st = jax.lax.fori_loop(0, iters, body,
                           (x0, r0, z0, z0, _dot(r0, z0)))
    return st[0]

p1, _ = timed(lambda c: run_pcg_iters(sol, b, c), n1)
p2, xp = timed(lambda c: run_pcg_iters(sol, b, c), n2)
pcg_it_s = (p2 - p1) / (n2 - n1)
# Iteration count to 1e-8 (run once; while_loop with residual exit).
xs_, rel_pcg, iters_pcg = g.mg_pcg(sol, b, cfg)
iters_pcg = int(iters_pcg)
rel_pcg = float(rel_pcg)
time_to_1e8 = pcg_it_s * iters_pcg

# bf16 V-cycle preconditioner around the f32 FLEXIBLE CG (halves the
# window-matrix bytes; the Polak-Ribiere beta absorbs the bf16 rounding
# that diverges fixed-beta PCG; CG's matvec and residuals stay f32).
sol16 = g.cast_fast_operators(sol, jnp.bfloat16)

@functools.partial(jax.jit, static_argnames=("iters",))
def run_fcg16(h16, hs, b, iters):
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = g.v_cycle(h16, jnp.zeros_like(r0), r0, cfg,
                   x0_zero=True).astype(b.dtype)
    def body(_, st):
        x, r, z, p, rz = st
        ap = g.level_matvec(hs.levels[0], p)
        alpha = rz / jnp.maximum(_dot(p, ap), 1e-30)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = g.v_cycle(h16, jnp.zeros_like(r_new), r_new, cfg,
                      x0_zero=True).astype(b.dtype)
        rz2 = _dot(r_new, z)
        beta = (rz2 - _dot(r, z)) / jnp.maximum(rz, 1e-30)
        return x, r_new, z, z + beta * p, rz2
    st = jax.lax.fori_loop(0, iters, body,
                           (x0, r0, z0, z0, _dot(r0, z0)))
    return st[0]

q1, _ = timed(lambda c: run_fcg16(sol16, sol, b, c), n1)
q2, _ = timed(lambda c: run_fcg16(sol16, sol, b, c), n2)
pcg16_it_s = (q2 - q1) / (n2 - n1)
_, rel16, iters16 = g.mg_fcg(sol16, b, cfg, h_outer=sol)
time_to_1e8_bf16 = pcg16_it_s * int(iters16)

json.dump({"device": DEVICE, "t_build": t_build, "escalate": escalate,
           "t1": t1, "t2": t2, "t3": t3,
           "n1": n1, "n2": n2, "n3": n3, "slope_s": float(slope),
           "slope_r2": r2, "residual": rel,
           "pcg_iter_s": pcg_it_s, "pcg_iters": iters_pcg,
           "pcg_rel": rel_pcg, "time_to_1e8_s": time_to_1e8,
           "pcg16_iter_s": pcg16_it_s, "pcg16_iters": int(iters16),
           "pcg16_rel": float(rel16),
           "time_to_1e8_bf16_s": time_to_1e8_bf16,
           "levels": [int(d.n_real) for d in diags],
           "shapes": [(l.op.num_vertices, l.op.max_degree)
                      for l in sol.levels]}, open(out, "w"))

# Export the compacted solver so the CPU baseline runs its SciPy
# V-cycles on the IDENTICAL hierarchy without re-running the device
# build pipeline on JAX-CPU.  save_solver only records op/u/cheb -- the
# attached fast forms are derived data.
from gravomg_tpu.io.serialization import save_solver
save_solver(sys.argv[5], sol)
"""

# Warm build: run the whole pipeline twice in one process and time the
# SECOND pass -- every shape is then compile-cached in-process, so the
# number is the warm pipeline-and-build latency regardless of the
# persistent cache's state.
_WARM_BUILD_SCRIPT = _COMMON + r"""
n, esc, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[-1]
cfg, graph, spd, h, diags = build_pipeline(n, esc)
jax.block_until_ready(h)
# Free the first build BEFORE the second: a tuple rebind drops the old
# hierarchy only after the second build returns, so both would be
# resident together (2x device memory at 1M).
h = diags = None
gc.collect()
t0 = time.perf_counter()
cfg, graph, spd, h, diags = build_pipeline(n, esc)
jax.block_until_ready(h)
t_build = time.perf_counter() - t0
json.dump({"t_build_warm": t_build}, open(out, "w"))
"""

# Execution-only build timing: run the full pipeline once (compiling
# everything in-process), then execute the device-resident build R more
# times on the same inputs; two subprocesses with different R give the
# per-build execution slope with launch/compile constants cancelled
# (same protocol as the V-cycle slope).
_BUILD_EXEC_SCRIPT = _COMMON + r"""
n, reps, esc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out = sys.argv[-1]
kw = dict(caps=DEFAULT_CAPS.escalated(esc)) if esc else {}
t0 = time.perf_counter()
cfg, graph, spd, h, diags = build_pipeline(n, esc)
for _ in range(reps):
    # Free the previous hierarchy BEFORE rebuilding: a tuple rebind
    # keeps it alive through the new build (2x device memory at 1M).
    h = diags = None
    gc.collect()
    h, diags = build_hierarchy_device(graph, spd, cfg, **kw)
jax.block_until_ready(h)
json.dump({"t_total": time.perf_counter() - t0, "reps": reps},
          open(out, "w"))
"""

# Sequential CPU hierarchy build (csrc reference-semantics pipeline,
# C4->C12 per level) at the same N: the build-time baseline the
# execution-only number races (BASELINE "hierarchy construction" target).
_BUILD_CPU_SCRIPT = r"""
import json, sys, time
import numpy as np
import gravomg_tpu.io.native as native
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync

n, out = int(sys.argv[1]), sys.argv[2]
pts = torus_points(n, seed=1).astype(np.float32)
pts = pts[morton_order(pts)]
graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
assert not bool(short)
nbr = np.asarray(graph.neighbors)
dst = np.asarray(graph.distances)
p64 = np.asarray(pts, np.float64)
t0 = time.perf_counter()
native.build_hierarchy(nbr, dst, p64, reduction_ratio=2.0)
json.dump({"cpu_build_s": time.perf_counter() - t0}, open(out, "w"))
"""

_BASELINE_SCRIPT = r"""
import json, os, sys, time
import numpy as np
import jax.numpy as jnp
import gravomg_tpu as g
from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics,
                                          compact_solver)
import scipy.sparse as sp
import scipy.linalg as sla

n, solver_npz, out_json = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cfg = g.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")

def _ell_to_csr(nbr, off, diag):
    v_, k_ = nbr.shape
    mask = nbr != int(g.INVALID_INDEX)
    rows = np.repeat(np.arange(v_), k_)[mask.ravel()]
    cols = nbr.ravel()[mask.ravel()]
    m = sp.csr_matrix((off.ravel()[mask.ravel()], (rows, cols)),
                      shape=(v_, v_))
    return m + sp.diags(diag)

def _u_to_csr(ucols, uw, n_coarse):
    vf = ucols.shape[0]
    rows = np.repeat(np.arange(vf), 3)
    return sp.csr_matrix((uw.ravel(), (rows, ucols.ravel())),
                         shape=(vf, n_coarse))

if solver_npz and os.path.exists(solver_npz):
    # The device bench run exported its compacted solver: run the SciPy
    # V-cycle on the IDENTICAL hierarchy (same levels, same nnz, same
    # Chebyshev windows).  Avoids re-running the whole device-build
    # pipeline on CPU JAX, which takes hours at 1M on one core.
    nb = n
    z = np.load(solver_npz)
    nlev = int(z["n_levels"])
    As = [_ell_to_csr(z[f"l{i}_nbr"], z[f"l{i}_off"],
                      np.asarray(z[f"l{i}_diag"], np.float64))
          for i in range(nlev)]
    Us = [_u_to_csr(z[f"l{i}_ucols"], z[f"l{i}_uw"],
                    int(z[f"l{i}_unc"])) for i in range(nlev - 1)]
    cheb = [tuple(map(float, z[f"l{i}_cheb"]))
            for i in range(nlev - 1)]
else:
    # MEASURED at full size (no linear extrapolation; an explicit cap
    # env remains for smoke runs only).
    nb = min(n, int(os.environ.get("GRAVOMG_BENCH_CPU_CAP", str(n))))
    pts = torus_points(nb, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph, short = grid_knn_graph_nosync(pts, 16, margin=2.4)
    assert not bool(short)
    # Same auto-scaled screening as the device script (build_pipeline).
    spd, _ = g.screened_poisson_operator(graph, alpha="auto")
    h, diags = build_hierarchy_device(graph, spd, cfg)
    check_diagnostics(diags)
    hs = compact_solver(h.solver, diags)
    As = [_ell_to_csr(np.asarray(l.op.neighbors), np.asarray(l.op.offdiag),
                      np.asarray(l.op.diag)) for l in hs.levels]
    Us = [_u_to_csr(np.asarray(l.u.cols), np.asarray(l.u.weights),
                    l.u.n_coarse) for l in hs.levels[:-1]]
    cheb = [(float(l.cheb.lam_min), float(l.cheb.lam_max))
            for l in hs.levels[:-1]]

Dinv = [1.0 / A.diagonal() for A in As]
# Deep f32 RAP chains leave the coarsest operator slightly asymmetric
# and indefinite in the last digits at 1M scale; symmetrize in f64 and
# escalate the shift until SPD (mirrors solve/coarse.py).
_ac = As[-1].toarray().astype(np.float64)
_ac = 0.5 * (_ac + _ac.T)
_base = np.abs(np.diag(_ac)).max()
for _s in (1e-10, 1e-6, 1e-4):
    try:
        chol = sla.cho_factor(_ac + _s * _base * np.eye(_ac.shape[0]))
        break
    except np.linalg.LinAlgError:
        continue
else:
    raise RuntimeError("coarsest operator not factorizable")

# Same smoother as the device path (Chebyshev of cfg.chebyshev_degree on
# the Jacobi-preconditioned operator) so per-cycle work matches.
def smooth(lvl, x, b):
    A, dinv = As[lvl], Dinv[lvl]
    lo, hi = cheb[lvl]
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = dinv * (b - A @ x)
    d = r / theta
    x = x + d
    for _ in range(cfg.chebyshev_degree - 1):
        r = dinv * (b - A @ x)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x

def vcycle_cpu(lvl, x, b):
    if lvl == len(As) - 1:
        return sla.cho_solve(chol, b)
    A, U = As[lvl], Us[lvl]
    x = smooth(lvl, x, b)
    r = b - A @ x
    e = vcycle_cpu(lvl + 1, np.zeros(U.shape[1]), U.T @ r)
    x = x + U @ e
    return smooth(lvl, x, b)

b = np.random.default_rng(0).standard_normal(nb)
x = vcycle_cpu(0, np.zeros(nb), b)
t0 = time.perf_counter()
for _ in range(20):
    x = vcycle_cpu(0, x, b)
cpu_ms = (time.perf_counter() - t0) / 20 * 1000 * (n / nb)
json.dump({"cpu_vcycle_ms": cpu_ms, "baseline_n": nb}, open(out_json, "w"))
"""


def _run(script: str, args, out: str, env=None) -> dict:
    """Run one measurement script in a fresh process; it writes its
    result to ``out``.  Any failure raises (no stale results)."""
    os.makedirs(CACHE, exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    subprocess.run([sys.executable, "-c", script, *map(str, args), out],
                   check=True, cwd=REPO, env=env, timeout=_remaining())
    return json.load(open(out))


def solver_npz_path(n: int) -> str:
    return os.path.join(CACHE, f"solver_{n}.npz")


def run_device(n: int, n1: int, n2: int, n3: int) -> dict:
    return _run(_DEVICE_SCRIPT, [n, n1, n2, n3, solver_npz_path(n)],
                os.path.join(CACHE, "device_slope.json"))


def run_warm_build(n: int, esc: int = 0) -> dict:
    return _run(_WARM_BUILD_SCRIPT, [n, esc],
                os.path.join(CACHE, "device_warmbuild.json"))


def run_build_exec(n: int, r1: int = 0, r2: int = 4,
                   esc: int = 0) -> dict:
    ts = {reps: _run(_BUILD_EXEC_SCRIPT, [n, reps, esc],
                     os.path.join(CACHE, f"device_buildexec_{reps}.json")
                     )["t_total"] for reps in (r1, r2)}
    return {"build_exec_s": (ts[r2] - ts[r1]) / (r2 - r1),
            "t_r1": ts[r1], "t_r2": ts[r2]}


def _cpu_env() -> dict:
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0"})
    return env


def cpu_build_baseline(n: int) -> dict:
    return _run(_BUILD_CPU_SCRIPT, [n], os.path.join(CACHE, "cpubuild.json"),
                env=_cpu_env())


def cpu_baseline(n: int) -> dict:
    return _run(_BASELINE_SCRIPT, [n, solver_npz_path(n)],
                os.path.join(CACHE, "cpu_vcycle.json"), env=_cpu_env())


def main():
    from gravomg_tpu.config import MultigridConfig

    # Device first: it exports its compacted solver, which the CPU
    # baseline then reuses (identical hierarchy).
    cache0 = _xla_cache_entries()
    r = run_device(BENCH_N, N1, N2, N3)
    meta = cpu_baseline(BENCH_N)
    esc = int(r["escalate"])
    warm = run_warm_build(BENCH_N, esc)
    bexec = run_build_exec(BENCH_N, esc=esc)
    bcpu = cpu_build_baseline(BENCH_N)
    dev_ms = r["slope_s"] * 1000
    if not dev_ms > 0:
        raise RuntimeError(f"non-positive V-cycle slope {dev_ms} ms")
    # The default solve path (solve/cg.py::mg_solve): bf16-FCG at or
    # above the config threshold, f32 MG-PCG below -- report its
    # time-to-target as the solver headline beside the V-cycle slope.
    if BENCH_N >= MultigridConfig().bf16_threshold:
        if not r["pcg16_rel"] <= 1e-8:
            raise RuntimeError(f"bf16-FCG missed 1e-8: {r['pcg16_rel']}")
        t_default, default_path = r["time_to_1e8_bf16_s"], "bf16_fcg"
    else:
        t_default, default_path = r["time_to_1e8_s"], "f32_pcg"
    print(json.dumps({
        "metric": f"vcycle_ms_{BENCH_N}v",
        "value": round(dev_ms, 4),
        "unit": "ms",
        "vs_baseline": round(meta["cpu_vcycle_ms"] / dev_ms, 3),
        "device": r["device"]}))
    scaled = ("" if meta["baseline_n"] == BENCH_N
              else f"(cpu measured at {meta['baseline_n']}v, scaled) ")
    print(f"# device={r['device']} "
          f"build_cold={r['t_build']:.3f}s "
          f"build_warm={warm['t_build_warm']:.3f}s "
          f"build_exec={bexec['build_exec_s']:.3f}s "
          f"build_cpu_csrc={bcpu['cpu_build_s']:.3f}s "
          f"cpu_vcycle={meta['cpu_vcycle_ms']:.2f}ms {scaled}"
          f"device_vcycle={dev_ms:.4f}ms slope_r2={r['slope_r2']:.6f} "
          f"T({r['n1']})={r['t1']:.3f}s T({r['n2']})={r['t2']:.3f}s "
          f"T({r['n3']})={r['t3']:.3f}s "
          f"residual_12cycles={r['residual']:.2e} "
          f"pcg_iter_ms={r['pcg_iter_s']*1000:.3f} "
          f"pcg_iters_to_1e8={r['pcg_iters']} pcg_rel={r['pcg_rel']:.2e} "
          f"time_to_1e8_s={r['time_to_1e8_s']:.4f} "
          f"default_path={default_path} "
          f"time_to_1e8_default_s={t_default:.4f} "
          f"bf16: pcg_iter_ms={r['pcg16_iter_s']*1000:.3f} "
          f"iters={r['pcg16_iters']} rel={r['pcg16_rel']:.2e} "
          f"t1e8={r['time_to_1e8_bf16_s']:.4f} "
          f"xla_cache_entries={cache0}->{_xla_cache_entries()} "
          f"levels={r['levels']} shapes={r['shapes']}", file=sys.stderr)


if __name__ == "__main__":
    main()
