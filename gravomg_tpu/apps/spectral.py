"""Spectral analysis: lowest Laplace eigenpairs via MG-preconditioned
block LOBPCG (the "spectral stepping" half of BASELINE config 5).

Solves the generalized symmetric eigenproblem

    L v = lam M v,   L = graph Laplacian, M = lumped mass (diagonal),

for the k smallest eigenpairs.  The reference library stops at
hierarchy construction (SURVEY.md section 0); spectral workloads are a
standard consumer of its prolongation hierarchy, and BASELINE config 5
names them explicitly.

Shape of the algorithm:

  * All tall-skinny products are (V, m) x (m, m) / (V, m)^T (V, m)
    matmuls, batched over the whole block and pinned to full precision
    (:func:`_mm`; TF32 would keep ~3 digits of the Grams).
  * The preconditioner is the multigrid V-cycle applied to the entire
    residual block at once: every solver stage (smoothers, transfers,
    coarse Cholesky) natively supports (V, D) right-hand sides, so one
    cycle preconditions all k residuals in a single pass over the
    operators (amortizing the streaming of A across columns).
  * The dense Rayleigh-Ritz problem is m x m with m <= 3k, solved in
    f64 on the host between jitted steps; the host loop also lets the
    caller early-stop on the residual.

Numerical design (both measured on the icosphere oracle): the search
block S = [X, W, P] becomes near-M-rank-deficient as pairs converge,
and a *jittered-Cholesky* whitening then produces spurious Ritz values
at the BOTTOM of the spectrum (tiny Gram norm / tiny quotient ratios
displace true pairs).  The cure here is eigendecomposition-based
whitening with degenerate directions pinned to a huge Ritz value, so
the k-smallest selection can never pick them; W and P are additionally
projected M-orthogonal to X before entering S.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.types import Graph
from gravomg_tpu.geometry.laplacian import graph_laplacian
from gravomg_tpu.hierarchy import Hierarchy
from gravomg_tpu.apps.poisson import poisson_hierarchy
from gravomg_tpu.solve.vcycle import SolverHierarchy, v_cycle

# Pinned Ritz value for degenerate search directions: far above any
# Laplacian eigenvalue, far below f32 overflow.
_DEGENERATE = 1e12
# Relative Gram-eigenvalue threshold below which a direction is
# considered degenerate (f32 roundoff floor with headroom).
_RANK_TOL = 1e-6


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Matrix product at full precision (no TF32 passes)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _b_orthonormalize(mass: jax.Array, v: jax.Array) -> jax.Array:
    """An M-orthonormal basis of span(v) (M diagonal).

    Whitens with the Gram eigendecomposition; near-null Gram directions
    get a unit scale instead of a 1/sqrt blow-up, leaving harmless
    near-zero columns (the Rayleigh-Ritz pinning below keeps them out
    of the answer).  Column order is NOT preserved -- use only on the
    W/P basis blocks, never on the Ritz block X.
    """
    g = _mm(v.T, mass[:, None] * v)
    d, q = jnp.linalg.eigh(g)
    dsafe = jnp.where(d > _RANK_TOL * jnp.max(d), d, 1.0)
    return _mm(v, q * jax.lax.rsqrt(dsafe))


def _project_out(mass: jax.Array, basis: jax.Array,
                 v: jax.Array) -> jax.Array:
    """Remove the M-projection onto ``basis`` (M-orthonormal columns)."""
    return v - _mm(basis, _mm(basis.T, mass[:, None] * v))


def _rayleigh_ritz_host(ga: "np.ndarray", gb: "np.ndarray", k: int):
    """k smallest eigenpairs of the dense pencil (ga, gb), gb PSD, on
    the host in f64 (NumPy/LAPACK).

    Degenerate gb directions (rank-deficient search block) are pinned
    to ``_DEGENERATE`` so they sort to the top and can never displace a
    true pair at the small end -- the failure mode of jittered-Cholesky
    whitening.  The pencil needs f64: its eigenvalue error is
    ~eps * ||c|| with ||c|| ~ lam_max of the pencil (1e5-1e6 at 100k
    vertices), so an f32 solve perturbs the low Ritz values by O(0.1-1)
    -- the measured -5.0 "nullspace" and the 5e-2 block-residual stall.
    The LOBPCG driver already syncs every iteration for its early-stop
    check, and the Grams are ~20 kB.
    """
    import numpy as np
    d, q = np.linalg.eigh(gb)
    good = d > _RANK_TOL * d.max()
    dsafe = np.where(good, d, 1.0)
    wh = q / np.sqrt(dsafe)
    c = wh.T @ ga @ wh
    gm = good.astype(c.dtype)
    c = c * gm[:, None] * gm[None, :] + np.diag(
        np.where(good, 0.0, _DEGENERATE))
    theta, y = np.linalg.eigh(c)
    vecs = wh @ y
    return theta[:k], vecs[:, :k]


@functools.partial(jax.jit, static_argnames=("cfg", "use_p"))
def _lobpcg_block(hs: SolverHierarchy, lap, mass, x, p,
                  cfg: MultigridConfig, use_p: bool):
    """Device half of one LOBPCG step: residual, V-cycle
    preconditioner, search block S = [X, W, (P)], and the f64 Grams.

    The Grams accumulate in f64: the f32 Gram entries carry
    ~1e-6 * ||L|| * sqrt(V) rounding, which at 20k+ vertices floors the block residual around 5e-2 and
    leaves the nullspace Ritz value oscillating at +-0.5 (measured
    trajectory, 2026-08-21: max_res flat at 5.4-6.1e-2 from iteration
    60 to 160).  The dense m x m eigensolve happens on the HOST
    (:func:`_rayleigh_ritz_host`); returns (s, ga, gb, resnorm).
    """
    from gravomg_tpu.solve.spmv import spmv

    ax = spmv(lap, x)
    # f64 Rayleigh quotients (X is M-orthonormal): the f32 sum over V
    # rows is the same Gram-precision floor as the Grams below.
    with jax.enable_x64():
        lam = jnp.sum(x.astype(jnp.float64) * ax.astype(jnp.float64),
                      axis=0)
    lam = lam.astype(x.dtype)
    r = ax - (mass[:, None] * x) * lam[None, :]
    # Scale-relative residual: the nullspace pair has lam ~ 0, so
    # normalize by the largest Ritz value, not per-column lam.
    resnorm = jnp.linalg.norm(r, axis=0) / jnp.maximum(
        jnp.max(jnp.abs(lam)), 1e-12)
    # Multigrid preconditioner: one V-cycle on the whole residual block.
    w = v_cycle(hs, jnp.zeros_like(r), r, cfg, x0_zero=True)
    w = _b_orthonormalize(mass, _project_out(mass, x, w))
    if use_p:
        pb = _project_out(mass, x, p)
        pb = pb - _mm(w, _mm(w.T, mass[:, None] * pb))
        s = jnp.concatenate([x, w, _b_orthonormalize(mass, pb)], axis=1)
    else:
        s = jnp.concatenate([x, w], axis=1)
    as_ = spmv(lap, s)
    with jax.enable_x64():
        s64 = s.astype(jnp.float64)
        ga = _mm(s64.T, as_.astype(jnp.float64))
        gb = _mm(s64.T, mass.astype(jnp.float64)[:, None] * s64)
    return s, ga, gb, resnorm


@functools.partial(jax.jit, static_argnames=("k",))
def _lobpcg_update(s, y, k: int):
    """Device half two: apply the host Ritz rotation.

    Ritz vectors are gb-orthonormal by construction: use them directly
    (a re-orthonormalization would scramble the column <-> eigenvalue
    correspondence).  P = the W/P component of the update (classic
    LOBPCG three-term recurrence): drop X's contribution so P spans
    the search step."""
    x_new = _mm(s, y)
    y_tail = y.at[:k].set(0.0)
    p_new = _mm(s, y_tail)
    return x_new, p_new


def _lobpcg_step(hs: SolverHierarchy, lap, mass, x, p,
                 cfg: MultigridConfig, k: int, use_p: bool):
    """One preconditioned Rayleigh-Ritz step on the block [X, W, (P)].

    x: (V, k) current M-orthonormal Ritz block; p: (V, k) previous
    search step.  Returns (x_new, p_new, ritz_values, residual_norms).
    Device work is jitted (:func:`_lobpcg_block` / :func:`_lobpcg_update`);
    the m x m dense pencil solves on the host in f64 (see
    :func:`_rayleigh_ritz_host` -- ~20 kB of Grams per iteration, and
    the driver loop already syncs each iteration for early stopping).
    """
    import numpy as np

    s, ga, gb, resnorm = _lobpcg_block(hs, lap, mass, x, p, cfg, use_p)
    theta, y = _rayleigh_ritz_host(np.asarray(ga), np.asarray(gb), k)
    x_new, p_new = _lobpcg_update(
        s, jnp.asarray(y.astype(np.float32)), k)
    return x_new, p_new, jnp.asarray(theta.astype(np.float32)), resnorm


def spectral_alpha(graph: Graph, weighting: str = "invdist",
                   target_frac: float = 0.25,
                   rel_floor: float = 1e-5,
                   lap_mass: Optional[Tuple] = None) -> jax.Array:
    """Screening shift (pencil units) for an *eigen*-preconditioner.

    The Poisson path's ``alpha="auto"`` pins the shift at 1e-4 of the
    mean diagonal for f32-SPD safety -- but in pencil units that shift
    grows like 1/h^3 with density (measured: 3.9 at 5k -> 355 at 100k
    on a torus) while the target eigenvalues stay O(lam_1).  Once
    alpha > lam_1 the V-cycle of L + alpha*M acts as a scaled identity
    on the low modes and LOBPCG loses its preconditioner entirely
    (measured: max resnorm 0.13 after 40 iterations at 100k).

    This picks alpha ~ lam_1 * target_frac instead, estimating lam_1
    from the Rayleigh quotients of the three M-centered coordinate
    functions (smooth low-frequency surrogates on any embedded surface;
    the min is an upper bound on lam_1 within a small factor -- 1.4x at
    100k measured).  Coordinates with negligible M-weighted variance
    (a planar cloud's normal direction) are excluded: their quotient is
    0/guard ~ 0 and would collapse the min regardless of the valid
    coordinates.  Clamped below by ``rel_floor`` of the mean diagonal --
    measured f32 Galerkin-RAP noise sits at ~1e-6 of the diagonal
    (the Poisson path's 1e-4 "auto" floor carries ~1e2 margin over it),
    so 1e-5 keeps ~10x SPD margin even when the floor binds -- and
    above by the Poisson "auto" value (a smaller-than-auto alpha is
    only ever a spectral improvement).  Stays traced: no host sync.

    ``lap_mass``: optional precomputed ``(lap, mass)`` pair (as from
    :func:`graph_laplacian`) to avoid re-assembling the Laplacian.
    """
    from gravomg_tpu.solve.spmv import spmv

    lap, mass = (lap_mass if lap_mass is not None
                 else graph_laplacian(graph, weighting))
    v = graph.points - (jnp.sum(mass[:, None] * graph.points, axis=0)
                        / jnp.sum(mass))[None, :]
    var = jnp.sum(mass[:, None] * v * v, axis=0)
    nondegenerate = var > 1e-6 * jnp.max(var)
    rq = (jnp.sum(v * spmv(lap, v), axis=0)
          / jnp.maximum(var, 1e-30))
    lam1_est = jnp.min(jnp.where(nondegenerate, rq, jnp.inf))
    diag_over_mass = jnp.mean(lap.diag) / jnp.mean(mass)
    floor = rel_floor * diag_over_mass
    auto = 1e-4 * diag_over_mass
    return jnp.clip(target_frac * lam1_est, floor, auto)


def laplace_eigs(graph: Graph, k: int = 8,
                 cfg: MultigridConfig = MultigridConfig(),
                 h: Optional[Hierarchy] = None, alpha="spectral",
                 weighting: str = "invdist", iters: int = 40,
                 tol: float = 1e-5, seed: int = 0):
    """k smallest eigenpairs of (L, M) on a kNN graph.

    Builds (or reuses via ``h``) the screened-Poisson hierarchy
    L + alpha*M as the preconditioner -- its V-cycle approximates
    (L + alpha*M)^{-1}, spectrally equivalent to L^{-1} on the low end,
    which is what LOBPCG needs.  ``alpha="spectral"`` (default) sizes
    the shift to the estimated lam_1 (:func:`spectral_alpha`); the
    Poisson-tuned ``"auto"`` overshoots lam_1 at scale and degrades the
    preconditioner to a scaled identity (see spectral_alpha).  Callers
    passing a prebuilt ``h`` own that trade-off themselves.  Returns
    (eigenvalues (k,), eigenvectors (V, k), residual norms (k,));
    eigenvectors are M-orthonormal.  The first pair is the Laplacian
    nullspace (lam ~ 0, constant vector).

    tol is on ||L v - lam M v|| / lam_max, checked host-side between
    jitted steps.
    """
    lap, mass = graph_laplacian(graph, weighting)
    if h is None:
        if isinstance(alpha, str) and alpha == "spectral":
            alpha = spectral_alpha(graph, weighting,
                                   lap_mass=(lap, mass))
        h = poisson_hierarchy(graph, alpha=alpha, cfg=cfg,
                              lap_mass=(lap, mass))
    # Accept either the full Hierarchy or a bare SolverHierarchy (e.g.
    # a compacted device-built solver with fast operators attached).
    solver = h.solver if hasattr(h, "solver") else h
    n = lap.num_vertices
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, k), lap.diag.dtype)
    # Seed with the known nullspace direction: column 0 <- constants.
    x = x.at[:, 0].set(1.0)
    x = _b_orthonormalize(mass, x)
    p = jnp.zeros_like(x)
    theta = jnp.zeros((k,), lap.diag.dtype)
    resnorm = jnp.full((k,), jnp.inf, lap.diag.dtype)
    step = functools.partial(_lobpcg_step, solver, lap, mass)
    for it in range(iters):
        x, p, theta, resnorm = step(x, p, cfg, k, it > 0)
        if bool(jnp.max(resnorm) < tol):
            break
    # The in-step residual lags one iteration behind (it is measured on
    # the entry block); recompute for the returned pairs.
    from gravomg_tpu.solve.spmv import spmv
    r = spmv(lap, x) - (mass[:, None] * x) * theta[None, :]
    resnorm = jnp.linalg.norm(r, axis=0) / jnp.maximum(
        jnp.max(jnp.abs(theta)), 1e-12)
    return theta, x, resnorm
