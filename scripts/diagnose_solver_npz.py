"""Diagnose an exported compacted solver (bench.py save_solver npz).

Loads the npz on CPU (NumPy/SciPy only -- no JAX, no device), checks
hierarchy invariants, and runs exact f64 V-cycles to separate "the
hierarchy is bad" from "the device fast-operator path is bad" when a
bench run reports a diverging residual.

Checks per level:
  - diag positivity, finiteness of offdiag/diag
  - row sums of U (should be ~1 on real rows)
  - Chebyshev window sanity (0 < lo < hi)
  - symmetry of A (pattern + values)
Then: 12 f64 V-cycles on a random RHS, residual printed per cycle.

Usage: python scripts/diagnose_solver_npz.py path/to/solver.npz
"""

import sys

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

INVALID_INDEX = np.int32(2**31 - 1)
CHEB_DEGREE = 4  # MultigridConfig default


def ell_to_csr(nbr, off, diag):
    v_, k_ = nbr.shape
    mask = nbr != int(INVALID_INDEX)
    rows = np.repeat(np.arange(v_), k_)[mask.ravel()]
    cols = nbr.ravel()[mask.ravel()]
    m = sp.csr_matrix((off.ravel()[mask.ravel()], (rows, cols)),
                      shape=(v_, v_))
    return m + sp.diags(np.asarray(diag, np.float64))


def u_to_csr(ucols, uw, n_coarse):
    vf = ucols.shape[0]
    rows = np.repeat(np.arange(vf), ucols.shape[1])
    return sp.csr_matrix((np.asarray(uw, np.float64).ravel(),
                          (rows, ucols.ravel())),
                         shape=(vf, n_coarse))


def main(path):
    z = np.load(path)
    nlev = int(z["n_levels"])
    print(f"levels={nlev}")
    As, Us, cheb = [], [], []
    for i in range(nlev):
        nbr = z[f"l{i}_nbr"]
        off = np.asarray(z[f"l{i}_off"], np.float64)
        diag = np.asarray(z[f"l{i}_diag"], np.float64)
        A = ell_to_csr(nbr, off, diag)
        As.append(A)
        sym = abs(A - A.T).max()
        print(f"L{i}: n={A.shape[0]} nnz={A.nnz} "
              f"diag[min,max]=[{diag.min():.3e},{diag.max():.3e}] "
              f"off_finite={np.isfinite(off).all()} "
              f"asym_max={sym:.3e}")
        if i < nlev - 1:
            U = u_to_csr(z[f"l{i}_ucols"], z[f"l{i}_uw"],
                         int(z[f"l{i}_unc"]))
            Us.append(U)
            rs = np.asarray(U.sum(axis=1)).ravel()
            lo, hi = map(float, z[f"l{i}_cheb"])
            cheb.append((lo, hi))
            print(f"    U: ({U.shape[0]}x{U.shape[1]}) nnz={U.nnz} "
                  f"rowsum[min,max]=[{rs.min():.6f},{rs.max():.6f}] "
                  f"cheb=({lo:.4f},{hi:.4f})")

    Dinv = [1.0 / A.diagonal() for A in As]
    ac = As[-1].toarray()
    ac = 0.5 * (ac + ac.T)
    base = np.abs(np.diag(ac)).max()
    for s in (1e-10, 1e-6, 1e-4):
        try:
            chol = sla.cho_factor(ac + s * base * np.eye(ac.shape[0]))
            print(f"coarse chol ok (shift {s:g})")
            break
        except np.linalg.LinAlgError:
            continue
    else:
        print("coarse NOT factorizable")
        return

    def smooth(lvl, x, b):
        A, dinv = As[lvl], Dinv[lvl]
        lo, hi = cheb[lvl]
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = dinv * (b - A @ x)
        d = r / theta
        x = x + d
        for _ in range(CHEB_DEGREE - 1):
            r = dinv * (b - A @ x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    def vcycle(lvl, x, b):
        if lvl == len(As) - 1:
            return sla.cho_solve(chol, b)
        A, U = As[lvl], Us[lvl]
        x = smooth(lvl, x, b)
        r = b - A @ x
        e = vcycle(lvl + 1, np.zeros(U.shape[1]), U.T @ r)
        x = x + U @ e
        return smooth(lvl, x, b)

    n = As[0].shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    nb = np.linalg.norm(b)
    x = np.zeros(n)
    for c in range(12):
        x = vcycle(0, x, b)
        rel = np.linalg.norm(b - As[0] @ x) / nb
        print(f"cycle {c + 1:2d}: rel={rel:.3e}")


if __name__ == "__main__":
    main(sys.argv[1])
