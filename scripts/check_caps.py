"""Structural cap-adequacy audit for the device builder's static plan.

CPU-only and fast (~seconds at 500k): builds the exact-greedy hierarchy
with the csrc sequential pipeline (`csrc/gravomg_host.cpp`, reference
semantics per reference `src/sampling.cpp:7-53` +
`src/multigrid.cpp:77-498`), then computes with SciPy the TRUE
structural requirements the device builder's static caps must cover at
each level transition:

  * n_real      -- real coarse count (vs plan_levels cap)
  * kc          -- max coarse adjacency degree (vs kc_cap)
  * children    -- max fine children per coarse vertex incl. U support
                   (vs build_restriction's headroom cap)
  * y_req       -- max distinct coarse columns per fine row of A @ U
                   (vs the lane-merged rap_y_width at that level)
  * rap_offdeg  -- max off-diagonal degree of U^T A U
                   (vs rap_cap_for_level)

The greedy hierarchy differs from the default random-priority MIS one,
but both are maximal independent sets of the same conflict relation, so
their degree profiles track each other closely; the margins asserted by
tests/test_caps.py absorb the residual difference.  The device-built
profile at 1M (scripts/diag_build1m.py) is the ground truth this audit
is validated against.

Usage: python scripts/check_caps.py [N] [--json OUT]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, ".")
# Host-side audit: never touch an accelerator (and avoid its init latency).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def knn_graph_np(pts: np.ndarray, k: int):
    """Symmetric kNN graph in padded ELL, pure NumPy/SciPy (no JAX
    compile: grid_knn_graph_nosync costs ~160 s of CPU XLA compile at
    any size, which would dominate this audit / its test)."""
    from scipy.spatial import cKDTree
    from gravomg_tpu.types import INVALID_INDEX

    n = pts.shape[0]
    tree = cKDTree(pts)
    d, j = tree.query(pts, k=k + 1, workers=-1)
    d, j = d[:, 1:], j[:, 1:]                      # drop self
    rows = np.repeat(np.arange(n), k)
    a = sp.csr_matrix((d.ravel(), (rows, j.ravel())), shape=(n, n))
    a = a.maximum(a.T).tocsr()                     # symmetrize
    deg = np.diff(a.indptr)
    kk = int(deg.max())
    nbr = np.full((n, kk), np.int32(INVALID_INDEX), np.int32)
    dst = np.full((n, kk), np.inf)
    # Vectorized padded fill (CSR indices are ascending per row).
    idx = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
    r = np.repeat(np.arange(n), deg)
    nbr[r, idx] = a.indices.astype(np.int32)
    dst[r, idx] = a.data
    return nbr, dst


def audit(n: int, k: int = 16, coarse_threshold: int = 1000,
          reduction_ratio: float = 2.0,
          max_levels: int = 16) -> dict:
    import gravomg_tpu.io.native as native
    from gravomg_tpu.config import MultigridConfig
    from gravomg_tpu.geometry.meshes import torus_points
    from gravomg_tpu.geometry.order import morton_order
    from gravomg_tpu.hierarchy_static import (plan_levels,
                                              rap_cap_for_level)
    from gravomg_tpu.types import INVALID_INDEX

    cfg = MultigridConfig(coarse_threshold=coarse_threshold,
                          smoother="chebyshev")
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    nbr, dst = knn_graph_np(pts, k)
    inv = np.int32(INVALID_INDEX)

    # Screened-Poisson operator assembled directly in SciPy: the audit
    # is purely structural (sparsity of U^T A U), so any nonzero edge
    # weights give the same degrees -- invdist mirrors the bench's
    # graph_laplacian without paying its ~1-2 min CPU XLA compile.
    m = nbr != inv
    rows = np.repeat(np.arange(n), nbr.shape[1])[m.ravel()]
    cols = nbr.ravel()[m.ravel()]
    w = 1.0 / np.maximum(dst.ravel()[m.ravel()], 1e-8)
    W = sp.csr_matrix((w, (rows, cols)), shape=(n, n))
    A = sp.diags(np.asarray(W.sum(axis=1)).ravel() * 1.0001) - W

    dst = np.where(m, dst, 0.0)
    p64 = np.asarray(pts, np.float64)
    caps = plan_levels(n, cfg)
    report = {"n": n, "k": k, "caps": caps, "levels": []}

    lvl_nbr, lvl_dst, lvl_pts = nbr, dst, p64
    t0 = time.perf_counter()
    for li in range(max_levels):
        v = lvl_nbr.shape[0]
        if v <= coarse_threshold or li >= len(caps):
            break
        kc_cap_call = 192
        lv = native.coarsen_level(lvl_nbr, lvl_dst, lvl_pts,
                                  reduction_ratio=reduction_ratio,
                                  kc_cap=kc_cap_call)
        nc = lv["coarse_points"].shape[0]
        cnbr = lv["coarse_nbr"]
        kc_deg = int((cnbr != inv).sum(axis=1).max())
        # U (v, 3) -> csr; duplicate columns in a row merge.
        ucols = lv["u_cols"]
        uw = lv["u_weights"]
        rows = np.repeat(np.arange(v), 3)
        U = sp.csr_matrix((uw.ravel(), (rows, ucols.ravel())),
                          shape=(v, nc))
        U.sum_duplicates()
        Us = U.copy()
        Us.eliminate_zeros()
        children = np.diff(Us.tocsc().indptr)
        AU = (A @ Us).tocsr()
        AU.eliminate_zeros()
        y_req = int(np.diff(AU.indptr).max()) if AU.nnz else 0
        RAP = (Us.T @ AU).tocsr()
        RAP.eliminate_zeros()
        rap_deg = int(np.diff(RAP.indptr).max()) if RAP.nnz else 0
        cap = caps[li]
        rec = {
            "level": li, "vf": int(v), "nc": int(nc), "cap": int(cap),
            "cap_ok": bool(nc <= cap),
            "op_deg": int(np.diff(A.indptr).max()) - 1,
            "kc_deg": kc_deg,
            "children_max": int(children.max()),
            "children_mean": float(children.mean()),
            "y_req": y_req,
            "rap_offdeg": rap_deg - 1,
            "rap_cap_eff": rap_cap_for_level(cap, 64),
        }
        report["levels"].append(rec)
        print("#", json.dumps(rec), flush=True)

        # Descend: Euclidean distances between coarse points over the
        # coarse adjacency pattern (coarse edge weights are vestigial,
        # SURVEY.md section 2.1-C7).
        cp = lv["coarse_points"]
        valid = cnbr != inv
        safe = np.where(valid, cnbr, 0)
        d = np.linalg.norm(cp[safe] - cp[:, None, :], axis=-1)
        lvl_dst = np.where(valid, d, 0.0)
        lvl_nbr = cnbr
        lvl_pts = cp
        A = (Us.T @ AU).tocsr()
    report["audit_s"] = time.perf_counter() - t0
    return report


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    out = None
    if "--json" in sys.argv:
        out = sys.argv[sys.argv.index("--json") + 1]
    rep = audit(n)
    print(f"# audit wall {rep['audit_s']:.1f}s")
    if out:
        json.dump(rep, open(out, "w"), indent=1)
        print(f"# wrote {out}")
