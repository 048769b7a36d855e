"""Halo-exchange plan evidence at scale.

The halo path's claim -- per-matvec communication is O(edge-cut), not
O(V) -- only bites at scale: the committed dryrun fixture (2562 rows
over 8 devices, ~320 rows/device) has a cut comparable to the shard
size and reported halo_frac 1.022.  This script builds the REAL
exchange plans (``parallel/halo.py::build_halo_ell``, the exact code
the sharded solver runs) for every level of a >=200k hierarchy,
entirely host-side (csrc exact-greedy hierarchy + SciPy Galerkin
products; no accelerator needed -- the plan is a pure
function of the concrete column tables), and writes the per-level
halo_frac / bytes-per-matvec table the O(V^(2/3)) claim stands on.

Usage: python scripts/halo_evidence.py [N] [ND] [--json OUT]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, ".")
sys.path.insert(0, "scripts")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from check_caps import knn_graph_np  # noqa: E402


def csr_to_ell(a: sp.csr_matrix, inv: np.int32):
    deg = np.diff(a.indptr)
    kk = max(int(deg.max()), 1)
    r = a.shape[0]
    cols = np.full((r, kk), inv, np.int32)
    vals = np.zeros((r, kk))
    idx = np.arange(a.nnz) - np.repeat(a.indptr[:-1], deg)
    rr = np.repeat(np.arange(r), deg)
    cols[rr, idx] = a.indices.astype(np.int32)
    vals[rr, idx] = a.data
    return cols, vals


def pad_rows(cols, vals, nd, inv):
    r = cols.shape[0]
    rp = -(-r // nd) * nd
    if rp != r:
        cols = np.vstack([cols, np.full((rp - r, cols.shape[1]), inv,
                                        cols.dtype)])
        vals = np.vstack([vals, np.zeros((rp - r, vals.shape[1]))])
    return cols, vals


def plan_stats(cols, vals, valid, n_src, nd):
    from gravomg_tpu.parallel.halo import build_halo_ell
    ns = -(-n_src // nd) * nd
    op = build_halo_ell(cols, vals, valid, ns, nd)
    return {
        "rows": int(op.n_rows), "n_src": int(op.n_src),
        "seg_max": int(op.s),
        "halo_frac": round(float(op.halo_frac), 4),
        "exchanged_kb": round(2 * nd * op.s * 4 / 1024, 1),
        "allgather_kb": round(op.n_src * 4 / 1024, 1),
    }


def main(n: int, nd: int) -> dict:
    import gravomg_tpu.io.native as native
    from gravomg_tpu.geometry.meshes import torus_points
    from gravomg_tpu.geometry.order import morton_order
    from gravomg_tpu.types import INVALID_INDEX

    inv = np.int32(INVALID_INDEX)
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    nbr, dst = knn_graph_np(pts, 16)
    m = nbr != inv
    rows = np.repeat(np.arange(n), nbr.shape[1])[m.ravel()]
    cols = nbr.ravel()[m.ravel()]
    w = 1.0 / np.maximum(dst.ravel()[m.ravel()], 1e-8)
    W = sp.csr_matrix((w, (rows, cols)), shape=(n, n))
    A = sp.diags(np.asarray(W.sum(axis=1)).ravel() * 1.0001) - W

    dstz = np.where(m, dst, 0.0)
    lvl_nbr, lvl_dst, lvl_pts = nbr, dstz, np.asarray(pts, np.float64)
    out = {"n": n, "nd": nd, "levels": []}
    t0 = time.perf_counter()
    li = 0
    while A.shape[0] > 1000 and li < 8:
        v = lvl_nbr.shape[0]
        lv = native.coarsen_level(lvl_nbr, lvl_dst, lvl_pts,
                                  reduction_ratio=2.0, kc_cap=192)
        nc = lv["coarse_points"].shape[0]
        ucols = lv["u_cols"]
        uw = lv["u_weights"]
        rr = np.repeat(np.arange(v), 3)
        U = sp.csr_matrix((uw.ravel(), (rr, ucols.ravel())),
                          shape=(v, nc))
        U.sum_duplicates()
        Us = U.copy()
        Us.eliminate_zeros()

        # A level: square operator plan.
        acols, avals = csr_to_ell(A.tocsr(), inv)
        acols, avals = pad_rows(acols, avals, nd, inv)
        rec = {"level": li, "v": int(v), "nc": int(nc)}
        rec["A"] = plan_stats(acols, avals, acols != inv, v, nd)
        # U: (v, 3) rows into the coarse source.
        uc, uv = pad_rows(ucols.astype(np.int32), uw, nd, 0)
        rec["U"] = plan_stats(uc, uv, np.ones_like(uc, bool), nc, nd)
        # U^T: children table (coarse rows into the fine source).
        Uc = Us.tocsc()
        cdeg = np.diff(Uc.indptr)
        mc = max(int(cdeg.max()), 1)
        tcols = np.full((nc, mc), inv, np.int32)
        tvals = np.zeros((nc, mc))
        idx = np.arange(Uc.nnz) - np.repeat(Uc.indptr[:-1], cdeg)
        cc = np.repeat(np.arange(nc), cdeg)
        tcols[cc, idx] = Uc.indices.astype(np.int32)
        tvals[cc, idx] = Uc.data
        tcols, tvals = pad_rows(tcols, tvals, nd, inv)
        rec["Ut"] = plan_stats(tcols, tvals, tcols != inv, v, nd)
        out["levels"].append(rec)
        print("#", json.dumps(rec), flush=True)

        AU = (A @ Us).tocsr()
        A = (Us.T @ AU).tocsr()
        A.eliminate_zeros()
        cp = lv["coarse_points"]
        cnbr = lv["coarse_nbr"]
        valid = cnbr != inv
        safe = np.where(valid, cnbr, 0)
        d = np.linalg.norm(cp[safe] - cp[:, None, :], axis=-1)
        lvl_dst = np.where(valid, d, 0.0)
        lvl_nbr = cnbr
        lvl_pts = cp
        li += 1
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    nd = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    rep = main(n, nd)
    print(f"# wall {rep['wall_s']}s")
    if "--json" in sys.argv:
        out = sys.argv[sys.argv.index("--json") + 1]
        json.dump(rep, open(out, "w"), indent=1)
        print(f"# wrote {out}")
