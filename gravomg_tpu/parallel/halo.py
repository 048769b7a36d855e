"""Halo-decomposed vertex sharding: O(edge-cut) communication per SpMV.

The plain sharded path (parallel/sharding.py) lets XLA all-gather the
full source vector before every row gather: per-device communication
and x-footprint are O(V).  That demonstrates correctness, not scaling.
This module is the graph analogue of halo
exchange in context parallelism (SURVEY.md §5): each device owns a
contiguous block of Morton-ordered rows, and the only remote values it
touches are the x-entries referenced by its rows' off-shard columns --
the EDGE CUT of the block partition, which spatial ordering makes
O(V^(2/3))-ish per device instead of O(V).

Design (all structure precomputed host-side, so the exchange is a
single static collective):

  * Rows are block-partitioned over the mesh axis: device ``d`` owns
    rows ``[d*vd, (d+1)*vd)``; the source vector is likewise
    block-partitioned into shards of ``vs``.
  * At shard time we read the (concrete) column tables and compute,
    per ordered device pair (o -> d), the sorted unique o-local source
    indices device d needs.  These become a static
    ``send_idx[o, d, :]`` table, padded to the max segment S.
  * The matvec runs under ``shard_map``: each device gathers its send
    rows (``x[send_idx[d]]``, an (nd, S) buffer), one
    ``lax.all_to_all`` swaps segments, and the received halo is
    concatenated after the local shard.  Column tables were remapped
    host-side into this local coordinate system, so no runtime index
    arithmetic remains.
  * Per-device bytes moved: 2 * nd * S * 4 per matvec (send+receive),
    versus V * 4 for the all-gather path.  ``HaloOperator.halo_frac``
    reports the measured ratio; tests assert it stays well below 1.

The reference is a sequential CPU library with no distributed code
(SURVEY.md §2.3); this is the scaling design for meshes beyond one
device's memory: shard_map + all_to_all, which XLA hands to the
backend's collectives (NCCL on GPUs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.solve.coarse import coarse_solve
from gravomg_tpu.solve.smoothers import ChebyshevParams, chebyshev, \
    weighted_jacobi
from gravomg_tpu.solve.vcycle import SolverHierarchy
from gravomg_tpu.types import INVALID_INDEX


class HaloOperator(NamedTuple):
    """Row-sharded ELL operator with a static halo-exchange plan.

    Arrays (global shapes; sharded over the mesh axis at attach time):
      cols:     (R, K) int32 LOCAL column ids: ``[0, vs)`` addresses the
                device's own source shard, ``vs + o*S + p`` addresses
                halo slot p received from device o.  Invalid entries
                point at 0 with weight 0.
      vals:     (R, K) float entry values (0 in padding).
      diag:     (R,) diagonal, or None for rectangular operators.
      send_idx: (nd, nd, S) int32; ``send_idx[d, o]`` = the d-local
                source indices device d ships to device o (0-padded;
                padding slots transfer real-but-unused values).
    Static aux: n_rows, n_src (source length), s (max segment), nd.
    """

    cols: jax.Array
    vals: jax.Array
    diag: Optional[jax.Array]
    send_idx: jax.Array
    n_rows: int
    n_src: int
    s: int
    nd: int

    @property
    def halo_frac(self) -> float:
        """Per-matvec exchanged elements / the all-gather alternative."""
        return (self.nd * self.s) / self.n_src


jax.tree_util.register_pytree_node(
    HaloOperator,
    lambda op: (tuple(op[:4]), (op.n_rows, op.n_src, op.s, op.nd)),
    lambda aux, ch: HaloOperator(*ch, *aux),
)


def build_halo_ell(cols: np.ndarray, vals: np.ndarray,
                   valid: np.ndarray, n_src: int, nd: int,
                   diag: Optional[np.ndarray] = None,
                   s_round: int = 8) -> HaloOperator:
    """Precompute the halo-exchange plan for an ELL table (host-side).

    ``cols``/``vals``/``valid``: (R, K) global column table; ``n_src``
    the source-vector length.  R and n_src must divide ``nd`` (pad
    first -- :func:`gravomg_tpu.parallel.sharding.pad_solver_levels`).
    """
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # Zero-weight entries (pad slots of U rows, decoupled pad rows)
    # contribute nothing -- keep them out of the exchange plan.
    valid = np.asarray(valid) & (vals != 0)
    r, k = cols.shape
    if r % nd or n_src % nd:
        raise ValueError(f"rows {r} / n_src {n_src} not divisible by {nd}")
    vd, vs = r // nd, n_src // nd
    owner = np.where(valid, cols // vs, -1)

    # Per ordered pair (owner o -> requester d): sorted unique o-local
    # source indices d's rows reference.
    need = [[np.zeros(0, np.int64)] * nd for _ in range(nd)]
    smax = 0
    for d in range(nd):
        sl = slice(d * vd, (d + 1) * vd)
        c, ow = cols[sl].ravel(), owner[sl].ravel()
        for o in range(nd):
            if o == d:
                continue
            uniq = np.unique(c[ow == o]) - o * vs
            need[o][d] = uniq
            smax = max(smax, len(uniq))
    s = max(-(-max(smax, 1) // s_round) * s_round, s_round)

    send_idx = np.zeros((nd, nd, s), np.int32)
    for o in range(nd):
        for d in range(nd):
            lst = need[o][d]
            send_idx[o, d, :len(lst)] = lst

    # Remap global columns into each row-shard's local coordinates.
    local = np.zeros_like(cols, dtype=np.int32)
    for d in range(nd):
        sl = slice(d * vd, (d + 1) * vd)
        blk, ob = cols[sl], owner[sl]
        loc = blk - d * vs
        for o in range(nd):
            if o == d:
                continue
            m = ob == o
            if not m.any():
                continue
            pos = np.searchsorted(need[o][d], blk[m] - o * vs)
            loc[m] = vs + o * s + pos
        local[sl] = np.where(ob == -1, 0, loc)

    return HaloOperator(
        cols=jnp.asarray(local),
        vals=jnp.asarray(np.where(valid, vals, 0.0)),
        diag=None if diag is None else jnp.asarray(diag),
        send_idx=jnp.asarray(send_idx),
        n_rows=r, n_src=int(n_src), s=int(s), nd=nd)


def shard_halo_operator(op: HaloOperator, mesh: Mesh,
                        axis: str) -> HaloOperator:
    """Lay the operator's arrays out over the mesh (rows over ``axis``,
    send table over its leading device dim)."""
    row2 = NamedSharding(mesh, P(axis, None))
    return op._replace(
        cols=jax.device_put(op.cols, row2),
        vals=jax.device_put(op.vals, row2),
        diag=(None if op.diag is None
              else jax.device_put(op.diag, NamedSharding(mesh, P(axis)))),
        send_idx=jax.device_put(op.send_idx,
                                NamedSharding(mesh, P(axis, None, None))))


def _mv_body(axis: str, cols, vals, diag, send_idx, x):
    """Per-device matvec body (inside shard_map).

    cols/vals: (vd, K); diag: (vd,) or (0,); send_idx: (1, nd, S);
    x: (vs,) or (vs, D).  Exchanges only the static halo segments.
    """
    send = send_idx[0]                          # (nd, S)
    buf = x[send]                               # (nd, S[, D])
    recv = jax.lax.all_to_all(buf, axis, 0, 0, tiled=True)
    if x.ndim == 1:
        xx = jnp.concatenate([x, recv.reshape(-1)])
        y = jnp.sum(vals * xx[cols], axis=1)
        return y + diag * x if diag.shape[0] else y
    xx = jnp.concatenate([x, recv.reshape(-1, x.shape[1])])
    y = jnp.einsum("vk,vkd->vd", vals, xx[cols],
                   precision=jax.lax.Precision.HIGHEST)
    return y + diag[:, None] * x if diag.shape[0] else y


@functools.lru_cache(maxsize=64)
def _mv_fn(mesh: Mesh, axis: str, ndim: int):
    xs = P(axis) if ndim == 1 else P(axis, None)
    spec = (P(axis, None), P(axis, None), P(axis), P(axis, None, None),
            xs)
    return shard_map(functools.partial(_mv_body, axis), mesh=mesh,
                     in_specs=spec, out_specs=xs)


def halo_matvec(op: HaloOperator, x: jax.Array, mesh: Mesh,
                axis: str) -> jax.Array:
    """y = A x with halo exchange; x is the sharded (n_src,) source or
    an (n_src, D) multi-RHS block."""
    diag = op.diag if op.diag is not None else jnp.zeros((0,), x.dtype)
    return _mv_fn(mesh, axis, x.ndim)(op.cols, op.vals, diag,
                                      op.send_idx, x)


# ---------------------------------------------------------------------------
# Halo-sharded solver hierarchy
# ---------------------------------------------------------------------------


class HaloLevel(NamedTuple):
    op: HaloOperator                    # square, with diag
    u: Optional[HaloOperator]           # prolongation rows (fine x coarse)
    ut: Optional[HaloOperator]          # restriction rows (coarse x fine)
    cheb: Optional[ChebyshevParams]


class HaloSolver(NamedTuple):
    levels: Tuple[HaloLevel, ...]
    coarse_chol: jax.Array              # replicated dense factor


def halo_shard_solver(h: SolverHierarchy, mesh: Mesh,
                      axis: str = "data") -> HaloSolver:
    """Convert a padded SolverHierarchy (EVERY level's vertex count
    divisible by the mesh size -- use ``pad_solver_levels(h, nd,
    pad_coarse=True)``) into halo form and lay it out over the mesh.

    The coarsest level's dense Cholesky factor stays replicated; its
    padded identity rows extend the factor with an identity block.
    """
    nd = int(mesh.devices.size)
    levels = []
    for li, lvl in enumerate(h.levels):
        op = lvl.op
        nbr = np.asarray(op.neighbors)
        hop = build_halo_ell(nbr, np.asarray(op.offdiag),
                             nbr != int(INVALID_INDEX),
                             op.num_vertices, nd,
                             diag=np.asarray(op.diag))
        hu = hut = None
        if lvl.u is not None:
            u = lvl.u
            cols = np.asarray(u.cols)
            hu = build_halo_ell(cols, np.asarray(u.weights),
                                np.ones_like(cols, bool), u.n_coarse, nd)
        if lvl.ut is not None:
            rt = lvl.ut
            rows = np.asarray(rt.rows)
            hut = build_halo_ell(rows, np.asarray(rt.weights),
                                 rows != int(INVALID_INDEX),
                                 rt.n_fine, nd)
        levels.append(HaloLevel(
            op=shard_halo_operator(hop, mesh, axis),
            u=None if hu is None else shard_halo_operator(hu, mesh, axis),
            ut=(None if hut is None
                else shard_halo_operator(hut, mesh, axis)),
            cheb=lvl.cheb))
    rep = NamedSharding(mesh, P())
    return HaloSolver(levels=tuple(levels),
                      coarse_chol=jax.device_put(h.coarse_chol, rep))


class _MvStub(NamedTuple):
    """Duck-typed stand-in handing the smoothers a diagonal while the
    matvec comes through their ``mv`` hook."""
    diag: jax.Array


def _halo_smooth(lvl: HaloLevel, x, b, iters: int, cfg: MultigridConfig,
                 mesh: Mesh, axis: str, x0_zero: bool = False):
    mv = functools.partial(halo_matvec, lvl.op, mesh=mesh, axis=axis)
    stub = _MvStub(lvl.op.diag)
    if cfg.smoother == "chebyshev":
        return chebyshev(stub, x, b, lvl.cheb, cfg.chebyshev_degree, mv=mv,
                         x0_zero=x0_zero)
    return weighted_jacobi(stub, x, b, iters, cfg.jacobi_omega, mv=mv,
                           x0_zero=x0_zero)


def _halo_descend(hs: HaloSolver, li: int, x, b, cfg: MultigridConfig,
                  mesh: Mesh, axis: str, x0_zero: bool = False):
    lvl = hs.levels[li]
    if li == len(hs.levels) - 1:
        return coarse_solve(hs.coarse_chol, b)
    x = _halo_smooth(lvl, x, b, cfg.pre_smooth, cfg, mesh, axis,
                     x0_zero=x0_zero)
    r = b - halo_matvec(lvl.op, x, mesh, axis)
    rc = halo_matvec(lvl.ut, r, mesh, axis)
    # Coarse corrections start from zero: skip their pre-smooth's first
    # matvec AND its halo exchange (A 0 = 0 bit-exactly).
    ec = _halo_descend(hs, li + 1, jnp.zeros_like(rc), rc, cfg, mesh, axis,
                       x0_zero=True)
    if li + 1 < len(hs.levels) - 1:
        for _ in range(cfg.cycle_gamma - 1):
            ec = _halo_descend(hs, li + 1, ec, rc, cfg, mesh, axis)
    x = x + halo_matvec(lvl.u, ec, mesh, axis)
    return _halo_smooth(lvl, x, b, cfg.post_smooth, cfg, mesh, axis)


def halo_v_cycle(hs: HaloSolver, x, b, cfg: MultigridConfig, mesh: Mesh,
                 axis: str = "data", x0_zero: bool = False):
    """One multigrid cycle with every operator application running a
    halo exchange instead of a full all-gather."""
    return _halo_descend(hs, 0, x, b, cfg, mesh, axis, x0_zero=x0_zero)


def halo_solve(hs: HaloSolver, b: jax.Array, cfg: MultigridConfig,
               mesh: Mesh, axis: str = "data", n_real: Optional[int] = None,
               method: str = "mg_pcg"):
    """Converged MG-preconditioned CG with halo-sharded levels.

    ``b`` is the unpadded RHS; returns (x[:n], rel, iters).
    """
    n = b.shape[0] if n_real is None else n_real
    vp = hs.levels[0].op.n_rows
    bp = jnp.zeros((vp,), b.dtype).at[:b.shape[0]].set(b)
    bp = jax.device_put(bp, NamedSharding(mesh, P(axis)))

    x, rel, it = _halo_runner(mesh, axis, cfg, method)(hs, bp)
    return x[:n], rel, it


@functools.lru_cache(maxsize=16)
def _halo_runner(mesh: Mesh, axis: str, cfg: MultigridConfig, method: str):
    """The jitted halo solve, one per (mesh, axis, cfg, method), so
    repeated solves reuse its compilation."""
    from gravomg_tpu.solve.cg import fcg, pcg

    # hs rides in as a jit ARGUMENT (closure-captured arrays would be
    # baked as HLO constants and re-materialized per call).
    @jax.jit
    def run(hs, bp):
        op0 = hs.levels[0].op
        mv = functools.partial(halo_matvec, op0, mesh=mesh, axis=axis)

        def precond(r):
            return halo_v_cycle(hs, jnp.zeros_like(r), r, cfg, mesh,
                                axis, x0_zero=True)

        fn = {"mg_pcg": pcg, "mg_fcg": fcg}[method]
        return fn(op0, bp, precond, tol=cfg.tolerance,
                  max_iters=cfg.max_cycles, mv=mv)

    return run
