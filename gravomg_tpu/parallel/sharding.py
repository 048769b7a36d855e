"""Multi-device execution: batched (data-parallel) and vertex-sharded solves.

The reference is single-threaded CPU with no parallel code at all
(SURVEY.md §2.3); the scaling axes for this domain are:

  * **data parallelism over meshes** -- vmapped V-cycles on a batch of
    same-bucket meshes, sharded over the device mesh's 'data' axis
    (BASELINE.json config 5: 64-mesh shape collections);
  * **vertex sharding** (the graph analogue of sequence/context
    parallelism, SURVEY.md §5) -- the ELL rows of A, and all vectors,
    sharded over the 'vertex' axis.  ELL SpMV gathers arbitrary remote
    rows, so the vector is all-gathered before the gather; XLA inserts
    the collective from the sharding annotations, and dot products in
    CG/V-cycle norms become psums automatically.

Both paths are plain jit-with-shardings: no hand-written collectives are
needed at this communication pattern's scale (one all-gather of a (V,)
vector per SpMV).  The mesh is 1-D and topology-free.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.solve.vcycle import SolverHierarchy, v_cycle
from gravomg_tpu.solve.spmv import spmv

_HI = jax.lax.Precision.HIGHEST


def make_mesh(n_devices: Optional[int] = None,
              axis: str = "data") -> Mesh:
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devs), (axis,))


def pad_axis(x: jax.Array, mult: int, axis: int = 0,
             fill=0) -> jax.Array:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def pad_solver_fine_level(h: SolverHierarchy, mult: int) -> SolverHierarchy:
    """Pad the finest level to a vertex count divisible by ``mult`` so it
    can shard evenly.  Padded rows are decoupled identity rows (diag 1,
    no neighbors, zero prolongation weights): they solve to x=0 for b=0
    and perturb nothing."""
    from gravomg_tpu.types import INVALID_INDEX

    lvl = h.levels[0]
    v = lvl.op.num_vertices
    pad = (-v) % mult
    if pad == 0:
        return h
    op = lvl.op
    new_op = op._replace(
        neighbors=pad_axis(op.neighbors, mult, fill=INVALID_INDEX),
        offdiag=pad_axis(op.offdiag, mult, fill=0),
        diag=pad_axis(op.diag, mult, fill=1.0),
    )
    u = lvl.u
    new_u = None
    if u is not None:
        new_u = u._replace(cols=pad_axis(u.cols, mult, fill=0),
                           weights=pad_axis(u.weights, mult, fill=0.0))
    # The gather-form U^T table stays valid: padded fine rows have zero
    # weights, so they were never in the table; only the static fine
    # count needs refreshing.
    new_ut = (lvl.ut._replace(n_fine=v + pad)
              if lvl.ut is not None else None)
    new_lvl = lvl._replace(op=new_op, u=new_u, ut=new_ut)
    return h._replace(levels=(new_lvl,) + h.levels[1:])


def pad_solver_levels(h: SolverHierarchy, mult: int,
                      pad_coarse: bool = False) -> SolverHierarchy:
    """Pad EVERY level but the coarsest to a vertex count divisible by
    ``mult`` so the whole V-cycle shards evenly (finest-level-only
    padding would demonstrate layouts, not scaling).

    Padded rows are decoupled identity rows (diag 1, no neighbors);
    padded prolongation rows carry zero weights; padded restriction
    rows are INVALID (yield exact 0).  Zero is a fixed point of every
    padded row under smoothing/transfer, so the solve is bit-unchanged
    on the real rows.  By default the coarsest level keeps its exact
    size (its dense Cholesky factor is replicated anyway);
    ``pad_coarse=True`` pads it too and extends the Cholesky factor
    with an identity block -- required by the halo-sharded path
    (parallel/halo.py), which block-partitions every level's rows.

    Fast-form (block-dense / slab) operators are dropped: their window
    geometry is single-chip; the sharded path runs the ELL forms whose
    gathers XLA turns into all-gather + local gather.
    """
    from gravomg_tpu.types import INVALID_INDEX

    nlev = len(h.levels)
    new_v = [(-(-lvl.op.num_vertices // mult) * mult
              if (li < nlev - 1 or pad_coarse) else lvl.op.num_vertices)
             for li, lvl in enumerate(h.levels)]
    levels = []
    for li, lvl in enumerate(h.levels):
        v, vp = lvl.op.num_vertices, new_v[li]
        op = lvl.op
        if vp > v:
            op = op._replace(
                neighbors=pad_axis(op.neighbors, mult,
                                   fill=INVALID_INDEX),
                offdiag=pad_axis(op.offdiag, mult, fill=0),
                diag=pad_axis(op.diag, mult, fill=1.0),
            )
        u = lvl.u
        if u is not None:
            cols, w = u.cols, u.weights
            if vp > v:
                cols = pad_axis(cols, mult, fill=0)
                w = pad_axis(w, mult, fill=0.0)
            u = u._replace(cols=cols, weights=w, n_coarse=new_v[li + 1])
        ut = lvl.ut
        if ut is not None:
            rows, w = ut.rows, ut.weights
            if new_v[li + 1] > ut.rows.shape[0]:
                pad = new_v[li + 1] - ut.rows.shape[0]
                rows = jnp.pad(rows, ((0, pad), (0, 0)),
                               constant_values=INVALID_INDEX)
                w = jnp.pad(w, ((0, pad), (0, 0)), constant_values=0.0)
            ut = ut._replace(rows=rows, weights=w, n_fine=vp)
        levels.append(lvl._replace(op=op, u=u, ut=ut,
                                   banded=None, uw=None, utw=None))
    chol = h.coarse_chol
    if pad_coarse and new_v[-1] > h.levels[-1].op.num_vertices:
        # Padded coarse rows are decoupled identity rows, so the factor
        # of the padded operator is block-diag(chol, I).
        vc, vcp = h.levels[-1].op.num_vertices, new_v[-1]
        ext = jnp.zeros((vcp, vcp), chol.dtype)
        ext = ext.at[:vc, :vc].set(chol)
        ext = ext.at[jnp.arange(vc, vcp), jnp.arange(vc, vcp)].set(1.0)
        chol = ext
    return h._replace(levels=tuple(levels), coarse_chol=chol)


def shard_fast_operator(bop, mesh: Mesh, axis: str = "data"):
    """Lay a :class:`~gravomg_tpu.ops.blockdense.BlockDenseOperator` out
    over the mesh: the window matrix M (the dominant traffic, ~95% of a
    fast SpMV's bytes) and the per-block window starts are sharded over
    the row-block axis when the block count divides the mesh; the small
    escape-chute COO is replicated (its segment-sum spans all rows).

    Inside a jitted solve the window gather of x reads arbitrary
    128-row segments, so XLA all-gathers x once per matvec -- the same
    collective the ELL path pays -- while each device streams only its
    M shard.  Build the operator with ``block = n_rows / n_devices``
    (or a divisor) so ``nblk % n_devices == 0``; misaligned operators
    fall back to full replication (correct, not scaled).

    Slab forms (ops/slab.py) are left untouched by the sharded path:
    their bucket row-permutation is a single-chip layout.
    """
    from gravomg_tpu.ops.blockdense import BlockDenseOperator

    if bop is None or not isinstance(bop, BlockDenseOperator):
        return bop
    nd = mesh.devices.size
    rep = NamedSharding(mesh, P())
    ok = (bop.m.shape[0] % nd == 0
          and bop.m.shape[0] * bop.m.shape[1] == bop.n_rows)
    m = jax.device_put(bop.m,
                       NamedSharding(mesh, P(axis, None, None))
                       if ok else rep)
    ws = jax.device_put(bop.win_start,
                        NamedSharding(mesh, P(axis, None))
                        if ok else rep)
    diag = bop.diag
    if diag is not None:
        dok = diag.shape[0] % nd == 0
        diag = jax.device_put(diag, NamedSharding(mesh, P(axis))
                              if dok else rep)
    return bop._replace(
        m=m, win_start=ws, diag=diag,
        esc_rows=jax.device_put(bop.esc_rows, rep),
        esc_cols=jax.device_put(bop.esc_cols, rep),
        esc_w=jax.device_put(bop.esc_w, rep))


def shard_solver(h: SolverHierarchy, mesh: Mesh,
                 axis: str = "data") -> SolverHierarchy:
    """Lay a padded hierarchy out over the mesh: every level's operator
    rows, prolongation rows, and restriction rows sharded over
    ``axis``; the coarsest operator and its Cholesky factor replicated.

    Call :func:`pad_solver_levels` first (every non-coarsest level's
    vertex count must divide the mesh size).  Vectors produced inside a
    jitted solve inherit these layouts through XLA sharding
    propagation; dot products become psums (annotate inputs, let XLA
    place the collectives).

    Block-dense fast forms (``banded``/``uw``/``utw``), when present,
    are sharded too (:func:`shard_fast_operator`) -- attach them AFTER
    :func:`pad_solver_levels` (which drops pre-pad forms) with
    mesh-aligned blocks, e.g.
    ``attach_fast_operators(hp, block=v_padded // n_devices)``.
    """
    nd = mesh.devices.size
    row = NamedSharding(mesh, P(axis))
    row2 = NamedSharding(mesh, P(axis, None))
    rep = NamedSharding(mesh, P())

    def put(x, s):
        return jax.device_put(x, s)

    levels = []
    for li, lvl in enumerate(h.levels):
        last = li == len(h.levels) - 1
        ok = lvl.op.num_vertices % nd == 0 and not last
        op = lvl.op
        op = op._replace(
            neighbors=put(op.neighbors, row2 if ok else rep),
            offdiag=put(op.offdiag, row2 if ok else rep),
            diag=put(op.diag, row if ok else rep))
        u = lvl.u
        if u is not None:
            uok = u.cols.shape[0] % nd == 0
            u = u._replace(cols=put(u.cols, row2 if uok else rep),
                           weights=put(u.weights, row2 if uok else rep))
        ut = lvl.ut
        if ut is not None:
            tok = ut.rows.shape[0] % nd == 0
            ut = ut._replace(rows=put(ut.rows, row2 if tok else rep),
                             weights=put(ut.weights,
                                         row2 if tok else rep))
        cheb = lvl.cheb
        if cheb is not None:
            cheb = jax.tree.map(lambda a: put(a, rep), cheb)
        lvl = lvl._replace(
            banded=shard_fast_operator(lvl.banded, mesh, axis),
            uw=shard_fast_operator(lvl.uw, mesh, axis),
            utw=shard_fast_operator(lvl.utw, mesh, axis))
        levels.append(lvl._replace(op=op, u=u, ut=ut, cheb=cheb))
    return h._replace(levels=tuple(levels),
                      coarse_chol=put(h.coarse_chol, rep))


def sharded_solve(h: SolverHierarchy, b: jax.Array,
                  cfg: MultigridConfig, mesh: Mesh, axis: str = "data",
                  method: str = "mg_pcg"):
    """Full MG-preconditioned CG solve to ``cfg.tolerance`` with every
    level vertex-sharded over the mesh (a converged sharded solve, not a
    single step).

    ``h`` must come from pad_solver_levels + shard_solver; ``b`` is the
    UNPADDED right-hand side.  Returns (x[:n], rel, iters).
    """
    from gravomg_tpu.solve.cg import mg_fcg, mg_pcg

    fn = {"mg_pcg": mg_pcg, "mg_fcg": mg_fcg}[method]
    n = b.shape[0]
    vp = h.levels[0].op.num_vertices
    vspec = NamedSharding(mesh, P(axis))
    bp = jnp.zeros((vp,), b.dtype).at[:n].set(b)
    bp = jax.device_put(bp, vspec)
    with mesh:
        x, rel, it = fn(h, bp, cfg)
    return x[:n], rel, it


def batched_vcycle(h: SolverHierarchy, cfg: MultigridConfig, mesh: Mesh,
                   axis: str = "data"):
    """Return a jitted function solving a sharded batch of RHS with one
    V-cycle each: (B, V) -> (B, V), B sharded over the mesh.

    One hierarchy, many right-hand sides -- the spectral / curvature-flow
    time-stepping pattern (BASELINE.json config 5); for distinct meshes
    per batch entry, stack hierarchies with identical padded shapes and
    vmap over them the same way.
    """
    batch_sharding = NamedSharding(mesh, P(axis, None))

    def step(xs, bs):
        xs = jax.lax.with_sharding_constraint(xs, batch_sharding)
        out = jax.vmap(lambda x, b: v_cycle(h, x, b, cfg))(xs, bs)
        return jax.lax.with_sharding_constraint(out, batch_sharding)

    return jax.jit(step)


def vertex_sharded_cg_step(h: SolverHierarchy, cfg: MultigridConfig,
                           mesh: Mesh, axis: str = "data"):
    """Return a jitted MG-preconditioned-CG step with the fine level's
    vectors sharded over vertices.

    The fine operator's ELL rows and all fine vectors carry a
    PartitionSpec((axis,)) sharding; gathers of x[neighbors] induce an
    all-gather of x, reductions induce psum -- all inserted by XLA from
    the annotations (annotate, compile, let XLA place the collectives).
    """
    vspec = NamedSharding(mesh, P(axis))
    a0 = h.levels[0].op

    def step(x, r, p, rz):
        x = jax.lax.with_sharding_constraint(x, vspec)
        p = jax.lax.with_sharding_constraint(p, vspec)
        ap = spmv(a0, p)
        alpha = rz / jnp.vdot(p, ap, precision=_HI)
        x = x + alpha * p
        r = r - alpha * ap
        z = v_cycle(h, jnp.zeros_like(r), r, cfg, x0_zero=True)
        rz_new = jnp.vdot(r, z, precision=_HI)
        beta = rz_new / rz
        p = z + beta * p
        return (jax.lax.with_sharding_constraint(x, vspec), r, p, rz_new)

    return jax.jit(step)
