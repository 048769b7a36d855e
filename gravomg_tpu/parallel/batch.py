"""Batched multi-mesh solves (BASELINE config 5: 64-mesh shape
collections, vmapped V-cycles for spectral / curvature-flow stepping).

Same-bucket hierarchies (identical padded shapes per level -- which the
geometric size buckets of hierarchy.py produce for same-family meshes)
are stacked into one batched pytree and driven by a single vmapped,
jitted V-cycle / solve.  Sharding the leading batch axis over a device
mesh turns this into multi-chip data parallelism (parallel/sharding.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.solve.vcycle import SolverHierarchy, v_cycle
from gravomg_tpu.solve.spmv import spmv
import functools


def stackable(hs: Sequence[SolverHierarchy]) -> bool:
    """True if all hierarchies share shapes (same buckets per level)."""
    ref = jax.tree_util.tree_structure(hs[0])
    shapes = jax.tree_util.tree_map(lambda x: x.shape, hs[0])
    for h in hs[1:]:
        if jax.tree_util.tree_structure(h) != ref:
            return False
        if jax.tree_util.tree_map(lambda x: x.shape, h) != shapes:
            return False
    return True


def stack_solvers(hs: Sequence[SolverHierarchy]) -> SolverHierarchy:
    """Stack same-shape hierarchies along a new leading batch axis."""
    assert stackable(hs), "hierarchies must share level shapes/buckets"
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *hs)


def attach_collection(hs: Sequence[SolverHierarchy],
                      block: int = 256, window: int = 128,
                      dtype=None) -> List[SolverHierarchy]:
    """Attach gather-free block-dense fast forms with IDENTICAL shapes
    across a same-bucket mesh collection, so the results stack.

    ``attach_fast_operators`` on its own picks per-operator window
    counts and escape capacities by data-dependent retry, and trims the
    escape chute to its fill -- three shape degrees of freedom that
    differ across meshes and break :func:`stackable`.  This wrapper
    converts every mesh with trimming off and a shared (nw, cap)
    geometry floor, escalating the floor to the max any mesh needed and
    re-converting until all agree (a fixpoint; one extra pass in
    practice).  Slab forms are deliberately NOT used: their bucket
    partition is data-dependent and cannot be shape-shared.

    Without this, a batched V-cycle over a collection runs the
    gather-based ELL path, which vmap lowers to batched gathers.
    """
    from gravomg_tpu.solve.vcycle import attach_fast_operators

    geo: dict = {}
    for _ in range(8):
        outs, grown = [], False
        for h in hs:
            used: dict = {}
            outs.append(attach_fast_operators(
                h, block=block, window=window, dtype=dtype,
                trim=False, geometry=geo, used_geometry=used))
            for k, v in used.items():
                cur = geo.get(k, (0, 0))
                nv = (max(v[0], cur[0]), max(v[1], cur[1]))
                if nv != cur:
                    geo[k] = nv
                    grown = grown or (cur != (0, 0))
        if not grown:
            return outs
    raise RuntimeError("attach_collection geometry did not converge")


@functools.partial(jax.jit, static_argnames=("cfg",))
def batched_v_cycle(hb: SolverHierarchy, xs: jax.Array, bs: jax.Array,
                    cfg: MultigridConfig) -> jax.Array:
    """One V-cycle per batch entry: hb stacked, xs/bs (B, V)."""
    return jax.vmap(lambda h, x, b: v_cycle(h, x, b, cfg))(hb, xs, bs)


@functools.partial(jax.jit, static_argnames=("cfg",))
def batched_solve(hb: SolverHierarchy, bs: jax.Array,
                  cfg: MultigridConfig):
    """Stationary V-cycle solves across the batch (shared iteration
    count: runs until every entry meets tolerance or max_cycles)."""
    a0 = hb.levels[0].op
    bnorm = jnp.maximum(jnp.linalg.norm(bs, axis=1), 1e-30)

    def rel(xs):
        r = bs - jax.vmap(spmv)(a0, xs)
        return jnp.linalg.norm(r, axis=1) / bnorm

    def cond(state):
        xs, it, rels = state
        return (jnp.max(rels) > cfg.tolerance) & (it < cfg.max_cycles)

    def body(state):
        xs, it, _ = state
        xs = jax.vmap(lambda h, x, b: v_cycle(h, x, b, cfg))(hb, xs, bs)
        return xs, it + 1, rel(xs)

    xs0 = jnp.zeros_like(bs)
    xs, it, rels = jax.lax.while_loop(
        cond, body, (xs0, jnp.int32(0), rel(xs0)))
    return xs, rels, it
