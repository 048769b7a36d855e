"""Every f32 matrix product where exactness is claimed is pinned to
``Precision.HIGHEST``: on a GPU, XLA may otherwise run f32 dots in TF32,
which keeps ~3 decimal digits.  The check reads the traced program, so
it holds on the CPU, where TF32 cannot show in the numbers."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gravomg_tpu import MultigridConfig
from gravomg_tpu.io.serialization import load_solver
from gravomg_tpu.types import EllOperator, Restriction

_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "entry_hierarchy.npz")


def _dots(closed):
    """(operand dtype, precision) of every dot_general, sub-jaxprs
    (loops, jits, conds) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((eqn.invars[0].aval.dtype,
                              eqn.params.get("precision")))
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (list, tuple))
                            else (val,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr,
                                                           "eqns"):
                        walk(sub.jaxpr)

    walk(closed.jaxpr)
    return found


def _highest(prec) -> bool:
    hi = jax.lax.Precision.HIGHEST
    if isinstance(prec, (tuple, list)):
        return len(prec) > 0 and all(p == hi for p in prec)
    return prec == hi


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _ell(v=64, k=6, seed=0):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, v, size=(v, k)).astype(np.int32)
    off = -rng.random((v, k)).astype(np.float32)
    diag = (np.abs(off).sum(1) + 1.0).astype(np.float32)
    return EllOperator(jnp.asarray(nbr), jnp.asarray(off), jnp.asarray(diag))


def _trace_knn():
    from gravomg_tpu.geometry.knn import knn_indices
    pts = jnp.asarray(np.random.default_rng(0).normal(size=(300, 3)),
                      jnp.float32)
    return jax.make_jaxpr(lambda p: knn_indices(p, 8, block=128,
                                                tile=256))(pts), False


def _trace_pcg():
    from gravomg_tpu.solve.cg import pcg
    op = _ell()
    b = jnp.ones((64,), jnp.float32)
    return jax.make_jaxpr(
        lambda op, b: pcg(op, b, lambda r: r / op.diag))(op, b), True


def _trace_spmv_multi():
    from gravomg_tpu.solve.spmv import spmv
    op = _ell()
    x = jnp.ones((64, 4), jnp.float32)
    return jax.make_jaxpr(spmv)(op, x), True


def _trace_restrict_gather():
    from gravomg_tpu.prolong.operator import restrict_gather
    rng = np.random.default_rng(1)
    rt = Restriction(rows=jnp.asarray(rng.integers(0, 64, size=(16, 8)),
                                      jnp.int32),
                     weights=jnp.asarray(rng.random((16, 8)), jnp.float32),
                     n_fine=64)
    x = jnp.ones((64, 4), jnp.float32)
    return jax.make_jaxpr(restrict_gather)(rt, x), True


def _trace_lobpcg_gram():
    from gravomg_tpu.apps.spectral import _lobpcg_block
    hs = _f32(load_solver(_FIXTURE))
    lap = hs.levels[0].op
    v = lap.num_vertices
    mass = jnp.ones((v,), jnp.float32)
    x = jnp.asarray(np.random.default_rng(2).normal(size=(v, 3)),
                    jnp.float32)
    step = functools.partial(_lobpcg_block, cfg=MultigridConfig(),
                             use_p=True)
    return jax.make_jaxpr(step)(hs, lap, mass, x, jnp.zeros_like(x)), True


@pytest.mark.parametrize("trace", [_trace_knn, _trace_pcg,
                                   _trace_spmv_multi,
                                   _trace_restrict_gather,
                                   _trace_lobpcg_gram],
                         ids=["knn_graph", "pcg", "spmv_multi_rhs",
                              "restrict_gather", "lobpcg_gram"])
def test_f32_dots_pinned_highest(trace):
    closed, expect_dots = trace()
    dots = _dots(closed)
    f32 = [(dt, p) for dt, p in dots if dt == jnp.float32]
    if expect_dots:
        assert f32, "expected f32 dot_generals in the traced program"
    loose = [p for _, p in f32 if not _highest(p)]
    assert not loose, f"{len(loose)} f32 dot_general(s) not HIGHEST: {loose}"
