"""Device-memory bandwidth probe: slope-timed streaming ops.

Measures the bandwidth the card reaches on plain streaming reads
(read-only reduce, row reduce, dense matvec, bf16 read), so SpMV numbers
are judged against a *measured* roofline instead of a data-sheet one.
Each op runs inside one jitted fori_loop at two trip counts; the slope
cancels launch and readout constants.

Usage: python scripts/membw_probe.py [mb]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def _slope_ms(fn, arr, n1=3, n2=23, reps=3):
    """ms per call of ``fn(arr, s)``; every call reads ``arr`` through
    a dependence on the loop carry, so nothing is hoisted out of the
    loop, and ``arr`` is an argument, so nothing is constant-folded."""
    @jax.jit
    def run(arr, seed, iters):
        return jax.lax.fori_loop(0, iters,
                                 lambda _, s: s + fn(arr, s) * 1e-30, seed)

    seed = jnp.float32(0.0)

    def timed(iters):
        run(arr, seed, iters).block_until_ready()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run(arr, seed, iters).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(n2) - timed(n1)) / (n2 - n1) * 1000.0


def probe(mb: int = 1024) -> dict:
    """GB/s read by each streaming pattern over an ``mb``-MiB f32 array."""
    rows = mb * (1 << 20) // (4 * 1408)
    a = jnp.asarray(np.random.default_rng(0).normal(size=(rows, 1408)),
                    jnp.float32)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(1408,)),
                    jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    pats = {
        "sum": (lambda a, s: jnp.sum(a + s), a),
        "rowsum": (lambda a, s: jnp.sum(jnp.sum(a + s, axis=1)), a),
        "matvec": (lambda a, s: jnp.sum(jnp.matmul(a, x + s,
                                                   precision=hi)), a),
        "sum_bf16": (lambda a, s: jnp.sum(a.astype(jnp.float32) + s),
                     a.astype(jnp.bfloat16)),
    }
    out = {}
    for name, (fn, arr) in pats.items():
        ms = _slope_ms(fn, arr)
        out[name] = {"ms": ms, "gb_s": arr.nbytes / ms / 1e6}
    return out


if __name__ == "__main__":
    from gravomg_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    for name, r in probe(mb).items():
        print(f"{name} {mb}MB: {r['ms']:.3f}ms -> {r['gb_s']:.0f} GB/s read",
              flush=True)
