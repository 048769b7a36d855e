"""Compilation: where the persistent XLA cache lives, and running
compile-bound host work concurrently.

One rule for every entry point: ``JAX_COMPILATION_CACHE_DIR`` when it is
set (JAX reads it itself; no other directory is set over it), otherwise
the fixed, gitignored ``<repo>/.bench_cache/xla``.  A fixed path matters:
the path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, TypeVar

T = TypeVar("T")

_MAX_WORKERS = 8

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache", "xla")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def run_concurrently(jobs: Sequence[Callable[[], T]]) -> List[T]:
    """Run independent thunks in a thread pool; results in job order.

    For host-interactive conversions and ahead-of-time compiles, whose
    time is mostly XLA compilation: XLA compiles with the GIL released,
    so the compiles of independent jobs overlap.  The first exception
    propagates."""
    if len(jobs) <= 1:
        return [job() for job in jobs]
    with ThreadPoolExecutor(max_workers=min(len(jobs), _MAX_WORKERS)) as ex:
        return list(ex.map(lambda job: job(), jobs))
