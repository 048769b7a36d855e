"""Mesh / point-cloud normalization.

Equivalent of reference C1 ``GravoMG::scaleMesh``
(`src/utility.cpp:8-48`, decl `include/gravomg/utility.h:20`).
"""

from __future__ import annotations

import jax.numpy as jnp
import jax


def scale_mesh(points: jax.Array, scale_ratio: float = 1.0) -> jax.Array:
    """Normalize a point cloud to a centered bounding box.

    Semantics mirror the reference (`src/utility.cpp:28-40`): translate the
    per-axis minimum to the origin, scale so the longest axis-aligned
    bounding-box edge equals ``scale_ratio``, then translate so the
    bounding-box center sits at the origin.  The reference also accepts a
    face matrix ``F`` that it never reads (`src/utility.cpp:8`); we drop
    that parameter.  Returns a new array (pure function) instead of
    mutating in place.
    """
    mins = jnp.min(points, axis=0)
    maxs = jnp.max(points, axis=0)
    extent = jnp.max(maxs - mins)
    scaled = (points - mins) * (scale_ratio / extent)
    # After the first translation the per-axis minimum is 0, so the bbox
    # center is half the per-axis maximum (same as `src/utility.cpp:34-40`).
    return scaled - 0.5 * jnp.max(scaled, axis=0)
