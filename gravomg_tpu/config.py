"""Configuration for hierarchy construction and solving.

The reference's knobs are compile-time constants and plain function
arguments (`test/main.cpp:22-24`: NUM_POINTS / REDUCTION_RATIO / K;
`radius`, `weighting_scheme`, `scaleRatio` elsewhere) -- SURVEY.md §5
calls for a small frozen config, not a flag framework.
"""

from __future__ import annotations

import dataclasses

from gravomg_tpu.prolong.operator import BARYCENTRIC


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    # --- hierarchy construction ---
    reduction_ratio: float = 2.0      # demo REDUCTION_RATIO (`test/main.cpp:23`)
    weighting: int = BARYCENTRIC      # Weighting enum (`multigrid.h:12-16`)
    max_levels: int = 8
    coarse_threshold: int = 512       # stop coarsening; dense-solve below this
    degree_multiple: int = 8          # round max degrees up to this multiple;
                                      # raise (e.g. 16/32) so same-family
                                      # meshes share shape buckets for
                                      # batched/vmapped solves
    # --- smoothing ---
    smoother: str = "jacobi"          # "jacobi" | "chebyshev"
    pre_smooth: int = 2
    post_smooth: int = 2
    jacobi_omega: float = 2.0 / 3.0
    chebyshev_degree: int = 4
    # Swept at 50k (scripts/sweep_contraction.py,
    # SWEEP_contraction_50k.json): ratio 16 contracts at rho=0.135/cycle
    # vs 0.251 at the old ratio 4 (identical per-cycle work) and drops
    # MG-PCG from 10 to 8 iterations.  The reduction-ratio
    # hypothesis was refuted by the same sweep (rho 0.28 at 1.2x vs
    # 0.25 at 2x reduction).
    chebyshev_ratio: float = 16.0
    # --- cycling ---
    # gamma=1 is the V-cycle, gamma=2 the W-cycle (each level visits the
    # next-coarser level gamma times).  The cycle unrolls at trace time:
    # coarse-level work grows ~gamma^level, cheap while levels shrink
    # geometrically (the BASELINE configs are all V-cycles).
    cycle_gamma: int = 1
    # --- outer iteration ---
    tolerance: float = 1e-8           # relative residual target (BASELINE)
    max_cycles: int = 200
    # At or above this many fine rows the default solve
    # (solve.cg.mg_solve) preconditions flexible CG with a bf16-cast
    # V-cycle (bf16 halves the window-matrix bytes; FCG's Polak-Ribiere
    # beta is what keeps the rounded preconditioner convergent).  On an
    # NVIDIA H100 80GB HBM3 at a 700 W power limit, at 1M rows, bf16-FCG
    # took 0.1006 s (12 iterations) against 0.0858 s (9 iterations) for
    # f32 MG-PCG (chip_smoke.py), so no measured size favours it: the
    # default threshold is above any int32-indexed level, i.e. off.
    # Pass a smaller value to opt in.
    bf16_threshold: int = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BuildCaps:
    """Static-cap defaults for the device-resident builder -- the ONE
    place they live (a rap_cap 128->64 halving once landed in
    hierarchy_static.py alone, unvalidated at 1M, and broke the default
    north-star build).  `build_hierarchy_device` resolves its cap
    keyword defaults from `DEFAULT_CAPS`; tests/test_caps.py pins
    adequacy of this exact object against the measured structural
    requirements of a >=500k hierarchy, so editing a value here without
    re-validating fails CI rather than the end-of-round bench.
    """
    # Values sized from the measured 1M structural profile
    # (scripts/diag_build1m.py, scripts/diag_build1m_out.json: true
    # Galerkin off-degree <= 46 across all transitions, worst
    # large-level 40; y_req 18-27 handled by rap_y_width_for_level's
    # tiering) with the greedy-hierarchy audit (scripts/check_caps.py)
    # tracking the same profile.  An earlier default-build failure at
    # 1M was the y-width tier boundary, not rap_cap.
    kc_cap: int = 48            # coarse adjacency degree cap
    assoc_factor: int = 2       # per-vertex triangle association pad
    tri_factor: int = 2         # triangle count cap (x coarse cap)
    rap_cap: int = 64           # Galerkin off-diagonal degree (large lvls)
    rap_y_width: int = 24       # lane-merged distinct-coarse-cols pad
    children_headroom: int = 12 # U^T children cap (x padded mean)
    min_reduction: float = 4.0  # plan_levels per-level cap divisor

    def escalated(self, step: int = 1) -> "BuildCaps":
        """Widened caps for overflow retries (each step roughly doubles
        every data-dependent cap)."""
        return dataclasses.replace(
            self,
            kc_cap=self.kc_cap + 16 * step,
            assoc_factor=self.assoc_factor * 2 ** step,
            tri_factor=self.tri_factor * 2 ** step,
            rap_cap=self.rap_cap * 2 ** step,
            rap_y_width=self.rap_y_width * 2 ** step,
            children_headroom=self.children_headroom * 2 ** step)


DEFAULT_CAPS = BuildCaps()
