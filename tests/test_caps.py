"""Cap-adequacy regression tests for the device builder's static plan.

The regression this guards: cap defaults were edited in
hierarchy_static.py without re-validating at scale, and the shipped
default config could no longer build the 1M north-star hierarchy
(small-scale tests and the dryrun stayed green -- nothing exercised cap
adequacy at scale).  These tests close that hole: a CPU-only structural
audit (scripts/check_caps.py; exact-greedy csrc hierarchy + SciPy
Galerkin products, no accelerator and no large XLA compile) measures the TRUE
per-level requirements at >= 500k vertices and asserts that
``DEFAULT_CAPS`` + ``plan_levels`` + the per-level adaptive rules cover
them with margin.  Editing a cap default without re-validating now
fails here, not in the end-of-round bench.

Ground truth anchoring: the audit's greedy-hierarchy profile was
validated against the device (random-priority MIS) hierarchy at 1M
(scripts/diag_build1m.py, scripts/diag_build1m_out.json): y_req 17-27 vs 18-27,
rap off-degree 34-46 vs 36-46 -- the two track within ~2 counts, which
the margins here absorb.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gravomg_tpu.config import DEFAULT_CAPS, BuildCaps, MultigridConfig
from gravomg_tpu.hierarchy_static import (plan_levels, rap_cap_for_level,
                                          rap_y_width_for_level)


@pytest.fixture(scope="module")
def audit_500k():
    import gravomg_tpu.io.native as native
    if not native.available():
        pytest.skip("csrc native library unavailable")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from check_caps import audit
    return audit(500_000)


def test_default_caps_cover_500k(audit_500k):
    """Every static cap in DEFAULT_CAPS covers the measured structural
    requirement at 500k, with the margins that absorb the greedy-vs-MIS
    hierarchy difference (~2 counts on y_req / rap degree)."""
    caps = DEFAULT_CAPS
    assert audit_500k["levels"], "audit produced no levels"
    for lv in audit_500k["levels"]:
        lvl = lv["level"]
        # plan_levels row cap >= real coarse count (with the ~2x slack
        # the plan is designed to hold).
        assert lv["nc"] <= lv["cap"], f"level {lvl}: coarse cap"
        # kc_cap covers the coarse adjacency degree.
        assert lv["kc_deg"] <= caps.kc_cap, f"level {lvl}: kc_cap"
        # Galerkin degree cap (per-level adaptive rule).
        r_cap = rap_cap_for_level(lv["cap"], caps.rap_cap)
        assert lv["rap_offdeg"] + 4 <= r_cap, \
            f"level {lvl}: rap degree {lv['rap_offdeg']} vs cap {r_cap}"
        # Lane-merge y width (per-level adaptive rule).  vf rows with
        # the operator degree observed at that level.
        y_w = rap_y_width_for_level(lv["vf"], lv["op_deg"]
                                    if "op_deg" in lv else 64)
        assert lv["y_req"] + 3 <= y_w, \
            f"level {lvl}: y_req {lv['y_req']} vs y_w {y_w}"
        # U^T children cap: headroom * padded mean (the builder's
        # formula uses the padded coarse count, which only widens it;
        # use the real count here -- strictly tighter).
        ccap = max(8, caps.children_headroom * 3 * lv["vf"] // lv["nc"])
        assert lv["children_max"] <= ccap, f"level {lvl}: children cap"


def test_rap_y_width_tiering_pins_r04_regression():
    """The exact 1M default-build failure shape: a 70976-row mid level needed
    y_req=25; the old one-threshold rule gave it 24."""
    assert rap_y_width_for_level(70976, 40) >= 25 + 3
    # The finest level keeps the narrow default (sort volume there is
    # the dominant build cost).
    assert rap_y_width_for_level(1_000_000, 30) == \
        DEFAULT_CAPS.rap_y_width
    # Small levels keep the near-exhaustive bound.
    assert rap_y_width_for_level(4736, 46) == 48


def test_escalated_caps_strictly_widen():
    e1 = DEFAULT_CAPS.escalated(1)
    e2 = DEFAULT_CAPS.escalated(2)
    for f in ("kc_cap", "assoc_factor", "tri_factor", "rap_cap",
              "rap_y_width", "children_headroom"):
        assert getattr(e1, f) > getattr(DEFAULT_CAPS, f)
        assert getattr(e2, f) > getattr(e1, f)


def test_builders_share_cap_source():
    """build_hierarchy_device resolves defaults from DEFAULT_CAPS: a
    custom BuildCaps must reach the plan (cap defaults once drifted
    because hierarchy_static.py carried its own literals)."""
    import inspect
    from gravomg_tpu.hierarchy_static import build_hierarchy_device
    sig = inspect.signature(build_hierarchy_device)
    # The cap keywords must default to None (resolved from BuildCaps),
    # not to literals that can drift from config.py.
    for name in ("kc_cap", "assoc_factor", "tri_factor", "rap_cap",
                 "rap_y_width"):
        assert sig.parameters[name].default is None, name
    assert sig.parameters["caps"].default is None
    cfg = MultigridConfig()
    # plan_levels' default divisor comes from the same object.
    assert plan_levels(100_000, cfg) == plan_levels(
        100_000, cfg, min_reduction=DEFAULT_CAPS.min_reduction)
