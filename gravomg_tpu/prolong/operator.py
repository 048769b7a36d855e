"""Prolongation-operator assembly -- the heart of the library.

Reference C12 ``constructProlongation`` (`src/multigrid.cpp:265-498`),
C10 ``inTriangle`` (`src/multigrid.cpp:18-55`), C11 weighting schemes
(`src/multigrid.cpp:57-75`), C13 ``projectedPoints``
(`src/multigrid.cpp:500-510`).

Per fine point, with parent p's coarse neighborhood (SURVEY.md §2.1-C12):
  1. parent has no coarse neighbors  -> single weight 1.0 on the parent
     (`src/multigrid.cpp:294-299`);
  2. exactly one neighbor            -> clamped projection onto the
     parent->neighbor segment (`src/multigrid.cpp:301-334`);
  3. general: scan the parent's incident Voronoi triangles *in
     association-list order* and take the FIRST whose plane projection
     contains the point (the loop breaks on the first hit despite the
     "minimum distance" framing, `src/multigrid.cpp:374-380`);
  4. fallback A: the lowest-indexed coarse neighbor whose ``insideEdge``
     side-channel entry survived (`std::map` ascending-key iteration with
     an immediate break, `src/multigrid.cpp:414-421`), weighted by
     clamped projection onto that edge;
  5. fallback B: inverse-distance weights over {parent} ∪ the two coarse
     neighbors nearest to the fine point (`src/multigrid.cpp:449-483`),
     regardless of the requested scheme (`src/multigrid.cpp:476-481`).

All five cases become mask algebra evaluated for every (fine point x
candidate triangle) pair at once -- no branches, no side-channel state.

Two exact-compat observations let the ``insideEdge`` map
(`src/multigrid.cpp:37-48`) collapse into pure reductions:
  * the recorded first-encounter score ``||u - (u.w) w||`` (w the
    UNNORMALIZED edge vector, the reference's off-by-|w|^2 quirk,
    SURVEY.md §2.1-C10) depends only on (fine, parent, edge endpoint) --
    not on which triangle recorded it -- and is a norm, hence >= 0;
  * therefore the ``distance >= 0`` acceptance test in fallback A passes
    iff the entry was never overwritten by the kill rule, so the chosen
    edge is simply the lowest-indexed neighbor that appears in some
    scanned triangle's slot 1/2 and was never killed.  The recorded float
    value itself is dead (the loop breaks before comparing it).

The barycentric math follows `src/multigrid.cpp:29-35`: project onto the
triangle plane, then signed sub-area ratios against the (sign-arbitrary)
triangle normal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gravomg_tpu.types import (Graph, Prolongation, TriangleSet,
                               INVALID_INDEX, safe_gather_index)

# Full-f32 products (no TF32 passes): weights match the reference to 1e-6.
_HI = jax.lax.Precision.HIGHEST

BARYCENTRIC, UNIFORM, INVDIST = 0, 1, 2  # `multigrid.h:12-16`


def _inverse_distance_weights(points: jax.Array, p: jax.Array,
                              cols: jax.Array, n: int) -> jax.Array:
    """Reference C11 `inverseDistanceWeights` (`src/multigrid.cpp:63-75`):
    normalized 1 / max(1e-8, ||p - pos[e]||) over the first ``n`` cols."""
    d = jnp.linalg.norm(p[None, :] - points[cols], axis=-1)
    w = 1.0 / jnp.maximum(d, 1e-8)
    w = jnp.where(jnp.arange(cols.shape[0]) < n, w, 0.0)
    return w / jnp.sum(w)


def _two_point_weights(scheme: int, points: jax.Array, p: jax.Array,
                       w_far: jax.Array, c0: jax.Array, c1: jax.Array):
    """Shared by cases 2 and 4: weights over (c0, c1) given the clamped
    projection weight of the far endpoint under BARYCENTRIC."""
    if scheme == BARYCENTRIC:
        return jnp.stack([1.0 - w_far, w_far])
    if scheme == UNIFORM:
        return jnp.full((2,), 0.5, points.dtype)
    cols = jnp.stack([c0, c1])
    return _inverse_distance_weights(points, p, cols, 2)[:2]


@functools.partial(jax.jit, static_argnames=("scheme",))
def _prolongation_rows(fine_points, parents, coarse_points, coarse_nbr,
                       triangles: TriangleSet, scheme: int):
    """Vectorized kernel: per-fine-point U row (cols (3,), weights (3,))
    plus case flags (hit, edge-fallback, point-fallback)."""
    cmask_all = coarse_nbr != INVALID_INDEX
    cnbr_safe = safe_gather_index(coarse_nbr)
    tri_v = triangles.vertices
    tri_n = triangles.normals
    tri_safe = jnp.where(tri_v == INVALID_INDEX, 0, tri_v)
    assoc = triangles.assoc

    # Pack each triangle's data into ONE gatherable row: the scan below
    # visits A candidate triangles per fine point, and separate
    # vertex-id / normal / 3x coarse-point gathers cost 5A indices per
    # point where one packed (T, 16) row per candidate costs A.
    # Layout: v0 v1 v2 coords (9), normal (3), the three vertex ids
    # bitcast int32->f32 (offset by 2^23 so every pattern is a NORMAL
    # float -- devices may flush denormals, and f64<->f32 conversion of
    # normals is exact on the f64 path), one pad lane.
    dt = coarse_points.dtype
    _id_f = jax.lax.bitcast_convert_type(
        tri_safe.astype(jnp.int32) + jnp.int32(2 ** 23), jnp.float32)
    packed = jnp.concatenate([
        coarse_points[tri_safe[:, 0]], coarse_points[tri_safe[:, 1]],
        coarse_points[tri_safe[:, 2]], tri_n.astype(dt),
        _id_f.astype(dt),
        jnp.zeros((tri_v.shape[0], 1), dt)], axis=1)      # (T, 16)

    # Same packing for the per-coarse neighbor coordinates (case 2 /
    # both fallbacks): one (C, Kc*3) row gather per point instead of
    # Kc point gathers.
    kc = coarse_nbr.shape[1]
    cpn = coarse_points[cnbr_safe].reshape(-1, kc * 3)

    def per_point(p, c):
        pc = coarse_points[c]
        nbrs = cnbr_safe[c]                       # (Kc,) ascending
        npts = cpn[c].reshape(kc, 3)              # (Kc, 3) one gather
        nmask = cmask_all[c]
        deg = jnp.sum(nmask)

        # ---- case 2: single neighbor (`src/multigrid.cpp:301-334`) ----
        nb0 = nbrs[0]
        seg = npts[0] - pc
        # Reference normalizes by the TRUE norm but divides by the clamped
        # length (`src/multigrid.cpp:311-313`); keep both for exactness.
        seg_len = jnp.maximum(jnp.linalg.norm(seg), 1e-8)
        w_nb = jnp.dot(p - pc, seg / jnp.linalg.norm(seg),
                       precision=_HI) / seg_len
        w_nb = jnp.clip(w_nb, 0.0, 1.0)
        w2 = _two_point_weights(scheme, coarse_points, p, w_nb, c, nb0)
        single_cols = jnp.stack([c, nb0, c])
        single_wts = jnp.stack([w2[0], w2[1], jnp.zeros_like(w2[0])])

        # ---- triangle scan (`src/multigrid.cpp:335-405`) ----
        ts = assoc[c]                             # (A,)
        tvalid = ts != INVALID_INDEX
        ts_safe = jnp.where(tvalid, ts, 0)
        prow = packed[ts_safe]                    # (A, 16): ONE gather
        # 2-D slices/selects ONLY: a (A, 3, 3) take_along_axis temp has
        # tiny minor dims that tiled layouts pad many-fold.
        p0, p1, p2 = prow[:, 0:3], prow[:, 3:6], prow[:, 6:9]
        tn = prow[:, 9:12]                        # (A, 3)
        tv = jax.lax.bitcast_convert_type(
            prow[:, 12:15].astype(jnp.float32),
            jnp.int32) - jnp.int32(2 ** 23)       # (A, 3) vertex ids
        # Rotate so the parent sits in slot 0 (`src/multigrid.cpp:360`).
        pos_c = jnp.argmax(tv == c, axis=1)       # (A,)

        def rot3(a0, a1, a2, shift):
            # element `shift` positions after pos_c, cyclically.
            s = (pos_c + shift) % 3
            pick = lambda col0, col1, col2: jnp.where(
                (s == 0)[:, None] if col0.ndim == 2 else (s == 0),
                col0, jnp.where((s == 1)[:, None]
                                if col0.ndim == 2 else (s == 1),
                                col1, col2))
            return pick(a0, a1, a2)

        rt = jnp.stack([rot3(tv[:, 0], tv[:, 1], tv[:, 2], k)
                        for k in range(3)], axis=1)    # rotated (A, 3)
        v1 = rot3(p0, p1, p2, 0)                  # == pc wherever valid
        v2 = rot3(p0, p1, p2, 1)
        v3 = rot3(p0, p1, p2, 2)
        # inTriangle (`src/multigrid.cpp:29-35`)
        dist_plane = jnp.sum((p - v1) * tn, axis=1)
        p_proj = p - dist_plane[:, None] * tn
        double_area = jnp.sum(jnp.cross(v2 - v1, v3 - v1) * tn, axis=1)
        b0 = jnp.sum(jnp.cross(v3 - v2, p_proj - v2) * tn,
                     axis=1) / double_area
        b1 = jnp.sum(jnp.cross(v1 - v3, p_proj - v3) * tn,
                     axis=1) / double_area
        b2 = 1.0 - b0 - b1
        hit = tvalid & (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
        has_hit = jnp.any(hit)
        first = jnp.argmax(hit)                   # first True in assoc order
        tri_cols = rt[first]
        if scheme == BARYCENTRIC:
            tri_wts = jnp.stack([b0[first], b1[first], b2[first]])
        elif scheme == UNIFORM:
            tri_wts = jnp.full((3,), 1.0 / 3.0, p.dtype)
        else:
            tri_wts = _inverse_distance_weights(
                coarse_points, p, tri_cols, 3)

        # ---- fallback A: surviving edge (`src/multigrid.cpp:406-448`)
        # Kill rules from inTriangle's side effects
        # (`src/multigrid.cpp:43-48`), applied across ALL scanned
        # triangles (the scan only reaches the fallback when no triangle
        # hit, so every associated triangle was processed).
        kill1 = (b0 < 0.0) | (b1 < 0.0)           # slot-1 edge killed
        kill2 = (b0 < 0.0) | (b2 < 0.0)           # slot-2 edge killed
        e = nbrs                                   # (Kc,)
        in1 = tvalid[None, :] & (rt[None, :, 1] == e[:, None])  # (Kc, A)
        in2 = tvalid[None, :] & (rt[None, :, 2] == e[:, None])
        present = jnp.any(in1 | in2, axis=1)
        killed = jnp.any((in1 & kill1[None, :]) | (in2 & kill2[None, :]),
                         axis=1)
        eligible = nmask & present & ~killed
        has_edge = jnp.any(eligible)
        e_slot = jnp.argmax(eligible)              # lowest index first
        e_idx = nbrs[e_slot]
        eseg = npts[e_slot] - pc
        eseg_len = jnp.maximum(jnp.linalg.norm(eseg), 1e-8)
        w_e = jnp.clip(
            jnp.dot(p - pc, eseg / jnp.linalg.norm(eseg),
                    precision=_HI) / eseg_len,
            0.0, 1.0)
        we2 = _two_point_weights(scheme, coarse_points, p, w_e, c, e_idx)
        edge_cols = jnp.stack([c, e_idx, c])
        edge_wts = jnp.stack([we2[0], we2[1], jnp.zeros_like(we2[0])])

        # ---- fallback B: three nearest (`src/multigrid.cpp:449-483`)
        nd = jnp.linalg.norm(p[None, :] - npts, axis=-1)
        nd = jnp.where(nmask, nd, jnp.inf)
        # std::sort on (distance, index) pairs; rows are ascending by
        # index, so a stable sort on distance reproduces the tie-break.
        order = jnp.argsort(nd, stable=True)
        n1 = nbrs[order[0]]
        n2 = nbrs[order[1]]
        fb_cols = jnp.stack([c, n1, n2])
        fb_wts = _inverse_distance_weights(coarse_points, p, fb_cols, 3)

        # ---- combine (`src/multigrid.cpp:286-486`) ----
        gen_cols = jnp.where(
            has_hit, tri_cols, jnp.where(has_edge, edge_cols, fb_cols))
        gen_wts = jnp.where(
            has_hit, tri_wts, jnp.where(has_edge, edge_wts, fb_wts))
        cols = jnp.where(
            deg == 0, jnp.stack([c, c, c]),
            jnp.where(deg == 1, single_cols, gen_cols)).astype(jnp.int32)
        one = jnp.ones((), p.dtype)
        zero = jnp.zeros((), p.dtype)
        wts = jnp.where(
            deg == 0, jnp.stack([one, zero, zero]),
            jnp.where(deg == 1, single_wts, gen_wts))
        flags = jnp.stack([
            (deg >= 2) & has_hit,
            (deg >= 2) & ~has_hit & has_edge,
            (deg >= 2) & ~has_hit & ~has_edge,
        ])
        return cols, wts, flags

    return jax.vmap(per_point)(fine_points, parents)


_ID_OFFSET = jnp.int32(2 ** 23)   # bitcast int->f32 stays a NORMAL float


def _affine_tables(coarse_points: jax.Array, coarse_nbr: jax.Array,
                   triangles: TriangleSet):
    """Level-wide precomputation for the lane-major affine path.

    The barycentric coordinates of the PLANE-PROJECTED point are affine
    in the unprojected point p: with g0 = n x (v3 - v2),
    ``b0 * 2A = p_proj . g0 - v2 . g0`` and ``p_proj . g0 == p . g0``
    because g0 is perpendicular to the plane normal n (p_proj = p - ((p
    - v1) . n) n).  So each (triangle, rotation) pair reduces to two
    gradient vectors + offsets; the per-(point, candidate) test
    ``inTriangle`` (`src/multigrid.cpp:29-35`) becomes two fused
    multiply-adds on (block, A) lane-major arrays instead of vector
    algebra on (block, A, 3) temps whose tiny minor dim tiled layouts
    pad many-fold.

    Returns:
      packed_rot: (3T, 16) f32 rows ``[g0 (3), c0, g1 (3), c1, rotated
        vertex ids bitcast (3), pad (5)]`` indexed by 3 * tid + rot.
      enc:        (C, A) int32 ``3 * assoc + assoc_rot`` (INVALID pad).
      nbr_planes: (C, 3 * Kc) neighbor coordinates, plane-major
        ``[x (Kc) | y (Kc) | z (Kc)]`` so per-coordinate slices of a row
        gather are lane-contiguous (block, Kc) arrays.
    """
    tv = triangles.vertices
    tn = triangles.normals.astype(coarse_points.dtype)
    tsafe = jnp.where(tv == INVALID_INDEX, 0, tv)
    p = [coarse_points[tsafe[:, k]] for k in range(3)]       # 3 x (T, 3)
    # Signed double area against n -- cyclically invariant, computed in
    # the rot-0 frame exactly as `src/multigrid.cpp:32`.
    area2 = jnp.sum(jnp.cross(p[1] - p[0], p[2] - p[0]) * tn, axis=1)
    rows = []
    for r in range(3):
        v2, v3 = p[(r + 1) % 3], p[(r + 2) % 3]
        g0 = jnp.cross(tn, v3 - v2) / area2[:, None]
        c0 = -jnp.sum(g0 * v2, axis=1, keepdims=True)
        g1 = jnp.cross(tn, p[r] - v3) / area2[:, None]
        c1 = -jnp.sum(g1 * v3, axis=1, keepdims=True)
        ids = jnp.stack([tsafe[:, r], tsafe[:, (r + 1) % 3],
                         tsafe[:, (r + 2) % 3]], axis=1)
        idf = jax.lax.bitcast_convert_type(
            ids.astype(jnp.int32) + _ID_OFFSET, jnp.float32)
        rows.append(jnp.concatenate(
            [g0, c0, g1, c1, idf.astype(coarse_points.dtype),
             jnp.zeros((tv.shape[0], 5), coarse_points.dtype)], axis=1))
    packed_rot = jnp.stack(rows, axis=1).reshape(-1, 16)      # (3T, 16)

    rot = (triangles.assoc_rot if triangles.assoc_rot is not None
           else jnp.zeros_like(triangles.assoc))
    enc = jnp.where(triangles.assoc == INVALID_INDEX, INVALID_INDEX,
                    3 * triangles.assoc + rot)

    kc = coarse_nbr.shape[1]
    npall = coarse_points[safe_gather_index(coarse_nbr)]      # (C, Kc, 3)
    nbr_planes = jnp.swapaxes(npall, 1, 2).reshape(-1, 3 * kc)
    return packed_rot, enc, nbr_planes


def _prolongation_block_affine(fp, par, coarse_points, coarse_nbr,
                               packed_rot, enc, nbr_planes, scheme: int):
    """Lane-major affine kernel over one block of fine points.

    Same five-case semantics as :func:`_prolongation_rows` (reference
    `src/multigrid.cpp:265-498`); barycentric signs come from the
    algebraically identical affine form, so f32 roundoff near b == 0
    can differ from the sequential formula by ~1 ulp -- within the f32
    path's documented 2e-6..6e-6 envelope (exact-compat runs use the
    non-affine path at f64).  All per-candidate temps are (B, A) with
    the candidate axis minor.
    """
    dt = fp.dtype
    kc = coarse_nbr.shape[1]
    px, py, pz = fp[:, 0], fp[:, 1], fp[:, 2]
    pc = coarse_points[par]                                   # (B, 3)
    pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]

    cand = enc[par]                                           # (B, A)
    tvalid = cand != INVALID_INDEX
    prow = packed_rot[jnp.where(tvalid, cand, 0)]             # (B, A, 16)
    pt = jnp.swapaxes(prow, 1, 2)                             # (B, 16, A)
    lane = lambda k: pt[:, k, :]                              # (B, A)
    b0 = (lane(0) * px[:, None] + lane(1) * py[:, None]
          + lane(2) * pz[:, None] + lane(3))
    b1 = (lane(4) * px[:, None] + lane(5) * py[:, None]
          + lane(6) * pz[:, None] + lane(7))
    b2 = 1.0 - b0 - b1
    rid = [jax.lax.bitcast_convert_type(
        lane(8 + k).astype(jnp.float32), jnp.int32) - _ID_OFFSET
        for k in range(3)]

    hit = tvalid & (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    has_hit = jnp.any(hit, axis=1)
    first = jnp.argmax(hit, axis=1)[:, None]                  # (B, 1)
    take1 = lambda a: jnp.take_along_axis(a, first, axis=1)[:, 0]
    tri_cols = jnp.stack([take1(r) for r in rid], axis=1)     # (B, 3)
    if scheme == BARYCENTRIC:
        tri_wts = jnp.stack([take1(b0), take1(b1), take1(b2)], axis=1)
    elif scheme == UNIFORM:
        tri_wts = jnp.full((fp.shape[0], 3), 1.0 / 3.0, dt)
    else:
        td = jnp.linalg.norm(
            fp[:, None, :] - coarse_points[tri_cols], axis=-1)
        tw = 1.0 / jnp.maximum(td, 1e-8)
        tri_wts = tw / jnp.sum(tw, axis=1, keepdims=True)

    # Neighborhood tables (one row gather each).
    nbr_row = coarse_nbr[par]                                 # (B, Kc)
    nmask = nbr_row != INVALID_INDEX
    nbrs = jnp.where(nmask, nbr_row, 0)
    deg = jnp.sum(nmask, axis=1)
    planes = nbr_planes[par]                                  # (B, 3Kc)
    npx = planes[:, 0 * kc:1 * kc]
    npy = planes[:, 1 * kc:2 * kc]
    npz = planes[:, 2 * kc:3 * kc]

    def two_point(w_far, other_idx, other_d):
        """Weights over (parent, other) per scheme -- vectorized
        `_two_point_weights`; distances recomputed as the reference does
        (`src/multigrid.cpp:63-75`)."""
        if scheme == BARYCENTRIC:
            return 1.0 - w_far, w_far
        if scheme == UNIFORM:
            h = jnp.full_like(w_far, 0.5)
            return h, h
        d_par = jnp.sqrt((px - pcx) ** 2 + (py - pcy) ** 2
                         + (pz - pcz) ** 2)
        wp = 1.0 / jnp.maximum(d_par, 1e-8)
        wo = 1.0 / jnp.maximum(other_d, 1e-8)
        s = wp + wo
        return wp / s, wo / s

    def seg_weight(ex, ey, ez):
        """Clamped projection of p - pc onto the segment pc -> e
        (`src/multigrid.cpp:309-315`): normalize by the true norm,
        divide by the clamped length."""
        sx, sy, sz = ex - pcx, ey - pcy, ez - pcz
        sl = jnp.sqrt(sx * sx + sy * sy + sz * sz)
        slc = jnp.maximum(sl, 1e-8)
        dot = ((px - pcx) * (sx / sl) + (py - pcy) * (sy / sl)
               + (pz - pcz) * (sz / sl))
        return jnp.clip(dot / slc, 0.0, 1.0)

    # ---- case 2: single neighbor ----
    nb0 = nbrs[:, 0]
    d_nb0 = jnp.sqrt((px - npx[:, 0]) ** 2 + (py - npy[:, 0]) ** 2
                     + (pz - npz[:, 0]) ** 2)
    w_nb = seg_weight(npx[:, 0], npy[:, 0], npz[:, 0])
    s_w0, s_w1 = two_point(w_nb, nb0, d_nb0)
    single_cols = jnp.stack([par, nb0, par], axis=1)
    single_wts = jnp.stack([s_w0, s_w1, jnp.zeros_like(s_w0)], axis=1)

    # ---- fallback A: surviving edge ----
    kill1 = (b0 < 0.0) | (b1 < 0.0)
    kill2 = (b0 < 0.0) | (b2 < 0.0)
    in1 = tvalid[:, None, :] & (rid[1][:, None, :] == nbrs[:, :, None])
    in2 = tvalid[:, None, :] & (rid[2][:, None, :] == nbrs[:, :, None])
    present = jnp.any(in1 | in2, axis=2)
    killed = jnp.any((in1 & kill1[:, None, :]) | (in2 & kill2[:, None, :]),
                     axis=2)
    eligible = nmask & present & ~killed
    has_edge = jnp.any(eligible, axis=1)
    e_slot = jnp.argmax(eligible, axis=1)[:, None]
    tke = lambda a: jnp.take_along_axis(a, e_slot, axis=1)[:, 0]
    e_idx = tke(nbrs)
    ex, ey, ez = tke(npx), tke(npy), tke(npz)
    d_e = jnp.sqrt((px - ex) ** 2 + (py - ey) ** 2 + (pz - ez) ** 2)
    w_e = seg_weight(ex, ey, ez)
    e_w0, e_w1 = two_point(w_e, e_idx, d_e)
    edge_cols = jnp.stack([par, e_idx, par], axis=1)
    edge_wts = jnp.stack([e_w0, e_w1, jnp.zeros_like(e_w0)], axis=1)

    # ---- fallback B: three nearest (always inverse-distance) ----
    nd = jnp.sqrt((px[:, None] - npx) ** 2 + (py[:, None] - npy) ** 2
                  + (pz[:, None] - npz) ** 2)
    nd = jnp.where(nmask, nd, jnp.inf)
    s1 = jnp.argmin(nd, axis=1)[:, None]    # first min = stable tie-break
    d1 = jnp.take_along_axis(nd, s1, axis=1)[:, 0]
    nd2 = jnp.where(jnp.arange(kc)[None, :] == s1, jnp.inf, nd)
    s2 = jnp.argmin(nd2, axis=1)[:, None]
    d2 = jnp.take_along_axis(nd2, s2, axis=1)[:, 0]
    n1 = jnp.take_along_axis(nbrs, s1, axis=1)[:, 0]
    n2 = jnp.take_along_axis(nbrs, s2, axis=1)[:, 0]
    d_par = jnp.sqrt((px - pcx) ** 2 + (py - pcy) ** 2 + (pz - pcz) ** 2)
    fw = jnp.stack([1.0 / jnp.maximum(d_par, 1e-8),
                    1.0 / jnp.maximum(d1, 1e-8),
                    1.0 / jnp.maximum(d2, 1e-8)], axis=1)
    fb_wts = fw / jnp.sum(fw, axis=1, keepdims=True)
    fb_cols = jnp.stack([par, n1, n2], axis=1)

    # ---- combine ----
    gen_cols = jnp.where(has_hit[:, None], tri_cols,
                         jnp.where(has_edge[:, None], edge_cols, fb_cols))
    gen_wts = jnp.where(has_hit[:, None], tri_wts,
                        jnp.where(has_edge[:, None], edge_wts, fb_wts))
    self_cols = jnp.stack([par, par, par], axis=1)
    one_wts = jnp.concatenate(
        [jnp.ones((fp.shape[0], 1), dt), jnp.zeros((fp.shape[0], 2), dt)],
        axis=1)
    cols = jnp.where((deg == 0)[:, None], self_cols,
                     jnp.where((deg == 1)[:, None], single_cols,
                               gen_cols)).astype(jnp.int32)
    wts = jnp.where((deg == 0)[:, None], one_wts,
                    jnp.where((deg == 1)[:, None], single_wts, gen_wts))
    flags = jnp.stack([
        (deg >= 2) & has_hit,
        (deg >= 2) & ~has_hit & has_edge,
        (deg >= 2) & ~has_hit & ~has_edge,
    ], axis=1)
    return cols, wts, flags


@functools.partial(jax.jit, static_argnames=("scheme", "block",
                                             "precise_weights", "affine",
                                             "first_pass_assoc"))
def construct_prolongation(fine_points: jax.Array, parents: jax.Array,
                           coarse_points: jax.Array, coarse_nbr: jax.Array,
                           triangles: TriangleSet,
                           scheme: int = BARYCENTRIC,
                           block: int = 16384,
                           precise_weights: bool = False,
                           affine: str = "auto",
                           first_pass_assoc: int = 32
                           ) -> Tuple[Prolongation, jax.Array]:
    """Assemble U (reference `src/multigrid.cpp:265-498`).

    Evaluated in fixed-size blocks of fine points (lax.map over an inner
    vmap) so peak memory stays O(block * A) at 1M vertices.

    ``precise_weights`` runs the weight arithmetic (barycentric area
    ratios, projections) in f64 on the same discrete hierarchy and
    rounds the result back to the input dtype: pure-f32 weights land at
    ~2e-6 of the f64 reference (measured), while the BASELINE target is
    1e-6; this mode meets it at the cost of emulated-f64 arithmetic on
    O(V) elements (requires jax x64 to be enabled).

    Returns (Prolongation, case_counts (3,) int32 = [triangle hits,
    edge fallbacks, point fallbacks], escalation_overflow () bool);
    `case_counts` surfaces the reference's never-printed counters
    (`src/multigrid.cpp:282-284`); the overflow is True iff the
    two-pass escalation (below) ran out of its static compaction cap
    and some rows kept first-pass fallback weights.

    ``affine`` selects the lane-major affine-barycentric kernel
    (:func:`_prolongation_block_affine`): "auto" enables it for f32
    inputs (where it replaces minor-dim-3 vector algebra with fused
    multiply-adds on (block, A) arrays) and keeps the
    sequential-formula kernel for f64/compat runs, whose 1e-12 oracle
    bound depends on following the reference's exact float sequence.
    "on"/"off" force it.

    ``first_pass_assoc`` (affine path only): kernel cost is LINEAR in
    the association pad A while real per-vertex triangle counts are
    tiny (measured at 1M: mean 4.4, max 31 against A = 96), so the
    first pass scans only the first ``first_pass_assoc`` candidates.
    That is exact for every point that either hits a triangle there
    (first-hit order is assoc order, so an early hit is THE hit,
    `src/multigrid.cpp:374-380`) or whose parent has no later
    candidates; the rare rest -- no early hit AND parent assoc count
    beyond the slice -- rerun at full A via a static-size compaction
    (cap vf // 8 + 1 block, overflow-flagged).  0 disables.
    """
    out_dtype = fine_points.dtype
    use_affine = (affine == "on"
                  or (affine == "auto" and out_dtype == jnp.float32
                      and not precise_weights))
    if precise_weights:
        import jax.dtypes as _dt
        if jnp.zeros((), jnp.float64).dtype != jnp.float64:
            raise RuntimeError(
                "precise_weights requires jax_enable_x64")
        fine_points = fine_points.astype(jnp.float64)
        coarse_points = coarse_points.astype(jnp.float64)
        # Recompute normals in f64 from the (same) triangle vertices --
        # an f32 normal perturbation would re-enter the barycentric
        # ratios and spoil the extended precision.
        tv = jnp.where(triangles.vertices == INVALID_INDEX, 0,
                       triangles.vertices)
        p0 = coarse_points[tv[:, 0]]
        e01 = coarse_points[tv[:, 1]] - p0
        e02 = coarse_points[tv[:, 2]] - p0
        nrm = jnp.cross(e01, e02)
        nn = jnp.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = jnp.where(nn > 0, nrm / jnp.where(nn > 0, nn, 1.0), nrm)
        triangles = triangles._replace(normals=nrm)
    vf = fine_points.shape[0]
    n_coarse = coarse_points.shape[0]
    block = min(block, ((vf + 255) // 256) * 256)
    vpad = ((vf + block - 1) // block) * block
    fp = jnp.pad(fine_points, ((0, vpad - vf), (0, 0)))
    pp = jnp.pad(parents, (0, vpad - vf))

    esc_ovf = jnp.bool_(False)
    if use_affine:
        packed_rot, enc, nbr_planes = _affine_tables(
            coarse_points, coarse_nbr, triangles)
        a_full = enc.shape[1]
        a1 = first_pass_assoc if 0 < first_pass_assoc < a_full else a_full
        enc1 = enc[:, :a1]

        def run_block(args):
            f, par = args
            return _prolongation_block_affine(
                f, par, coarse_points, coarse_nbr, packed_rot, enc1,
                nbr_planes, scheme)
    else:
        def run_block(args):
            f, par = args
            return _prolongation_rows(f, par, coarse_points, coarse_nbr,
                                      triangles, scheme)

    cols, wts, flags = jax.lax.map(
        run_block, (fp.reshape(-1, block, 3), pp.reshape(-1, block)))
    cols = cols.reshape(vpad, 3)
    wts = wts.reshape(vpad, 3)
    flags = flags.reshape(vpad, 3)

    if use_affine and a1 < a_full:
        # Escalation pass: exact only beyond the slice for points whose
        # parent has candidates there AND that found no early hit (an
        # early hit is final: first-hit order is assoc order).
        acount = jnp.sum(triangles.assoc != INVALID_INDEX, axis=1)
        need = ((acount[pp] > a1) & jnp.any(flags, axis=1)
                & ~flags[:, 0])
        need = need & (jnp.arange(vpad) < vf)
        esc_cap = min(vpad, ((max(block, vpad // 8) + block - 1)
                             // block) * block)
        esc_ovf = jnp.sum(need) > esc_cap
        idx = jnp.nonzero(need, size=esc_cap, fill_value=vpad)[0]
        idx_safe = jnp.minimum(idx, vpad - 1)

        def run_block_full(args):
            f, par = args
            return _prolongation_block_affine(
                f, par, coarse_points, coarse_nbr, packed_rot, enc,
                nbr_planes, scheme)

        cols2, wts2, flags2 = jax.lax.map(
            run_block_full, (fp[idx_safe].reshape(-1, block, 3),
                             pp[idx_safe].reshape(-1, block)))
        # Sentinel-row scatter: fill slots land at row vpad and drop.
        def put(dst, src):
            buf = jnp.concatenate(
                [dst, jnp.zeros((1, 3), dst.dtype)], axis=0)
            return buf.at[idx].set(src.reshape(esc_cap, 3))[:vpad]

        cols = put(cols, cols2)
        wts = put(wts, wts2)
        flags = put(flags, flags2)

    cols = cols[:vf]
    wts = wts[:vf].astype(out_dtype)
    flags = flags[:vf]
    counts = jnp.sum(flags, axis=0).astype(jnp.int32)
    return (Prolongation(cols=cols, weights=wts, n_coarse=n_coarse),
            counts, esc_ovf)


def prolong(u_op: Prolongation, coarse_values: jax.Array) -> jax.Array:
    """Apply U: fine = U @ coarse.  Reference C13 `projectedPoints`
    (`src/multigrid.cpp:500-510`) is exactly this with coarse positions.

    coarse_values: (n_coarse,) or (n_coarse, D).
    """
    gathered = coarse_values[u_op.cols]            # (Vf, 3[, D])
    if coarse_values.ndim == 1:
        return jnp.sum(u_op.weights * gathered, axis=1)
    return jnp.sum(u_op.weights[:, :, None] * gathered, axis=1)


def restrict(u_op: Prolongation, fine_values: jax.Array) -> jax.Array:
    """Apply U^T: coarse = U^T @ fine.  Restriction is U^T in the Gravo MG
    method (reference `README.md:1` names it; never materialized there).

    Scatter-form fallback (a scatter-add over 3 Vf entries); the solver
    hot path uses the precomputed gather-form
    :func:`build_restriction` / :func:`restrict_gather` instead.
    """
    if fine_values.ndim == 1:
        contrib = u_op.weights * fine_values[:, None]
        out = jnp.zeros((u_op.n_coarse,), fine_values.dtype)
        return out.at[u_op.cols].add(contrib)
    contrib = u_op.weights[:, :, None] * fine_values[:, None, :]
    out = jnp.zeros((u_op.n_coarse, fine_values.shape[1]),
                    fine_values.dtype)
    return out.at[u_op.cols.reshape(-1)].add(
        contrib.reshape(-1, fine_values.shape[1]))


@functools.partial(jax.jit, static_argnames=("max_children",))
def build_restriction(u_op: Prolongation,
                      max_children: int) -> Tuple["Restriction", jax.Array]:
    """Precompute gather-form U^T: per coarse vertex, the (fine row, U
    weight) pairs that contribute to it.  Built once per hierarchy; turns
    every restriction in the V-cycle from a scatter-add into a
    fixed-shape gather + row-reduce.

    Zero-weight U entries (padded fine rows, duplicated slots) are
    dropped.  Returns (Restriction, overflow flag) -- overflow means some
    coarse vertex has more than ``max_children`` contributing fine
    entries and the table is invalid.
    """
    from gravomg_tpu.ops.segment import group_ordered
    from gravomg_tpu.types import Restriction

    vf = u_op.n_fine
    if vf >= 2 ** 29:
        # (fine row, slot) packs as fine*4 + slot in int32; beyond 2^29
        # rows that silently wraps and corrupts the children table.
        raise ValueError(
            f"build_restriction: n_fine={vf} >= 2**29 overflows the "
            "int32 (row, slot) packing; shard the level first")
    nc = u_op.n_coarse
    cols = u_op.cols.reshape(-1)                     # (3 Vf,)
    w = u_op.weights.reshape(-1)
    valid = (w != 0.0)
    # Pack (fine row, slot) into one int32 payload; group by coarse col.
    fine_ids = jnp.repeat(
        jnp.arange(vf, dtype=jnp.int32), 3, total_repeat_length=3 * vf)
    slot_ids = jnp.tile(jnp.arange(3, dtype=jnp.int32), vf)
    payload = fine_ids * 4 + slot_ids
    table, _, overflow = group_ordered(cols, payload, valid, nc,
                                       max_children)
    tmask = table != INVALID_INDEX
    safe = jnp.where(tmask, table, 0)
    rows = safe >> 2
    slots = safe & 3
    weights = jnp.where(tmask, u_op.weights[rows, slots], 0.0)
    rows = jnp.where(tmask, rows, INVALID_INDEX)
    return Restriction(rows=rows, weights=weights, n_fine=vf), overflow


def restrict_gather(rt, fine_values: jax.Array) -> jax.Array:
    """Apply U^T via the precomputed children table: a fixed-shape
    gather + row-reduce (same shape recipe as spmv)."""
    safe = rt.safe_rows()
    if fine_values.ndim == 1:
        return jnp.sum(rt.weights * fine_values[safe], axis=1)
    return jnp.einsum("ck,ckd->cd", rt.weights, fine_values[safe],
                      precision=jax.lax.Precision.HIGHEST)


def projected_points(u_op: Prolongation,
                     coarse_points: jax.Array) -> jax.Array:
    """Reference C13 (`src/multigrid.cpp:500-510`): U @ coarse_points,
    the demo's visual sanity oracle (`test/main.cpp:147-156`)."""
    return prolong(u_op, coarse_points)
