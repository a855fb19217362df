"""Batch-last geometry: the full getRT chain laid out for batched serving.

Same math as :func:`mrs_optic_flow_tpu.geometry.motion.get_rt` (which stays
the reference implementation for single frames and for tests), re-laid-out
for throughput serving: every intermediate keeps the **batch axis last**, so
the widest axis is the contiguous one and the coordinate axes of size
2/3/9/16 stay outer.  (The layout was chosen for the wide vector lanes of
the accelerator this was first built for; whether it is the best layout on
the GPU is not measured yet.)

Differences from the per-sample path (documented, not bugs):

- RANSAC hypothesis draws come from ONE key (``keys[0]``) with a
  ``[iterations, P, B]`` Gumbel tensor instead of per-sample key streams —
  deterministic, independent across samples, but a different random
  sequence than ``jax.vmap(get_rt)``.  On consensus-stable data both find
  the same homography; the reference's RANSAC is itself nondeterministic.
- Float reductions associate differently (axis order), so results match
  the per-sample path to ~1e-4, not bitwise.

Reference citations as in ``motion.py``: getRT ``src/optic_flow.cpp:515-774``,
RANSAC ``:558``, decomposition ``:592`` (Malis-Vargas, as
``cv::decomposeHomographyMat``), solution selection ``:630-671``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.geometry.motion import GetRTResult, grid_centers
from mrs_optic_flow_tpu.geometry.rotations import matrix_from_quat



# ---------------------------------------------------------------------------
# primitives on trailing-batch layouts
# ---------------------------------------------------------------------------


def _undistort_xy(px, py, fx, fy, cx, cy, dist, iterations=5):
    """cv::undistortPoints on component arrays of any matching shape."""
    xd = (px - cx) / fx
    yd = (py - cy) / fy
    if dist is None:
        return xd, yd
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return x, y


def _mm33(a, b):
    """[3, 3, B] @ [3, 3, B] with the batch trailing, expanded elementwise —
    27 fused multiply-adds instead of B tiny 3x3 matmuls."""
    return jnp.sum(a[:, :, None, :] * b[None, :, :, :], axis=1)


def _norm_h9(h):
    """Normalize [..., 9, B] so h22 ~ 1 (OpenCV convention)."""
    scale = h[..., 8, :]
    scale = jnp.where(jnp.abs(scale) > 1e-12, scale, 1.0)
    return h / scale[..., None, :]


def _signd(x):
    return jnp.where(x >= 0.0, 1.0, -1.0)


# ---------------------------------------------------------------------------
# RANSAC homography, batch-last
# ---------------------------------------------------------------------------


def _dlt_rows_b(x, y, u, v, w):
    """Weighted DLT rows for point components ``[..., N, B]`` -> A
    ``[..., 2N, 9, B]`` (same row layout as ``homography._dlt_rows``)."""
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], axis=-2)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], axis=-2)
    a = jnp.concatenate([r1, r2], axis=-3)  # [..., 2N, 9, B]
    ww = jnp.concatenate([w, w], axis=-2)
    return a * ww[..., :, None, :]


def _h4_b(x4, y4, u4, v4):
    """Exact homography from 4 point pairs: components ``[I, 4, B]`` ->
    h ``[I, 9, B]`` (row-major, up to scale).

    Projective canonical-basis method, division-free: each side's 3x3 map
    takes the canonical basis (e1, e2, e3, e1+e2+e3) to that side's four
    points with columns Cramer-scaled (multiplying every column by the base
    determinant leaves the projective map unchanged), and
    ``H = H_dst . adj(H_src)``.  For 4 points in general position this IS
    the 1-D null space of the 8x9 DLT system — the same hypothesis the
    previous Gram-Schmidt null-space solve produced — at ~5% of its FLOPs
    (RANSAC hypothesis solving is most of the geometry's work).  Degenerate
    draws (3 collinear / coincident
    points) yield a rank-deficient H whose reprojection error is large, so
    they lose the consensus vote exactly like the null-space version.
    """

    def _side(a, b):
        a1, a2, a3, a4 = (a[:, i] for i in range(4))
        b1, b2, b3, b4 = (b[:, i] for i in range(4))

        def det(pa, pb, qa, qb, ra, rb):
            # | pa qa ra ; pb qb rb ; 1 1 1 |
            return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb)

        d1 = det(a4, b4, a2, b2, a3, b3)
        d2 = det(a1, b1, a4, b4, a3, b3)
        d3 = det(a1, b1, a2, b2, a4, b4)
        return [
            [d1 * a1, d2 * a2, d3 * a3],
            [d1 * b1, d2 * b2, d3 * b3],
            [d1, d2, d3],
        ]

    hs = _side(x4, y4)
    hd = _side(u4, v4)
    adj = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r1, r2 = (r for r in range(3) if r != j)  # adj[i][j] = cof[j][i]
            c1, c2 = (c for c in range(3) if c != i)
            minor = hs[r1][c1] * hs[r2][c2] - hs[r1][c2] * hs[r2][c1]
            adj[i][j] = minor if (i + j) % 2 == 0 else -minor
    rows = [
        sum(hd[i][k] * adj[k][j] for k in range(3))
        for i in range(3)
        for j in range(3)
    ]
    h = jnp.stack(rows, axis=1)  # [I, 9, B]
    # normalize each hypothesis to O(1) scale (the per-sample solver's
    # _norm_h role): the raw adjugate product scales as ~s^8 of the
    # normalized-coordinate scale, and at very long focal lengths genuine
    # projection denominators would fall under _project_err2_b's absolute
    # 1e-12 clamp and mis-score every hypothesis.  Max-abs (not h22) is
    # degeneracy-safe; a homography is defined up to scale, so downstream
    # math is unchanged.
    scale = jnp.max(jnp.abs(h), axis=1, keepdims=True)
    return h / jnp.where(scale > 0.0, scale, 1.0)


def _project_err2_b(h, ax, ay, bx, by):
    """Forward reprojection squared error: h ``[I, 9, B]`` against point
    components ``[P, B]`` -> err2 ``[I, P, B]``."""

    def hc(i):
        return h[:, i, None, :]  # [I, 1, B]

    axn, ayn, bxn, byn = ax[None], ay[None], bx[None], by[None]
    d = hc(6) * axn + hc(7) * ayn + hc(8)
    d = jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    u = (hc(0) * axn + hc(1) * ayn + hc(2)) / d
    v = (hc(3) * axn + hc(4) * ayn + hc(5)) / d
    return (u - bxn) ** 2 + (v - byn) ** 2


def _qr_null_b(a, h0):
    """Smallest right-singular vector of ``A [M, 9, B]`` — the batch-last
    port of ``homography._solve_h_qr_null`` (Householder QR + seeded
    inverse iteration)."""
    m, k, _ = a.shape
    r = a
    rows = jnp.arange(m)[:, None]
    for j in range(k):
        col = r[:, j, :]  # [M, B]
        x = jnp.where(rows >= j, col, 0.0)
        normx = jnp.sqrt(jnp.sum(x * x, axis=0, keepdims=True))
        rjj = col[j : j + 1, :]
        sign = jnp.where(rjj >= 0.0, 1.0, -1.0)
        u1 = rjj + sign * normx
        safe = normx > 1e-30
        v = jnp.where(safe, x / jnp.where(jnp.abs(u1) > 1e-30, u1, 1.0), 0.0)
        v = v.at[j, :].set(jnp.where(safe[0], 1.0, 0.0))
        tau = jnp.where(safe, sign * u1 / jnp.where(normx > 1e-30, normx, 1.0), 0.0)
        w = jnp.sum(v[:, None, :] * r, axis=0)  # [K, B]
        r = r - tau[0][None, None, :] * v[:, None, :] * w[None, :, :]
    r = r[:k]  # [9, 9, B]

    diag = jnp.stack([r[i, i] for i in range(k)], axis=0)  # [9, B]
    dsafe = jnp.where(jnp.abs(diag) > 1e-12, diag, 1e-12)

    def fwd_solve(b):  # R^T z = b
        zs = []
        for i in range(k):
            acc = b[i]
            for mm in range(i):
                acc = acc - r[mm, i] * zs[mm]
            zs.append(acc / dsafe[i])
        return jnp.stack(zs, axis=0)

    def back_solve(b):  # R y = b
        ys = [None] * k
        for i in reversed(range(k)):
            acc = b[i]
            for mm in range(i + 1, k):
                acc = acc - r[i, mm] * ys[mm]
            ys[i] = acc / dsafe[i]
        return jnp.stack(ys, axis=0)

    x = h0 / jnp.maximum(jnp.sqrt(jnp.sum(h0 * h0, axis=0, keepdims=True)), 1e-30)
    for _ in range(3):
        x = back_solve(fwd_solve(x))
        x = x / jnp.maximum(jnp.sqrt(jnp.sum(x * x, axis=0, keepdims=True)), 1e-30)
    return _norm_h9(x)


def _ransac_h_b(ax, ay, bx, by, valid, key, iterations, threshold):
    """Batch-last RANSAC homography.  ``ax/ay`` [P] (shared grid centres)
    or [P, B]; ``bx/by/valid`` [P, B].  Returns (h [9,B], inliers [P,B],
    n_inliers [B], ok [B])."""
    p, b = bx.shape
    axb = jnp.broadcast_to(ax.reshape((p, -1)), (p, b))
    ayb = jnp.broadcast_to(ay.reshape((p, -1)), (p, b))
    bxv = jnp.where(valid, bx, 0.0)
    byv = jnp.where(valid, by, 0.0)
    axv = jnp.where(valid, axb, 0.0)
    ayv = jnp.where(valid, ayb, 0.0)

    # Gumbel top-4: uniform-over-valid distinct sampling per (iteration,
    # sample) — the batch-last equivalent of jax.random.choice(p=valid).
    # Selection by 4 rounds of argmax+mask instead of an argsort over the
    # point axis (a variadic sort per (iteration, sample)).
    g = jax.random.gumbel(key, (iterations, p, b))
    g = jnp.where(valid[None], g, -jnp.inf)
    iota_p = jnp.arange(p)[None, :, None]
    ohs = []
    for _ in range(4):
        top = jnp.argmax(g, axis=1)  # [I, B]
        oh_k = (iota_p == top[:, None, :]).astype(bx.dtype)  # [I, P, B]
        ohs.append(oh_k)
        g = jnp.where(oh_k > 0.5, -jnp.inf, g)
    oh = jnp.stack(ohs, axis=1)  # [I, 4, P, B]

    def sel(comp):  # [P, B] -> [I, 4, B]
        return jnp.sum(oh * comp[None, None], axis=2)

    x4, y4, u4, v4 = sel(axv), sel(ayv), sel(bxv), sel(byv)
    hs = _h4_b(x4, y4, u4, v4)  # [I, 9, B] exact 4-point homographies

    err2 = _project_err2_b(hs, axv, ayv, bxv, byv)
    inls = (err2 < threshold * threshold) & valid[None]  # [I, P, B]
    counts = jnp.sum(inls, axis=1)  # [I, B]
    best = jnp.argmax(counts, axis=0)  # [B]
    oh_best = (jnp.arange(iterations)[:, None] == best[None]).astype(bx.dtype)
    inliers = jnp.sum(inls * oh_best[:, None, :], axis=0) > 0.5  # [P, B]
    n_inl = jnp.sum(counts * oh_best, axis=0).astype(jnp.int32)
    h_seed = jnp.sum(hs * oh_best[:, None, :], axis=0)  # [9, B]

    a_full = _dlt_rows_b(axv, ayv, bxv, byv, inliers.astype(bx.dtype))  # [2P, 9, B]
    h = _qr_null_b(a_full, h_seed)
    ok = n_inl >= 4
    eye = jnp.asarray(np.eye(3, dtype=np.float32).reshape(9))
    h = jnp.where(ok[None], h, eye[:, None])
    return h, inliers, n_inl, ok


# ---------------------------------------------------------------------------
# Malis-Vargas decomposition, batch-last
# ---------------------------------------------------------------------------


def _sv_middle_b(h):
    """Middle singular value of ``h [3, 3, B]`` (closed form, see
    ``homography._sv_middle_3x3``)."""
    a = jnp.sum(h[:, :, None, :] * h[:, None, :, :], axis=0)  # H^T H
    q = (a[0, 0] + a[1, 1] + a[2, 2]) / 3.0
    eye = jnp.asarray(np.eye(3, dtype=np.float32))[..., None]
    bm = a - q[None, None] * eye
    p2 = jnp.sum(bm * bm, axis=(0, 1)) / 6.0
    pp = jnp.sqrt(jnp.maximum(p2, 0.0))
    psafe = jnp.where(pp > 1e-30, pp, 1.0)
    c = bm / psafe[None, None]
    det_c = (
        c[0, 0] * (c[1, 1] * c[2, 2] - c[1, 2] * c[2, 1])
        - c[0, 1] * (c[1, 0] * c[2, 2] - c[1, 2] * c[2, 0])
        + c[0, 2] * (c[1, 0] * c[2, 1] - c[1, 1] * c[2, 0])
    )
    rr = jnp.clip(det_c / 2.0, -1.0, 1.0)
    phi = jnp.arccos(rr) / 3.0
    e1 = q + 2.0 * pp * jnp.cos(phi)
    e3 = q + 2.0 * pp * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    e2 = jnp.where(pp > 1e-30, e2, q)
    return jnp.sqrt(jnp.maximum(e2, 0.0))


def _opp_minor(s, row, col):
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return s[y1, x2] * s[y2, x1] - s[y1, x1] * s[y2, x2]


def _decompose_b(h):
    """Malis-Vargas on ``h [3, 3, B]`` -> (rots [4,3,3,B], trans [4,3,B],
    normals [4,3,B], n_solutions [B]).  Same algorithm/solution order as
    ``homography.decompose_homography`` (float32 path)."""
    gamma = _sv_middle_b(h)
    hn = h / gamma[None, None]
    # normalize to det(Hn) > 0 like OpenCV's HomographyDecomp — sign(h22)
    # mis-handles det < 0 fits (see homography.decompose_homography)
    det = (
        hn[0, 0] * (hn[1, 1] * hn[2, 2] - hn[1, 2] * hn[2, 1])
        - hn[0, 1] * (hn[1, 0] * hn[2, 2] - hn[1, 2] * hn[2, 0])
        + hn[0, 2] * (hn[1, 0] * hn[2, 1] - hn[1, 1] * hn[2, 0])
    )
    hn = hn * _signd(det)[None, None]

    eye = jnp.asarray(np.eye(3, dtype=np.float32))[..., None]
    s = jnp.sum(hn[:, :, None, :] * hn[:, None, :, :], axis=0) - eye
    rotation_only = jnp.max(jnp.abs(s), axis=(0, 1)) < 1e-3

    m00 = _opp_minor(s, 0, 0)
    m11 = _opp_minor(s, 1, 1)
    m22 = _opp_minor(s, 2, 2)
    rt_m00 = jnp.sqrt(jnp.maximum(m00, 0.0))
    rt_m11 = jnp.sqrt(jnp.maximum(m11, 0.0))
    rt_m22 = jnp.sqrt(jnp.maximum(m22, 0.0))
    e12 = _signd(_opp_minor(s, 1, 2))
    e02 = _signd(_opp_minor(s, 0, 2))
    e01 = _signd(_opp_minor(s, 0, 1))

    s00, s11, s22 = s[0, 0], s[1, 1], s[2, 2]
    idx = jnp.argmax(
        jnp.stack([jnp.abs(s00), jnp.abs(s11), jnp.abs(s22)], 0), axis=0
    )

    npa0 = jnp.stack([s00, s[0, 1] + rt_m22, s[0, 2] + e12 * rt_m11], 0)
    npb0 = jnp.stack([s00, s[0, 1] - rt_m22, s[0, 2] - e12 * rt_m11], 0)
    npa1 = jnp.stack([s[0, 1] + rt_m22, s11, s[1, 2] - e02 * rt_m00], 0)
    npb1 = jnp.stack([s[0, 1] - rt_m22, s11, s[1, 2] + e02 * rt_m00], 0)
    npa2 = jnp.stack([s[0, 2] + e01 * rt_m11, s[1, 2] + rt_m00, s22], 0)
    npb2 = jnp.stack([s[0, 2] - e01 * rt_m11, s[1, 2] - rt_m00, s22], 0)
    is0 = (idx == 0)[None]
    is1 = (idx == 1)[None]
    npa = jnp.where(is0, npa0, jnp.where(is1, npa1, npa2))
    npb = jnp.where(is0, npb0, jnp.where(is1, npb1, npb2))

    trace_s = s00 + s11 + s22
    v = 2.0 * jnp.sqrt(jnp.maximum(1.0 + trace_s - m00 - m11 - m22, 0.0))
    s_ii = jnp.where(idx == 0, s00, jnp.where(idx == 1, s11, s22))
    es_ii = _signd(s_ii)
    rnorm = jnp.sqrt(jnp.maximum(2.0 + trace_s + v, 0.0))
    nt = jnp.sqrt(jnp.maximum(2.0 + trace_s - v, 0.0))

    def unit3(x):
        n = jnp.sqrt(jnp.sum(x * x, axis=0, keepdims=True))
        return x / jnp.maximum(n, 1e-12)

    na = unit3(npa)
    nb = unit3(npb)
    half_nt = 0.5 * nt
    esii_t_r = es_ii * rnorm
    ta_star = half_nt[None] * (esii_t_r[None] * nb - nt[None] * na)
    tb_star = half_nt[None] * (esii_t_r[None] * na - nt[None] * nb)

    inv_v = 2.0 / jnp.where(jnp.abs(v) > 1e-30, v, 1e-30)

    def rmat_from(tstar, nvec):
        outer = tstar[:, None] * nvec[None, :]  # [3, 3, B]
        return _mm33(hn, eye - inv_v[None, None] * outer)

    ra = rmat_from(ta_star, na)
    rb = rmat_from(tb_star, nb)
    ta = jnp.sum(ra * ta_star[None], axis=1)
    tb = jnp.sum(rb * tb_star[None], axis=1)

    rots = jnp.stack([ra, ra, rb, rb], axis=0)  # [4, 3, 3, B]
    trans = jnp.stack([ta, -ta, tb, -tb], axis=0)  # [4, 3, B]
    norms = jnp.stack([na, -na, nb, -nb], axis=0)

    ro = rotation_only[None, None, None]
    rots = jnp.where(ro, jnp.broadcast_to(hn[None], rots.shape), rots)
    trans = jnp.where(ro[0], jnp.zeros_like(trans), trans)
    norms = jnp.where(ro[0], jnp.zeros_like(norms), norms)
    n_solutions = jnp.where(rotation_only, 1, 4).astype(jnp.int32)
    return rots, trans, norms, n_solutions


# ---------------------------------------------------------------------------
# quaternion helpers on trailing-batch layouts ([4, ..., B] components)
# ---------------------------------------------------------------------------


def _quat_from_matrix_b(m):
    """Shepperd's method on ``m [S, 3, 3, B]`` -> q ``[S, 4, B]`` (x,y,z,w),
    mirroring ``rotations.quat_from_matrix``."""
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    tr = m00 + m11 + m22

    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) / 2.0
    q0 = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], 1) / jnp.maximum(
        4.0 * qw0, 1e-12
    )[:, None]
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) / 2.0
    q1 = jnp.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], 1) / jnp.maximum(
        4.0 * qx1, 1e-12
    )[:, None]
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) / 2.0
    q2 = jnp.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], 1) / jnp.maximum(
        4.0 * qy2, 1e-12
    )[:, None]
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) / 2.0
    q3 = jnp.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], 1) / jnp.maximum(
        4.0 * qz3, 1e-12
    )[:, None]

    pivots = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], 1)
    best = jnp.argmax(pivots, axis=1)  # [S, B]
    cand = jnp.stack([q0, q1, q2, q3], axis=1)  # [S, 4cand, 4, B]
    oh = (jnp.arange(4)[None, :, None] == best[:, None, :]).astype(m.dtype)
    q = jnp.sum(cand * oh[:, :, None, :], axis=1)  # [S, 4, B]
    n = jnp.sqrt(jnp.sum(q * q, axis=1, keepdims=True))
    return q / jnp.maximum(n, 1e-30)


def _quat_axis_angle_b(q):
    """tf2 getAxis/getAngle on ``q [S, 4, B]`` -> (axis [S,3,B], angle [S,B])."""
    w = jnp.clip(q[:, 3], -1.0, 1.0)
    angle = 2.0 * jnp.arccos(w)
    s2 = 1.0 - w * w
    safe = s2 >= 10.0 * jnp.finfo(q.dtype).eps
    s = jnp.sqrt(jnp.where(safe, s2, 1.0))
    xunit = jnp.asarray([1.0, 0.0, 0.0], q.dtype)[None, :, None]
    axis = jnp.where(safe[:, None], q[:, :3] / s[:, None], xunit)
    return axis, angle


def _quat_from_axis_angle_b(axis, angle):
    """[S,3,B], [S,B] -> [S,4,B]; axis normalized internally."""
    n = jnp.sqrt(jnp.sum(axis * axis, axis=1, keepdims=True))
    axis = axis / jnp.maximum(n, 1e-30)
    half = angle[:, None] * 0.5
    return jnp.concatenate([axis * jnp.sin(half), jnp.cos(half)], axis=1)


def _quat_angle_b(a, b):
    """tf2 Quaternion::angle between [S,4,B] and [4,B] (broadcast)."""
    d = jnp.sum(a * b[None], axis=1) / jnp.sqrt(
        jnp.sum(a * a, axis=1) * jnp.sum(b * b, axis=0)[None]
    )
    return jnp.arccos(jnp.clip(d, -1.0, 1.0))


# ---------------------------------------------------------------------------
# the full chain
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("frame_size", "patch", "shifted_pts_thr", "ransac_iterations"),
)
def get_rt_batch(
    shifts: jnp.ndarray,  # [B, P, 2]
    heights: jnp.ndarray,  # [B]
    dts: jnp.ndarray,  # [B]
    ul_corner_x: jnp.ndarray,
    camera_matrix: jnp.ndarray,  # [3, 3]
    dist_coeffs,  # [5] or None (static fast path)
    c2b_quat: jnp.ndarray,  # [4]
    ang_rate_quats: jnp.ndarray,  # [B, 4]
    keys: jax.Array,  # [B] PRNG keys (draws derive from keys[0]; see module doc)
    *,
    frame_size: int,
    patch: int,
    shifted_pts_thr: int = 8,
    ransac_threshold: float = 0.01,
    ransac_iterations: int = 512,
) -> GetRTResult:
    """Batched ``getRT``: [B, P, 2] pixel shifts -> batched GetRTResult.

    Semantics of :func:`...motion.get_rt` (same gates, same solution
    selection); execution re-laid-out batch-last.
    """
    b = shifts.shape[0]
    sx = shifts[..., 0].T  # [P, B]
    sy = shifts[..., 1].T
    valid = jnp.isfinite(sx) & jnp.isfinite(sy)
    sx = jnp.where(valid, sx, 0.0)
    sy = jnp.where(valid, sy, 0.0)

    centers = grid_centers(frame_size, patch)  # numpy [P, 2]
    cxs = jnp.asarray(centers[:, 0])[:, None]  # [P, 1]
    cys = jnp.asarray(centers[:, 1])[:, None]

    fx = camera_matrix[0, 0]
    fy = camera_matrix[1, 1]
    ccx = camera_matrix[0, 2] - ul_corner_x  # cx -= ulCorner.x (:524)
    ccy = camera_matrix[1, 2]

    ok = jnp.isfinite(1.0 / dts)
    ok &= jnp.sum(valid, axis=0) >= shifted_pts_thr

    # [P, 1] for the shared-camera scalar ul_corner_x; [P, B] when the
    # caller batches per-sample crop offsets (a [B] ul_corner_x) — passed
    # through UN-sliced: _ransac_h_b broadcasts either shape, and slicing
    # column 0 here would silently feed sample 0's grid to every sample
    ax, ay = _undistort_xy(cxs, cys, fx, fy, ccx, ccy, dist_coeffs)
    bx, by = _undistort_xy(cxs + sx, cys + sy, fx, fy, ccx, ccy, dist_coeffs)

    h9, inliers, n_inl, h_ok = _ransac_h_b(
        ax, ay, bx, by, valid, keys[0], ransac_iterations, ransac_threshold
    )
    ok &= h_ok
    ok &= n_inl >= shifted_pts_thr

    h33 = h9.reshape(3, 3, b)
    rots, trans, normals, n_solutions = _decompose_b(h33)

    # --- IMU-nearest solution selection (src/optic_flow.cpp:630-671) ---
    quats = _quat_from_matrix_b(rots)  # [4, 4, B]
    axes, angles = _quat_axis_angle_b(quats)  # [4,3,B], [4,B]
    r_c2b = matrix_from_quat(c2b_quat)  # [3, 3] (single constant-ish quat)
    axes_b = jnp.sum(r_c2b[None, :, :, None] * axes[:, None], axis=2)
    q_rate_b = _quat_from_axis_angle_b(axes_b, angles / dts[None])
    rate_t = ang_rate_quats.T  # [4, B]
    inv_sign = jnp.asarray([-1.0, -1.0, -1.0, 1.0], rate_t.dtype)[:, None]
    d_plus = _quat_angle_b(q_rate_b, rate_t)
    d_minus = _quat_angle_b(q_rate_b, rate_t * inv_sign)
    ang_diffs = jnp.minimum(d_plus, d_minus)  # [4, B]

    usable = jnp.arange(4)[:, None] < n_solutions[None]
    ang_diffs = jnp.where(usable, ang_diffs, jnp.pi + 1.0)
    best = jnp.argmin(ang_diffs, axis=0)  # [B]
    oh = (jnp.arange(4)[:, None] == best[None]).astype(shifts.dtype)  # [4, B]
    best_diff = jnp.sum(ang_diffs * oh, axis=0)
    found = best_diff < jnp.pi
    ok &= found

    multi = n_solutions > 1
    ang_diff_rejected = found & multi & (best_diff > (jnp.pi / 4))
    ok &= jnp.where(multi, best_diff <= (jnp.pi / 4), True)

    nz_best = jnp.sum(normals[:, 2] * oh, axis=0)
    inverse_sol = nz_best >= 0.0
    inv_unit = jnp.where(multi & inverse_sol, -1.0, 1.0)

    r_best = jnp.sum(rots * oh[:, None, None], axis=0)  # [3, 3, B]
    t_best = jnp.sum(trans * oh[:, None], axis=0)  # [3, B]
    axes_best = jnp.sum(axes * oh[:, None], axis=0)  # [3, B]
    angles_best = jnp.sum(angles * oh, axis=0)  # [B]

    tran = jnp.sum(r_best * (inv_unit[None] * t_best)[None], axis=1)
    tran = tran * (heights / dts)[None]
    rot = _quat_from_axis_angle_b(
        axes_best[None], (angles_best / dts)[None]
    )[0]  # [4, B]

    finite = jnp.all(jnp.isfinite(tran), axis=0) & jnp.all(jnp.isfinite(rot), axis=0)
    ok &= finite

    rot_out = jnp.where(ok[None], rot, jnp.nan).T  # [B, 4]
    tran_out = jnp.where(ok[None], tran, jnp.nan).T  # [B, 3]
    return GetRTResult(
        ok=ok,
        rot=rot_out,
        tran=tran_out,
        n_inliers=n_inl,
        ang_diff=best_diff,
        ang_diff_rejected=ang_diff_rejected,
    )
