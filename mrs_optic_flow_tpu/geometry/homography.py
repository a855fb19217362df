"""Homography estimation and decomposition, jit-compatible.

Replaces the two OpenCV calls at the heart of getRT:

- ``cv::findHomography(undistPtsA, undistPtsB, cv::RANSAC, 0.01)``
  (``src/optic_flow.cpp:558``) -> :func:`find_homography_ransac`.  OpenCV's
  adaptive-iteration RANSAC becomes a *fixed* budget of vmapped 4-point DLT
  hypotheses scored in parallel (SURVEY.md section 7 "hard parts": no
  data-dependent loops under jit), followed by a weighted least-squares DLT
  refit on the consensus set (OpenCV refines with LM; one linear refit is
  within noise for the 16-point grids used here).

- ``cv::decomposeHomographyMat`` (``src/optic_flow.cpp:592``) ->
  :func:`decompose_homography`, the Malis-Vargas analytical decomposition
  (the same algorithm OpenCV implements), returning the fixed 4-solution
  tensor plus a count (1 for the pure-rotation case, else 4).

All points are in *normalized* camera coordinates (the reference undistorts
first and decomposes against an identity camera matrix,
``src/optic_flow.cpp:592``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# JAX's default f32 matmul runs at reduced precision on some backends (TF32
# on GPU tensor cores, bf16 passes elsewhere; ~1e-2 relative error observed);
# geometry needs true float32, so every contraction pins Precision.HIGHEST.
_HI = jax.lax.Precision.HIGHEST


def _dlt_rows(src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted DLT design matrix A [2N, 9] for H mapping src -> dst.

    src, dst: [N, 2]; w: [N] row weights (0 masks a point out).
    Rows per point i:
      [ x y 1 0 0 0 -x*u -y*u -u ]
      [ 0 0 0 x y 1 -x*v -y*v -v ]   with (x,y)=src_i, (u,v)=dst_i.
    """
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], axis=-1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], axis=-1)
    a = jnp.concatenate([r1, r2], axis=0)  # [2N, 9]
    return a * jnp.concatenate([w, w], axis=0)[:, None]


def _norm_h(h: jnp.ndarray) -> jnp.ndarray:
    """Normalize so h22 ~ 1 where possible (OpenCV convention)."""
    scale = jnp.where(jnp.abs(h[..., 2, 2]) > 1e-12, h[..., 2, 2], 1.0)
    return h / scale[..., None, None]


def _solve_h4(src4: jnp.ndarray, dst4: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 point pairs ``[..., 4, 2]`` -> ``[..., 3, 3]``
    (up to scale) — the minimal RANSAC hypothesis in closed form.

    Projective canonical-basis method, division-free: each side's 3x3 map
    takes the canonical basis (e1, e2, e3, e1+e2+e3) to that side's four
    points with columns Cramer-scaled (scaling every column by the base
    determinant leaves the projective map unchanged), and
    ``H = H_dst . adj(H_src)``.  For points in general position this spans
    the 1-D null space of the 8x9 DLT system exactly — what a Gram-Schmidt
    null-space solve computed here before, at ~5% of its FLOPs (the same
    win measured on the batch-last serving path, docs/PERFORMANCE.md
    rule 4).  Degenerate draws (3 collinear / coincident points) yield a
    rank-deficient H whose reprojection error is large, so they lose the
    consensus vote — RANSAC's native failure handling.
    """

    def _side(p):
        a1, a2, a3, a4 = (p[..., i, 0] for i in range(4))
        b1, b2, b3, b4 = (p[..., i, 1] for i in range(4))

        def det(pa, pb, qa, qb, ra, rb):
            # | pa qa ra ; pb qb rb ; 1 1 1 |
            return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb)

        d1 = det(a4, b4, a2, b2, a3, b3)
        d2 = det(a1, b1, a4, b4, a3, b3)
        d3 = det(a1, b1, a2, b2, a4, b4)
        r0 = jnp.stack([d1 * a1, d2 * a2, d3 * a3], axis=-1)
        r1 = jnp.stack([d1 * b1, d2 * b2, d3 * b3], axis=-1)
        r2 = jnp.stack([d1, d2, d3], axis=-1)
        return jnp.stack([r0, r1, r2], axis=-2)

    hs = _side(src4)
    hd = _side(dst4)
    cols = []
    for i in range(3):
        rows = []
        for j in range(3):
            r1, r2 = (r for r in range(3) if r != j)  # adj[i][j] = cof[j][i]
            c1, c2 = (c for c in range(3) if c != i)
            minor = (
                hs[..., r1, c1] * hs[..., r2, c2]
                - hs[..., r1, c2] * hs[..., r2, c1]
            )
            rows.append(minor if (i + j) % 2 == 0 else -minor)
        cols.append(jnp.stack(rows, axis=-1))
    adj = jnp.stack(cols, axis=-2)  # [..., 3, 3]
    return _norm_h(jnp.matmul(hd, adj, precision=_HI))


def _solve_h_svd(a: jnp.ndarray) -> jnp.ndarray:
    """Null vector via SVD of A itself — ~3e-7 accurate in float32 (the
    normal equations square the conditioning).  Reference solver for tests;
    the production refit is :func:`_solve_h_qr_null` (a vmapped iterative
    SVD of small matrices is slow on accelerators)."""
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    return _norm_h(vt[..., -1, :].reshape(a.shape[:-2] + (3, 3)))


def _solve_h_qr_null(a: jnp.ndarray, h0: jnp.ndarray) -> jnp.ndarray:
    """Smallest right-singular vector of ``A`` [..., M, 9] via Householder
    QR + inverse iteration on ``R`` — the fixed-shape replacement for the
    refit SVD.

    QR keeps the conditioning of ``A`` itself (unlike the normal equations,
    which square it), and both stages are fixed-shape batched vector ops:
    9 unrolled Householder reflections, then 3 rounds of inverse iteration
    ``x <- R^{-1} R^{-T} x`` with unrolled triangular solves.  Seeded with
    ``h0`` (the best RANSAC hypothesis, already ~the null vector), it
    converges past float32 eigengap resolution in one round; extra rounds
    cover poor seeds.  Matches :func:`_solve_h_svd` to ~1e-6 on
    well-conditioned consensus sets; rank-deficient sets produce junk that
    the caller's ``ok`` gate discards (same contract as the SVD path).
    """
    k = a.shape[-1]
    r = a
    # Householder triangularization: after step j, column j of r is zeroed
    # below the diagonal.  Only R is needed, so reflectors are not stored.
    for j in range(k):
        col = r[..., :, j]
        below = jnp.arange(r.shape[-2]) >= j
        x = jnp.where(below, col, 0.0)
        normx = jnp.linalg.norm(x, axis=-1, keepdims=True)
        rjj = col[..., j : j + 1]
        sign = jnp.where(rjj >= 0.0, 1.0, -1.0)
        u1 = rjj + sign * normx
        # guard the zero column: v = e_j gives an identity reflection
        safe = normx > 1e-30
        v = jnp.where(safe, x / jnp.where(jnp.abs(u1) > 1e-30, u1, 1.0), 0.0)
        v = v.at[..., j].set(jnp.where(safe[..., 0], 1.0, 0.0))
        tau = jnp.where(
            safe, sign * u1 / jnp.where(normx > 1e-30, normx, 1.0), 0.0
        )
        w = jnp.einsum("...m,...mk->...k", v, r, precision=_HI)
        r = r - tau[..., :, None] * v[..., :, None] * w[..., None, :]
    r = r[..., :k, :]  # [..., 9, 9] upper triangular

    # inverse iteration: x <- R^{-1} R^{-T} x, renormalized each round
    diag = jnp.diagonal(r, axis1=-2, axis2=-1)
    dsafe = jnp.where(jnp.abs(diag) > 1e-12, diag, 1e-12)

    def fwd_solve(b):  # R^T z = b (R^T lower triangular)
        zs = []
        for i in range(k):
            acc = b[..., i]
            for m in range(i):
                acc = acc - r[..., m, i] * zs[m]
            zs.append(acc / dsafe[..., i])
        return jnp.stack(zs, axis=-1)

    def back_solve(b):  # R y = b
        ys = [None] * k
        for i in reversed(range(k)):
            acc = b[..., i]
            for m in range(i + 1, k):
                acc = acc - r[..., i, m] * ys[m]
            ys[i] = acc / dsafe[..., i]
        return jnp.stack(ys, axis=-1)

    x = h0.reshape(h0.shape[:-2] + (k,))
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    for _ in range(3):
        x = back_solve(fwd_solve(x))
        x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return _norm_h(x.reshape(a.shape[:-2] + (3, 3)))


def _project(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply homography h [...,3,3] to pts [N,2] -> [...,N,2]."""
    x = pts[..., 0]
    y = pts[..., 1]
    d = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    d = jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    u = (h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]) / d
    v = (h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]) / d
    return jnp.stack([u, v], axis=-1)


class HomographyResult(NamedTuple):
    h: jnp.ndarray  # [3, 3]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # scalar int32
    ok: jnp.ndarray  # scalar bool


@functools.partial(jax.jit, static_argnames=("iterations",))
def find_homography_ransac(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    *,
    threshold: float = 0.01,
    iterations: int = 512,
) -> HomographyResult:
    """RANSAC homography over masked points.

    ``src``/``dst``: [N, 2] normalized coords; ``valid``: [N] bool (NaN
    windows arrive masked out, the jit-safe version of the NaN-drop loop at
    ``src/optic_flow.cpp:527-547``).  ``threshold`` is the forward
    reprojection distance, 0.01 as in ``src/optic_flow.cpp:558``.

    Invalid points contribute weight 0 everywhere, and hypotheses drawn from
    fewer than 4 distinct valid points lose the consensus vote naturally.
    """
    n = src.shape[0]
    src = jnp.where(valid[:, None], src, 0.0)
    dst = jnp.where(valid[:, None], dst, 0.0)

    p = valid.astype(jnp.float32)
    p_norm = p / jnp.maximum(jnp.sum(p), 1.0)

    def hypothesis(k):
        # 4 distinct valid indices (Gumbel top-k choice without replacement)
        idx = jax.random.choice(k, n, shape=(4,), replace=False, p=p_norm)
        return src[idx], dst[idx]

    keys = jax.random.split(key, iterations)
    src4, dst4 = jax.vmap(hypothesis)(keys)  # [iters, 4, 2] each
    hs = _solve_h4(src4, dst4)  # closed-form minimal solve, no per-sample eigh
    errs = jnp.sum((_project(hs[:, None], src[None]) - dst[None]) ** 2, axis=-1)
    inls = (errs < threshold * threshold) & valid[None, :]
    counts = jnp.sum(inls, axis=-1)
    best = jnp.argmax(counts)
    inliers = inls[best]
    n_inl = counts[best]

    # least-squares refit on the consensus set (stable even if degenerate —
    # the triangular solves always return something; `ok` gates downstream
    # use).  Seeded with the winning hypothesis, which is already near the
    # null direction.
    h = _solve_h_qr_null(
        _dlt_rows(src, dst, inliers.astype(src.dtype)), hs[best]
    )
    ok = n_inl >= 4
    h = jnp.where(ok, h, jnp.eye(3, dtype=src.dtype))
    return HomographyResult(h=h, inliers=inliers, n_inliers=n_inl, ok=ok)


# ---------------------------------------------------------------------------
# Malis-Vargas homography decomposition
# ---------------------------------------------------------------------------


class HomographyDecomposition(NamedTuple):
    rotations: jnp.ndarray  # [4, 3, 3]
    translations: jnp.ndarray  # [4, 3]
    normals: jnp.ndarray  # [4, 3]
    n_solutions: jnp.ndarray  # scalar int32 (1 or 4)


def _opposite_of_minor(m: jnp.ndarray, row: int, col: int) -> jnp.ndarray:
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return m[..., y1, x2] * m[..., y2, x1] - m[..., y1, x1] * m[..., y2, x2]


def _signd(x: jnp.ndarray) -> jnp.ndarray:
    """sign with signd(0) = +1 (OpenCV homography_decomp convention)."""
    return jnp.where(x >= 0.0, 1.0, -1.0)


def _det3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form determinant of ``[..., 3, 3]`` (no batched LU —
    docs/PERFORMANCE.md rule 4)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _sv_middle_3x3(h: jnp.ndarray) -> jnp.ndarray:
    """Middle singular value of a 3x3 via the closed-form (trigonometric)
    eigenvalues of the symmetric ``H^T H`` — replaces ``jnp.linalg.svd``
    whose vmapped QR iteration is slow on accelerators.

    For symmetric A with eigenvalues e1 >= e2 >= e3:
    ``e_k = q + 2 p cos(phi + 2 pi k / 3)`` (Cardano / Smith's method).
    """
    a = jnp.matmul(jnp.swapaxes(h, -1, -2), h, precision=_HI)
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    b = a - q[..., None, None] * jnp.eye(3, dtype=a.dtype)
    p2 = jnp.sum(b * b, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    psafe = jnp.where(p > 1e-30, p, 1.0)
    c = b / psafe[..., None, None]
    det_c = (
        c[..., 0, 0] * (c[..., 1, 1] * c[..., 2, 2] - c[..., 1, 2] * c[..., 2, 1])
        - c[..., 0, 1] * (c[..., 1, 0] * c[..., 2, 2] - c[..., 1, 2] * c[..., 2, 0])
        + c[..., 0, 2] * (c[..., 1, 0] * c[..., 2, 1] - c[..., 1, 1] * c[..., 2, 0])
    )
    rr = jnp.clip(det_c / 2.0, -1.0, 1.0)
    phi = jnp.arccos(rr) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3  # middle eigenvalue of H^T H
    e2 = jnp.where(p > 1e-30, e2, q)  # isotropic case: all eigenvalues = q
    return jnp.sqrt(jnp.maximum(e2, 0.0))


def decompose_homography(h: jnp.ndarray) -> HomographyDecomposition:
    """Analytical Malis-Vargas decomposition of a calibrated homography.

    Returns the same solution set as ``cv::decomposeHomographyMat(H, I)``
    (``src/optic_flow.cpp:592``): up to four ``{R, t, n}`` triples with
    ``H ~ gamma * (R + t n^T)``.  For a (near-)pure rotation, solution 0 is
    ``{H_n, 0, 0}`` and ``n_solutions == 1`` (OpenCV epsilon 1e-3 on
    ``|H^T H - I|``).  Output order matches OpenCV: ``[Ra+, Ra-, Rb+, Rb-]``.

    Runs in float64 when x64 is enabled (the reference's calib3d path is
    CV_64F; the sqrt cancellations here lose ~2 digits in float32).
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    h = jnp.asarray(h, dtype=dtype)

    # normalize by the middle singular value (gamma), sign-correct so that
    # points in front of the camera map with positive depth
    gamma = _sv_middle_3x3(h)
    hn = h / gamma[..., None, None]
    # OpenCV flips the sign so that the decomposition exists: its
    # HomographyDecomp normalizes to det(Hn) > 0 (a reflection admits no
    # R/t/n factoring into proper rotations). sign(h22) is NOT equivalent:
    # det(H) < 0 with h22 > 0 yields four det(R) = -1 solutions (verified
    # against cv2 on random homographies). In-pipeline findHomography fixes
    # h22 = 1, so this only matters for degenerate/junk fits — exactly the
    # case that must not fabricate a plausible rotation.
    hn = hn * _signd(_det3x3(hn))[..., None, None]

    s = jnp.matmul(hn.swapaxes(-1, -2), hn, precision=_HI) - jnp.eye(3, dtype=hn.dtype)
    rotation_only = jnp.max(jnp.abs(s), axis=(-2, -1)) < 1e-3  # per-batch

    m00 = _opposite_of_minor(s, 0, 0)
    m11 = _opposite_of_minor(s, 1, 1)
    m22 = _opposite_of_minor(s, 2, 2)
    rt_m00 = jnp.sqrt(jnp.maximum(m00, 0.0))
    rt_m11 = jnp.sqrt(jnp.maximum(m11, 0.0))
    rt_m22 = jnp.sqrt(jnp.maximum(m22, 0.0))
    m01 = _opposite_of_minor(s, 0, 1)
    m12 = _opposite_of_minor(s, 1, 2)
    m02 = _opposite_of_minor(s, 0, 2)
    e12, e02, e01 = _signd(m12), _signd(m02), _signd(m01)

    s00, s11, s22 = s[..., 0, 0], s[..., 1, 1], s[..., 2, 2]
    idx = jnp.argmax(jnp.stack([jnp.abs(s00), jnp.abs(s11), jnp.abs(s22)], -1), axis=-1)

    npa0 = jnp.stack([s00, s[..., 0, 1] + rt_m22, s[..., 0, 2] + e12 * rt_m11], -1)
    npb0 = jnp.stack([s00, s[..., 0, 1] - rt_m22, s[..., 0, 2] - e12 * rt_m11], -1)
    npa1 = jnp.stack([s[..., 0, 1] + rt_m22, s11, s[..., 1, 2] - e02 * rt_m00], -1)
    npb1 = jnp.stack([s[..., 0, 1] - rt_m22, s11, s[..., 1, 2] + e02 * rt_m00], -1)
    npa2 = jnp.stack([s[..., 0, 2] + e01 * rt_m11, s[..., 1, 2] + rt_m00, s22], -1)
    npb2 = jnp.stack([s[..., 0, 2] - e01 * rt_m11, s[..., 1, 2] - rt_m00, s22], -1)
    sel = [(idx == 0)[..., None], (idx == 1)[..., None]]
    npa = jnp.select(sel, [npa0, npa1], npa2)
    npb = jnp.select(sel, [npb0, npb1], npb2)

    trace_s = s00 + s11 + s22
    v = 2.0 * jnp.sqrt(jnp.maximum(1.0 + trace_s - m00 - m11 - m22, 0.0))
    s_ii = jnp.select([idx == 0, idx == 1], [s00, s11], s22)
    es_ii = _signd(s_ii)
    r = jnp.sqrt(jnp.maximum(2.0 + trace_s + v, 0.0))
    nt = jnp.sqrt(jnp.maximum(2.0 + trace_s - v, 0.0))

    def unit(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    na = unit(npa)
    nb = unit(npb)
    half_nt = 0.5 * nt
    esii_t_r = es_ii * r
    ta_star = half_nt[..., None] * (esii_t_r[..., None] * nb - nt[..., None] * na)
    tb_star = half_nt[..., None] * (esii_t_r[..., None] * na - nt[..., None] * nb)

    def rmat_from(tstar, nvec):
        # R = Hn (I - (2/v) tstar n^T)
        outer = tstar[..., :, None] * nvec[..., None, :]
        inv_v = (2.0 / v)[..., None, None]
        return jnp.matmul(hn, jnp.eye(3, dtype=hn.dtype) - inv_v * outer, precision=_HI)

    ra = rmat_from(ta_star, na)
    rb = rmat_from(tb_star, nb)
    ta = jnp.matmul(ra, ta_star[..., :, None], precision=_HI)[..., 0]
    tb = jnp.matmul(rb, tb_star[..., :, None], precision=_HI)[..., 0]

    rots = jnp.stack([ra, ra, rb, rb], axis=-3)
    trans = jnp.stack([ta, -ta, tb, -tb], axis=-2)
    norms = jnp.stack([na, -na, nb, -nb], axis=-2)

    # pure-rotation fallback in slot 0
    ro_m = rotation_only[..., None, None, None]  # broadcast over [sol, 3, 3]
    ro_v = rotation_only[..., None, None]  # broadcast over [sol, 3]
    rots = jnp.where(ro_m, jnp.broadcast_to(hn[..., None, :, :], rots.shape), rots)
    trans = jnp.where(ro_v, jnp.zeros_like(trans), trans)
    norms = jnp.where(ro_v, jnp.zeros_like(norms), norms)
    n_solutions = jnp.where(rotation_only, 1, 4).astype(jnp.int32)
    return HomographyDecomposition(rots, trans, norms, n_solutions)
