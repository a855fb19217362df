"""On-device log-polar resampling (``cv::logPolar`` equivalent).

Feeds the scale/rotation estimator (``src/scaleRotationEstimator.cpp:34-148``):
phase correlation of two log-polar images turns scale into an x-shift and
rotation into a y-shift, decoded as ``scale = exp(dx / M)`` and
``rot = (dy / Ky) * pi/180`` with ``Ky = resolution / 360``
(``src/scaleRotationEstimator.cpp:28``, ``:123-124``).

Sampling convention matches OpenCV's dense inverse map (``cv::logPolar`` is
``warpPolar(..., WARP_POLAR_LOG)`` in the OpenCV 4.x the reference builds
against): output pixel ``(row=phi_idx, col=rho_idx)`` samples the source at
``center + (exp(rho_idx / M) - 1) * (cos(phi), sin(phi))`` with
``phi = phi_idx * 2*pi / rows`` — the ``-1`` pins rho=0 exactly to the
centre and is verified to 1e-5 against ``cv2.warpPolar`` in
``tests/test_logpolar.py``.  Two interpolators:

- ``interp="lanczos4"`` (default) — the reference's request
  (``cv::INTER_LANCZOS4``, ``src/scaleRotationEstimator.cpp:113``): an 8x8
  separable-weight windowed-sinc tap stencil with per-axis normalized
  weights and zero border (``cv::remap`` BORDER_CONSTANT semantics);
- ``interp="bilinear"`` — 2x2 tap stencil, same border semantics.

Execution: the resample is computed as ONE-HOT SEPARABLE MATMULS, not
gathers.  For each output row (fixed phi) the per-axis tap weights are
scattered into dense ``[C, N]`` matrices (8 broadcast compares per axis) and
contracted against the image as a matmul:

    T[y, c]  = sum_x img[y, x] * Wx[c, x]        (matmul)
    out[c]   = sum_y Wy[c, y] * T[y, c]          (elementwise + reduce)

The matmul form was chosen on the accelerator this was first built for,
where gathers were slow; whether a gather wins on the GPU is not measured
yet.  The one-hot form is dense and batches over frames.  Output rows are processed in chunks under ``lax.map`` to bound the dense
weight temporaries.

Two execution paths share these semantics: the per-frame path above (any
geometry), and the PRECOMPUTED fast path (:func:`build_lp_plan` +
``plan``/``weights`` arguments) that exploits the grid's octant symmetry and
static windows — see the "Precomputed-weight fast path" comment block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.ops.preprocess import is_8bit

#: the 8 Lanczos-4 taps around floor(coord)
_LANCZOS4_OFFSETS = np.arange(-3, 5)


def _lanczos4_weights(frac: jnp.ndarray) -> jnp.ndarray:
    """Normalized Lanczos-4 weights ``[..., 8]`` for fractional offsets
    ``frac`` in [0, 1).  ``L(t) = sinc(t) * sinc(t/4)`` for ``|t| < 4``;
    per-sample normalization to unit sum mirrors OpenCV's
    ``interpolateLanczos4`` coefficient tables."""
    t = frac[..., None] - jnp.asarray(_LANCZOS4_OFFSETS, jnp.float32)
    # jnp.sinc is the normalized sinc: sin(pi t)/(pi t), sinc(0) = 1
    w = jnp.sinc(t) * jnp.sinc(t / 4.0)
    return w / jnp.sum(w, axis=-1, keepdims=True)


def _bilinear_weights(frac: jnp.ndarray) -> jnp.ndarray:
    """Bilinear weights ``[..., 2]`` for taps at offsets (0, 1)."""
    return jnp.stack([1.0 - frac, frac], axis=-1)


def _one_hot_weight_matrix(
    idx0: jnp.ndarray, w: jnp.ndarray, offsets: np.ndarray, n: int
) -> jnp.ndarray:
    """Scatter per-pixel tap weights into a dense ``[..., N]`` matrix.

    ``idx0`` ``[...,]`` int32 tap origins, ``w`` ``[..., T]`` weights,
    ``offsets`` the T tap offsets.  Out-of-range taps fall outside the iota
    and contribute nothing — exactly ``cv::remap`` BORDER_CONSTANT zeros.
    """
    iota = jnp.arange(n, dtype=jnp.int32)
    dense = jnp.zeros(idx0.shape + (n,), jnp.float32)
    for k, off in enumerate(offsets):
        hit = (idx0 + np.int32(off))[..., None] == iota  # [..., N]
        dense = dense + hit.astype(jnp.float32) * w[..., k : k + 1]
    return dense


def _resample_separable(
    img: jnp.ndarray,
    y: jnp.ndarray,
    x: jnp.ndarray,
    *,
    offsets: np.ndarray,
    weight_fn,
    rows_per_chunk: int = 8,
    img_exact_bf16: bool = False,
) -> jnp.ndarray:
    """Sample ``img`` [H, W] at float coords (``y``, ``x``) [R, C] with a
    separable tap stencil via one-hot matmuls (module docstring).  Output
    rows are processed ``rows_per_chunk`` at a time under ``lax.map``; the
    dense weight temporaries per chunk are ``2 * G * C * N`` floats."""
    h, w = img.shape[-2], img.shape[-1]
    r, c = y.shape

    y0 = jnp.floor(y)
    x0 = jnp.floor(x)
    wy = weight_fn((y - y0).astype(jnp.float32))  # [R, C, T]
    wx = weight_fn((x - x0).astype(jnp.float32))
    # clamp origins into a harmless range: any stencil fully outside the
    # image has all-zero one-hot rows anyway, and the clamp keeps the int32
    # compare domain tight (exp(rho/M) can reach ~1e4 off-image)
    y0i = jnp.clip(y0, -16.0, h + 16.0).astype(jnp.int32)
    x0i = jnp.clip(x0, -16.0, w + 16.0).astype(jnp.int32)

    g = min(rows_per_chunk, r)
    n_chunks = -(-r // g)
    pad_rows = n_chunks * g - r

    def _chunks(a):
        if pad_rows:
            a = jnp.pad(a, ((0, pad_rows),) + ((0, 0),) * (a.ndim - 1))
        return a.reshape((n_chunks, g) + a.shape[1:])

    def _split(a):
        hi = a.astype(jnp.bfloat16)
        lo = (a - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return hi, lo

    img_hi, img_lo = _split(img)

    def _one(args):
        y0c, x0c, wyc, wxc = args  # [G, C](, T)
        wx_d = _one_hot_weight_matrix(x0c, wxc, offsets, w)  # [G, C, N]
        wy_d = _one_hot_weight_matrix(y0c, wyc, offsets, h)  # [G, C, N]
        # T1[g, y, c] = sum_x img[y, x] * wx_d[g, c, x] via the bf16 hi/lo
        # operand split (3 passes ~ 2e-5 relative error) with float32
        # accumulation
        wx_hi, wx_lo = _split(wx_d)

        def ein(a, b):
            return jnp.einsum("yx,gcx->gyc", a, b,
                              preferred_element_type=jnp.float32)

        t1 = ein(img_hi, wx_hi) + ein(img_hi, wx_lo)
        if not img_exact_bf16:
            t1 = t1 + ein(img_lo, wx_hi)
        # (8-bit integer frames are exact in bf16, so img_lo == 0 and its
        # pass is dropped)
        # out[g, c] = sum_y wy_d[g, c, y] * T1[g, y, c] — pinned to HIGHEST:
        # at default precision a float32 dot may run in TF32 or bf16
        # (~4e-3 relative), silently undoing the hi/lo split above
        return jnp.einsum("gcy,gyc->gc", wy_d, t1,
                          precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(
        _one, (_chunks(y0i), _chunks(x0i), _chunks(wy), _chunks(wx))
    )
    return out.reshape(-1, c)[:r]


def _interp_taps(interp: str):
    """(offsets, jnp weight_fn) for an interpolator name; shared by the
    per-frame builder (v1) and the precomputed-plan builder (v2)."""
    if interp == "lanczos4":
        return _LANCZOS4_OFFSETS, _lanczos4_weights
    if interp == "bilinear":
        return np.arange(2), _bilinear_weights
    raise ValueError(
        f"unknown interp {interp!r} (expected 'lanczos4' or 'bilinear')"
    )


def _static_trim(n: int, res: int, magnitude: float, offsets: np.ndarray) -> int:
    """Live log-polar column count (static rho trim), rounded up to a
    multiple of 128 columns.  A tap at integer index floor(coord)+off contributes only
    if it lands in [0, n); any sample farther from the centre than the
    image corner plus the stencil margin hits only zeros (BORDER_CONSTANT),
    so those columns are provably all-zero."""
    margin = float(max(abs(int(offsets[0])), int(offsets[-1]))) + 1.0
    r_max = float(np.sqrt(2.0)) * (n / 2.0 + margin)
    r_np = np.exp(np.arange(res, dtype=np.float64) / magnitude) - 1.0
    c_used = int(np.searchsorted(r_np > r_max, True))
    return min(res, -(-max(c_used, 1) // 128) * 128)


# ---------------------------------------------------------------------------
# Precomputed-weight fast path (v2)
#
# The sampling grid is STATIC (it depends only on (n, res, magnitude,
# interp)), so the dense one-hot weight matrices need not be rebuilt on
# device every frame — and the grid has the dihedral symmetry of the square:
# with ``res`` divisible by 8, output row p+k*res/8 samples the image at the
# row-p positions reflected/rotated by k*45 deg.  Since the centre is
# exactly (n/2, n/2), every octant's sample coordinate per axis is one of
# just FOUR static coordinate families over p in [0, res/8]:
#
#     cos+ : n/2 + r*cos(phi_p)      sin+ : n/2 + r*sin(phi_p)
#     cos- : n/2 - r*cos(phi_p)      sin- : n/2 - r*sin(phi_p)
#
# so only 4 weight tensors of res/8+1 rows are precomputed (numpy, float64
# tap math) instead of building res full rows on device per frame, and the
# 8 octants' first-pass matmuls collapse to 4 shared ones:
#
#     t1[W](p, y, c) = sum_x img[y, x] * W[p, c, x]        (matmul)
#     row of octant o = sum_y A[p, c, y] * t1[B](p, y, c)  (multiply-reduce)
#
# with (A, B) the octant's (y, x) coordinate families.  Two further static
# trims fall out of the geometry: per 128-column rho chunk, (a) the image
# columns any stencil tap can touch (the x window) and (b) the t1 rows its
# two consumers' y windows span are bounded by the chunk's radius range, so
# both matmul operands are sliced to static windows (~7x fewer matmul FLOPs
# at the production 480/49.9 geometry).
#
# The tensors are returned as a flat tuple of arrays and must be threaded
# into jitted programs as ARGUMENTS: a traced-over concrete array becomes an
# HLO literal (measured: a 45 MB closure constant produced 90 MB of HLO and
# a multi-second XLA constant-folding stall), which would bloat every
# compile that fuses the estimator.
# ---------------------------------------------------------------------------


#: octant o -> (y coordinate family, x coordinate family), indices into
#: (cos+, sin+, cos-, sin-); octant o covers output rows
#: [o*res/8, (o+1)*res/8], traversed forward for even o, backward for odd
_OCTANT_COMBOS = (
    (1, 0),  # o0:        phi -> x = cos+, y = sin+
    (0, 1),  # o1:  pi/2 - phi -> x = sin+, y = cos+
    (0, 3),  # o2:  pi/2 + phi -> x = sin-, y = cos+
    (1, 2),  # o3:    pi - phi -> x = cos-, y = sin+
    (3, 2),  # o4:    pi + phi -> x = cos-, y = sin-
    (2, 3),  # o5: 3pi/2 - phi -> x = sin-, y = cos-
    (2, 1),  # o6: 3pi/2 + phi -> x = sin+, y = cos-
    (3, 0),  # o7:   2pi - phi -> x = cos+, y = sin-
)

#: x-pass tensor b is consumed by octants with these y families
_T1_CONSUMERS = {0: (1, 3), 1: (0, 2), 2: (1, 3), 3: (0, 2)}


@dataclasses.dataclass(frozen=True)
class LPPlan:
    """Static schedule of the precomputed log-polar resample (hashable —
    rides jit static args; the matching weight arrays ride as arguments)."""

    n: int
    res: int
    c_used: int
    p8: int  # rows per octant family: res // 8 + 1
    interp: str
    #: the optimM the rho grid was built for — carried so the fast path can
    #: reject a plan/magnitude mismatch (the weights bake the grid in; a
    #: silent mismatch would skew the decode by the magnitude ratio)
    magnitude: float
    #: per rho chunk: (c0, c1, x windows ((lo, len) x 4 tensors),
    #: t1 y ranges ((lo, len) x 4 tensors))
    chunks: Tuple[tuple, ...]
    #: output row q -> flat index into the [8 * p8] computed-row stack
    assembly: Tuple[int, ...]


def _np_weights(frac: np.ndarray, interp: str) -> np.ndarray:
    """float64 tap weights [..., T]; same math as the jnp weight fns."""
    if interp == "lanczos4":
        t = frac[..., None] - _LANCZOS4_OFFSETS.astype(np.float64)
        w = np.sinc(t) * np.sinc(t / 4.0)
        return w / np.sum(w, axis=-1, keepdims=True)
    return np.stack([1.0 - frac, frac], axis=-1)


def _win_round(lo: int, hi: int, n: int, quantum: int) -> Tuple[int, int]:
    """Round window [lo, hi) up to a multiple of ``quantum`` inside [0, n]
    (padding only adds zero-weight taps — lane/sublane alignment for free)."""
    lo, hi = max(0, lo), min(n, hi)
    if hi <= lo:
        return 0, 0
    ln = -(-(hi - lo) // quantum) * quantum
    hi = min(n, lo + ln)
    lo = max(0, hi - ln)
    return lo, min(n, lo + ln) - lo


def build_lp_plan(
    n: int,
    magnitude: float,
    *,
    resolution: Optional[int] = None,
    interp: str = "lanczos4",
) -> Optional[Tuple[LPPlan, Tuple[np.ndarray, ...]]]:
    """Precompute the plan + weight tensors for :func:`logpolar`'s fast
    path.  Returns ``None`` when the geometry lacks the 8-fold symmetry
    (``res % 8 != 0``) — callers fall back to the per-frame builder.  The
    returned arrays are numpy; callers device-put them once and thread them
    as jit arguments (see module comment)."""
    import ml_dtypes

    res = resolution or n
    offsets, _ = _interp_taps(interp)
    if res % 8 or res < 8:
        return None
    magnitude = float(magnitude)
    c_used = _static_trim(n, res, magnitude, offsets)
    s = res // 8
    p8 = s + 1
    c = n / 2.0

    phi = np.arange(p8, dtype=np.float64) * (2.0 * np.pi / res)
    r = np.exp(np.arange(c_used, dtype=np.float64) / magnitude) - 1.0
    # the four coordinate families [p8, c_used]
    fams = [
        c + r[None, :] * np.cos(phi)[:, None],
        c + r[None, :] * np.sin(phi)[:, None],
        c - r[None, :] * np.cos(phi)[:, None],
        c - r[None, :] * np.sin(phi)[:, None],
    ]
    t_off0, t_off1 = int(offsets[0]), int(offsets[-1])

    chunks = []
    weights: list[np.ndarray] = []
    for c0 in range(0, c_used, 128):
        c1 = min(c_used, c0 + 128)
        xwins = []
        dense = []
        for u in fams:
            uc = u[:, c0:c1]
            idx0 = np.floor(uc).astype(np.int64)
            # image columns any tap can touch, clipped to the image
            lo, ln = _win_round(
                int(idx0.min()) + t_off0, int(idx0.max()) + t_off1 + 1, n, 128
            )
            xwins.append((lo, ln))
            w = _np_weights(uc - np.floor(uc), interp)  # [p8, cc, T]
            d = np.zeros((p8, c1 - c0, max(ln, 1)), np.float64)
            pg, cg = np.indices(idx0.shape)
            for k, off in enumerate(offsets):
                j = idx0 + int(off)
                valid = (j >= lo) & (j < lo + ln) & (j >= 0) & (j < n)
                np.add.at(
                    d,
                    (pg, cg, np.clip(j - lo, 0, max(ln - 1, 0))),
                    w[..., k] * valid,
                )
            dense.append(d if ln else d[..., :0])
        # t1 rows each x-pass tensor must cover: the union of its two
        # consumers' y windows (a hole between disjoint windows is covered
        # — simpler, and only the far chunk's unions approach full height)
        yranges = []
        for b in range(4):
            spans = [xwins[a] for a in _T1_CONSUMERS[b]]
            spans = [sp for sp in spans if sp[1]]
            if not spans or xwins[b][1] == 0:
                yranges.append((0, 0))
                continue
            lo = min(sp[0] for sp in spans)
            hi = max(sp[0] + sp[1] for sp in spans)
            yranges.append(_win_round(lo, hi, n, 8))
        chunks.append((c0, c1, tuple(xwins), tuple(yranges)))
        for d in dense:
            f32 = d.astype(np.float32)
            hi_ = f32.astype(ml_dtypes.bfloat16)
            lo_ = (f32 - hi_.astype(np.float32)).astype(ml_dtypes.bfloat16)
            weights += [hi_, lo_]

    # output row q of octant k = q // s: row q - k*s of family k (even k)
    # or row (k+1)*s - q (odd k); octant-boundary rows are computed twice
    # (identical values) — the even-octant copy is used
    assembly = []
    for q in range(res):
        k = q // s
        p = (q - k * s) if k % 2 == 0 else ((k + 1) * s - q)
        assembly.append(k * p8 + p)

    plan = LPPlan(
        n=n, res=res, c_used=c_used, p8=p8, interp=interp,
        magnitude=float(magnitude),
        chunks=tuple(chunks), assembly=tuple(assembly),
    )
    return plan, tuple(weights)


def _resample_v2(
    img: jnp.ndarray,
    weights: Tuple[jnp.ndarray, ...],
    plan: LPPlan,
    img_exact_bf16: bool,
) -> jnp.ndarray:
    """Precomputed-weight log-polar resample (see module comment): 4 shared
    windowed x-pass matmuls + 8 windowed y-pass reductions per rho chunk,
    rows assembled by the static octant map.  ``img`` [n, n] float32."""
    img_hi = img.astype(jnp.bfloat16)
    img_lo = (img - img_hi.astype(jnp.float32)).astype(jnp.bfloat16)

    octant_rows = [[] for _ in range(8)]  # per octant, per chunk [p8, cc]
    wi = 0
    for (c0, c1, xwins, yranges) in plan.chunks:
        cc = c1 - c0
        t1 = [None] * 4
        wf32 = [None] * 4
        for b in range(4):
            w_hi, w_lo = weights[wi], weights[wi + 1]
            wi += 2
            (xlo, xln), (ylo, yln) = xwins[b], yranges[b]
            # y-side operand: the same tensor recombined to f32 (fuses into
            # the reduce; avoids keeping a third f32 copy resident)
            wf32[b] = w_hi.astype(jnp.float32) + w_lo.astype(jnp.float32)
            if xln == 0 or yln == 0:
                continue
            sl_hi = jax.lax.slice(img_hi, (ylo, xlo), (ylo + yln, xlo + xln))

            def ein(a, w):
                return jnp.einsum(
                    "yx,pcx->pyc", a, w, preferred_element_type=jnp.float32
                )

            a = ein(sl_hi, w_hi) + ein(sl_hi, w_lo)
            if not img_exact_bf16:
                sl_lo = jax.lax.slice(
                    img_lo, (ylo, xlo), (ylo + yln, xlo + xln)
                )
                a = a + ein(sl_lo, w_hi)
            t1[b] = a  # [p8, yln, cc]
        for o, (a_f, b_f) in enumerate(_OCTANT_COMBOS):
            (alo, aln) = xwins[a_f]
            if t1[b_f] is None or aln == 0:
                octant_rows[o].append(jnp.zeros((plan.p8, cc), jnp.float32))
                continue
            ylo_b = yranges[b_f][0]
            tb = jax.lax.slice_in_dim(
                t1[b_f], alo - ylo_b, alo - ylo_b + aln, axis=1
            )
            # pinned to HIGHEST like the v1 path: both operands are f32 and
            # a default-precision dot may round them to TF32 or bf16
            octant_rows[o].append(
                jnp.einsum(
                    "pcy,pyc->pc", wf32[a_f], tb,
                    precision=jax.lax.Precision.HIGHEST,
                )
            )

    rows8 = jnp.stack(
        [jnp.concatenate(rows, axis=-1) for rows in octant_rows]
    )  # [8, p8, c_used]
    flat = rows8.reshape(8 * plan.p8, plan.c_used)
    out = jnp.take(
        flat, jnp.asarray(np.asarray(plan.assembly, np.int32)), axis=0
    )
    if plan.c_used < plan.res:
        out = jnp.concatenate(
            [out, jnp.zeros((plan.res, plan.res - plan.c_used), jnp.float32)],
            axis=-1,
        )
    return out


def logpolar(
    img: jnp.ndarray,
    magnitude,
    *,
    resolution: int | None = None,
    interp: str = "lanczos4",
    rows_per_chunk: int = 8,
    plan: Optional[LPPlan] = None,
    weights: Optional[Tuple[jnp.ndarray, ...]] = None,
) -> jnp.ndarray:
    """Log-polar transform of a square ``[N, N]`` image.

    ``magnitude`` is the reference's ``optimM`` scale parameter
    (``scale_rot_magnitude``, ``config/default.yaml:14``) — a Python float
    (it comes from config; a concrete array is accepted and canonicalized).
    It is STATIC: with the rho grid known at trace time, every output
    column whose radius exceeds the farthest sample any stencil tap can
    touch (image corner + tap margin) is provably all-zero under the
    BORDER_CONSTANT semantics, so only the live columns (rounded up to the
    a multiple of 128) are resampled and the zeros are concatenated back —
    bit-identical output with fewer matmul FLOPs at the production
    geometry (480 px, optimM 49.9: rays exit the image by rho ~ 293, so
    384 of 480 columns are computed).

    ``resolution`` sets the output size (defaults to N — the reference's
    square geometry); a smaller output trades decode resolution for speed,
    with the decode constants rescaled by the caller (see
    ``ScaleRotationEstimator``).  ``rows_per_chunk`` bounds the dense
    one-hot weight temporaries (output rows per ``lax.map`` step) of the
    per-frame path.

    ``plan``/``weights`` (from :func:`build_lp_plan`, device-put by the
    caller) select the precomputed-weight fast path: no per-frame weight
    build, 4 shared octant-symmetric x-pass matmuls, static x/y windows.
    Both paths produce the same resample (v2's tap math is float64 at build
    time; conformance is pinned by the same cv2 oracle tests).
    """
    if (plan is None) != (weights is None):
        raise ValueError("plan and weights must be supplied together")
    if plan is not None:
        n = img.shape[-1]
        if plan.n != n or plan.interp != interp:
            raise ValueError(
                f"plan was built for n={plan.n}/{plan.interp}, "
                f"got n={n}/{interp}"
            )
        # the weights bake the rho/phi grid in, so magnitude/resolution
        # mismatches must fail loudly — a silent mismatch skews the decode
        # by the magnitude ratio (scale = exp(dx/M))
        if abs(plan.magnitude - float(magnitude)) > 1e-9:
            raise ValueError(
                f"plan was built for magnitude={plan.magnitude}, "
                f"got {float(magnitude)}"
            )
        if resolution is not None and plan.res != resolution:
            raise ValueError(
                f"plan was built for resolution={plan.res}, got {resolution}"
            )
        return _logpolar_v2_impl(img, weights, plan=plan)
    return _logpolar_impl(
        img,
        magnitude=float(magnitude),
        resolution=resolution,
        interp=interp,
        rows_per_chunk=int(rows_per_chunk),
    )


@functools.partial(jax.jit, static_argnames=("plan",))
def _logpolar_v2_impl(
    img: jnp.ndarray, weights: Tuple[jnp.ndarray, ...], *, plan: LPPlan
) -> jnp.ndarray:
    # 8-bit integer frames are exact in bf16 — drop the low-order image
    # pass (the ONE predicate: preprocess.is_8bit)
    return _resample_v2(
        img.astype(jnp.float32), weights, plan, is_8bit(img.dtype)
    )


@functools.partial(
    jax.jit,
    static_argnames=("magnitude", "resolution", "interp", "rows_per_chunk"),
)
def _logpolar_impl(
    img: jnp.ndarray,
    *,
    magnitude: float,
    resolution: int | None,
    interp: str,
    rows_per_chunk: int,
) -> jnp.ndarray:
    n = img.shape[-1]
    res = resolution or n
    # 8-bit integer frames (the node's uint8 grayscale carry) are exact in
    # bf16 — the resample drops its low-order image pass (1 of 3 matmul
    # passes; the ONE predicate: preprocess.is_8bit)
    exact = is_8bit(img.dtype)
    img = img.astype(jnp.float32)
    offsets, weight_fn = _interp_taps(interp)

    # static rho trim — see _static_trim
    c_used = _static_trim(n, res, magnitude, offsets)

    rho = jnp.arange(c_used, dtype=jnp.float32)
    phi = jnp.arange(res, dtype=jnp.float32) * (2.0 * jnp.pi / res)
    r = jnp.exp(rho / jnp.float32(magnitude)) - 1.0
    cx = n / 2.0
    cy = n / 2.0
    x = cx + r[None, :] * jnp.cos(phi)[:, None]
    y = cy + r[None, :] * jnp.sin(phi)[:, None]
    out = _resample_separable(
        img, y, x, offsets=offsets, weight_fn=weight_fn,
        rows_per_chunk=rows_per_chunk, img_exact_bf16=exact,
    )
    if c_used < res:
        out = jnp.concatenate(
            [out, jnp.zeros((res, res - c_used), jnp.float32)], axis=-1
        )
    return out
