"""Batched FFT phase correlation — the compute core of the framework.

This is the batched JAX re-design of the reference's fused OpenCL kernel
``phaseCorrelateField`` (``cl/FftMethod.cl:1381-1485``) and of the CPU
fallback ``cv::phaseCorrelate`` path (``src/FftMethod.cpp:1836``).  The math
chain, per patch (reference citations in parentheses):

1. forward 2-D real FFT of both patches (``cl/FftMethod.cl:528-721``),
2. normalized cross-power spectrum ``R = F1 * conj(F2) / sqrt(|F1*conj(F2)|^2
   + FLT_EPSILON)`` — epsilon semantics from ``cmulnormf``
   (``cl/FftMethod.cl:976-982``), conjugation order from the ``MUL_CONJ``
   branch (``cl/FftMethod.cl:1043``, options set in
   ``src/FftMethod.cpp:326``).  Every bin is treated uniformly; the OCL
   kernel's CCS packing special-cases the four real bins (DC/Nyquist) as
   ``1/(F1*F2)`` (``cl/FftMethod.cl:1020-1033``), a format artifact worth
   ~1e-3 px against the 0.1 px conformance budget (ARCHITECTURE.md
   deviation 15),
3. inverse 2-D real FFT with ``1/N^2`` scaling — the CPU path's
   ``cv::idft(DFT_SCALE)`` convention; the live OCL field kernel's
   ``SCALE_VAL`` is identity (its build options never define ``DFT_SCALE``,
   ``src/FftMethod.cpp:305-332``), so its internal maxval runs ``N^2``
   larger.  Shifts are scale-invariant; the unit-normalized ``response``
   matches ``cv::phaseCorrelate``'s published convention
   (ARCHITECTURE.md deviation 15),
4. fftshift + zeroing of shifts beyond ``SEARCH_RADIUS`` on both axes
   (``cl/FftMethod.cl:737-747``, ``:821-830``; radius 55 hard-coded at
   ``src/FftMethod.cpp:819-822``),
5. argmax with lowest-flat-index tie-breaking (``minmaxloc``,
   ``cl/FftMethod.cl:1164-1313``),
6. weighted centroid over a ``(2*radius+1)^2`` window (radius 3,
   ``cl/FftMethod.cl:1478``) of strictly positive values, denominator seeded
   with FLT_EPSILON (``refine``, ``cl/FftMethod.cl:1315-1379``),
7. result expressed relative to the patch centre ``(N>>1, N>>1)``
   (``cl/FftMethod.cl:1373-1374``).

Sign convention: the returned shift ``d`` satisfies ``curr(x) ~= prev(x - d)``
— identical to the reference field kernel invoked as
``phaseCorrelateField(imCurrF, imPrevF)`` (``src/FftMethod.cpp:1825``) and to
the CPU fallback's ``-cv::phaseCorrelate(curr, prev)``
(``src/FftMethod.cpp:1836``).

Where the reference hand-rolls radix-{2,3,4,5,8} butterflies and a plan cache
(``src/FftMethod.cpp:215-565``), here a *whole batch* of patches flows through
one jitted graph; the "plan" is the XLA compilation keyed by shape.  Two
spectral backends are provided:

- ``backend="fft"`` — ``jnp.fft.rfft2``/``irfft2`` (XLA's native FFT),
- ``backend="dft"`` — DFT-by-matmul: for the small patch sizes used here
  (120 px default) the transform is a pair of ``[N,N]`` matmuls per axis.

Both are plain XLA; which one is faster on a given card is a measurement
(``PERF.md``), not a rule.

Everything is shape-polymorphic over leading batch dims: inputs
``[..., N, N]`` produce shifts ``[..., 2]`` (x, y order, like
``cv::Point2f``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# float32 machine epsilon — FLT_EPSILON in the OpenCL kernel
# (cl/FftMethod.cl:979, :1352).
FLT_EPSILON = float(np.finfo(np.float32).eps)

#: default peak-search radius, hard-coded as SEARCH_RADIUS=55 in the
#: reference build options (src/FftMethod.cpp:819-822).
DEFAULT_SEARCH_RADIUS = 55

#: default weighted-centroid radius (cl/FftMethod.cl:1478).
DEFAULT_CENTROID_RADIUS = 3


# ---------------------------------------------------------------------------
# matmul-DFT backend
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_matrices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix ``W[j,k] = exp(-2*pi*i*j*k/n)``.

    Replaces the reference's twiddle-table generation
    (``OCL_FftPlan::fillRadixTable``, ``src/FftMethod.cpp:546-565``): the
    whole transform is a matmul with this constant, computed once per size in
    float64 and cast down.
    """
    j = np.arange(n, dtype=np.float64)
    theta = -2.0 * np.pi * np.outer(j, j) / n
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


# sub-pixel accuracy needs full float32 matmuls — at default precision a
# float32 dot may run in TF32 (GPU tensor cores) or bf16 passes, which costs
# tenths of a pixel of centroid error.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HIGHEST)


def _lmm(w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("jk,...kl->...jl", w, x, precision=_HIGHEST)


def _dft2_real(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2-D DFT of a real input via 6 matmuls. Returns (real, imag)."""
    n = x.shape[-1]
    c, s = (jnp.asarray(m) for m in _dft_matrices(n))
    # rows (last axis): T = X @ W  (W symmetric, so no transpose needed)
    tr = _mm(x, c)
    ti = _mm(x, s)
    # cols: F = W @ T
    fr = _lmm(c, tr) - _lmm(s, ti)
    fi = _lmm(c, ti) + _lmm(s, tr)
    return fr, fi


def _idft2_real_output(rr: jnp.ndarray, ri: jnp.ndarray) -> jnp.ndarray:
    """Real part of the inverse 2-D DFT via 6 matmuls (1/N^2 scaled)."""
    n = rr.shape[-1]
    c, s = (jnp.asarray(m) for m in _dft_matrices(n))
    # conj(W) = C - i*S with S as stored (S holds sin(-theta) = -sin(theta)),
    # i.e. inverse weights are (C, -S).
    ur = _mm(rr, c) + _mm(ri, s)
    ui = _mm(ri, c) - _mm(rr, s)
    out = _lmm(c, ur) + _lmm(s, ui)
    return out * (1.0 / (n * n))


# ---------------------------------------------------------------------------
# correlation surface
# ---------------------------------------------------------------------------


def correlation_surface(
    curr: jnp.ndarray,
    prev: jnp.ndarray,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    backend: str = "fft",
) -> jnp.ndarray:
    """fftshifted, radius-masked phase-correlation surface.

    Steps 1-4 of the module docstring.  ``curr``/``prev``: float32
    ``[..., N, N]``; returns ``[..., N, N]`` with the zero-shift response at
    ``(N//2, N//2)`` and entries beyond ``search_radius`` (per axis) zeroed —
    mirroring the masked/zero-filled writes of ``ifft_multi_radix_rows``
    (``cl/FftMethod.cl:737-747``, ``:821-830``).
    """
    n = curr.shape[-1]
    if curr.shape[-2] != n:
        raise ValueError(f"patches must be square, got {curr.shape[-2]}x{n}")
    if prev.shape != curr.shape:
        raise ValueError(f"curr/prev shapes differ: {curr.shape} vs {prev.shape}")

    # the reference converts frames to CV_32F before correlating
    # (src/FftMethod.cpp:1805-1806); pin float32 regardless of input dtype
    # or the global x64 flag.
    curr = curr.astype(jnp.float32)
    prev = prev.astype(jnp.float32)

    if backend == "fft":
        f1 = jnp.fft.rfft2(curr)
        f2 = jnp.fft.rfft2(prev)
        r = f1 * jnp.conj(f2)
        # cmulnormf: rsqrt(re^2 + im^2 + FLT_EPSILON) (cl/FftMethod.cl:979)
        denom = jax.lax.rsqrt(r.real * r.real + r.imag * r.imag + FLT_EPSILON)
        r = r * denom.astype(r.dtype)
        surf = jnp.fft.irfft2(r, s=(n, n))
    elif backend == "dft":
        f1r, f1i = _dft2_real(curr)
        f2r, f2i = _dft2_real(prev)
        # F1 * conj(F2)
        rr = f1r * f2r + f1i * f2i
        ri = f1i * f2r - f1r * f2i
        denom = jax.lax.rsqrt(rr * rr + ri * ri + FLT_EPSILON)
        rr = rr * denom
        ri = ri * denom
        surf = _idft2_real_output(rr, ri)
    else:
        raise ValueError(f"unknown backend {backend!r} (expected 'fft' or 'dft')")

    surf = jnp.fft.fftshift(surf, axes=(-2, -1))

    # keep |shift| <= search_radius on each axis; the kernel zeroes indices
    # strictly inside (R, N-R) pre-shift, i.e. keeps |s - N//2| <= R after
    # the shift (cl/FftMethod.cl:737, :826).
    idx = jnp.abs(jnp.arange(n) - n // 2) <= search_radius
    mask = idx[:, None] & idx[None, :]
    return jnp.where(mask, surf, 0.0)


# ---------------------------------------------------------------------------
# peak + sub-pixel refine
# ---------------------------------------------------------------------------


def peak_refine(
    surf: jnp.ndarray,
    *,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Argmax + positive-only weighted centroid (steps 5-7).

    ``surf``: ``[..., N, N]`` fftshifted correlation surface.  Returns
    ``(shift, maxval)`` with ``shift[..., 0] = x`` (columns) and
    ``shift[..., 1] = y`` (rows), relative to the centre ``(N//2, N//2)`` as
    in ``refine`` (``cl/FftMethod.cl:1373-1374``).  A NaN surface yields NaN
    shifts — the analogue of the reference's LARGE-SHIFT/uninitialized-maxloc
    path (``src/FftMethod.cpp:461-466``).
    """
    n = surf.shape[-1]
    flat = surf.reshape(surf.shape[:-2] + (n * n,))
    # jnp.argmax ties -> lowest flat index, matching the min-index tie rule of
    # minmaxloc (cl/FftMethod.cl:1250-1253).
    loc = jnp.argmax(flat, axis=-1)
    maxval = jnp.take_along_axis(flat, loc[..., None], axis=-1)[..., 0]
    yc = loc // n
    xc = loc % n

    rows = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    yc_b = yc[..., None, None].astype(jnp.int32)
    xc_b = xc[..., None, None].astype(jnp.int32)
    # window clamp to the array bounds (cl/FftMethod.cl:1342-1345) falls out
    # of the iota-mask formulation for free; positive-values-only per
    # cl/FftMethod.cl:1355.
    in_win = (jnp.abs(rows - yc_b) <= centroid_radius) & (jnp.abs(cols - xc_b) <= centroid_radius)
    w = jnp.where(in_win & (surf > 0.0), surf, 0.0)
    denom = jnp.sum(w, axis=(-2, -1)) + FLT_EPSILON  # seeded sum (cl:1352)
    cx = jnp.sum(w * cols.astype(surf.dtype), axis=(-2, -1)) / denom - (n // 2)
    cy = jnp.sum(w * rows.astype(surf.dtype), axis=(-2, -1)) / denom - (n // 2)

    shift = jnp.stack([cx, cy], axis=-1)
    shift = jnp.where(jnp.isnan(maxval)[..., None], jnp.nan, shift)
    return shift, maxval


def phase_correlate_field(
    curr: jnp.ndarray,
    prev: jnp.ndarray,
    *,
    search_radius: int = DEFAULT_SEARCH_RADIUS,
    centroid_radius: int = DEFAULT_CENTROID_RADIUS,
    backend: str = "fft",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full batched phase correlation: ``[..., N, N]`` pairs -> shifts.

    The one-launch equivalent of the reference's single blocking enqueue per
    frame pair (``src/FftMethod.cpp:398``): the whole patch batch is one XLA
    program.

    Returns ``(shift [..., 2], maxval [...])``.
    """
    surf = correlation_surface(curr, prev, search_radius=search_radius, backend=backend)
    return peak_refine(surf, centroid_radius=centroid_radius)
