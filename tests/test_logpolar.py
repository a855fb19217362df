"""Log-polar resample conformance + interpolation-quality quantification.

The reference requests Lanczos4 resampling for its log-polar transform
(``cv::INTER_LANCZOS4``, ``src/scaleRotationEstimator.cpp:113``).  These
tests pin our sampler to the OpenCV oracle (``cv2.warpPolar`` with
``WARP_POLAR_LOG`` — what ``cv::logPolar`` delegates to in OpenCV 4.x) and
quantify the scale/rotation decode accuracy of both interpolators on
textured frames — the measurement VERDICT.md round 1 asked for.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mrs_optic_flow_tpu.ops.logpolar import logpolar

from oracle import smooth_random_image


def _texture(rng, n):
    return smooth_random_image(rng, n)  # already 0..255 float32


def _cv2_logpolar(img, m, flags):
    import cv2

    n = img.shape[0]
    max_r = float(np.exp(n / m))
    return cv2.warpPolar(
        img, (n, n), (n / 2, n / 2), max_r, flags + cv2.WARP_POLAR_LOG
    )


# interior columns: inside the source disc, away from the centre singularity
def _interior(m, n):
    rho_max = int(m * np.log(n / 2 - 6))
    return np.s_[:, 4:rho_max]


def test_logpolar_bilinear_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    n, m = 128, 20.0
    img = _texture(rng, n)
    ours = np.asarray(logpolar(jnp.asarray(img), jnp.float32(m), interp="bilinear"))
    ref = _cv2_logpolar(img, m, cv2.INTER_LINEAR)
    sl = _interior(m, n)
    assert np.abs(ours[sl] - ref[sl]).max() < 0.01  # 0-255 scale


def test_logpolar_lanczos4_matches_opencv(rng):
    """Float Lanczos-4 vs OpenCV's fixed-point (2^15-quantized) tables:
    sub-1% of the 0-255 range everywhere in the interior."""
    cv2 = pytest.importorskip("cv2")
    n, m = 128, 20.0
    img = _texture(rng, n)
    ours = np.asarray(logpolar(jnp.asarray(img), jnp.float32(m), interp="lanczos4"))
    ref = _cv2_logpolar(img, m, cv2.INTER_LANCZOS4)
    sl = _interior(m, n)
    assert np.abs(ours[sl] - ref[sl]).mean() < 1.0
    assert np.abs(ours[sl] - ref[sl]).max() < 5.0


@pytest.mark.parametrize("interp", ["lanczos4", "bilinear"])
def test_logpolar_uint8_exact_fast_path(rng, interp):
    """8-bit integer frames are exact in bf16, so the resample drops the
    low-order image pass (2 bf16 matmul passes instead of 3) — the result must be
    bit-identical to feeding the same values as float32 (the node's uint8
    grayscale carry hits this path; see ``ops/logpolar.py``)."""
    n, m = 128, 20.0
    img_u8 = rng.integers(0, 255, size=(n, n), dtype=np.uint8)
    out_u8 = np.asarray(
        logpolar(jnp.asarray(img_u8), jnp.float32(m), interp=interp)
    )
    out_f32 = np.asarray(
        logpolar(jnp.asarray(img_u8, jnp.float32), jnp.float32(m), interp=interp)
    )
    np.testing.assert_array_equal(out_u8, out_f32)


def test_scale_rotation_quantize_ingest(rng):
    """With ``quantize_8bit`` (default) the estimator rounds float grays to
    the reference's 8U pixels before the log-polar resample, so a float
    frame and its rounded uint8 image produce identical states; disabling
    it keeps the float values."""
    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    n = 64
    f = rng.uniform(0, 255, size=(n, n)).astype(np.float32)
    eng = ScaleRotationEstimator(ScaleRotationConfig(resolution=n, magnitude=12.0))
    lp_f = eng._logpolar(jnp.asarray(f))
    lp_u = eng._logpolar(jnp.asarray(np.clip(np.round(f), 0, 255), jnp.uint8))
    np.testing.assert_array_equal(np.asarray(lp_f), np.asarray(lp_u))

    eng_nq = ScaleRotationEstimator(
        ScaleRotationConfig(resolution=n, magnitude=12.0, quantize_8bit=False)
    )
    lp_nq = eng_nq._logpolar(jnp.asarray(f))
    assert np.abs(np.asarray(lp_nq) - np.asarray(lp_f)).max() > 0  # not rounded


def test_scale_rotation_quantized_lp_carry(rng):
    """With ``quantize_8bit`` the log-polar image itself is round-and-
    saturated to 8 bits before correlation and carried as uint8 — the
    reference's ``tempIm`` is CV_8UC1 and is converted to CV_32F only for
    ``cv::phaseCorrelate`` (``src/scaleRotationEstimator.cpp:108-117``)."""
    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    n = 64
    f = rng.uniform(0, 255, size=(n, n)).astype(np.float32)
    eng = ScaleRotationEstimator(ScaleRotationConfig(resolution=n, magnitude=12.0))
    lp = eng._logpolar(jnp.asarray(f))
    assert lp.dtype == jnp.uint8
    # the quantized image is exactly the rounded/saturated float resample
    eng_nq = ScaleRotationEstimator(
        ScaleRotationConfig(resolution=n, magnitude=12.0, quantize_8bit=False)
    )
    lp_f = np.asarray(eng_nq._logpolar(jnp.asarray(np.rint(f).clip(0, 255))))
    np.testing.assert_array_equal(
        np.asarray(lp), np.clip(np.round(lp_f), 0, 255).astype(np.uint8)
    )
    # the carried state matches: init zeros and step outputs are uint8
    st = eng.init_state()
    assert st.prev_logpolar.dtype == jnp.uint8
    st2, res = eng.step(st, jnp.asarray(f))
    assert st2.prev_logpolar.dtype == jnp.uint8
    assert float(res.scale) == 1.0 and float(res.rotation) == 0.0  # first frame


@pytest.mark.parametrize("interp", ["lanczos4", "bilinear"])
def test_logpolar_static_rho_trim_exact(rng, interp):
    """The static rho trim (``ops/logpolar.py``): columns whose radius
    exceeds the farthest sample any stencil tap can touch are provably
    all-zero under BORDER_CONSTANT, so the resample computes only the live
    columns and concatenates zeros back.  Verify (a) the trimmed tail of an
    untrimmed computation is indeed exactly zero, and (b) the live columns
    match the untrimmed computation (tolerance covers shape-dependent
    matmul accumulation order on the CPU bf16-emulation path; the math per
    column is identical)."""
    from mrs_optic_flow_tpu.ops import logpolar as lpmod

    # 256 px: rays exit the image by rho ~ 105, which rounds up to a
    # 128-column live block — half the columns trimmed (at 128 px the
    # 128-lane rounding would disable the trim entirely)
    n, m = 256, 20.0
    img = _texture(rng, n)
    out = np.asarray(logpolar(jnp.asarray(img), m, interp=interp))

    # untrimmed manual computation with the same building blocks
    offsets, wfn = (
        (lpmod._LANCZOS4_OFFSETS, lpmod._lanczos4_weights)
        if interp == "lanczos4"
        else (np.arange(2), lpmod._bilinear_weights)
    )
    rho = jnp.arange(n, dtype=jnp.float32)
    phi = jnp.arange(n, dtype=jnp.float32) * (2 * jnp.pi / n)
    r = jnp.exp(rho / jnp.float32(m)) - 1.0
    x = n / 2 + r[None, :] * jnp.cos(phi)[:, None]
    y = n / 2 + r[None, :] * jnp.sin(phi)[:, None]
    full = np.asarray(
        lpmod._resample_separable(
            jnp.asarray(img), y, x, offsets=offsets, weight_fn=wfn
        )
    )

    # the impl's trim boundary (same formula as _logpolar_impl) actually
    # trimmed something at this geometry...
    margin = float(max(abs(int(offsets[0])), int(offsets[-1]))) + 1.0
    r_max = np.sqrt(2.0) * (n / 2.0 + margin)
    c_used = int(np.searchsorted(np.exp(np.arange(n) / m) - 1.0 > r_max, True))
    c_used = min(n, -(-max(c_used, 1) // 128) * 128)
    assert c_used < n
    # ...and everything it zeroed was already exactly zero untrimmed
    assert np.all(out[:, c_used:] == 0.0)
    assert np.all(full[:, c_used:] == 0.0)
    np.testing.assert_allclose(out, full, atol=0.1)  # 0-255 scale

    # rows_per_chunk is a scheduling knob, not a semantic one
    out2 = np.asarray(
        logpolar(jnp.asarray(img), m, interp=interp, rows_per_chunk=32)
    )
    np.testing.assert_allclose(out2, out, atol=0.1)


def test_logpolar_production_geometry_oracle(rng):
    """The SHIPPED configuration — 480² frame, ``magnitude`` 49.9
    (``config/default.yaml``: the reference's optimM,
    ``src/scaleRotationEstimator.cpp:28``), Lanczos4, 8-bit input, static
    rho trim ACTIVE (384 of 480 live columns) — against ``cv2.warpPolar``
    directly.  Round-2 review finding: the cv2 diffs ran only at 128² where
    the trim is a no-op, so a trim-boundary or full-res weight bug would
    have passed.  Asserts (a) the impl's trim boundary at this geometry is
    384, (b) every trimmed column is provably dead (the OpenCV oracle also
    zeroes it), (c) live interior columns match OpenCV within the standard
    tolerance, and (d) the estimator's quantized production path
    (``_logpolar`` with uint8 ingest + uint8 carry) matches the uint8
    OpenCV output to a few LSB."""
    cv2 = pytest.importorskip("cv2")

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    n, m = 480, 49.9
    img_u8 = (smooth_random_image(rng, n)).astype(np.uint8)

    # (a) the trim formula at this geometry: rays exit by rho ~ 293, rounded
    # up to the 128-lane tile -> 384 live columns
    margin = 5.0  # |offsets| max + 1 for Lanczos4
    r_max = np.sqrt(2.0) * (n / 2.0 + margin)
    c_used = int(np.searchsorted(np.exp(np.arange(n) / m) - 1.0 > r_max, True))
    c_used = min(n, -(-max(c_used, 1) // 128) * 128)
    assert c_used == 384

    ours = np.asarray(
        logpolar(jnp.asarray(img_u8), jnp.float32(m), interp="lanczos4")
    )
    ref = _cv2_logpolar(img_u8.astype(np.float32), m, cv2.INTER_LANCZOS4)

    # (b) the trimmed tail is exactly the dead zone: ours is zero by
    # construction AND an untrimmed computation with the same building
    # blocks confirms nothing lives there.  (cv2.warpPolar is NOT usable as
    # the dead-zone oracle: beyond radius n/2 its remap output is
    # uninitialized memory — zero pages in a fresh process, heap garbage /
    # NaN after other allocations, which made this assertion order-dependent
    # when it compared ref's tail.)
    assert np.all(ours[:, c_used:] == 0.0)
    from mrs_optic_flow_tpu.ops import logpolar as lpmod

    rho = jnp.arange(n, dtype=jnp.float32)
    phi = jnp.arange(n, dtype=jnp.float32) * (2 * jnp.pi / n)
    r_f = jnp.exp(rho / jnp.float32(m)) - 1.0
    x = n / 2 + r_f[None, :] * jnp.cos(phi)[:, None]
    y = n / 2 + r_f[None, :] * jnp.sin(phi)[:, None]
    full = np.asarray(
        lpmod._resample_separable(
            jnp.asarray(img_u8, jnp.float32), y, x,
            offsets=lpmod._LANCZOS4_OFFSETS, weight_fn=lpmod._lanczos4_weights,
        )
    )
    assert np.all(full[:, c_used:] == 0.0)

    # (c) live interior columns at the standard lanczos4 tolerance
    sl = _interior(m, n)
    assert np.abs(ours[sl] - ref[sl]).mean() < 1.0
    assert np.abs(ours[sl] - ref[sl]).max() < 5.0

    # (d) the estimator's production path: uint8 ingest, quantized uint8
    # log-polar carry (the reference's CV_8UC1 tempIm) vs the uint8 oracle
    eng = ScaleRotationEstimator(ScaleRotationConfig())  # shipped defaults
    assert eng.config.resolution == n and eng.config.magnitude == m
    lp = np.asarray(eng._logpolar(jnp.asarray(img_u8))).astype(np.float32)
    ref_u8 = _cv2_logpolar(img_u8, m, cv2.INTER_LANCZOS4).astype(np.float32)
    assert np.abs(lp[sl] - ref_u8[sl]).mean() < 1.5
    # fixed-point-vs-float Lanczos edge cases can differ by a few LSB more
    # after both sides round to uint8
    assert np.abs(lp[sl] - ref_u8[sl]).max() < 8.0


def test_logpolar_bad_interp():
    with pytest.raises(ValueError, match="interp"):
        logpolar(jnp.zeros((16, 16)), jnp.float32(5.0), interp="nearest")


@pytest.mark.parametrize(
    "n,res,m,interp",
    [
        (64, 64, 12.0, "lanczos4"),
        (128, 128, 20.0, "bilinear"),
        (128, 64, 10.0, "lanczos4"),  # reduced lp_resolution geometry
    ],
)
def test_logpolar_precomputed_plan_matches_per_frame(rng, n, res, m, interp):
    """The precomputed-weight fast path (``build_lp_plan`` — octant
    symmetry, shared x-passes, static windows; ``ops/logpolar.py``) must
    produce the per-frame path's resample: same taps, float64 build-time
    math, tolerance covers f32 trig/summation-order differences only."""
    import jax

    from mrs_optic_flow_tpu.ops.logpolar import build_lp_plan

    img = _texture(rng, n)
    v1 = np.asarray(
        logpolar(jnp.asarray(img), jnp.float32(m), resolution=res, interp=interp)
    )
    plan, w_np = build_lp_plan(n, m, resolution=res, interp=interp)
    w = tuple(jax.device_put(x) for x in w_np)
    v2 = np.asarray(
        logpolar(
            jnp.asarray(img), jnp.float32(m), resolution=res, interp=interp,
            plan=plan, weights=w,
        )
    )
    np.testing.assert_allclose(v2, v1, atol=0.05)  # 0-255 scale
    # the uint8-exact pass drop is bit-identical on this path too
    u8 = img.astype(np.uint8)
    a = np.asarray(
        logpolar(jnp.asarray(u8), jnp.float32(m), resolution=res,
                 interp=interp, plan=plan, weights=w)
    )
    b = np.asarray(
        logpolar(jnp.asarray(u8, jnp.float32), jnp.float32(m), resolution=res,
                 interp=interp, plan=plan, weights=w)
    )
    np.testing.assert_array_equal(a, b)


def test_logpolar_plan_requires_weights():
    from mrs_optic_flow_tpu.ops.logpolar import build_lp_plan

    plan, w = build_lp_plan(64, 12.0)
    with pytest.raises(ValueError, match="together"):
        logpolar(jnp.zeros((64, 64)), 12.0, plan=plan)
    with pytest.raises(ValueError, match="built for"):
        logpolar(jnp.zeros((32, 32)), 12.0, plan=plan, weights=w)


def test_build_lp_plan_non_symmetric_returns_none():
    """res % 8 != 0 lacks the octant symmetry — callers fall back to the
    per-frame weight build."""
    from mrs_optic_flow_tpu.ops.logpolar import build_lp_plan

    assert build_lp_plan(60, 12.0) is None
    assert build_lp_plan(64, 12.0, resolution=60) is None


def test_scale_rotation_estimator_weight_paths(rng):
    """The estimator precomputes the plan at symmetric geometries (and its
    ``step`` matches the fallback per-frame path), and degrades to the
    per-frame build when the geometry lacks the symmetry."""
    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    f0 = _texture(rng, 64)
    f1 = np.roll(f0, 2, axis=0)

    eng = ScaleRotationEstimator(ScaleRotationConfig(resolution=64, magnitude=12.0))
    assert eng.lp_plan is not None and len(eng.lp_weights) > 0

    # force the fallback on the same geometry via the weight-threaded API
    st = eng.init_state()
    st_v2, _ = eng.step_w(st, jnp.asarray(f0), eng.lp_weights)
    _, res_v2 = eng.step_w(st_v2, jnp.asarray(f1), eng.lp_weights)
    st_v1, _ = eng.step_w(st, jnp.asarray(f0), ())
    _, res_v1 = eng.step_w(st_v1, jnp.asarray(f1), ())
    assert abs(float(res_v2.scale) - float(res_v1.scale)) < 1e-3
    assert abs(float(res_v2.rotation) - float(res_v1.rotation)) < 1e-3

    # non-symmetric lp resolution: no plan, still functional
    eng60 = ScaleRotationEstimator(
        ScaleRotationConfig(resolution=64, magnitude=12.0, lp_resolution=60)
    )
    assert eng60.lp_plan is None and eng60.lp_weights == ()
    st = eng60.init_state()
    st, r = eng60.step(st, jnp.asarray(f0))
    assert float(r.scale) == 1.0  # first frame
    _, r = eng60.step(st, jnp.asarray(f0))
    assert np.isfinite(float(r.scale))


def test_scale_rotation_batch_chunking_matches_vmap(rng):
    """The stream-chunked batched resample (``lp_batch_chunk``, the round-4
    fix for the 2.6x carried-SR fleet penalty — docs/PERFORMANCE.md) is a
    pure scheduling change: chunked, vmap (chunk 0), odd-batch (padded), and
    chunk>batch modes must produce identical log-polar images and identical
    batched/carried decodes."""
    import dataclasses

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    base = _texture(rng, 64)
    frames = jnp.asarray(
        np.stack([np.roll(base, i, axis=1) for i in range(5)])  # odd batch
    )
    cfg = ScaleRotationConfig(resolution=64, magnitude=12.0, lp_batch_chunk=2)
    engines = {
        "chunk2": ScaleRotationEstimator(cfg),
        "vmap": ScaleRotationEstimator(
            dataclasses.replace(cfg, lp_batch_chunk=0)
        ),
        "chunk_big": ScaleRotationEstimator(
            dataclasses.replace(cfg, lp_batch_chunk=16)
        ),
    }
    lps = {k: np.asarray(e.logpolar_batch(frames)) for k, e in engines.items()}
    np.testing.assert_array_equal(lps["chunk2"], lps["vmap"])
    np.testing.assert_array_equal(lps["chunk_big"], lps["vmap"])

    prev = jnp.asarray(np.stack([base] * 5))
    res = {
        k: e.step_batch(prev, frames) for k, e in engines.items()
    }
    np.testing.assert_allclose(
        np.asarray(res["chunk2"].scale), np.asarray(res["vmap"].scale),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(res["chunk2"].rotation), np.asarray(res["vmap"].rotation),
        atol=1e-6,
    )
    # carried mode chunks too
    lp_prev = engines["vmap"].logpolar_batch(prev)
    lp_c2, r_c2 = engines["chunk2"].step_batch_carried(lp_prev, frames)
    lp_v, r_v = engines["vmap"].step_batch_carried(lp_prev, frames)
    np.testing.assert_array_equal(np.asarray(lp_c2), np.asarray(lp_v))
    np.testing.assert_allclose(
        np.asarray(r_c2.rotation), np.asarray(r_v.rotation), atol=1e-6
    )


def test_scale_rotation_decode_accuracy_by_interp(rng):
    """Quantify the decode-accuracy cost of bilinear vs Lanczos4 log-polar
    resampling (VERDICT.md round 1, item 9): rotation and scale recovery on
    textured frames must be within tight bounds for Lanczos4 (the reference
    interpolator), and bilinear must not be catastrophically worse — the
    measured deltas are recorded in docs/PERFORMANCE.md."""
    cv2 = pytest.importorskip("cv2")

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    n = 128
    deg_true, zoom_true = 10.0, 1.08
    f0 = _texture(rng, n)
    m_rot = cv2.getRotationMatrix2D((n / 2, n / 2), deg_true, 1.0)
    f_rot = cv2.warpAffine(f0, m_rot, (n, n))
    m_zoom = cv2.getRotationMatrix2D((n / 2, n / 2), 0.0, zoom_true)
    f_zoom = cv2.warpAffine(f0, m_zoom, (n, n))

    errs = {}
    for interp in ("lanczos4", "bilinear"):
        eng = ScaleRotationEstimator(
            ScaleRotationConfig(resolution=n, magnitude=20.0, interp=interp)
        )
        res = eng.step_batch(
            jnp.asarray(np.stack([f0, f0])), jnp.asarray(np.stack([f_rot, f_zoom]))
        )
        rot_err = abs(float(res.rotation[0]) - np.deg2rad(deg_true))
        # zoom-IN decodes to scale < 1 (reference sign convention)
        scale_err = abs(float(res.scale[1]) - 1.0 / zoom_true)
        errs[interp] = (rot_err, scale_err)

    # the reference interpolator: tight bounds
    assert errs["lanczos4"][0] < np.deg2rad(1.0), errs
    assert errs["lanczos4"][1] < 0.03, errs
    # bilinear: quantified as usable (the documented cheaper mode)
    assert errs["bilinear"][0] < np.deg2rad(1.5), errs
    assert errs["bilinear"][1] < 0.05, errs


def test_scale_rotation_lp_resolution_decode(rng):
    """A reduced lp_resolution rescales magnitude and Ky so the decode stays
    consistent with the configured ``magnitude`` semantics: rotation/scale
    recovery at lp 64 on a 128 px frame must agree with the full-resolution
    decode within the coarser grid's tolerance."""
    cv2 = pytest.importorskip("cv2")

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator

    n, deg_true = 128, 14.0
    f0 = _texture(rng, n)
    m_rot = cv2.getRotationMatrix2D((n / 2, n / 2), deg_true, 1.0)
    f_rot = cv2.warpAffine(f0, m_rot, (n, n))

    eng = ScaleRotationEstimator(
        ScaleRotationConfig(resolution=n, magnitude=20.0, lp_resolution=64)
    )
    assert eng.ky == 64 / 360.0 and abs(eng.m_eff - 10.0) < 1e-9
    res = eng.step_batch(jnp.asarray(f0)[None], jnp.asarray(f_rot)[None])
    # 64 log-polar rows -> one row = 5.6 deg; sub-pixel centroid gets closer
    assert abs(float(res.rotation[0]) - np.deg2rad(deg_true)) < np.deg2rad(3.0)
    assert abs(float(res.scale[0]) - 1.0) < 0.08


def test_logpolar_plan_mismatch_rejected(rng):
    """The precomputed-weight fast path validates magnitude and resolution,
    not just n/interp: the weights bake the rho grid in, so a mismatched
    plan would silently skew the decode by the magnitude ratio."""
    import pytest

    from mrs_optic_flow_tpu.ops.logpolar import build_lp_plan, logpolar

    n, mag = 64, 12.0
    built = build_lp_plan(n, mag)
    assert built is not None
    plan, w = built
    w = tuple(jnp.asarray(x) for x in w)
    img = jnp.asarray(smooth_random_image(rng, n, cutoff=0.4))
    # matching call works
    out = logpolar(img, mag, plan=plan, weights=w)
    assert out.shape == (n, n)
    with pytest.raises(ValueError, match="magnitude"):
        logpolar(img, mag * 2, plan=plan, weights=w)
    with pytest.raises(ValueError, match="resolution"):
        logpolar(img, mag, resolution=n // 2, plan=plan, weights=w)
