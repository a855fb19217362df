"""The plain XLA flow path — the one device path — on the properties the
removed fused kernels were held to: NaN propagation, SEARCH_RADIUS masking,
uint8 == float32 inputs, odd window sizes, the reference's field order and
parity with the float64 oracle.  Each property runs on both spectral
backends, on the patch path (``phase_correlate_field``, what
``FftMethod._correlate`` runs) and on the frame path
(``FftMethod.step_batch``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu.ops.phase_correlate import phase_correlate_field

from oracle import make_accuracy_pairs, phase_correlate_oracle, smooth_random_image

BACKENDS = ["dft", "fft"]


def _engine(backend, frame, patch, **kw):
    return FftMethod(FftMethodConfig(
        frame_size=frame, sample_point_size=patch, backend=backend, **kw
    ))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("path", ["patch", "frame"])
def test_nan_propagation(backend, path):
    """A NaN window poisons its shift and response instead of producing a
    plausible number."""
    bad = jnp.full((1, 48, 48), jnp.nan, jnp.float32)
    if path == "patch":
        s, m = phase_correlate_field(bad, bad, search_radius=20, backend=backend)
    else:
        res = _engine(backend, 48, 24, quantize_8bit=False).step_batch(bad, bad)
        s, m = res.shifts_raw, res.response
    assert np.all(np.isnan(np.asarray(s)))
    assert np.all(np.isnan(np.asarray(m)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("path", ["patch", "frame"])
def test_masked_large_shift(rng, backend, path):
    """A shift beyond SEARCH_RADIUS (55 px) is not reported as a valid
    peak: the true peak is masked away and the response collapses."""
    n = 120
    prev = smooth_random_image(rng, n)
    curr = np.roll(prev, 58, axis=1)
    if path == "patch":
        _, m = phase_correlate_field(jnp.asarray(curr), jnp.asarray(prev),
                                     backend=backend)
    else:
        res = _engine(backend, n, n).step_batch(
            jnp.asarray(prev)[None], jnp.asarray(curr)[None]
        )
        m = res.response[0, 0]
    assert float(m) < 0.5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["step", "step_batch"])
def test_uint8_matches_float32_bit_identical(rng, backend, mode):
    """uint8 frames stay uint8 until the engine casts them on device; the
    result is bit-identical to pre-converted float32 frames."""
    eng = _engine(backend, 48, 12)
    f0 = (smooth_random_image(rng, 48, cutoff=0.35)).astype(np.uint8)
    f1 = np.roll(f0, (3, -2), axis=(0, 1))
    outs = []
    for dtype in (jnp.uint8, jnp.float32):
        a, b = jnp.asarray(f0, dtype), jnp.asarray(f1, dtype)
        if mode == "step":
            st = eng.set_im_prev(eng.init_state(), a)
            _, res = eng.step(st, b)
        else:
            res = eng.step_batch(a[None], b[None])
        outs.append((np.asarray(res.shifts), np.asarray(res.response)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [15, 45])
def test_odd_window_matches_oracle(rng, backend, n):
    """Odd window sizes (no Hermitian-symmetric middle row, fftshift off by
    one) agree with the oracle transcribing the reference math."""
    radius = n // 2 - 4
    prev = smooth_random_image(rng, n, cutoff=0.35)
    curr = np.roll(prev, (1, 2), axis=(0, 1))
    s, m = phase_correlate_field(jnp.asarray(curr), jnp.asarray(prev),
                                 search_radius=radius, backend=backend)
    ref, ref_max = phase_correlate_oracle(curr, prev, search_radius=radius)
    np.testing.assert_allclose(np.asarray(s), ref, atol=1e-3)
    np.testing.assert_allclose(float(m), ref_max, rtol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_frame_field_order(rng, backend):
    """Each window of a frame recovers its own shift, in the reference's
    field order ``index = i + q*j`` (``src/FftMethod.cpp:417``)."""
    n, q, b = 24, 2, 2
    prev = np.stack([smooth_random_image(rng, n * q, cutoff=0.35) for _ in range(b)])
    d = rng.integers(-4, 5, size=(b, q * q, 2))
    curr = np.empty_like(prev)
    for bi in range(b):
        for j in range(q):
            for i in range(q):
                dx, dy = d[bi, i + q * j]
                win = prev[bi, j * n:(j + 1) * n, i * n:(i + 1) * n]
                curr[bi, j * n:(j + 1) * n, i * n:(i + 1) * n] = np.roll(
                    win, (dy, dx), (0, 1)
                )
    res = _engine(backend, n * q, n, quantize_8bit=False).step_batch(
        jnp.asarray(prev), jnp.asarray(curr)
    )
    np.testing.assert_allclose(np.asarray(res.shifts_raw), d, atol=0.3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_oracle_parity(rng, backend):
    """Known-shift uint8 pairs through ``step_batch``: every window within
    0.05 px of the float64 oracle on the same pixels (the conformance
    budget chip_smoke.py holds on the card)."""
    prev, curr, _, osh = make_accuracy_pairs(rng, 2, size=96, patch=24,
                                             max_shift=5.0)
    s = np.asarray(_engine(backend, 96, 24).step_batch(
        jnp.asarray(prev), jnp.asarray(curr)).shifts)
    assert not np.isnan(s).any()
    assert np.max(np.abs(s - osh)) < 0.05


def test_cross_backend_conformance(rng):
    """The two spectral backends agree within the guard band — the live
    version of the reference's storageA/storageB debug diff."""
    from mrs_optic_flow_tpu.ops import conformance

    assert conformance.backends() == ("fft", "dft")
    prev = np.stack([smooth_random_image(rng, 120) for _ in range(2)])
    curr = np.roll(prev, (0, 3, -2), axis=(0, 1, 2)).astype(np.float32)
    report = conformance.check(jnp.asarray(curr), jnp.asarray(prev))
    assert len(report) == 1  # the one pair of 2 backends
    assert max(report.values()) < 0.05
