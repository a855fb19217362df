"""Property tests (SURVEY.md section 4): shift recovery under noise and
combined motion, across the operating envelope."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mrs_optic_flow_tpu.ops.phase_correlate import phase_correlate_field
from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu.geometry import get_rt
from mrs_optic_flow_tpu.geometry.rotations import quat_axis_angle, quat_from_rpy

from oracle import fourier_shift, smooth_random_image

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("noise_sigma", [0.0, 2.0, 8.0, 20.0])
def test_noise_robustness(rng, noise_sigma):
    """Sub-pixel recovery degrades gracefully with additive noise: <0.1 px
    clean, <0.5 px at SNR ~6 (sigma 20 on a 0-255 texture)."""
    n = 120
    errs = []
    for _ in range(4):
        prev = smooth_random_image(rng, n)
        d = rng.uniform(-25, 25, size=2)
        curr = fourier_shift(prev, *d).astype(np.float32)
        curr = curr + rng.normal(0, noise_sigma, curr.shape).astype(np.float32)
        prev = prev + rng.normal(0, noise_sigma, prev.shape).astype(np.float32)
        s, _ = phase_correlate_field(jnp.asarray(curr), jnp.asarray(prev))
        errs.append(np.abs(np.asarray(s) - d).max())
    tol = 0.1 if noise_sigma <= 2.0 else 0.5
    assert max(errs) < tol, (noise_sigma, errs)


def test_shift_envelope(rng):
    """Every integer shift magnitude up to the search radius is recovered."""
    n = 120
    prev = smooth_random_image(rng, n)
    for mag in [1, 10, 25, 40, 54]:
        curr = np.roll(prev, (0, mag), axis=(0, 1))
        s, _ = phase_correlate_field(jnp.asarray(curr), jnp.asarray(prev))
        assert abs(float(s[0]) - mag) < 0.3, (mag, s)


def test_combined_rotation_translation(rng):
    """getRT separates rotation rate from translation on a warped scene."""
    K = np.array([[420.0, 0, 240.0], [0, 420.0, 240.0], [0, 0, 1.0]])
    dist = np.zeros(5)
    height, dt = 3.0, 0.05
    yaw_rate = 0.4  # rad/s about the optical axis
    v_cam = np.array([0.9, 0.0, 0.0])

    from scipy.spatial.transform import Rotation

    n_img = 480
    prev = smooth_random_image(rng, n_img)
    # warp: x2 = H x1 in normalized coords, H = R + (v dt / h) n^T, n=(0,0,-1)
    r = Rotation.from_rotvec([0, 0, yaw_rate * dt]).as_matrix()
    h_mat = r + np.outer(v_cam * dt / height, [0, 0, -1.0])
    # pixel-space homography: K H K^-1 (no distortion)
    hp = K @ h_mat @ np.linalg.inv(K)
    # default warpPerspective: dst(x) = src(H^-1 x), i.e. content moves
    # forward under H (x2 = H x1)
    curr = cv2.warpPerspective(prev, hp, (n_img, n_img), flags=cv2.INTER_LINEAR)

    eng = FftMethod(FftMethodConfig(backend="fft"))
    state = eng.init_state()
    state, _ = eng.step(state, jnp.asarray(prev))
    state, res = eng.step(state, jnp.asarray(curr))

    rate_q = quat_from_rpy(0.0, 0.0, yaw_rate)
    out = get_rt(
        res.shifts, jnp.float32(height), jnp.float32(dt), jnp.float32(0.0),
        jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32),
        quat_from_rpy(0.0, 0.0, 0.0), rate_q, jax.random.PRNGKey(0),
        frame_size=480, patch=120,
    )
    assert bool(out.ok)
    tran = np.asarray(out.tran)
    axis, ang = quat_axis_angle(out.rot)
    rate_vec = np.asarray(axis) * float(ang)
    assert abs(rate_vec[2] - yaw_rate) < 0.08, rate_vec
    assert np.abs(tran[:2] - v_cam[:2]).max() < 0.2, tran


def test_response_monotonic_with_texture(rng):
    """Peak response reflects confidence: a matched pair scores far above an
    uncorrelated pair (the signal behind the max-response masking)."""
    n = 120
    strong = smooth_random_image(rng, n, cutoff=0.3)
    _, r_matched = phase_correlate_field(
        jnp.asarray(np.roll(strong, 5, 1)), jnp.asarray(strong)
    )
    a = rng.normal(128, 20, (n, n)).astype(np.float32)
    b = rng.normal(128, 20, (n, n)).astype(np.float32)  # independent
    _, r_uncorr = phase_correlate_field(jnp.asarray(a), jnp.asarray(b))
    assert float(r_matched) > 3 * float(r_uncorr), (float(r_matched), float(r_uncorr))
