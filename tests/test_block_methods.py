"""Block-matching engines (methods 3/5) and scale/rotation estimator."""

import numpy as np
import pytest

import jax.numpy as jnp

from mrs_optic_flow_tpu.models import (
    BlockMethod,
    BlockMethodConfig,
    FastSpacedBM,
    FastSpacedBMConfig,
    ScaleRotationEstimator,
    ScaleRotationConfig,
    make_engine,
)
from mrs_optic_flow_tpu.ops.block_matching import (
    histogram_vote,
    sad_min_flow,
    sad_search,
)

from oracle import smooth_random_image

# small geometry to keep single-core CPU compile times sane
SMALL = dict(frame_size=96, sample_point_size=24, scan_radius=8)


def test_sad_search_oracle(rng):
    """SAD maps must equal the brute-force definition of
    src/BlockMethod.cpp:43-57."""
    s, r = 8, 3
    curr = rng.integers(0, 255, size=(2, s, s)).astype(np.float32)
    region = rng.integers(0, 255, size=(2, s + 2 * r, s + 2 * r)).astype(np.float32)
    sad = np.asarray(
        sad_search(jnp.asarray(curr), jnp.asarray(region), block_size=s, scan_radius=r)
    )
    for g in range(2):
        for i in range(2 * r + 1):
            for j in range(2 * r + 1):
                ref = np.abs(curr[g] - region[g, i : i + s, j : j + s]).sum()
                assert abs(sad[g, i, j] - ref) < 1e-3


def test_sad_min_flow_and_noise_gate():
    r = 2
    d = 2 * r + 1
    sad = np.full((2, d, d), 100.0, np.float32)
    sad[0, 1, 4] = 1.0  # min at dy=-1, dx=+2
    sad[1, r, r] = 50.0  # center barely better than elsewhere
    sad[1, 0, 0] = 49.5
    flow = np.asarray(sad_min_flow(jnp.asarray(sad), r))
    assert flow[0].tolist() == [2, -1]
    # noise gate: center - min = 0.5 <= threshold -> (0, 0)
    flow_g = np.asarray(sad_min_flow(jnp.asarray(sad), r, noise_threshold=0.8))
    assert flow_g[1].tolist() == [0, 0]
    assert flow_g[0].tolist() == [2, -1]


def test_histogram_vote():
    flow = jnp.asarray(np.array([[3, -1], [3, -1], [3, 2], [-2, -1]], np.int32))
    tx, ty = histogram_vote(flow, 4, top_k=2)
    assert int(tx[0]) == 3 and int(ty[0]) == -1
    assert int(tx[1]) == -2 and int(ty[1]) == 2


def test_block_method_recovers_shift(rng):
    eng = BlockMethod(BlockMethodConfig(**SMALL))
    assert eng.grid_side >= 3
    state = eng.init_state()
    f0 = smooth_random_image(rng, 96)
    f1 = np.roll(f0, (3, -5), axis=(0, 1))
    state, _ = eng.step(state, jnp.asarray(f0))
    state, res = eng.step(state, jnp.asarray(f1))
    s = np.asarray(res.shifts)[0]
    assert np.all(np.abs(s - np.array([-5, 3])) <= 0.5), s


def test_fast_spaced_bm_recovers_shift(rng):
    eng = FastSpacedBM(FastSpacedBMConfig(**SMALL, step_size=8))
    assert eng.grid_side >= 2
    state = eng.init_state()
    f0 = smooth_random_image(rng, 96)
    f1 = np.roll(f0, (-2, 4), axis=(0, 1))
    state, _ = eng.step(state, jnp.asarray(f0))
    state, res = eng.step(state, jnp.asarray(f1))
    s = np.asarray(res.shifts)[0]
    assert s.tolist() == [4, -2], s


def test_fast_spaced_bm_flat_image(rng):
    eng = FastSpacedBM(FastSpacedBMConfig(**SMALL, step_size=8))
    state = eng.init_state()
    flat = np.full((96, 96), 128.0, np.float32)
    state, _ = eng.step(state, jnp.asarray(flat))
    state, res = eng.step(state, jnp.asarray(flat))
    assert np.asarray(res.shifts)[0].tolist() == [0.0, 0.0]


def test_scale_rotation_estimator(rng):
    cv2 = pytest.importorskip("cv2")
    n = 128
    eng = ScaleRotationEstimator(ScaleRotationConfig(resolution=n, magnitude=20.0))
    state = eng.init_state()
    f0 = smooth_random_image(rng, n)
    # rotate by 10 degrees about the centre
    m = cv2.getRotationMatrix2D((n / 2, n / 2), 10.0, 1.0)
    f1 = cv2.warpAffine(f0, m, (n, n))
    state, r0 = eng.step(state, jnp.asarray(f0))
    assert float(r0.scale) == 1.0 and float(r0.rotation) == 0.0  # first frame
    state, r1 = eng.step(state, jnp.asarray(f1))
    assert abs(float(r1.rotation) - np.deg2rad(10)) < np.deg2rad(1.5), r1
    assert abs(float(r1.scale) - 1.0) < 0.05
    # zoom in by 1.1: the reference decode maps a zoom-IN to scale < 1
    # (scale = exp(pt.x / M) with pt from cv::phaseCorrelate,
    # src/scaleRotationEstimator.cpp:123) — ideal value 1/1.1 ~ 0.909;
    # bilinear log-polar resampling biases it a few percent high.
    m = cv2.getRotationMatrix2D((n / 2, n / 2), 0.0, 1.1)
    f2 = cv2.warpAffine(f1, m, (n, n))
    state, r2 = eng.step(state, jnp.asarray(f2))
    assert 0.87 < float(r2.scale) < 0.96, r2
    assert abs(float(r2.rotation)) < np.deg2rad(1.0)


def test_make_engine_dispatch():
    assert isinstance(make_engine(3, **SMALL), BlockMethod)
    assert isinstance(make_engine(4), object)
    assert isinstance(make_engine(5, **SMALL), FastSpacedBM)
    with pytest.raises(ValueError):
        make_engine(7)


def test_scale_rotation_step_batch(rng):
    """Batched scale/rotation agrees with the stateful per-frame path."""
    cv2 = pytest.importorskip("cv2")
    n = 128
    eng = ScaleRotationEstimator(ScaleRotationConfig(resolution=n, magnitude=20.0))
    prevs, currs, singles = [], [], []
    for deg in (5.0, -8.0):
        f0 = smooth_random_image(rng, n)
        m = cv2.getRotationMatrix2D((n / 2, n / 2), deg, 1.0)
        f1 = cv2.warpAffine(f0, m, (n, n))
        prevs.append(f0)
        currs.append(f1)
        state = eng.init_state()
        state, _ = eng.step(state, jnp.asarray(f0))
        _, r = eng.step(state, jnp.asarray(f1))
        singles.append(r)
    batched = eng.step_batch(jnp.asarray(np.stack(prevs)), jnp.asarray(np.stack(currs)))
    for i, r in enumerate(singles):
        np.testing.assert_allclose(float(batched.scale[i]), float(r.scale), atol=1e-5)
        np.testing.assert_allclose(
            float(batched.rotation[i]), float(r.rotation), atol=1e-5
        )


@pytest.mark.slow
def test_block_engines_step_batch(rng):
    """The FlowEngine default batched mode (vmapped step) works for both
    SAD engines and agrees with per-frame stepping."""
    for method in (3, 5):
        eng = make_engine(method, **SMALL)
        b = 2
        prev = np.stack([smooth_random_image(rng, SMALL["frame_size"]) for _ in range(b)])
        curr = np.stack([np.roll(prev[i], (1, 2 * (i + 1)), axis=(0, 1)) for i in range(b)])
        batched = eng.step_batch(jnp.asarray(prev), jnp.asarray(curr))
        assert batched.shifts.shape[0] == b
        for i in range(b):
            state = eng.set_im_prev(eng.init_state(), jnp.asarray(prev[i]))
            _, single = eng.step(state, jnp.asarray(curr[i]))
            np.testing.assert_allclose(
                np.asarray(batched.shifts[i]), np.asarray(single.shifts),
                atol=1e-5, equal_nan=True,
            )
