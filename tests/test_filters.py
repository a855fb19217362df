"""Filter toolkit tests: allsac/ransac consensus, bounds, speed stats,
9-vector decomposition (oracle: direct transcription of
src/utilityFunctions.cpp in NumPy where behaviour is subtle)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mrs_optic_flow_tpu.config import load_config, ConfigError
from mrs_optic_flow_tpu.filters import (
    allsac_mean,
    allsac_mean_1d,
    analyze_speeds,
    bound_abs_mask,
    estimate_tran_rot_vvel,
    point_mean,
    ransac_mean,
    rotate_2d,
    SpeedBox,
)


def test_allsac_mean_consensus():
    pts = np.array([[1.0, 1.0], [1.1, 0.9], [0.95, 1.05], [8.0, 8.0], [1.02, 1.0]], np.float32)
    valid = jnp.ones(5, bool)
    mean, chosen = allsac_mean(jnp.asarray(pts), valid, jnp.float32(0.25))
    assert int(chosen) == 4
    np.testing.assert_allclose(np.asarray(mean), pts[[0, 1, 2, 4]].mean(0), atol=1e-6)


def test_allsac_mean_few_points():
    pts = jnp.asarray(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    mean, chosen = allsac_mean(pts, jnp.ones(2, bool), jnp.float32(0.01))
    np.testing.assert_allclose(np.asarray(mean), [2.0, 3.0])


def test_allsac_mean_masked():
    pts = np.array([[1.0, 1.0], [np.nan, np.nan], [1.2, 0.8], [1.1, 1.1]], np.float32)
    valid = jnp.asarray([True, False, True, True])
    mean, chosen = allsac_mean(jnp.where(jnp.asarray(valid)[:, None], jnp.asarray(pts), 0.0), valid, jnp.float32(1.0))
    assert int(chosen) == 3
    assert np.all(np.isfinite(np.asarray(mean)))


def test_allsac_1d():
    vals = jnp.asarray(np.array([1.0, 1.05, 0.98, 5.0, 1.01], np.float32))
    mean, chosen = allsac_mean_1d(vals, jnp.ones(5, bool), jnp.float32(0.2))
    assert int(chosen) == 4
    assert abs(float(mean) - np.mean([1.0, 1.05, 0.98, 1.01])) < 1e-6


def test_allsac_1d_all_invalid_is_nan():
    # the reference's calcMean over an empty vector is 0/0 = NaN
    # (src/utilityFunctions.cpp:105-142); a fabricated 0.0 would pass
    # downstream bound checks as a confident estimate
    vals = jnp.asarray(np.full(5, np.nan, np.float32))
    mean, chosen = allsac_mean_1d(vals, jnp.zeros(5, bool), jnp.float32(0.2))
    assert np.isnan(float(mean)) and int(chosen) == 0


def test_ransac_mean():
    rng = np.random.default_rng(0)
    cluster = rng.normal([2, -1], 0.05, size=(12, 2)).astype(np.float32)
    outliers = rng.normal(0, 5, size=(4, 2)).astype(np.float32)
    pts = jnp.asarray(np.concatenate([cluster, outliers]))
    mean = ransac_mean(pts, jnp.ones(16, bool), jnp.float32(0.09), jax.random.PRNGKey(0))
    assert np.abs(np.asarray(mean) - [2, -1]).max() < 0.1


def test_bounds_and_rotate():
    pts = jnp.asarray(np.array([[3.0, 4.0], [0.1, 0.1]], np.float32))
    assert np.asarray(bound_abs_mask(pts, 5.1)).tolist() == [True, True]
    assert np.asarray(bound_abs_mask(pts, 4.9)).tolist() == [False, True]
    r = np.asarray(rotate_2d(jnp.asarray([1.0, 0.0]), jnp.float32(np.pi / 2)))
    np.testing.assert_allclose(r, [0.0, 1.0], atol=1e-6)


def test_analyze_speeds():
    boxes = [
        SpeedBox(time=1.0, speed=np.array([1.0, 0.0]), odometry_speed=np.array([1.5, 0.0])),
        SpeedBox(time=2.0, speed=np.array([0.0, 1.0]), odometry_speed=np.array([0.0, 2.0])),
        SpeedBox(time=0.1, speed=np.array([9.0, 9.0]), odometry_speed=np.array([0.0, 0.0])),
    ]
    sd = analyze_speeds(0.5, boxes)  # excludes the t=0.1 sample
    assert sd.num == 2
    np.testing.assert_allclose(sd.mean, (0.5 + 1.0) / 2)
    np.testing.assert_allclose(sd.mean_x, 0.25)
    np.testing.assert_allclose(sd.mean_y, 0.5)


def test_tran_rot_vvel_pure_translation():
    # all 9 vectors identical -> translation = that vector, rot = vvel = 0
    vec = np.tile(np.array([4.0, -2.0], np.float32), (9, 1))
    out = estimate_tran_rot_vvel(
        jnp.asarray(vec), jnp.float32(40.0), jnp.float32(400.0), jnp.float32(400.0),
        jnp.float32(2.0), jnp.float32(100.0), jnp.float32(0.1),
        jnp.float32(5.0), jnp.float32(5.0),
    )
    # y was flipped then flipped back in the px conversion: tran = input vector
    np.testing.assert_allclose(np.asarray(out.tran), [4.0, -2.0], atol=1e-5)
    np.testing.assert_allclose(float(out.rot), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(out.vvel), 0.0, atol=1e-6)


def test_tran_rot_vvel_no_valid_estimates_is_nan():
    # outer grid all-NaN, centre finite: every r_est/s_est term touches an
    # outer cell, so rot and vvel have ZERO valid estimates — the reference
    # divides by size()==0 -> NaN (src/utilityFunctions.cpp:461-478); a
    # fabricated 0.0 rad/s would pass the bound gates as a real measurement
    vec = np.full((9, 2), np.nan, np.float32)
    vec[4] = (1.0, 1.0)  # r5, the centre vector (translation source)
    out = estimate_tran_rot_vvel(
        jnp.asarray(vec), jnp.float32(40.0), jnp.float32(400.0), jnp.float32(400.0),
        jnp.float32(2.0), jnp.float32(100.0), jnp.float32(0.1),
        jnp.float32(5.0), jnp.float32(5.0),
    )
    assert np.isnan(float(out.rot)) and np.isnan(float(out.vvel))
    assert np.all(np.isfinite(np.asarray(out.tran)))


def _pack_column_major(r):
    """r: dict k -> (vx, vy) in the reference's *flipped-y* working frame;
    returns the [9, 2] input array (screen coords, column-major order,
    src/utilityFunctions.cpp:358-369)."""
    order = [1, 4, 7, 2, 5, 8, 3, 6, 9]
    return np.array([[r[k][0], -r[k][1]] for k in order], np.float32)


def test_tran_rot_vvel_pure_rotation():
    """Rotational eigenfield: every r_est entry (src/utilityFunctions.cpp:
    421-447) equals +c, every s_est entry 0 -> rot = c/(dur*a), vvel = 0."""
    c = 0.5
    r = {
        1: (c, c), 9: (-c, -c), 3: (c, -c), 7: (-c, c),
        4: (0, c), 6: (0, -c), 2: (c, 0), 8: (-c, 0), 5: (0, 0),
    }
    out = estimate_tran_rot_vvel(
        jnp.asarray(_pack_column_major(r)), jnp.float32(1.0),
        jnp.float32(400.0), jnp.float32(400.0), jnp.float32(2.0),
        jnp.float32(100.0), jnp.float32(1.0), jnp.float32(5.0), jnp.float32(5.0),
    )
    np.testing.assert_allclose(np.asarray(out.tran), [0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(float(out.rot), c, atol=1e-5)
    np.testing.assert_allclose(float(out.vvel), 0.0, atol=1e-6)


def test_tran_rot_vvel_pure_scale():
    """Radial eigenfield: every s_est entry +c, every r_est 0 ->
    vvel = c*range/(dur*a), rot = 0."""
    c = 0.25
    r = {
        1: (-c, c), 9: (c, -c), 3: (c, c), 7: (-c, -c),
        4: (-c, 0), 6: (c, 0), 2: (0, c), 8: (0, -c), 5: (0, 0),
    }
    rng_ = 2.0
    out = estimate_tran_rot_vvel(
        jnp.asarray(_pack_column_major(r)), jnp.float32(1.0),
        jnp.float32(400.0), jnp.float32(400.0), jnp.float32(rng_),
        jnp.float32(100.0), jnp.float32(1.0), jnp.float32(5.0), jnp.float32(5.0),
    )
    np.testing.assert_allclose(float(out.rot), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(out.vvel), c * rng_, atol=1e-5)


def test_tran_rot_vvel_bounds_to_nan():
    vec = np.tile(np.array([0.0, 0.0], np.float32), (9, 1))
    # inject a huge rotational component via one vector pair
    vec[4] = [100.0, 0.0]  # r2 in column-major order -> r_est includes r2.x
    out = estimate_tran_rot_vvel(
        jnp.asarray(vec), jnp.float32(1.0), jnp.float32(400.0), jnp.float32(400.0),
        jnp.float32(2.0), jnp.float32(1e-6), jnp.float32(0.01),
        jnp.float32(0.1), jnp.float32(0.1),
    )
    assert np.isnan(float(out.rot)) or abs(float(out.rot)) <= 0.1


# ------------------------------ config ------------------------------------


def test_config_defaults_load():
    cfg = load_config()
    assert cfg.frame_size == 480
    assert cfg.sample_point_size == 120
    assert cfg.sample_point_size_lr == 240
    assert cfg.sample_point_count_sqrt == 4
    assert cfg.scan_diameter == 43
    assert cfg.calibration_coeff_x == pytest.approx(0.973)
    assert cfg.constraints.max_pixel_speed == 80
    assert cfg.ransac_threshold_rad_sq == pytest.approx(1.0)


def test_config_missing_param():
    with pytest.raises(ConfigError, match="missing required parameter"):
        load_config(overrides={"constraints": None})


def test_config_version_gate():
    with pytest.raises(ConfigError, match="version"):
        load_config(overrides={"version": "0.0.1"})


def test_config_scale_factor():
    cfg = load_config(overrides={"mrs_optic_flow": {"scale_factor": 2.0}})
    assert cfg.frame_size == 240
    assert cfg.sample_point_size == 60


def test_config_method_check():
    with pytest.raises(ConfigError, match="method"):
        load_config(overrides={"mrs_optic_flow": {"method": 7}})


def test_config_allsac_chosen_check():
    with pytest.raises(ConfigError, match="allsac"):
        load_config(overrides={"mrs_optic_flow": {"ransac": {"num_of_chosen": 3}}})


def test_config_tpu_block_optional():
    """The optional `tpu:` block reaches the engine; reference YAMLs
    without it (or with a bare empty `tpu:` header, which YAML maps to
    None) keep loading with defaults."""
    cfg = load_config(overrides={"tpu": None})  # absent/empty block
    assert cfg.backend == "fft"

    cfg = load_config(overrides={"tpu": {"backend": "dft"}})
    assert cfg.backend == "dft"

    from mrs_optic_flow_tpu.runtime import OpticFlowNode

    node = OpticFlowNode(cfg, publish=lambda t, m: None, log=lambda s: None)
    assert node.engine.config.backend == "dft"


@pytest.mark.parametrize("key, value", [
    ("use_pallas", True), ("use_pallas", False), ("mxu_passes", 3),
    ("half_spectrum", True), ("bands_per_step", 2), ("pairs_per_step", 2),
    ("band_stack", 2),
])
def test_config_rejects_removed_kernel_key(key, value):
    """Keys that chose among the removed kernels of the first build fail at load
    (the strict-load philosophy, src/optic_flow.cpp:1084-1087): the error
    names the key and says what it was, instead of silently meaning
    nothing."""
    from mrs_optic_flow_tpu.config import REMOVED_KERNEL_KEYS

    assert key in REMOVED_KERNEL_KEYS
    with pytest.raises(ConfigError, match=f"tpu/{key} chose a TPU Pallas kernel"):
        load_config(overrides={"tpu": {key: value}})


def test_shipped_config_loads_without_removed_keys():
    """configs/default.yaml itself sets none of the removed keys."""
    import pathlib

    import yaml

    from mrs_optic_flow_tpu.config import REMOVED_KERNEL_KEYS

    path = pathlib.Path(__file__).resolve().parents[1] / "configs" / "default.yaml"
    tree = yaml.safe_load(path.read_text())
    assert not set(tree.get("tpu") or {}) & set(REMOVED_KERNEL_KEYS)
    assert load_config().backend == "fft"
