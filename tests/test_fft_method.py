"""FftMethod engine tests: state threading, gating, long-range mode."""

import numpy as np
import pytest

import jax.numpy as jnp

from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig

from oracle import smooth_random_image

CFG = FftMethodConfig(backend="fft")  # fast on the CPU harness


def test_first_frame_zero_shift(rng):
    eng = FftMethod(CFG)
    state = eng.init_state()
    frame = smooth_random_image(rng, 480)
    state, res = eng.step(state, jnp.asarray(frame))
    # first frame correlates against itself -> ~zero shifts everywhere
    assert np.nanmax(np.abs(np.asarray(res.shifts))) < 0.5
    assert not bool(state.first)


def test_shift_sequence(rng):
    eng = FftMethod(CFG)
    state = eng.init_state()
    f0 = smooth_random_image(rng, 480)
    f1 = np.roll(f0, (4, -7), axis=(0, 1))
    state, _ = eng.step(state, jnp.asarray(f0))
    state, res = eng.step(state, jnp.asarray(f1))
    s = np.asarray(res.shifts)
    assert s.shape == (16, 2)
    assert np.all(np.abs(s - np.array([-7, 4])) < 0.3), s


def test_gating_rules():
    """Validity gates of src/FftMethod.cpp:1840-1854, checked point-by-point."""
    eng = FftMethod(CFG)
    raw = jnp.asarray(
        np.array(
            [
                [10.0, 10.0],  # fine
                [79.0, 0.0],  # |s| <= 80 but |sx| > S/2 = 60: rejected
                [60.0, 60.0],  # |s|^2 > 80^2: rejected
                [61.0, 0.0],  # |sx| > S/2 = 60: rejected
                [0.0, -61.0],  # |sy| > 60: rejected
                [np.nan, 3.0],  # NaN: rejected
            ],
            np.float32,
        )
    )
    gated = np.asarray(eng._gate(raw, 120, 80.0))
    valid = ~np.isnan(gated).any(axis=-1)
    assert valid.tolist() == [True, False, False, False, False, False]


def test_long_range_grid_shape(rng):
    eng = FftMethod(CFG)
    assert eng.sq_num == 4 and eng.sq_num_lr == 1
    state = eng.init_state()
    f0 = smooth_random_image(rng, 480)
    f1 = np.roll(f0, (12, -20), axis=(0, 1))
    state, _ = eng.step_long_range(state, jnp.asarray(f0))
    state, res = eng.step_long_range(state, jnp.asarray(f1))
    s = np.asarray(res.shifts)
    assert s.shape == (1, 2)
    # 4x downsampled: expect shift/4
    assert np.all(np.abs(s - np.array([-5.0, 3.0])) < 0.5), s


def test_step_batch(rng):
    eng = FftMethod(CFG)
    prev = np.stack([smooth_random_image(rng, 480) for _ in range(3)])
    d = [(2, 3), (-5, 1), (8, -8)]
    curr = np.stack([np.roll(prev[i], (d[i][1], d[i][0]), axis=(0, 1)) for i in range(3)])
    res = eng.step_batch(jnp.asarray(prev), jnp.asarray(curr))
    s = np.asarray(res.shifts)
    assert s.shape == (3, 16, 2)
    for i in range(3):
        assert np.all(np.abs(s[i] - np.array(d[i])) < 0.5)


def test_config_normalization():
    cfg = FftMethodConfig(frame_size=481, sample_point_size=100).normalized()
    assert cfg.frame_size == 480  # forced even (src/FftMethod.cpp:1707)
    assert cfg.sample_point_size == 480  # not a divisor -> one window (:1710-1716)


def test_bad_backend_rejected_at_construction():
    import pytest

    with pytest.raises(ValueError, match="backend"):
        FftMethod(FftMethodConfig(backend="nope"))


@pytest.mark.parametrize("mode", ["step", "step_batch"])
def test_backend_engine_equivalence(rng, mode):
    """The two spectral transforms (matmul DFT and XLA FFT) are one plain
    XLA path: the engine's flow agrees between them, per frame and batched."""
    f0 = smooth_random_image(rng, 480)
    f1 = np.roll(f0, (6, 2), axis=(0, 1))
    outs = []
    for backend in ("fft", "dft"):
        eng = FftMethod(FftMethodConfig(backend=backend))
        if mode == "step":
            state = eng.init_state()
            state, _ = eng.step(state, jnp.asarray(f0))
            _, res = eng.step(state, jnp.asarray(f1))
        else:
            res = eng.step_batch(jnp.asarray(f0)[None], jnp.asarray(f1)[None])
        outs.append(np.asarray(res.shifts))
    np.testing.assert_allclose(outs[0], outs[1], atol=5e-3)


def test_optic_flow_calc_compat(rng):
    """OpticFlowCalc wrapper: the reference's stateful interface
    (include/OpticFlowCalc.h:9-16) over the functional engine."""
    from mrs_optic_flow_tpu.models import OpticFlowCalc

    calc = OpticFlowCalc(FftMethod(CFG))
    f0 = smooth_random_image(rng, 480)
    f1 = np.roll(f0, (2, 5), axis=(0, 1))
    calc.set_im_prev(jnp.asarray(f0))
    raw = np.zeros((16, 2), np.float32)
    shifts = calc.process_image(jnp.asarray(f1), raw_output=raw)
    s = np.asarray(shifts)
    assert np.all(np.abs(s - np.array([5, 2])) < 0.3)
    assert np.abs(raw - np.array([5, 2])).max() < 0.3  # out-param filled


def test_unaligned_patch_size(rng):
    """Patch sizes off any power-of-two or 8-px alignment still work
    (e.g. 60-px patches, an 8x8 grid)."""
    eng = FftMethod(FftMethodConfig(frame_size=480, sample_point_size=60,
                                    backend="dft"))
    assert eng.sq_num == 8
    state = eng.init_state()
    f0 = smooth_random_image(rng, 480, cutoff=0.35)
    f1 = np.roll(f0, (2, -4), axis=(0, 1))
    state, _ = eng.step(state, jnp.asarray(f0))
    state, res = eng.step(state, jnp.asarray(f1))
    s = np.asarray(res.shifts)
    assert s.shape == (64, 2)
    med = np.nanmedian(s, axis=0)
    assert np.abs(med - np.array([-4, 2])).max() < 0.5, med


def test_step_batch_uint8_exact_inputs_bit_identical(rng):
    """uint8 frames stay uint8 until the engine casts them on device —
    results must be bit-identical to pre-converted float32 frames."""
    eng = FftMethod(FftMethodConfig(frame_size=64, sample_point_size=16))
    prev8 = (np.stack([smooth_random_image(rng, 64) for _ in range(3)]) * 255
             ).astype(np.uint8)
    curr8 = np.roll(prev8, 2, axis=2)
    r8 = eng.step_batch(jnp.asarray(prev8), jnp.asarray(curr8))
    rf = eng.step_batch(jnp.asarray(prev8, jnp.float32), jnp.asarray(curr8, jnp.float32))
    np.testing.assert_array_equal(np.asarray(r8.shifts), np.asarray(rf.shifts))
    np.testing.assert_array_equal(np.asarray(r8.response), np.asarray(rf.response))


def test_step_batch_long_range_matches_single(rng):
    """Batched long-range mode must agree with the per-frame step_long_range
    path (same resize, grid, and gating)."""
    import jax.numpy as jnp
    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
    from oracle import smooth_random_image

    eng = FftMethod(FftMethodConfig(frame_size=96, sample_point_size=24,
                                    long_range_ratio=4))
    b = 3
    prev = np.stack([smooth_random_image(rng, 96, cutoff=0.4) for _ in range(b)])
    curr = np.stack([np.roll(prev[i], (4 * (i + 1), -4), axis=(0, 1)) for i in range(b)])

    batched = eng.step_batch_long_range(jnp.asarray(prev), jnp.asarray(curr))
    assert batched.shifts.shape == (b, eng.num_windows_lr, 2)
    for i in range(b):
        state = eng.init_state()
        state, _ = eng.step_long_range(state, jnp.asarray(prev[i]))
        _, single = eng.step_long_range(state, jnp.asarray(curr[i]))
        np.testing.assert_allclose(
            np.asarray(batched.shifts[i]), np.asarray(single.shifts), atol=1e-4
        )


def test_long_range_small_downsampled_frame(rng):
    """frame/ratio < patch: the whole downsampled frame becomes the single
    long-range window instead of producing a zero-window reshape crash
    (frame 360 / patch 120 / ratio 4 -> 90 px window)."""
    import jax.numpy as jnp
    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
    from oracle import smooth_random_image

    eng = FftMethod(FftMethodConfig(frame_size=360, sample_point_size=120))
    assert eng.patch_lr == 90 and eng.num_windows_lr == 1
    prev = np.stack([smooth_random_image(rng, 360, cutoff=0.4)])
    curr = np.roll(prev, 8, axis=2)
    res = eng.step_batch_long_range(jnp.asarray(prev), jnp.asarray(curr))
    assert res.shifts.shape == (1, 1, 2)
    np.testing.assert_allclose(np.asarray(res.shifts)[0, 0], [2.0, 0.0], atol=0.3)


def test_quantized_state_carry(rng):
    """quantize_8bit (default True): the engine carries imPrev as uint8 like
    the reference's 8-bit pipeline (src/optic_flow.cpp:1597,
    src/FftMethod.cpp:1872).  On integral input the quantized and float32
    carries are numerically identical; fractional grays are rounded (the
    reference's convertTo quantization), which must not move the measured
    shift by more than the sub-LSB noise floor."""
    import jax.numpy as jnp
    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
    from oracle import smooth_random_image

    f0 = (smooth_random_image(rng, 64) * 255).astype(np.uint8)
    f1 = np.roll(f0, (2, -3), (0, 1))

    q = FftMethod(FftMethodConfig(frame_size=64, sample_point_size=16))
    assert q.config.quantize_8bit
    f = FftMethod(FftMethodConfig(frame_size=64, sample_point_size=16,
                                  quantize_8bit=False))

    sq = q.init_state()
    assert sq.prev.dtype == jnp.uint8
    sf = f.init_state()
    assert sf.prev.dtype == jnp.float32

    # integral frames: identical gated shifts through both carries
    sq, rq = q.step(sq, jnp.asarray(f0))
    sf, rf = f.step(sf, jnp.asarray(f0, jnp.float32))
    sq, rq = q.step(sq, jnp.asarray(f1))
    sf, rf = f.step(sf, jnp.asarray(f1, jnp.float32))
    assert sq.prev.dtype == jnp.uint8
    np.testing.assert_allclose(
        np.asarray(rq.shifts), np.asarray(rf.shifts), atol=1e-5
    )

    # fractional grays (the node's BGR mix): rounding stays sub-noise.
    # cutoff 0.35 gives real texture inside 16 px patches — at the default
    # 0.15 the patches are nearly flat and BOTH carries sit on fragile
    # sub-pixel peaks where 0.5 LSB legitimately moves weak windows
    g0 = smooth_random_image(rng, 64, cutoff=0.35)  # 0..255, fractional
    g1 = np.roll(g0, (2, -3), (0, 1))
    sq = q.init_state()
    sq, _ = q.step(sq, jnp.asarray(g0))
    assert sq.prev.dtype == jnp.uint8
    sq, rq2 = q.step(sq, jnp.asarray(g1))
    sf = f.init_state()
    sf, _ = f.step(sf, jnp.asarray(g0))
    sf, rf2 = f.step(sf, jnp.asarray(g1))
    np.testing.assert_allclose(
        np.asarray(rq2.shifts), np.asarray(rf2.shifts), atol=0.05
    )

    # set_im_prev honors the carry dtype
    st = q.set_im_prev(q.init_state(), jnp.asarray(g0))
    assert st.prev.dtype == jnp.uint8


def test_long_range_non_multiple_downsample(rng):
    """Downsampled frame NOT an exact multiple of the LR patch — a geometry
    the reference accepts (frame 600 / patch 120 / ratio 4 -> 150 px image,
    one 120 px window) — runs instead of crashing patchify's reshape: the
    LR core trims to the sq_num_lr*patch_lr grid, top-left aligned like the
    reference's Rect windows (src/FftMethod.cpp:1945-1957)."""
    import jax.numpy as jnp

    eng = FftMethod(FftMethodConfig(frame_size=600, sample_point_size=120))
    assert eng.patch_lr == 120 and eng.num_windows_lr == 1
    prev = smooth_random_image(rng, 600, cutoff=0.4)
    curr = np.roll(prev, (-8, 12), axis=(0, 1))
    # single-frame lane
    state = eng.init_state()
    state, _ = eng.step_long_range(state, jnp.asarray(prev))
    _, single = eng.step_long_range(state, jnp.asarray(curr))
    assert single.shifts.shape == (1, 2)
    np.testing.assert_allclose(
        np.asarray(single.shifts)[0], [3.0, -2.0], atol=0.3
    )
    # batched lane agrees
    batched = eng.step_batch_long_range(
        jnp.asarray(prev)[None], jnp.asarray(curr)[None]
    )
    np.testing.assert_allclose(
        np.asarray(batched.shifts[0]), np.asarray(single.shifts), atol=1e-4
    )


def test_unaligned_patch_uint8_exact_bit_identical(rng):
    """patch % 8 != 0 (100 px windows): uint8 frames give bit-identical
    results to pre-converted float32 frames there too."""
    eng = FftMethod(FftMethodConfig(frame_size=300, sample_point_size=100))
    assert eng.config.sample_point_size % 8 != 0
    prev8 = (smooth_random_image(rng, 300, cutoff=0.4) * 0.5 + 64).astype(np.uint8)
    curr8 = np.roll(prev8, (5, -9), axis=(0, 1))
    r8 = eng.step_batch(jnp.asarray(prev8)[None], jnp.asarray(curr8)[None])
    rf = eng.step_batch(
        jnp.asarray(prev8, jnp.float32)[None], jnp.asarray(curr8, jnp.float32)[None]
    )
    np.testing.assert_array_equal(np.asarray(r8.shifts), np.asarray(rf.shifts))
    np.testing.assert_allclose(
        np.asarray(r8.shifts)[0, 4], [-9.0, 5.0], atol=0.3
    )
