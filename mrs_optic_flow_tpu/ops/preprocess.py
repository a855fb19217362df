"""On-device image preprocessing.

The reference does all of this on the host CPU with OpenCV before uploading
to the GPU (``src/optic_flow.cpp:1602-1622``, ``src/FftMethod.cpp:1805-1806``);
here it runs inside the jitted device graph so that only the raw uint8 frame
crosses the host->device boundary — the transfer-cost lesson of the
reference's README (``README.md:85-88``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Weights of OpenCV's RGB2GRAY: gray = 0.299 R + 0.587 G + 0.114 B.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def to_grayscale(img: jnp.ndarray, *, swap_rb: bool = True) -> jnp.ndarray:
    """Channel-weighted grayscale of an ``[..., H, W, 3]`` image.

    ``swap_rb=True`` reproduces the reference's behaviour exactly: it decodes
    the ROS message as BGR8 (``src/optic_flow.cpp:1465``) and then applies
    ``CV_RGB2GRAY`` to that BGR buffer (``src/optic_flow.cpp:1622``), so the
    0.299 weight effectively lands on the *blue* channel — i.e. the RGB-order
    weights applied to the BGR channels AS-IS.  Set ``False`` for the
    colorimetrically-correct conversion of a BGR input (0.299 on channel 2).
    Matches ``native.bgr_to_gray`` mode-for-mode (conformance-tested against
    ``cv2.cvtColor`` in tests/test_native.py::test_gray_matches_opencv).
    """
    w = jnp.asarray(_GRAY_WEIGHTS, dtype=jnp.float32)
    if not swap_rb:
        w = w[::-1]
    # HIGHEST: at default precision a GPU runs this float32 contraction in
    # TF32, whose ~1e-3 relative error moves the rounded 8-bit gray by 1 LSB
    return jnp.tensordot(img.astype(jnp.float32), w, axes=([-1], [0]),
                         precision=jax.lax.Precision.HIGHEST)


def is_8bit(dtype) -> bool:
    """The one predicate behind the 8-bit fast paths: uint8/int8 pixels are
    exact in bfloat16 (8-bit integers fit its mantissa), so a bf16 hi/lo
    matmul split can drop the data's low-order pass."""
    return jnp.dtype(dtype) in (jnp.uint8, jnp.int8)


def quantize_u8(frame: jnp.ndarray) -> jnp.ndarray:
    """Round-and-saturate a float image to the reference's 8U pixels
    (``cv::cvtColor`` output is CV_8UC1, ``src/optic_flow.cpp:1622``).

    The single definition of the framework's 8-bit quantization: every
    quantize-to-carry site (``FftMethod._ingest``,
    ``ScaleRotationEstimator._ingest``, checkpoint resume) routes through
    here so the rounding semantics can never desynchronize between the
    engine carry, the log-polar ingest, and resume.  uint8 input passes
    through untouched.
    """
    frame = jnp.asarray(frame)
    if frame.dtype == jnp.uint8:
        return frame
    return jnp.clip(jnp.round(frame.astype(jnp.float32)), 0, 255).astype(
        jnp.uint8
    )


def center_crop(img: jnp.ndarray, frame_size: int, cx: float) -> jnp.ndarray:
    """Crop a ``frame_size``-square region centred on ``(cx, H/2)``.

    Mirrors the reference's cropping rectangle, which is centred on the
    camera's principal point in x for more symmetric distortion
    (``src/optic_flow.cpp:1610-1618``): ``xi = cx - frame_size/2``,
    ``yi = H/2 - frame_size/2``.  ``cx`` must be a static Python number (the
    crop offset is baked into the compiled program, like the reference bakes
    it per camera).  Returns ``[..., frame_size, frame_size]``.
    """
    h = img.shape[-2]
    xi = int(cx) - frame_size // 2
    yi = h // 2 - frame_size // 2
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(img, yi, yi + frame_size, axis=-2),
        xi,
        xi + frame_size,
        axis=-1,
    )


def crop_origin(img_width: int, img_height: int, frame_size: int, cx: float) -> tuple:
    """Upper-left corner ``(xi, yi)`` of the crop — the ``ulCorner`` passed to
    the geometry stage (``src/optic_flow.cpp:1719``)."""
    return int(cx) - frame_size // 2, img_height // 2 - frame_size // 2


def resize_by(img: jnp.ndarray, inv_scale: float) -> jnp.ndarray:
    """Bilinear resize by ``1/inv_scale`` on both axes.

    Equivalent of ``cv::resize(..., 1/scale, 1/scale)`` with the default
    INTER_LINEAR used for the scale factor (``src/optic_flow.cpp:1603``) and
    for long-range downsampling (``src/FftMethod.cpp:1931-1932``);
    ``jax.image.resize`` 'linear' uses the same half-pixel-centre convention.
    """
    new_shape = img.shape[:-2] + (
        round(img.shape[-2] / inv_scale),
        round(img.shape[-1] / inv_scale),
    )
    return jax.image.resize(img, new_shape, method="linear")


def patchify(frame: jnp.ndarray, patch: int) -> jnp.ndarray:
    """``[..., S*q, S*q] -> [..., q*q, S, S]`` non-overlapping patch grid.

    Row-major patch order ``index = i + q*j`` with ``i`` the column patch —
    identical to the field loop in the OpenCL kernel
    (``cl/FftMethod.cl:1407-1409``) and the decode loop
    (``src/FftMethod.cpp:413-418``).
    """
    *lead, h, w = frame.shape
    qy, qx = h // patch, w // patch
    x = frame.reshape(*lead, qy, patch, qx, patch)
    x = jnp.moveaxis(x, -2, -3)  # [..., qy, qx, S, S]
    return x.reshape(*lead, qy * qx, patch, patch)


def unpatchify(patches: jnp.ndarray, qy: int, qx: int) -> jnp.ndarray:
    """Inverse of :func:`patchify` for a ``[..., qy*qx, S, S]`` tensor."""
    *lead, _, s, _ = patches.shape
    x = patches.reshape(*lead, qy, qx, s, s)
    x = jnp.moveaxis(x, -2, -3)
    return x.reshape(*lead, qy * s, qx * s)
