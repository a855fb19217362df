"""FftMethod — the live flow engine (method 4 of the reference).

Rebuild of ``FftMethod`` (``src/FftMethod.cpp:1680-2007``,
``include/FftMethod.h``): a grid of ``sqNum x sqNum`` phase correlations per
frame pair, with validity gating, plus the 4x-downsampled long-range variant.

What changed in the re-design:

- the ctor's device-buffer zoo (usrc/FFT/FFTR/MUL/IFFTC/PCR/ML...,
  ``src/FftMethod.cpp:1723-1758``) disappears — XLA owns intermediate
  buffers inside the jitted program;
- the plan cache keyed by (size, depth) (``OCL_FftPlanCache``,
  ``include/FftMethod.h:284-317``) becomes the jit cache keyed by shape;
- the `useOCL` CPU/GPU switch (``src/FftMethod.cpp:1824-1836``) has no
  analogue: there is one device path, plain XLA, with ``backend`` choosing
  the spectral transform (cuFFT-backed ``fft`` or matmul ``dft``);
- the per-frame blocking enqueue + host readback decode loop
  (``src/FftMethod.cpp:398-472``) becomes one device program returning a
  ``[P, 2]`` array; a batched ``step_batch`` amortizes dispatch for
  throughput mode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from mrs_optic_flow_tpu.models.base import FlowEngine, FlowResult, FlowState
from mrs_optic_flow_tpu.ops.phase_correlate import (
    DEFAULT_CENTROID_RADIUS,
    DEFAULT_SEARCH_RADIUS,
    correlation_surface,
    peak_refine,
)
from mrs_optic_flow_tpu.ops.preprocess import patchify, resize_by


@dataclasses.dataclass(frozen=True)
class FftMethodConfig:
    """Static engine parameters (the FftMethod ctor args,
    ``src/FftMethod.cpp:1680-1684``)."""

    frame_size: int = 480  # config/default.yaml:32
    sample_point_size: int = 120  # config/default.yaml:33
    max_pixel_speed: float = 80.0  # config/default.yaml:63
    search_radius: int = DEFAULT_SEARCH_RADIUS  # src/FftMethod.cpp:819-822
    centroid_radius: int = DEFAULT_CENTROID_RADIUS  # cl/FftMethod.cl:1478
    long_range_ratio: int = 4  # LONG_RANGE_RATIO, src/FftMethod.cpp:3
    #: spectral transform, both plain XLA: 'fft' (XLA's FFT, cuFFT on the
    #: GPU) or 'dft' (matmul DFT at Precision.HIGHEST).  'fft' is the
    #: faster on an H100 at b=1 and at a 1024-pair batch (PERF.md)
    backend: str = "fft"
    #: carry ``imPrev`` as 8-bit grayscale like the reference (the node's
    #: cvtColor produces CV_8UC1 and FftMethod swaps that into imPrev,
    #: ``src/optic_flow.cpp:1597``, ``src/FftMethod.cpp:1872``; the float
    #: conversion at ``:1805`` happens per step, from the 8-bit image).
    #: Incoming float grays are rounded to uint8 before use, which matches
    #: the reference's quantization and quarters the carried state bytes.
    #: ``False`` keeps a float32 carry (no input rounding).
    quantize_8bit: bool = True

    def normalized(self) -> "FftMethodConfig":
        """Derived-size normalization from the reference ctor:
        even frame size (``src/FftMethod.cpp:1707-1709``), frame forced to a
        multiple of the patch else one window (``:1710-1716``)."""
        if self.backend not in ("dft", "fft"):
            # fail at construction, not at the first traced step (the config
            # layer's strict-load philosophy, src/optic_flow.cpp:1084-1087)
            raise ValueError(
                f"unknown backend {self.backend!r} (expected 'fft' or 'dft')"
            )
        frame = self.frame_size - (self.frame_size % 2)
        patch = self.sample_point_size
        if frame % patch != 0:
            patch = frame
        if frame == self.frame_size and patch == self.sample_point_size:
            return self
        return dataclasses.replace(self, frame_size=frame, sample_point_size=patch)


class FftMethod(FlowEngine):
    """Multi-patch FFT phase-correlation engine."""

    def __init__(self, config: FftMethodConfig = FftMethodConfig()):
        self.config = config.normalized()
        c = self.config
        #: grid side (sqNum = frameSize / samplePointSize, src/FftMethod.cpp:1719)
        self.sq_num = c.frame_size // c.sample_point_size
        #: long-range grid side (sqNum_lr = sqNum / LONG_RANGE_RATIO, :1720);
        #: the long-range patch size equals the normal one (:1685) — unless
        #: the downsampled frame is smaller than the patch (e.g. frame 360 /
        #: patch 120 / ratio 4 -> 90 px), where the whole downsampled frame
        #: becomes the single window (the reference's sqNum_lr would be 0
        #: there and its node-side bookkeeping indexes out of bounds;
        #: ARCHITECTURE.md deviation 5)
        self.patch_lr = min(c.sample_point_size, c.frame_size // c.long_range_ratio)
        self.sq_num_lr = max(
            (c.frame_size // c.long_range_ratio) // self.patch_lr, 1
        )
        self.num_windows = self.sq_num * self.sq_num
        self.num_windows_lr = self.sq_num_lr * self.sq_num_lr

    # -- state ---------------------------------------------------------------

    def init_state(self) -> FlowState:
        c = self.config
        dt = jnp.uint8 if c.quantize_8bit else jnp.float32
        return FlowState(
            prev=jnp.zeros((c.frame_size, c.frame_size), dt),
            first=jnp.asarray(True),
        )

    def _ingest(self, frame: jnp.ndarray) -> jnp.ndarray:
        """Frame as carried: rounded uint8 when ``quantize_8bit`` (the
        reference's 8-bit pipeline; pass-through for already-8-bit input),
        float32 otherwise."""
        if not self.config.quantize_8bit:
            return jnp.asarray(frame, jnp.float32)
        from mrs_optic_flow_tpu.ops.preprocess import quantize_u8

        return quantize_u8(frame)

    def set_im_prev(self, state: FlowState, frame: jnp.ndarray) -> FlowState:
        """``OpticFlowCalc::setImPrev`` with the engine's carry dtype."""
        return FlowState(prev=self._ingest(frame), first=jnp.asarray(False))

    # -- core ----------------------------------------------------------------

    def _correlate_frames(self, curr: jnp.ndarray, prev: jnp.ndarray, patch: int):
        """Frame(s) ``[(B,) H, W]`` -> per-window (shifts, response), field
        order ``index = i + q*j`` (``src/FftMethod.cpp:417``)."""
        c = self.config
        surf = correlation_surface(
            patchify(curr, patch).astype(jnp.float32),
            patchify(prev, patch).astype(jnp.float32),
            search_radius=c.search_radius, backend=c.backend,
        )
        return peak_refine(surf, centroid_radius=c.centroid_radius)

    def _lr_correlate(self, curr_d: jnp.ndarray, prev_d: jnp.ndarray):
        """Downsampled frame(s) ``[(B,) h, w]`` -> raw LR shifts/response.

        Shared by :meth:`step_long_range` and
        :meth:`step_batch_long_range`: TRIMS to the ``sq_num_lr * patch_lr``
        window grid first (top-left aligned, matching the reference's
        Rect-based window placement, ``src/FftMethod.cpp:1945-1957``) so
        geometries where the downsampled frame is not an exact multiple of
        the LR patch — which the reference accepts, e.g. frame 600 / patch
        120 / ratio 4 -> a 150 px image with one 120 px window — no longer
        crash ``patchify``'s reshape."""
        m = self.sq_num_lr * self.patch_lr
        return self._correlate_frames(
            curr_d[..., :m, :m], prev_d[..., :m, :m], self.patch_lr
        )

    def _gate(self, shifts: jnp.ndarray, patch: int, max_speed: float) -> jnp.ndarray:
        """Validity gating -> NaN poisoning (``src/FftMethod.cpp:1840-1854``):
        reject ``|s|^2 > max_px^2``, ``|sx| > S/2``, ``|sy| > S/2``, NaN."""
        sx, sy = shifts[..., 0], shifts[..., 1]
        ok = (sx * sx + sy * sy) <= max_speed * max_speed
        ok &= jnp.abs(sx) <= patch / 2.0
        ok &= jnp.abs(sy) <= patch / 2.0
        ok &= jnp.isfinite(sx) & jnp.isfinite(sy)
        return jnp.where(ok[..., None], shifts, jnp.nan)

    # -- public steps ----------------------------------------------------------

    @functools.partial(jax.jit, static_argnames=("self",))
    def step(self, state: FlowState, frame: jnp.ndarray) -> Tuple[FlowState, FlowResult]:
        """``FftMethod::processImage`` (``src/FftMethod.cpp:1772-1903``).

        ``frame``: grayscale ``[H, W]`` (uint8 or float); conversion to
        float32 happens on device (``convertTo(CV_32FC1)``, ``:1805``).
        """
        c = self.config
        curr = self._ingest(frame)
        prev = jnp.where(state.first, curr, state.prev)  # first-frame copy (:1788)
        raw, resp = self._correlate_frames(curr, prev, c.sample_point_size)
        shifts = self._gate(raw, c.sample_point_size, c.max_pixel_speed)

        new_state = FlowState(prev=curr, first=jnp.asarray(False))  # imPrev swap (:1872)
        return new_state, FlowResult(shifts=shifts, shifts_raw=raw, response=resp)

    @functools.partial(jax.jit, static_argnames=("self",))
    def step_long_range(
        self, state: FlowState, frame: jnp.ndarray
    ) -> Tuple[FlowState, FlowResult]:
        """``processImageLongRange`` (``src/FftMethod.cpp:1905-2007``):
        both frames downsampled by LONG_RANGE_RATIO (``:1931-1932``), coarser
        ``sq_num_lr`` grid at the same patch size, same gating with the
        long-range bounds (``max_px_speed_lr = max_px_speed``, ``:1687``).
        """
        c = self.config
        curr = self._ingest(frame)
        prev = jnp.where(state.first, curr, state.prev)

        # bilinear resize in float32 on the (possibly 8-bit) carry; the
        # reference resizes the 8U images and keeps 8U output (:1931-1932) —
        # a <=0.5 LSB rounding deviation on the downsampled pixels
        curr_d = resize_by(curr.astype(jnp.float32), c.long_range_ratio)
        prev_d = resize_by(prev.astype(jnp.float32), c.long_range_ratio)
        raw, resp = self._lr_correlate(curr_d, prev_d)
        shifts = self._gate(raw, self.patch_lr, c.max_pixel_speed)

        new_state = FlowState(prev=curr, first=jnp.asarray(False))
        return new_state, FlowResult(shifts=shifts, shifts_raw=raw, response=resp)

    @functools.partial(jax.jit, static_argnames=("self",))
    def step_batch(self, prev_frames: jnp.ndarray, curr_frames: jnp.ndarray) -> FlowResult:
        """Throughput mode: ``[B, H, W]`` frame pairs -> ``[B, P, 2]`` shifts.

        No reference equivalent — the OpenCL kernel processes one frame pair
        per blocking enqueue (``src/FftMethod.cpp:398``); batching is how the
        device amortizes dispatch (SURVEY.md section 2, parallelism item 1).
        """
        c = self.config
        # the engine's carry discipline applies to the batched modes too
        # (quantize_8bit rounds float frames to the reference's 8U pixels),
        # keeping step / step_batch / fleet paths numerically consistent
        curr_frames = self._ingest(curr_frames)
        prev_frames = self._ingest(prev_frames)
        raw, resp = self._correlate_frames(
            curr_frames, prev_frames, c.sample_point_size
        )
        shifts = self._gate(raw, c.sample_point_size, c.max_pixel_speed)
        return FlowResult(shifts=shifts, shifts_raw=raw, response=resp)

    @functools.partial(jax.jit, static_argnames=("self",))
    def step_batch_long_range(
        self, prev_frames: jnp.ndarray, curr_frames: jnp.ndarray
    ) -> FlowResult:
        """Batched long-range mode: ``[B, H, W]`` frame pairs, both 4x
        downsampled (``src/FftMethod.cpp:1931-1932``), coarser grid — the
        throughput analogue of :meth:`step_long_range` for fleet serving at
        takeoff / low altitude.  Returns ``[B, P_lr, 2]`` shifts."""
        c = self.config
        # _ingest first so the carry discipline matches step_long_range
        curr_d = resize_by(self._ingest(curr_frames).astype(jnp.float32), c.long_range_ratio)
        prev_d = resize_by(self._ingest(prev_frames).astype(jnp.float32), c.long_range_ratio)
        raw, resp = self._lr_correlate(curr_d, prev_d)
        shifts = self._gate(raw, self.patch_lr, c.max_pixel_speed)
        return FlowResult(shifts=shifts, shifts_raw=raw, response=resp)

    # hashable/static for jax.jit static_argnames=("self",)
    def __hash__(self):
        return hash(self.config)

    def __eq__(self, other):
        return isinstance(other, FftMethod) and self.config == other.config
