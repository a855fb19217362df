"""Scale / rotation estimator via log-polar phase correlation.

Rebuild of ``scaleRotationEstimator`` (``src/scaleRotationEstimator.cpp``):
log-polar transform of each frame (Lanczos4, ``:113``), phase correlation of
consecutive log-polar images, decode ``scale = exp(dx / M)``,
``rot = (dy / Ky) * pi/180`` (``:123-124``).  The node maps scale to vertical
velocity and rotation to yaw rate (``scale_rot_output``,
``config/default.yaml:15``; the wiring in the reference node is commented
out, ``src/optic_flow.cpp:1629-1650`` — here it is live through the runtime
layer).

Device design (unlike the reference's single CPU ``cv::phaseCorrelate``
call): the correlation runs through the same plain XLA phase correlation as
the flow engine (``backend`` = matmul DFT or XLA FFT), batched over frames.
``lp_resolution``
optionally shrinks the log-polar image (decode constants are rescaled so
the configured ``magnitude`` semantics are preserved); ``step_batch`` is the
fleet/throughput variant, and :class:`~mrs_optic_flow_tpu.runtime.fleet.FleetServer`
exposes it per tick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from mrs_optic_flow_tpu.ops.logpolar import build_lp_plan, logpolar
from mrs_optic_flow_tpu.ops.phase_correlate import correlation_surface, peak_refine


#: (n, res, magnitude, interp) -> (LPPlan, numpy weight tuple); shared across
#: estimator instances (tests build many estimators at the same geometry)
_PLAN_CACHE: dict = {}
#: (plan key, backend) -> device-put weight tuple
_DEVICE_WEIGHTS: dict = {}


def _plan_and_weights(n: int, res: int, magnitude: float, interp: str):
    key = (n, res, float(magnitude), interp)
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = build_lp_plan(
            n, magnitude, resolution=res, interp=interp
        )
    return _PLAN_CACHE[key]


class ScaleRotState(NamedTuple):
    prev_logpolar: jnp.ndarray  # [N, N] float32
    first: jnp.ndarray  # scalar bool


class ScaleRotResult(NamedTuple):
    scale: jnp.ndarray  # scalar: frame-to-frame scale factor (1.0 = none)
    rotation: jnp.ndarray  # scalar: frame-to-frame rotation [rad]


@dataclasses.dataclass(frozen=True)
class ScaleRotationConfig:
    resolution: int = 480  # square frame size (ctor arg, :5)
    magnitude: float = 49.9  # optimM (scale_rot_magnitude, config/default.yaml:14)
    #: log-polar image size; None = ``resolution`` (reference geometry).
    #: Smaller trades decode granularity for speed — magnitude and Ky are
    #: rescaled by ``lp_resolution / resolution`` so the decode stays
    #: consistent with the configured ``magnitude``.
    lp_resolution: Optional[int] = None
    #: log-polar interpolation: "lanczos4" (the reference's INTER_LANCZOS4,
    #: src/scaleRotationEstimator.cpp:113) or "bilinear" (cheaper; accuracy
    #: delta quantified in tests/test_logpolar.py)
    interp: str = "lanczos4"
    backend: str = "dft"  # dft (matmul DFT) | fft (XLA FFT)
    #: output rows per ``lax.map`` step of the log-polar resample — bounds
    #: the dense one-hot weight temporaries (``ops/logpolar.py``); tuned by
    #: ``scripts/tune_scale_rotation.py``
    lp_rows_per_chunk: int = 8
    #: streams per ``lax.map`` step of the BATCHED resample
    #: (``step_batch*``): a plain vmap multiplies the x-pass ``t1``
    #: temporaries by the stream count ([B, p8, yln, cc] — ~240 MB at 16
    #: streams x production geometry), while the per-stream matmuls are
    #: already large (M = p8*cc ~ 7.8k).  1 bounds the temporaries at one
    #: stream; the best chunk on the GPU is not measured yet
    #: (``scripts/tune_scale_rotation.py`` sweeps it).  0 disables chunking
    #: (plain vmap).  Under a MESH a
    #: ``lax.map`` over the GSPMD-sharded batch axis would serialize
    #: across devices, so ``BatchPipeline._sr_resample`` runs the chunked
    #: form inside ``shard_map`` (per-device local chunking) and falls
    #: back to vmap for uneven batches or <=1 local stream.
    lp_batch_chunk: int = 1
    #: round incoming float grays to uint8 before the log-polar resample —
    #: the reference feeds its 8-bit gray pipeline into ``cv::logPolar``
    #: (``src/scaleRotationEstimator.cpp:108-113`` on the CV_8UC1 imCurr),
    #: and 8-bit-exact inputs let the resample drop one of its three bf16
    #: matmul passes (``ops/logpolar.py``)
    quantize_8bit: bool = True

    @property
    def lp_res(self) -> int:
        return self.lp_resolution or self.resolution


class ScaleRotationEstimator:
    def __init__(self, config: ScaleRotationConfig = ScaleRotationConfig()):
        # fail at construction, not at the first traced step (the same
        # strict-load discipline as FftMethodConfig.normalized())
        if config.backend not in ("dft", "fft"):
            raise ValueError(
                f"unknown backend {config.backend!r} (expected 'fft' or 'dft')"
            )
        if config.interp not in ("lanczos4", "bilinear"):
            raise ValueError(
                f"unknown interp {config.interp!r} "
                "(expected 'lanczos4' or 'bilinear')"
            )
        self.config = config
        r = config.lp_res / config.resolution
        #: effective optimM at the log-polar resolution
        self.m_eff = config.magnitude * r
        #: Ky = lp_rows / 360 (src/scaleRotationEstimator.cpp:28 at r=1)
        self.ky = config.lp_res / 360.0
        #: precomputed log-polar resample plan (None when the geometry lacks
        #: the 8-fold symmetry — the per-frame weight-build path then runs);
        #: the matching weight arrays are threaded as jit ARGUMENTS through
        #: every program that fuses this estimator (``lp_weights``) — a
        #: traced-over concrete array would be embedded as an HLO literal
        #: (see ``ops/logpolar.py``)
        pw = _plan_and_weights(
            config.resolution, config.lp_res, self.m_eff, config.interp
        )
        self.lp_plan = pw[0] if pw is not None else None
        self._lp_weights_np = pw[1] if pw is not None else ()

    @property
    def lp_weights(self) -> tuple:
        """Device-resident weight tuple for the precomputed resample path
        (empty when :attr:`lp_plan` is None).  Pass this into any OUTER
        jitted program that traces ``step_w``/``step_batch_w``/
        ``step_batch_carried_w``."""
        if self.lp_plan is None:
            return ()
        key = (
            self.config.resolution, self.config.lp_res, self.m_eff,
            self.config.interp, jax.default_backend(),
        )
        if key not in _DEVICE_WEIGHTS:
            _DEVICE_WEIGHTS[key] = tuple(
                jax.device_put(w) for w in self._lp_weights_np
            )
        return _DEVICE_WEIGHTS[key]

    def init_state(self) -> ScaleRotState:
        n = self.config.lp_res
        dt = jnp.uint8 if self.config.quantize_8bit else jnp.float32
        return ScaleRotState(
            prev_logpolar=jnp.zeros((n, n), dt), first=jnp.asarray(True)
        )

    # -- internals -----------------------------------------------------------

    def _ingest(self, frame: jnp.ndarray) -> jnp.ndarray:
        """Frame as resampled: rounded uint8 when ``quantize_8bit`` (the
        reference's 8-bit pipeline; pass-through for already-8-bit input),
        float32 otherwise — the same contract as ``FftMethod._ingest``."""
        if not self.config.quantize_8bit:
            return jnp.asarray(frame, jnp.float32)
        from mrs_optic_flow_tpu.ops.preprocess import quantize_u8

        return quantize_u8(frame)

    def _logpolar(self, frame: jnp.ndarray) -> jnp.ndarray:
        """Eager/standalone resample (tests, host-side fixtures); fused
        programs must use :meth:`_logpolar_w` with threaded weights."""
        return self._logpolar_w(frame, self.lp_weights)

    def _logpolar_w(self, frame: jnp.ndarray, weights: tuple) -> jnp.ndarray:
        c = self.config
        # uint8 frames are exact in bf16, letting the resample drop one of
        # its three matmul passes (ops/logpolar.py)
        lp = logpolar(
            self._ingest(frame),
            self.m_eff,
            resolution=c.lp_res,
            interp=c.interp,
            rows_per_chunk=c.lp_rows_per_chunk,
            plan=self.lp_plan if weights else None,
            weights=weights or None,
        )
        if not c.quantize_8bit:
            return lp
        # the reference's cv::logPolar writes an 8-bit image (tempIm is
        # CV_8UC1 because imCurr is) and converts to CV_32F only for
        # cv::phaseCorrelate (src/scaleRotationEstimator.cpp:108-117), so
        # the correlated data — and the carried previous image — is
        # round-and-saturated to 8 bits.  Also 4x less HBM for the fleet's
        # per-stream carry, and the correlation inputs become 8-bit-exact.
        from mrs_optic_flow_tpu.ops.preprocess import quantize_u8

        return quantize_u8(lp)

    def _logpolar_batch_w(
        self, frames: jnp.ndarray, weights: tuple, *, chunk: Optional[int] = None
    ) -> jnp.ndarray:
        """Batched resample ``[B, n, n] -> [B, lp, lp]``, processed
        ``lp_batch_chunk`` streams per ``lax.map`` step (``chunk``
        overrides the config — ``BatchPipeline`` forces vmap mode (0) when
        the batch axis is GSPMD-sharded and runs the chunked form inside
        ``shard_map`` instead).

        A plain ``vmap`` scales the x-pass ``t1`` temporaries with the
        stream batch; chunking bounds them at ``lp_batch_chunk`` streams.
        The matmul sizes are carried by the per-stream shapes, not the
        stream batch."""
        b = frames.shape[0]
        g = int(self.config.lp_batch_chunk if chunk is None else chunk)
        g = min(g, b)
        one = lambda f: self._logpolar_w(f, weights)  # noqa: E731
        if g <= 0 or b <= g:
            return jax.vmap(one)(frames)
        n_chunks = -(-b // g)
        pad = n_chunks * g - b
        if pad:
            frames = jnp.concatenate(
                [frames, jnp.zeros((pad,) + frames.shape[1:], frames.dtype)]
            )
        chunked = frames.reshape((n_chunks, g) + frames.shape[1:])
        out = jax.lax.map(jax.vmap(one), chunked)
        return out.reshape((n_chunks * g,) + out.shape[2:])[:b]

    def _correlate(self, lp_c: jnp.ndarray, lp_p: jnp.ndarray):
        """Phase-correlate log-polar images ``[..., N, N]``;
        returns ``(shift [..., 2], maxval [...])``."""
        c = self.config
        surf = correlation_surface(
            lp_c, lp_p, search_radius=c.lp_res // 2, backend=c.backend
        )
        return peak_refine(surf)

    def _decode(self, shift: jnp.ndarray, gate: jnp.ndarray):
        """``pt`` -> (scale, rot) per ``src/scaleRotationEstimator.cpp:
        119-124``; ``gate`` True forces the no-estimate result (1, 0)."""
        n = self.config.lp_res
        pt = -shift  # back to the cv::phaseCorrelate sign (src/FftMethod.cpp:1836)
        in_range = jnp.abs(pt[..., 0]) <= n / 2  # (:119, both checks test pt.x)
        bad = gate | ~in_range
        scale = jnp.where(bad, 1.0, jnp.exp(pt[..., 0] / self.m_eff))
        rot = jnp.where(bad, 0.0, (pt[..., 1] / self.ky) * (jnp.pi / 180.0))
        return scale, rot

    # -- public steps ----------------------------------------------------------
    #
    # Each step comes in two forms: ``step*_w(..., weights)`` is the plain
    # traceable function for OUTER jitted programs (node frame program,
    # BatchPipeline, FleetServer tick) — the caller threads
    # :attr:`lp_weights` through its own argument list; the weight-less
    # public wrapper jits with the weights injected as arguments, so eager
    # callers keep the round-2 signatures.

    def step_w(
        self, state: ScaleRotState, frame: jnp.ndarray, weights: tuple
    ) -> Tuple[ScaleRotState, ScaleRotResult]:
        """``processImage`` (``src/scaleRotationEstimator.cpp:34-148``).

        The first frame returns (1, 0) (``:74-75``), as does an
        out-of-range correlation peak (``:119-121``).
        """
        lp = self._logpolar_w(frame, weights)
        prev_lp = jnp.where(state.first, lp, state.prev_logpolar)
        shift, _resp = self._correlate(lp, prev_lp)
        scale, rot = self._decode(shift, state.first)
        new_state = ScaleRotState(prev_logpolar=lp, first=jnp.asarray(False))
        return new_state, ScaleRotResult(scale=scale, rotation=rot)

    def step_batch_w(
        self, prev_frames: jnp.ndarray, curr_frames: jnp.ndarray,
        weights: tuple, *,
        lp_p: Optional[jnp.ndarray] = None,
        lp_c: Optional[jnp.ndarray] = None,
    ) -> ScaleRotResult:
        """Stateless batched mode: ``[B, N, N]`` frame pairs ->
        per-pair (scale [B], rotation [B]).  The throughput/fleet analogue
        of :meth:`step` (no reference equivalent — the reference is strictly
        frame-to-frame); same decode as ``src/scaleRotationEstimator.cpp:
        117-124``.  The log-polar resample runs ``lp_batch_chunk`` streams
        per ``lax.map`` step (:meth:`_logpolar_batch_w`); the correlation
        runs as ONE batched device program.  ``lp_p``/``lp_c`` accept
        already-resampled log-polar images (``BatchPipeline`` computes them
        under ``shard_map`` when the batch is mesh-sharded)."""
        if lp_p is None:
            lp_p = self._logpolar_batch_w(prev_frames, weights)
        if lp_c is None:
            lp_c = self._logpolar_batch_w(curr_frames, weights)
        shift, _resp = self._correlate(lp_c, lp_p)
        scale, rot = self._decode(shift, jnp.zeros(shift.shape[:-1], bool))
        return ScaleRotResult(scale=scale, rotation=rot)

    def step_batch_carried_w(
        self, prev_lp: jnp.ndarray, curr_frames: jnp.ndarray, weights: tuple,
        *, lp_c: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, ScaleRotResult]:
        """Fleet-serving variant: previous frames enter as already-computed
        log-polar images (carried on device across ticks, like the
        FleetServer's preprocessed ``prev``), so each tick pays ONE log-polar
        resample per stream instead of two.  Returns ``(curr_lp, result)``;
        feed ``curr_lp`` back as the next tick's ``prev_lp``.  ``lp_c``
        accepts an already-resampled current batch (the mesh path — see
        :meth:`step_batch_w`)."""
        if lp_c is None:
            lp_c = self._logpolar_batch_w(curr_frames, weights)
        shift, _resp = self._correlate(lp_c, prev_lp)
        scale, rot = self._decode(shift, jnp.zeros(shift.shape[:-1], bool))
        return lp_c, ScaleRotResult(scale=scale, rotation=rot)

    @functools.partial(jax.jit, static_argnames=("self",))
    def _step_jit(self, state, frame, weights):
        return self.step_w(state, frame, weights)

    def step(
        self, state: ScaleRotState, frame: jnp.ndarray
    ) -> Tuple[ScaleRotState, ScaleRotResult]:
        """Jitted :meth:`step_w` with this estimator's weights."""
        return self._step_jit(state, frame, self.lp_weights)

    @functools.partial(jax.jit, static_argnames=("self",))
    def _step_batch_jit(self, prev_frames, curr_frames, weights):
        return self.step_batch_w(prev_frames, curr_frames, weights)

    def step_batch(
        self, prev_frames: jnp.ndarray, curr_frames: jnp.ndarray
    ) -> ScaleRotResult:
        """Jitted :meth:`step_batch_w` with this estimator's weights."""
        return self._step_batch_jit(prev_frames, curr_frames, self.lp_weights)

    @functools.partial(jax.jit, static_argnames=("self",))
    def _step_batch_carried_jit(self, prev_lp, curr_frames, weights):
        return self.step_batch_carried_w(prev_lp, curr_frames, weights)

    def step_batch_carried(
        self, prev_lp: jnp.ndarray, curr_frames: jnp.ndarray
    ) -> Tuple[jnp.ndarray, ScaleRotResult]:
        """Jitted :meth:`step_batch_carried_w` with this estimator's
        weights."""
        return self._step_batch_carried_jit(
            prev_lp, curr_frames, self.lp_weights
        )

    @functools.partial(jax.jit, static_argnames=("self",))
    def _logpolar_batch_jit(self, frames, weights):
        return self._logpolar_batch_w(frames, weights)

    def logpolar_batch(self, frames: jnp.ndarray) -> jnp.ndarray:
        """Jitted batched resample ``[B, N, N] -> [B, lp, lp]`` — the fleet
        carry (re)builder (one compiled dispatch instead of an eager vmap)."""
        return self._logpolar_batch_jit(frames, self.lp_weights)

    def __hash__(self):
        return hash(self.config)

    def __eq__(self, other):
        return isinstance(other, ScaleRotationEstimator) and self.config == other.config
