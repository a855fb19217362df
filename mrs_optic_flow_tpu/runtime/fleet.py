"""FleetServer — many camera streams, one batched device dispatch per tick.

The production-serving shape for fleet workloads: ``N`` UAV camera streams
each carry their own previous-frame state (the reference's ``imPrev`` swap,
``src/FftMethod.cpp:1872``, per stream) and every tick runs the ENTIRE
fleet's flow + geometry as one ``BatchPipeline`` program.  The previous
frames live on device and are reused from the last tick's inputs, so each
tick transfers only the new frames — the host->device traffic of a single
camera, times the fleet, with zero re-uploads.

The reference is structurally single-stream (one nodelet per camera, one
blocking OpenCL enqueue per frame); this layer is the scaling story on top
of the same math (SURVEY.md section 2, parallelism item 1: batch frame
pairs per step).  Under a mesh the fleet batch shards over the devices'
``data`` axis like any other batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.parallel.pipeline import BatchPipeline


@dataclasses.dataclass
class FleetTick:
    """One tick's results, still on device — materialize lazily so a caller
    can keep a tick in flight while feeding the next (the ServingLoop
    double-buffer pattern)."""

    ok: jnp.ndarray  # [N] valid motion estimate this tick
    tran: jnp.ndarray  # [N, 3] camera-frame velocity
    rot: jnp.ndarray  # [N, 4] rate quaternion
    shifts: jnp.ndarray  # [N, P, 2]
    dts: np.ndarray  # [N] per-stream frame spacing used
    #: per-stream log-polar (scale, rotation) — filled only when the server
    #: was built with a ScaleRotationEstimator (NaN where the tick is invalid)
    scale: Optional[jnp.ndarray] = None  # [N]
    rotation: Optional[jnp.ndarray] = None  # [N] rad

    def materialize(self) -> "FleetTick":
        return FleetTick(
            ok=np.asarray(self.ok),
            tran=np.asarray(self.tran),
            rot=np.asarray(self.rot),
            shifts=np.asarray(self.shifts),
            dts=self.dts,
            scale=None if self.scale is None else np.asarray(self.scale),
            rotation=None if self.rotation is None else np.asarray(self.rotation),
        )


class FleetServer:
    """Batched per-tick serving over ``n_streams`` stateful camera streams.

    ``tick(frames, stamps, heights, ...)`` consumes one frame per stream
    (``mask`` marks streams that produced no frame this tick — their state
    is carried, their output gated off) and returns a :class:`FleetTick`.

    All streams share one camera->body rotation (a homogeneous fleet); use
    one server per camera mounting otherwise.
    """

    def __init__(
        self,
        pipeline: BatchPipeline,
        n_streams: int,
        *,
        c2b_quat=(0.0, 0.0, 0.0, 1.0),
        long_range: bool = False,
        cam_yaw: Optional[float] = None,
        seed: int = 0,
        scale_rotation=None,
    ):
        """``long_range=True`` runs the fleet through the 4x-downsampled
        long-range path (takeoff / low altitude; the reference's
        ``long_range_mode``) — pass per-stream ``roll_rates``/``pitch_rates``
        to :meth:`tick` for the rate feed-forward correction.

        ``scale_rotation``: an optional ``ScaleRotationEstimator`` (its
        ``resolution`` must equal the pipeline frame size); when set, every
        tick also runs the batched log-polar scale/rotation estimate
        (``step_batch_carried`` — the per-stream log-polar image carries on
        device, one resample per stream per tick) and fills
        ``FleetTick.scale`` / ``FleetTick.rotation``.  Defaults to the
        pipeline's own ``scale_rotation`` estimator; when the pipeline was
        built with one, the short-range tick runs the SR leg FUSED inside
        the pipeline program (``BatchPipeline.step_pre_carried`` — one
        dispatch per tick), otherwise SR is a second dispatch."""
        self.pipeline = pipeline
        self.n = n_streams
        self.c2b = jnp.asarray(c2b_quat, jnp.float32)
        self.long_range = long_range
        if cam_yaw is None:
            # derive like OpticFlowNode.set_transforms: cam_yaw =
            # yaw(inverse(c2b)) + pi/2 (src/optic_flow.cpp:1206-1208) — the
            # identity mount maps to pi/2, which get_2dt's rebuilt rate
            # feed-forward reads as mount yaw 0 (deviation 21); the old 0.0
            # default silently meant "camera yawed 90 deg on the body"
            from mrs_optic_flow_tpu.utils.quat_np import (
                np_quat_inverse,
                np_rpy_from_quat,
            )

            _, _, inv_yaw = np_rpy_from_quat(
                np_quat_inverse(np.asarray(c2b_quat, float))
            )
            cam_yaw = float(inv_yaw) + np.pi / 2
        self.cam_yaw = float(cam_yaw)
        if scale_rotation is None:
            scale_rotation = getattr(pipeline, "scale_rotation", None)
        self.scale_rotation = scale_rotation
        #: SR fused into the pipeline program (short-range only: the
        #: long-range fleet keeps the separate batched SR dispatch)
        self._sr_fused = (
            scale_rotation is not None
            and getattr(pipeline, "scale_rotation", None) is scale_rotation
            and not long_range
        )
        if scale_rotation is not None and (
            scale_rotation.config.resolution != pipeline.frame_size
        ):
            raise ValueError(
                "scale_rotation.resolution must equal the pipeline frame size"
            )
        self._key = jax.random.PRNGKey(seed)
        self._prev: Optional[jnp.ndarray] = None  # [N, F, F] preprocessed, on device
        self._prev_lp: Optional[jnp.ndarray] = None  # [N, L, L] log-polar carry
        self._prev_stamps = np.zeros(n_streams)
        self._seen = np.zeros(n_streams, bool)

    def _build_lp_carry(self, frames: jnp.ndarray) -> jnp.ndarray:
        """Initial / checkpoint-rebuild log-polar carry.  When the SR leg
        is fused into the pipeline program, the carry must be produced by
        the PIPELINE's resample (``BatchPipeline.logpolar_carry``) so its
        sharding matches exactly what ``step_pre_carried`` declares for
        ``prev_lp`` under a mesh; the estimator's own jit lets GSPMD infer
        a sharding the next dispatch can reject."""
        if self._sr_fused and hasattr(self.pipeline, "logpolar_carry"):
            return self.pipeline.logpolar_carry(frames)
        return self.scale_rotation.logpolar_batch(frames)

    def reset(self, stream_id: Optional[int] = None):
        """Drop carried state (all streams, or one) — e.g. after a camera
        reconnect, so the next frame becomes a fresh first frame."""
        if stream_id is None:
            self._seen[:] = False
        else:
            self._seen[stream_id] = False

    def save_state(self, path: str):
        """Checkpoint the fleet's streaming state (per-stream preprocessed
        previous frames + stamps + seen flags + RNG) so a serving restart
        resumes without N first-frame glitches — the fleet analogue of
        ``OpticFlowNode.save_state`` (the reference has neither;
        SURVEY.md section 5: "resume = next frame").  ``path`` gets a
        ``.npz`` suffix if absent (``np.savez`` appends one on write;
        keeping it explicit makes the round-trip suffix-stable)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(
            path,
            prev=np.asarray(self._prev) if self._prev is not None else np.zeros(0),
            prev_lp=np.asarray(self._prev_lp) if self._prev_lp is not None else np.zeros(0),
            prev_stamps=self._prev_stamps,
            seen=self._seen,
            long_range=np.asarray(self.long_range),
            key=np.asarray(self._key),
        )

    def load_state(self, path: str):
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        if bool(z["long_range"]) != self.long_range:
            raise ValueError("checkpoint range mode does not match this server")
        if z["seen"].shape != (self.n,):
            raise ValueError(
                f"checkpoint has {z['seen'].shape[0]} streams, server has {self.n}"
            )
        self._prev = jnp.asarray(z["prev"]) if z["prev"].size else None
        if self._prev is not None and self._prev.shape[0] != self.n:
            raise ValueError("checkpoint frame batch does not match the stream count")
        if "prev_lp" in z and z["prev_lp"].size:
            if self.scale_rotation is None:
                raise ValueError(
                    "checkpoint carries a log-polar state but this server has "
                    "no scale_rotation estimator"
                )
            lp = self.scale_rotation.config.lp_res
            if z["prev_lp"].shape != (self.n, lp, lp):
                raise ValueError(
                    f"checkpoint log-polar carry {z['prev_lp'].shape} does not "
                    f"match this server's ({self.n}, {lp}, {lp})"
                )
            self._prev_lp = jnp.asarray(z["prev_lp"])
        self._prev_stamps = z["prev_stamps"]
        self._seen = z["seen"].astype(bool)
        if "key" in z:
            # resume the RANSAC key stream so a restarted server reproduces
            # the uninterrupted run's hypothesis sampling
            self._key = jnp.asarray(z["key"])

    def tick(
        self,
        frames: np.ndarray,
        stamps: np.ndarray,
        heights: np.ndarray,
        rate_quats: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        roll_rates: Optional[np.ndarray] = None,
        pitch_rates: Optional[np.ndarray] = None,
        rolls: Optional[np.ndarray] = None,
        pitches: Optional[np.ndarray] = None,
    ) -> FleetTick:
        """``frames``: ``[N, H, W]`` (uint8 preferred — streams into the
        kernel uncast) or ``[N, H, W, 3]`` BGR.  ``stamps``/``heights``:
        ``[N]``.  ``mask``: ``[N]`` bool, False = stream produced no frame
        this tick.  ``roll_rates``/``pitch_rates``: ``[N]``, long-range
        mode's rate feed-forward (default 0).  ``rolls``/``pitches``:
        ``[N]`` attitude angles [rad] — in long-range mode the heights are
        tilt-corrected ``h / (cos(pitch) * cos(roll))`` before get2DT, the
        reference's ``src/optic_flow.cpp:1780-1781`` (default: level)."""
        n = self.n
        frames = jnp.asarray(frames)
        if frames.shape[0] != n:
            raise ValueError(f"expected {n} streams, got {frames.shape[0]}")
        # preprocess ONCE per frame: the preprocessed [N, F, F] result is both
        # this tick's curr and (where masked in) next tick's prev — raw BGR is
        # never re-grayscaled and the carried state is the cropped gray
        frames = self.pipeline.preprocess(frames)
        stamps = np.asarray(stamps, float)
        mask = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
        if rate_quats is None:
            rate_quats = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))

        if self._prev is None:
            # first tick: everything is a first frame (the reference skips
            # it, src/optic_flow.cpp:1544-1547)
            self._prev = frames
            self._prev_stamps = stamps.copy()
            self._seen = mask.copy()
            sr_scale = sr_rot = None
            if self.scale_rotation is not None:
                self._prev_lp = self._build_lp_carry(frames)
                sr_scale = jnp.full((n,), jnp.nan)
                sr_rot = jnp.full((n,), jnp.nan)
            zeros = jnp.zeros
            eng = self.pipeline.engine
            p = eng.num_windows_lr if self.long_range else eng.num_windows
            return FleetTick(
                ok=zeros((n,), bool), tran=jnp.full((n, 3), jnp.nan),
                rot=jnp.tile(jnp.asarray([0, 0, 0, 1], jnp.float32), (n, 1)),
                shifts=jnp.full((n, p, 2), jnp.nan), dts=np.zeros(n),
                scale=sr_scale, rotation=sr_rot,
            )

        dts = stamps - self._prev_stamps
        # negative/zero dt rejection (src/optic_flow.cpp:1425-1433), plus
        # first-frame and no-frame gating, all as data
        valid = mask & self._seen & (dts > 1e-3)
        safe_dts = np.where(dts > 1e-3, dts, 1.0)

        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, n)
        if self.long_range:
            zeros = jnp.zeros((n,), jnp.float32)
            heights_eff = np.asarray(heights, np.float32)
            if rolls is not None or pitches is not None:
                cr = np.cos(np.asarray(rolls, np.float32)) if rolls is not None else 1.0
                cp = np.cos(np.asarray(pitches, np.float32)) if pitches is not None else 1.0
                heights_eff = heights_eff / (cr * cp)
            out = self.pipeline.step_long_range_pre(
                self._prev,
                frames,
                jnp.asarray(heights_eff, jnp.float32),
                jnp.asarray(safe_dts, jnp.float32),
                zeros if roll_rates is None else jnp.asarray(roll_rates, jnp.float32),
                zeros if pitch_rates is None else jnp.asarray(pitch_rates, jnp.float32),
                jnp.float32(self.cam_yaw),
            )
            # long-range emits no rotation estimate (the reference publishes
            # NaN angulars on this topic, src/optic_flow.cpp:1839-1846)
            out_rot = jnp.tile(jnp.asarray([0, 0, 0, 1], jnp.float32), (n, 1))
            out_tran, out_ok, out_shifts = out.tran, out.ok, out.shifts
        else:
            if self.scale_rotation is not None and self._prev_lp is None:
                # e.g. resumed from a pre-scale-rotation checkpoint: rebuild
                # the log-polar carry from the carried prev frames
                self._prev_lp = self._build_lp_carry(self._prev)
            if self._sr_fused:
                # ONE device program per tick: flow + geometry + carried SR
                out, lp_c = self.pipeline.step_pre_carried(
                    self._prev,
                    frames,
                    self._prev_lp,
                    jnp.asarray(heights, jnp.float32),
                    jnp.asarray(safe_dts, jnp.float32),
                    jnp.asarray(rate_quats, jnp.float32),
                    self.c2b,
                    keys,
                )
            else:
                out = self.pipeline.step_pre(
                    self._prev,
                    frames,
                    jnp.asarray(heights, jnp.float32),
                    jnp.asarray(safe_dts, jnp.float32),
                    jnp.asarray(rate_quats, jnp.float32),
                    self.c2b,
                    keys,
                )
            out_tran, out_rot = out.tran, out.rot
            out_ok, out_shifts = out.ok, out.shifts

        valid_dev = jnp.asarray(valid)
        sr_scale = sr_rot = None
        if self.scale_rotation is not None:
            if self._prev_lp is None:  # long-range first SR tick after resume
                self._prev_lp = self.scale_rotation.logpolar_batch(self._prev)
            if self._sr_fused:
                sr_scale_raw, sr_rot_raw = out.scale, out.rotation
            else:
                lp_c, sr = self.scale_rotation.step_batch_carried(
                    self._prev_lp, frames
                )
                sr_scale_raw, sr_rot_raw = sr.scale, sr.rotation
            sr_scale = jnp.where(valid_dev, sr_scale_raw, jnp.nan)
            sr_rot = jnp.where(valid_dev, sr_rot_raw, jnp.nan)
            mask_lp = jnp.asarray(mask)[:, None, None]
            self._prev_lp = jnp.where(mask_lp, lp_c, self._prev_lp)

        # carry state: streams with a new frame swap prev; others keep it
        # (on device — no host round-trip)
        mask_dev = jnp.asarray(mask)[:, None, None]  # frames are [N, F, F] now
        self._prev = jnp.where(mask_dev, frames, self._prev)
        self._prev_stamps = np.where(mask, stamps, self._prev_stamps)
        self._seen = self._seen | mask

        return FleetTick(
            ok=out_ok & valid_dev,
            tran=jnp.where(valid_dev[:, None], out_tran, jnp.nan),
            # same invalid => NaN convention as tran: a first-frame /
            # reconnected / dropped stream's decomposition quaternion is
            # garbage (it correlates unrelated frames) and must not look
            # plausible
            rot=jnp.where(valid_dev[:, None], out_rot, jnp.nan),
            shifts=out_shifts,
            dts=dts,
            scale=sr_scale,
            rotation=sr_rot,
        )
