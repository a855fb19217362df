"""BatchPipeline — the full per-frame step, batched and mesh-shardable.

One compiled program covering everything the reference does per frame
(``processImage``, ``src/optic_flow.cpp:1541-1871``): grayscale + crop ->
multi-patch phase correlation -> validity gating -> undistort -> RANSAC
homography -> decomposition -> IMU-consistent solution -> metric velocity.
Batched over frame pairs; with a mesh, the batch shards over the ``data``
axis (throughput serving mode).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mrs_optic_flow_tpu.geometry.batched import get_rt_batch
from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu.ops.preprocess import center_crop, to_grayscale


class PipelineOutput(NamedTuple):
    ok: jnp.ndarray  # [B]
    tran: jnp.ndarray  # [B, 3] camera-frame velocity
    rot: jnp.ndarray  # [B, 4] rate quaternion
    shifts: jnp.ndarray  # [B, P, 2]
    fleet_mean_speed: jnp.ndarray  # [] mean |shift| across the whole batch/mesh
    #: per-pair log-polar scale factor / rotation [rad] — real estimates when
    #: the pipeline was built with ``scale_rotation=``, NaN otherwise (the
    #: repo-wide invalid => NaN convention keeps the output pytree static)
    scale: jnp.ndarray = jnp.nan  # [B]
    rotation: jnp.ndarray = jnp.nan  # [B]


class LongRangeOutput(NamedTuple):
    ok: jnp.ndarray  # [B]
    tran: jnp.ndarray  # [B, 3] camera-frame velocity (z = 0)
    tran_diff: jnp.ndarray  # [B, 3] rate-correction delta
    shifts: jnp.ndarray  # [B, P_lr, 2]
    fleet_mean_speed: jnp.ndarray  # []


class BatchPipeline:
    def __init__(
        self,
        *,
        frame_size: int = 480,
        sample_point_size: int = 120,
        camera_matrix: np.ndarray,
        dist_coeffs: np.ndarray,
        crop_cx: Optional[float] = None,
        shifted_pts_thr: int = 8,
        ransac_iterations: int = 256,
        backend: str = "fft",
        mesh: Optional[Mesh] = None,
        axis_name: str = "data",
        scale_rotation=None,
    ):
        """``scale_rotation``: an optional
        :class:`~mrs_optic_flow_tpu.models.scale_rotation.ScaleRotationEstimator`
        (its ``resolution`` must equal the pipeline frame size).  When set,
        ``step``/``step_pre`` also run the batched log-polar scale/rotation
        estimate per pair (both frames resampled — the stateless serving
        shape) and fill ``PipelineOutput.scale``/``rotation``, and the
        additional ``step_pre_carried`` entry point fuses the CARRIED
        variant (previous log-polar images ride on device, one resample per
        stream per tick — ``ScaleRotationEstimator.step_batch_carried``)
        into the same single device program, for :class:`FleetServer`.
        Match: ``/root/reference/src/scaleRotationEstimator.cpp:34-148``."""
        self.engine = FftMethod(
            FftMethodConfig(
                frame_size=frame_size,
                sample_point_size=sample_point_size,
                backend=backend,
            )
        )
        # the ENGINE-NORMALIZED geometry, not the raw ctor args: the engine
        # forces an even frame and patch|frame (FftMethodConfig.normalized,
        # the reference ctor's behavior) — using the raw values here would
        # silently desynchronize the patch grid get_rt_batch builds from the
        # shifts the engine actually produces (e.g. patch=130 collapses to
        # one window in the engine while geometry expects a 3x3 grid)
        self.frame_size = self.engine.config.frame_size
        self.sample_point_size = self.engine.config.sample_point_size
        self.camera_matrix = np.asarray(camera_matrix, np.float32)
        self.dist_coeffs = np.asarray(dist_coeffs, np.float32)
        self.crop_cx = float(crop_cx if crop_cx is not None else camera_matrix[0, 2])
        self.ul_x = float(int(self.crop_cx) - self.frame_size // 2)
        self.shifted_pts_thr = shifted_pts_thr
        self.ransac_iterations = ransac_iterations
        self.mesh = mesh
        self.axis_name = axis_name
        if scale_rotation is not None and (
            scale_rotation.config.resolution != self.frame_size
        ):
            raise ValueError(
                "scale_rotation.resolution must equal the pipeline frame size"
            )
        self.scale_rotation = scale_rotation
        self._srw_replicated = None

        step = self._build_step(pre=False)
        step_pre = self._build_step(pre=True)
        step_pre_carried = (
            self._build_step(pre=True, sr_carried=True)
            if scale_rotation is not None else None
        )
        step_lr = self._build_step_long_range(pre=False)
        step_lr_pre = self._build_step_long_range(pre=True)

        def _inject_srw(fn):
            # the SR estimator's precomputed log-polar weights ride every
            # dispatch as a trailing argument (same device buffers each
            # call); public signatures stay weight-free.  They must NOT be
            # closure constants of the jitted step — a traced-over concrete
            # array is embedded as an HLO literal (ops/logpolar.py)
            def call(*args):
                return fn(*args, self._srw())

            # ahead-of-time lowering with the same injected weights (e.g.
            # ``pipe.step.lower(...).compile().memory_analysis()``)
            call.lower = lambda *args: fn.lower(*args, self._srw())
            return call

        if mesh is not None:
            batch = NamedSharding(mesh, P(axis_name))
            rep = NamedSharding(mesh, P())
            out_sh = PipelineOutput(batch, batch, batch, batch, rep, batch, batch)
            out_lr_sh = LongRangeOutput(batch, batch, batch, batch, rep)
            # trailing rep: the replicated SR weight tuple (prefix sharding)
            sh = (batch,) * 2 + (batch,) * 3 + (rep,) + (batch,) + (rep,)
            sh_lr = (batch,) * 2 + (batch,) * 4 + (rep,)
            self.step = _inject_srw(
                jax.jit(step, in_shardings=sh, out_shardings=out_sh)
            )
            self.step_pre = _inject_srw(
                jax.jit(step_pre, in_shardings=sh, out_shardings=out_sh)
            )
            if step_pre_carried is not None:
                # extra prev_lp input rides the batch axis, as does the
                # returned curr_lp carry
                sh_c = (batch,) * 3 + (batch,) * 3 + (rep,) + (batch,) + (rep,)
                self.step_pre_carried = _inject_srw(
                    jax.jit(
                        step_pre_carried, in_shardings=sh_c,
                        out_shardings=(out_sh, batch),
                    )
                )
            self.step_long_range = jax.jit(
                step_lr, in_shardings=sh_lr, out_shardings=out_lr_sh
            )
            self.step_long_range_pre = jax.jit(
                step_lr_pre, in_shardings=sh_lr, out_shardings=out_lr_sh
            )
            self.preprocess = jax.jit(
                self._preprocess, in_shardings=(batch,), out_shardings=batch
            )
            if scale_rotation is not None:
                # the initial / checkpoint-rebuild log-polar carry must come
                # out with EXACTLY the sharding the carried step declares
                # for prev_lp — the estimator's own jit would let GSPMD
                # infer something else and the next dispatch would reject
                # the arg (FleetServer builds the tick-1 carry through this)
                self.logpolar_carry = _inject_srw(jax.jit(
                    lambda f, w: self._sr_resample(f, w),
                    in_shardings=(batch, rep), out_shardings=batch,
                ))
        else:
            self.step = _inject_srw(jax.jit(step))
            self.step_pre = _inject_srw(jax.jit(step_pre))
            if step_pre_carried is not None:
                self.step_pre_carried = _inject_srw(jax.jit(step_pre_carried))
            self.step_long_range = jax.jit(step_lr)
            self.step_long_range_pre = jax.jit(step_lr_pre)
            #: jitted preprocess alone — for callers (FleetServer) that cache
            #: the preprocessed frame as carried state and dispatch step_pre
            self.preprocess = jax.jit(self._preprocess)
            if scale_rotation is not None:
                self.logpolar_carry = _inject_srw(
                    jax.jit(lambda f, w: self._sr_resample(f, w))
                )

    def _srw(self) -> tuple:
        sr = self.scale_rotation
        if sr is None:
            return ()
        if self.mesh is None:
            return sr.lp_weights
        # replicate ONCE across the mesh; handing pjit a single-device array
        # would reshard all ~64 MB of weights on every dispatch
        if self._srw_replicated is None:
            rep = NamedSharding(self.mesh, P())
            self._srw_replicated = tuple(
                jax.device_put(w, rep) for w in sr.lp_weights
            )
        return self._srw_replicated

    def _sr_resample(self, frames: jnp.ndarray, sr_w: tuple) -> jnp.ndarray:
        """Batched log-polar resample of the SR leg, mesh-aware.

        Stream chunking (``lp_batch_chunk``, which bounds the vmap
        resample's temporaries) is a per-device schedule: a ``lax.map`` over
        a GSPMD-sharded batch axis would SERIALIZE across devices.  Under a
        mesh the chunked form therefore runs inside ``shard_map`` — each
        device chunks its LOCAL slice — falling back to plain
        vmap when the batch does not divide the mesh or chunking is off.
        The correlation stays in the outer GSPMD program (it is one
        batched dispatch with no cross-stream work)."""
        sr = self.scale_rotation
        if self.mesh is None:
            return sr._logpolar_batch_w(frames, sr_w)
        n = int(np.prod(self.mesh.devices.shape))
        b = frames.shape[0]
        g = int(sr.config.lp_batch_chunk)
        if g <= 0 or b % n or b // n <= 1:
            # vmap under GSPMD: per-device slices of <= 1 stream cannot
            # spill, and uneven batches cannot shard_map
            return sr._logpolar_batch_w(frames, sr_w, chunk=0)
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec

        p = PartitionSpec(self.axis_name)
        return shard_map(
            lambda f, w: sr._logpolar_batch_w(f, w),
            mesh=self.mesh, in_specs=(p, PartitionSpec()), out_specs=p,
        )(frames, sr_w)

    def _preprocess(self, raw: jnp.ndarray) -> jnp.ndarray:
        # grayscale inputs keep their dtype: uint8 frames stay uint8 until
        # the engine casts them (4x fewer bytes than a float32 copy)
        g = to_grayscale(raw) if raw.ndim == 4 else jnp.asarray(raw)
        return center_crop(g, self.frame_size, int(self.crop_cx))

    def _build_step(self, pre: bool = False, sr_carried: bool = False):
        cam = jnp.asarray(self.camera_matrix)
        # distortion-free cameras statically skip the 5-iteration fixed-point
        # undistort inversion (undistort_points dist=None fast path)
        dist = None if not np.any(self.dist_coeffs) else jnp.asarray(self.dist_coeffs)
        ul_x = jnp.float32(self.ul_x)
        sr = self.scale_rotation

        def core(prev, curr, heights, dts, rate_quats, c2b, keys, sr_pair):
            res = self.engine.step_batch(prev, curr)
            # batch-last geometry (laid out for the wide vector lanes of the
            # accelerator this was first built for; whether it is the best
            # layout on the GPU is not measured yet)
            rt = get_rt_batch(
                res.shifts, heights, dts, ul_x, cam, dist, c2b, rate_quats,
                keys,
                frame_size=self.frame_size,
                patch=self.sample_point_size,
                shifted_pts_thr=self.shifted_pts_thr,
                ransac_iterations=self.ransac_iterations,
            )
            # the one genuine collective of the deployment: fleet statistics
            # reduced across the sharded batch (an all-reduce over the
            # devices of the mesh — NVLink between GPUs);
            # nanmean like the long-range step — one dead stream's NaN raw
            # shifts must not blind the fleet-wide statistic
            fleet = jnp.nanmean(jnp.linalg.norm(res.shifts_raw, axis=-1))
            b = res.shifts.shape[0]
            scale, rotation = sr_pair
            if scale is None:
                scale = jnp.full((b,), jnp.nan, jnp.float32)
                rotation = jnp.full((b,), jnp.nan, jnp.float32)
            return PipelineOutput(
                ok=rt.ok, tran=rt.tran, rot=rt.rot, shifts=res.shifts,
                fleet_mean_speed=fleet, scale=scale, rotation=rotation,
            )

        if sr_carried:
            # FleetServer's shape: the previous log-polar images are carried
            # state, so each tick pays ONE resample per stream — and the SR
            # leg lives INSIDE the same device program as flow + geometry
            # (one dispatch per tick, the node path's fusion discipline).
            # ``sr_w``: the estimator's precomputed log-polar weights,
            # threaded as arguments (ops/logpolar.py module comment)
            def step_carried(prev, curr, prev_lp, heights, dts, rate_quats,
                             c2b, keys, sr_w):
                lp_c, sr_res = sr.step_batch_carried_w(
                    prev_lp, curr, sr_w,
                    lp_c=self._sr_resample(curr, sr_w),
                )
                out = core(prev, curr, heights, dts, rate_quats, c2b, keys,
                           (sr_res.scale, sr_res.rotation))
                return out, lp_c

            return step_carried

        def step(prev_raw, curr_raw, heights, dts, rate_quats, c2b, keys,
                 sr_w):
            # pre=True: inputs are already preprocessed [B, F, F] frames (a
            # FleetServer carries the preprocessed prev — no double work)
            prev = prev_raw if pre else self._preprocess(prev_raw)
            curr = curr_raw if pre else self._preprocess(curr_raw)
            sr_pair = (None, None)
            if sr is not None:
                # stateless pairs (ServingLoop): both frames resampled
                sr_res = sr.step_batch_w(
                    prev, curr, sr_w,
                    lp_p=self._sr_resample(prev, sr_w),
                    lp_c=self._sr_resample(curr, sr_w),
                )
                sr_pair = (sr_res.scale, sr_res.rotation)
            return core(prev, curr, heights, dts, rate_quats, c2b, keys,
                        sr_pair)

        return step

    def _build_step_long_range(self, pre: bool = False):
        """Batched long-range mode: 4x-downsampled flow + vmapped get2DT
        (the takeoff / low-altitude serving path; node-side per-frame
        equivalent is ``OpticFlowNode._frame_program_lr``).  get_2dt is
        small elementwise math, so plain vmap is fine here — no batch-last
        relayout needed (unlike the homography chain).

        ``heights`` must be TILT-CORRECTED by the caller: the reference
        passes ``uav_height / (cos(pitch) * cos(roll))`` to get2DT
        (``src/optic_flow.cpp:1780-1781``), as the node path does at its
        call site and ``FleetServer.tick`` does from its per-stream
        ``rolls``/``pitches`` arguments."""
        from mrs_optic_flow_tpu.geometry.motion import get_2dt

        cam = jnp.asarray(self.camera_matrix)
        ul_x = jnp.float32(self.ul_x)
        ratio = self.engine.config.long_range_ratio

        def step_lr(prev_raw, curr_raw, heights, dts, roll_rates, pitch_rates, cam_yaw):
            prev = prev_raw if pre else self._preprocess(prev_raw)
            curr = curr_raw if pre else self._preprocess(curr_raw)
            res = self.engine.step_batch_long_range(prev, curr)
            rt = jax.vmap(
                lambda s, h, d, rr, pr: get_2dt(
                    s, h, d, ul_x, cam, rr, pr, cam_yaw, long_range_ratio=ratio
                )
            )(res.shifts, heights, dts, roll_rates, pitch_rates)
            fleet = jnp.nanmean(jnp.linalg.norm(res.shifts_raw, axis=-1))
            return LongRangeOutput(
                ok=rt.ok, tran=rt.tran, tran_diff=rt.tran_diff,
                shifts=res.shifts, fleet_mean_speed=fleet,
            )

        return step_lr
