"""OpticFlowNode — orchestration, sensor fusion state, velocity publishing.

Transport-agnostic rebuild of the ROS nodelet ``mrs_optic_flow/OpticFlow``
(``src/optic_flow.cpp:808-1871``).  Callbacks mirror the six subscriptions
(``:1049-1058``); the 1 Hz timerTf lookup (``:1165-1243``) maps to either
push-style ``set_transforms`` or a pluggable ``transform_provider`` polled
at 1 Hz from the image path; ``on_image`` is callbackImage + processImage.
Published
messages go through a pluggable ``publish(topic, msg)`` callable (tests
collect them; a real deployment wires its own transport).

Behavioural parity notes:

- Readiness gating: odometry, imu, TFs gate in the image callback
  (``:1404-1422``); camera info and height gate inside processImage
  (``:1552-1567``); negative / too-small / over-rate dt skips (``:1425-1445``).
- The camera-centred crop uses the *distortion centre* cx for x and the
  image centre for y (``:1610-1612``).  With ``scale_factor != 1`` the
  reference crops the scaled image around the unscaled cx (``:1604-1610``) —
  an off-centre crop; here cx is scaled consistently.
- Dead-but-loaded parameters of the reference (calibration
  velocity-correction ratios, abs/rel bounding, speed_noise) are kept in
  the config for surface parity but — like the reference — do not alter the
  published velocity (``src/optic_flow.cpp:883-887`` load them; no use site
  exists in the live pipeline).  ``filter_method`` and the ransac params,
  dead in the reference's live path, ARE live here on the block-matching
  path (consensus fusion of per-cell velocities).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.config import OpticFlowConfig, load_config
from mrs_optic_flow_tpu.geometry.motion import get_2dt
from mrs_optic_flow_tpu.geometry.rotations import (
    matrix_from_quat,
    quat_axis_angle,
    quat_from_axis_angle,
    quat_rotate,
    rpy_from_matrix,
)
from mrs_optic_flow_tpu.models import FftMethod, make_engine
from mrs_optic_flow_tpu.models.scale_rotation import (
    ScaleRotationConfig,
    ScaleRotationEstimator,
)
from mrs_optic_flow_tpu.ops.preprocess import center_crop, resize_by, to_grayscale
from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache
from mrs_optic_flow_tpu.runtime.msgs import (
    CameraInfo,
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
    TrackerStatus,
    TwistWithCovarianceStamped,
)
from mrs_optic_flow_tpu.runtime.profiler import Profiler, ThrottledLog
from mrs_optic_flow_tpu.utils.quat_np import (
    np_quat_from_rpy,
    np_quat_inverse,
    np_quat_multiply,
    np_rpy_from_quat,
)


def _per_instance_cache(fn):
    """Per-node memoization of the jit program builders.

    ``functools.lru_cache`` on a method keys a CLASS-global cache by
    ``self``: every node ever constructed stays pinned for the process
    lifetime (engine, device buffers, compiled executables), and all nodes
    share one 8-slot pool — more than 8 live (node, geometry) combos evict
    each other and the next frame silently re-creates and RECOMPILES the
    whole fused program mid-stream.  An unbounded per-instance dict is the
    right shape: one node sees a handful of geometries, and the cache dies
    with the node."""

    @functools.wraps(fn)
    def wrapper(self, *args):
        cache = self.__dict__.setdefault("_program_cache", {})
        key = (fn.__name__, args)
        if key not in cache:
            cache[key] = fn(self, *args)
        return cache[key]

    return wrapper


class OpticFlowNode:
    def __init__(
        self,
        config: Optional[OpticFlowConfig] = None,
        publish: Optional[Callable[[str, object], None]] = None,
        log: Callable[[str], None] = print,
        uav_frame: str = "fcu",
        uav_untilted_frame: str = "fcu_untilted",
        enable_profiler: bool = True,
        transform_provider: Optional[Callable[[], object]] = None,
    ):
        """``transform_provider``: optional pluggable analogue of the
        reference's 1 Hz tf2 lookup timer (``timerTf``,
        ``src/optic_flow.cpp:1165-1243``) — a zero-argument callable
        returning the camera->base rotation quaternion ``[x, y, z, w]``, a
        ``(c2b_quat, cam_yaw)`` tuple, or ``None`` ("not available yet").
        It is polled at most once per second from the image path until it
        succeeds, then never again (the reference stops its timer the same
        way); a raising provider is treated as a failed lookup (the
        ``tf2::TransformException`` path).  ``set_transforms`` remains the
        push-style alternative."""
        # node start-up (CLI, ROS bridges, embedding code): later processes
        # load the frame programs from the persistent compile cache
        enable_persistent_cache()
        self.config = config or load_config()
        self.publish = publish or (lambda topic, msg: None)
        self.log = log
        self.log_throttled = ThrottledLog(1.0, log)
        self.uav_frame = uav_frame
        self.uav_untilted_frame = uav_untilted_frame
        self.profiler = Profiler("OpticFlow", enable_profiler)

        c = self.config
        engine_kwargs = dict(frame_size=c.frame_size, sample_point_size=c.sample_point_size)
        if c.method == 4:
            self.engine = make_engine(
                4, **engine_kwargs, max_pixel_speed=c.constraints.max_pixel_speed,
                backend=c.backend, long_range_ratio=c.long_range_ratio,
                quantize_8bit=c.quantize_8bit,
            )
        else:
            self.engine = make_engine(
                c.method, **engine_kwargs, scan_radius=c.scan_radius,
                step_size=c.step_size,
            )
        self.flow_state = self.engine.init_state()

        self.scale_rotation_estimator = None
        self.scale_rot_state = None
        if c.scale_rotation:
            self.scale_rotation_estimator = ScaleRotationEstimator(
                ScaleRotationConfig(
                    resolution=c.frame_size, magnitude=c.scale_rot_magnitude,
                    interp=c.scale_rot_interp,
                    lp_resolution=c.scale_rot_lp_resolution or None,
                    # the estimator shares the flow engine's backend
                    backend=c.backend, quantize_8bit=c.quantize_8bit,
                )
            )
            self.scale_rot_state = self.scale_rotation_estimator.init_state()

        # ---- sensor fusion state (the member soup of src/optic_flow.cpp:160-330)
        # (note: the SR estimator's precomputed log-polar weights enter the
        # frame programs through _sr_weights() as ARGUMENTS — see
        # ops/logpolar.py on why they must not be traced-over constants)
        self.got_camera_info = False
        self.got_image = False
        self.got_height = False
        self.got_imu = False
        self.got_odometry = False
        self.got_tfs = False
        self.got_active_tracker = False

        self.camera_matrix: Optional[np.ndarray] = None
        self.dist_coeffs: Optional[np.ndarray] = None
        self.uav_height = 0.0
        self.angular_rate = np.zeros(3)
        self.angular_rate_quat = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.imu_roll = self.imu_pitch = self.imu_yaw = 0.0
        self.imu_roll_rate = self.imu_pitch_rate = 0.0
        self.odom_rpy = np.zeros(3)
        self.odometry_speed = np.zeros(2)
        self.odometry_orientation = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.active_tracker = ""
        self.angle_diff = np.zeros(3)
        self._tilt_prev = np.asarray([0.0, 0.0, 0.0, 1.0])

        self.c2b_quat = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.cam_yaw = 0.0
        self.transform_provider = transform_provider
        self._tf_poll_next = -np.inf  # next stamp the provider may run (1 Hz)

        self.first_image = True
        self._begin: Optional[float] = None
        self.dt = 0.0
        self._mutex = threading.Lock()  # mutex_process_ (src/optic_flow.cpp:1683)
        self._key = jax.random.PRNGKey(0)
        #: tpu.host_preprocess native binding — resolved lazily on first
        #: frame (None = unresolved, False = unavailable, else the module)
        self._host_pre: Any = None
        self._frames_processed = 0
        #: rolling (flow, odometry) speed pairs for a-posteriori precision
        #: stats over the analyze_duration window (config/default.yaml:52)
        self._speed_history: list = []

    # ------------------------------------------------------------------ #
    # callbacks                                                           #
    # ------------------------------------------------------------------ #

    def on_camera_info(self, msg: CameraInfo):
        """``callbackCameraInfo`` (``src/optic_flow.cpp:1496-1531``)."""
        if self.got_camera_info:
            return
        if msg.binning_x != 0:
            self.log_throttled("binning", "[OpticFlow]: TODO: deal with binning")
        if len(msg.k) < 6 or len(msg.d) < 5:
            self.log_throttled("calib", "[OpticFlow]: camera info has wrong calibration")
            return
        self.camera_matrix = msg.matrix()
        self.dist_coeffs = msg.dist()
        self.got_camera_info = True

    def on_height(self, msg: Float64Stamped):
        """``callbackHeight`` (``src/optic_flow.cpp:1270-1293``)."""
        if abs(msg.value) < 0.001:
            return
        self.uav_height = float(msg.value)
        self.got_height = True

    def on_imu(self, msg: Imu):
        """``callbackImu`` (``src/optic_flow.cpp:1299-1341``)."""
        if self.config.ang_rate_source == "imu":
            self.angular_rate = np.asarray(msg.angular_velocity, float)
            # setRPY on angular rates (:1313) — the reference treats rates as
            # euler angles to build the comparison quaternion
            self.angular_rate_quat = np_quat_from_rpy(*self.angular_rate)
            self.got_imu = True
        self.imu_roll, self.imu_pitch, self.imu_yaw = np_rpy_from_quat(
            np.asarray(msg.orientation, float)
        )
        # filter_ratio == 1.0 (src/optic_flow.cpp:66) makes this a passthrough
        self.imu_roll_rate = float(msg.angular_velocity[0])
        self.imu_pitch_rate = float(msg.angular_velocity[1])

    def on_odometry(self, msg: Odometry):
        """``callbackOdometry`` (``src/optic_flow.cpp:1347-1375``)."""
        if self.config.ang_rate_source == "odometry":
            self.angular_rate = np.asarray(msg.angular_velocity, float)
            self.angular_rate_quat = np_quat_from_rpy(*self.angular_rate)
        self.odometry_speed = np.asarray(msg.linear_velocity[:2], float)
        self.odometry_orientation = np.asarray(msg.orientation, float)
        self.odom_rpy = np.asarray(np_rpy_from_quat(np.asarray(msg.orientation, float)))
        self.got_odometry = True

    def on_tracker_status(self, msg: TrackerStatus):
        """``callbackControlManagerDiag`` (``src/optic_flow.cpp:1253-1266``)."""
        self.active_tracker = msg.active_tracker
        self.got_active_tracker = True

    def set_transforms(self, c2b_quat, cam_yaw: Optional[float] = None):
        """timerTf replacement (``src/optic_flow.cpp:1165-1243``): camera->
        base rotation quaternion; cam_yaw defaults to (yaw of the inverse) +
        pi/2 as at ``:1206-1208``."""
        self.c2b_quat = np.asarray(c2b_quat, float)
        if cam_yaw is None:
            _, _, yaw = np_rpy_from_quat(np_quat_inverse(self.c2b_quat))
            cam_yaw = float(yaw) + np.pi / 2
        self.cam_yaw = float(cam_yaw)
        self.got_tfs = True

    def poll_transforms(self, now: float) -> bool:
        """Run the ``transform_provider`` (if any) at most once per second
        until it yields a transform — the pull-style ``timerTf``
        (``src/optic_flow.cpp:1165-1243``: 1 Hz lookup, stop on success,
        sleep-and-retry on ``tf2::TransformException``).  Driven from
        :meth:`on_image` with the frame stamp; callable explicitly with wall
        time by deployments that prefer their own cadence.  Returns
        ``got_tfs``."""
        if self.got_tfs or self.transform_provider is None:
            return self.got_tfs
        if now < self._tf_poll_next:
            return False
        self._tf_poll_next = now + 1.0
        try:
            result = self.transform_provider()
        except Exception as e:  # noqa: BLE001 — the TransformException path
            self.log(f"[OpticFlow]: TF: {type(e).__name__}: {e}")
            return False
        if result is None:
            return False
        if isinstance(result, tuple) and len(result) == 2:
            c2b, cam_yaw = result
            self.set_transforms(c2b, float(cam_yaw))
        else:
            self.set_transforms(result)
        self.log("[OpticFlow]: got TFs, stopping transform polling")
        return True

    # ------------------------------------------------------------------ #
    # helpers                                                             #
    # ------------------------------------------------------------------ #

    def poll_camera_init(self, now: float) -> Optional[str]:
        """timerCamInit analogue (``src/optic_flow.cpp:1102-1158``): once
        images arrive, camera info must follow within 15 s; past the timeout
        this reports (and logs) the condition.  The reference's fallback
        calibration path is disabled there (``:1125-1152``) and intentionally
        absent here — flying with guessed intrinsics is worse than not
        publishing.  Returns "waiting_image" / "waiting_info" / "timeout" /
        None (ready)."""
        if not self.got_image:
            self._caminfo_deadline = now + 15.0
            self.log_throttled("caminit", "[OpticFlow]: waiting for camera")
            return "waiting_image"
        if self.got_camera_info:
            return None
        if not hasattr(self, "_caminfo_deadline"):
            self._caminfo_deadline = now + 15.0
        if now < self._caminfo_deadline:
            self.log_throttled("caminit", "[OpticFlow]: waiting for camera info")
            return "waiting_info"
        self.log_throttled(
            "caminit",
            "[OpticFlow]: missing camera calibration parameters "
            "(nothing on camera_info / wrong matrices)",
        )
        return "timeout"

    def is_uav_landoff(self) -> bool:
        """``isUavLandoff`` (``src/optic_flow.cpp:364-384``)."""
        if not self.got_active_tracker:
            self.log_throttled("tracker", "[OpticFlow]: tracker status not available")
            return False
        return self.active_tracker == "LandoffTracker"

    def _resolve_long_range(self) -> bool:
        """The four mode policies (``src/optic_flow.cpp:1575-1585``)."""
        mode = self.config.long_range_mode
        if mode == "always_on":
            return True
        if mode == "always_off":
            return False
        if mode == "takeoff_based":
            return self.is_uav_landoff()
        if mode == "height_based":
            return self.uav_height < self.config.takeoff_height
        return False

    def _sr_weights(self) -> tuple:
        """Scale/rotation log-polar weight arrays for the frame programs
        (empty tuple when SR is off or the geometry lacks the precomputed
        fast path); same device buffers every call — zero per-frame cost."""
        sr = self.scale_rotation_estimator
        return sr.lp_weights if sr is not None else ()

    @_per_instance_cache
    def _frame_program(self, h: int, w: int, channels: int, cx_eff: int):
        """ONE fused device program per input geometry for the short-range
        path: preprocess -> engine step -> getRT -> detilt + body-frame
        rotation.  The reference performs one blocking kernel launch plus a
        readback per frame (``src/FftMethod.cpp:398-407``); dispatching the
        whole chain once keeps the same shape.  Host round-trip discipline
        (each round trip costs a full link RTT — docs/PERFORMANCE.md): the
        RANSAC key stream evolves ON DEVICE (``key`` in, next key out — no
        host-side ``jax.random.split`` dispatch per frame) and every scalar
        the host needs afterwards is packed into ONE ``summary`` vector
        ``[ok, tran_b(3), ang(3), n_inliers, ang_diff_rejected]`` for a
        single readback.  With ``scale_rotation: true`` the log-polar
        scale/rotation step (the reference's separate
        ``scale_rotation_estimator_->processImage`` call,
        ``src/optic_flow.cpp:1629-1650``) is FUSED into this same program —
        its carried log-polar state threads through ``sr_state`` and the
        summary gains ``[..., scale, rot]`` — so an SR-enabled node still
        pays ONE dispatch and ONE readback per frame.
        """
        c = self.config
        from mrs_optic_flow_tpu.geometry.motion import get_rt as _get_rt

        pre_cropped = channels == 1 and (h, w) == (c.frame_size, c.frame_size)
        ul_x = jnp.float32(cx_eff - c.frame_size // 2)
        sr = self.scale_rotation_estimator

        @jax.jit
        def run(state, sr_state, sr_w, key, img, height, dt, cam, dist, c2b,
                rate_quat, detilt):
            if pre_cropped:
                gray = jnp.asarray(img, jnp.float32)
            else:
                g = to_grayscale(img) if channels == 3 else jnp.asarray(img, jnp.float32)
                if abs(c.scale_factor - 1.0) > 0.01:
                    g = resize_by(g, c.scale_factor)
                gray = center_crop(g, c.frame_size, cx_eff)

            key, sub = jax.random.split(key)
            new_state, flow = self.engine.step(state, gray)
            res = _get_rt(
                flow.shifts, height, dt, ul_x, cam, dist, c2b, rate_quat, sub,
                frame_size=c.frame_size,
                patch=c.sample_point_size,
                shifted_pts_thr=c.shifted_pts_thr,
            )
            # detilt * (C2B * tran) (src/optic_flow.cpp:1694); axis into the
            # body frame (:1747, rotation-only)
            tran_b = quat_rotate(detilt, quat_rotate(c2b, res.tran))
            axis, angle = quat_axis_angle(res.rot)
            rot_b = quat_from_axis_angle(quat_rotate(c2b, axis), angle)
            ang = jnp.stack(rpy_from_matrix(matrix_from_quat(rot_b)))
            parts = [
                res.ok.astype(jnp.float32)[None],
                tran_b,
                ang,
                res.n_inliers.astype(jnp.float32)[None],
                res.ang_diff_rejected.astype(jnp.float32)[None],
            ]
            new_sr = sr_state
            if sr is not None:
                # weights threaded as program arguments, not closure
                # constants (ops/logpolar.py module comment)
                new_sr, srres = sr.step_w(sr_state, gray, sr_w)
                parts += [srres.scale[None], srres.rotation[None]]
            summary = jnp.concatenate(parts)
            return new_state, new_sr, key, gray, flow, summary

        return run

    @_per_instance_cache
    def _frame_program_simple(self, h: int, w: int, channels: int, cx_eff: int):
        """Fused program for the block-matching engines (methods 3/5):
        preprocess -> SAD engine step -> per-cell velocities -> consensus
        fusion per ``filter_method`` (allsac / ransac / average, the
        toolkit of ``src/utilityFunctions.cpp:58-216`` applied in velocity
        space like the reference's legacy pipeline).  The reference node
        refuses methods 3/5 outright (``src/optic_flow.cpp:953-1011``), so
        this path is an extension.  An enabled scale/rotation estimator is
        FUSED here exactly as on the FFT path (it is engine-agnostic;
        ``scale_rotation: true`` with method 3/5 previously built the
        estimator and then silently never stepped or published it)."""
        from mrs_optic_flow_tpu.filters import allsac_mean, point_mean, ransac_mean

        c = self.config
        pre_cropped = channels == 1 and (h, w) == (c.frame_size, c.frame_size)
        sr = self.scale_rotation_estimator

        @jax.jit
        def run(state, sr_state, sr_w, key, img, height, dt, cam, c2b):
            if pre_cropped:
                gray = jnp.asarray(img, jnp.float32)
            else:
                g = to_grayscale(img) if channels == 3 else jnp.asarray(img, jnp.float32)
                if abs(c.scale_factor - 1.0) > 0.01:
                    g = resize_by(g, c.scale_factor)
                gray = center_crop(g, c.frame_size, cx_eff)

            key, sub = jax.random.split(key)
            new_state, flow = self.engine.step(state, gray)
            # per-cell metric velocities: v = -d * h / f / dt
            cells = jnp.atleast_2d(flow.shifts_raw)
            scale = jnp.stack([height / cam[0, 0], height / cam[1, 1]])
            vels = -cells * scale / dt
            valid = jnp.all(jnp.isfinite(vels), axis=-1)
            vels = jnp.where(valid[:, None], vels, 0.0)
            thr_sq = jnp.float32(c.ransac_threshold_rad_sq)
            if c.filter_method == "allsac":
                vec, _ = allsac_mean(vels, valid, thr_sq)
            elif c.filter_method == "ransac":
                vec = ransac_mean(
                    vels, valid, thr_sq, sub,
                    num_of_chosen=c.ransac.num_of_chosen,
                    num_of_iterations=c.ransac.num_of_iter,
                )
            else:  # "average"
                vec = point_mean(vels, valid)
            ok = jnp.any(valid) & jnp.all(jnp.isfinite(vec))
            tran = jnp.concatenate([vec, jnp.zeros((1,), vec.dtype)])
            tran_b = quat_rotate(c2b, tran)
            parts = [ok.astype(jnp.float32)[None], tran_b]
            new_sr = sr_state
            if sr is not None:
                new_sr, srres = sr.step_w(sr_state, gray, sr_w)
                parts += [srres.scale[None], srres.rotation[None]]
            summary = jnp.concatenate(parts)
            return new_state, new_sr, key, gray, flow, summary

        return run

    @_per_instance_cache
    def _frame_program_lr(self, h: int, w: int, channels: int, cx_eff: int):
        """Fused long-range program: preprocess -> 4x-downsampled engine
        step -> get2DT -> body-frame rotation of both output vectors
        (``src/optic_flow.cpp:1779-1867``), one dispatch per frame.  As in
        ``_frame_program``, an enabled scale/rotation estimator runs INSIDE
        this program (on the full-resolution gray, like the reference's
        ``imCurr_`` feed) and appends ``[scale, rot]`` to the summary."""
        c = self.config
        pre_cropped = channels == 1 and (h, w) == (c.frame_size, c.frame_size)
        ul_x = jnp.float32(cx_eff - c.frame_size // 2)
        ratio = (
            self.engine.config.long_range_ratio
            if isinstance(self.engine, FftMethod)
            else 4
        )
        sr = self.scale_rotation_estimator

        @jax.jit
        def run(state, sr_state, sr_w, img, height_eff, dt, cam, c2b,
                roll_rate, pitch_rate, cam_yaw):
            if pre_cropped:
                gray = jnp.asarray(img, jnp.float32)
            else:
                g = to_grayscale(img) if channels == 3 else jnp.asarray(img, jnp.float32)
                if abs(c.scale_factor - 1.0) > 0.01:
                    g = resize_by(g, c.scale_factor)
                gray = center_crop(g, c.frame_size, cx_eff)

            new_state, flow = self.engine.step_long_range(state, gray)
            res = get_2dt(
                flow.shifts, height_eff, dt, ul_x, cam,
                roll_rate, pitch_rate, cam_yaw,
                long_range_ratio=ratio,
            )
            tran_b = quat_rotate(c2b, res.tran)
            diff_b = quat_rotate(c2b, res.tran_diff)
            parts = [res.ok.astype(jnp.float32)[None], tran_b, diff_b]
            new_sr = sr_state
            if sr is not None:
                new_sr, srres = sr.step_w(sr_state, gray, sr_w)
                parts += [srres.scale[None], srres.rotation[None]]
            summary = jnp.concatenate(parts)
            return new_state, new_sr, gray, flow, summary

        return run

    # ------------------------------------------------------------------ #
    # image path                                                          #
    # ------------------------------------------------------------------ #

    def on_image(self, msg: ImageMsg) -> Optional[TwistWithCovarianceStamped]:
        """``callbackImage`` (``src/optic_flow.cpp:1381-1489``) +
        ``processImage`` (``:1541-1871``).  Returns the published main twist
        (or None when gated), for test convenience."""
        if self.first_image or self._begin is None:
            self._begin = msg.stamp
        self.dt = msg.stamp - self._begin
        self._begin = msg.stamp

        if not self.got_odometry:
            self.log_throttled("odom", "[OpticFlow]: waiting for odometry")
            return None
        if self.config.ang_rate_source == "imu" and not self.got_imu:
            self.log_throttled("imu", "[OpticFlow]: waiting for imu")
            return None
        if not self.got_tfs and not self.poll_transforms(msg.stamp):
            self.log_throttled("tf", "[OpticFlow]: waiting for camera transforms")
            return None
        if not (np.isfinite(self.imu_roll) and np.isfinite(self.imu_pitch)):
            self.log_throttled("imunan", "[OpticFlow]: IMU data contains NaNs")
            return None
        if self.dt < 0.0 and not self.first_image:
            self.log_throttled("negdt", f"[OpticFlow]: time delta negative: {self.dt}")
            return None
        if abs(self.dt) < 0.001 and not self.first_image:
            self.log_throttled("smalldt", f"[OpticFlow]: time delta too small: {self.dt}")
            return None
        self.got_image = True
        if not self.first_image and self.dt < 1.0 / self.config.max_processing_rate:
            return None  # rate cap (src/optic_flow.cpp:1440)

        if self.config.ang_rate_source == "odometry_diff":
            # orientation delta since the previous frame (:1453-1464)
            tilt_curr = self.odometry_orientation
            diff = np_quat_multiply(np_quat_inverse(self._tilt_prev), tilt_curr)
            self.angle_diff = np.asarray(np_rpy_from_quat(diff))
            # get_rt compares a RATE-shaped quaternion (its flow quaternion
            # carries angle/dt, geometry/motion.py) — the imu/odometry
            # sources feed setRPY(rates) (:1313), so the per-frame angle
            # delta must be divided by dt to land in the same units
            # (ARCHITECTURE.md deviation 12)
            self.angular_rate_quat = np_quat_from_rpy(
                *(self.angle_diff / max(self.dt, 1e-6))
            )
            self._tilt_prev = tilt_curr

        # per-frame fault containment: a malformed frame must not take the
        # stream down (the reference wraps publishing in try/catch,
        # src/optic_flow.cpp:1770-1776; we widen it to the whole frame)
        t0 = time.perf_counter()
        try:
            return self._process_image(msg)
        except Exception as e:  # noqa: BLE001
            # throttled: a PERSISTENT per-frame failure (e.g. a calibration
            # whose crop lands out of bounds) would otherwise spam at full
            # camera rate — every other degraded-mode path throttles too
            self.log_throttled(
                "frame_fail",
                f"[OpticFlow]: frame at t={msg.stamp} failed: "
                f"{type(e).__name__}: {e}",
            )
            self._note_result(False)
            return None
        finally:
            # per-frame raw-image-to-publish wall latency — the metric the
            # reference's profiler only logs (SURVEY.md section 5); here it
            # is a live diagnostics topic.  Kept inside its own barrier: a
            # raising transport must not mask the frame's result.
            try:
                self.publish("processing_latency_out", time.perf_counter() - t0)
            except Exception:  # noqa: BLE001
                pass

    def _maybe_host_preprocess(self, img, channels: int, cx_eff: int):
        """``tpu.host_preprocess``: the native fused uint8 grayscale+crop
        (``native.gray_crop``) runs on the HOST so the device dispatch
        uploads the ``frame_size``² gray window instead of the full BGR
        frame (4.7x fewer bytes at the default 752x480x3 -> 480² geometry —
        the reference also preprocesses on host, src/optic_flow.cpp:
        1602-1622).  Mirrors the device preprocessing exactly: crop corner
        ``(cx_eff - fs/2, H/2 - fs/2)`` (ops/preprocess.py::center_crop) and
        OpenCV's fixed-point gray weights (the reference's CV_8UC1 contract;
        the device float mix can differ by at most 1 uint8 LSB).  Inputs the
        native path cannot honor (non-uint8, scale_factor != 1, crop
        touching the image edge where device/native clamp semantics would
        diverge) fall back to device preprocessing with a throttled log."""
        c = self.config
        if self._host_pre is None:  # resolve the native binding once
            try:
                from mrs_optic_flow_tpu import native  # noqa: PLC0415

                native.load()
                self._host_pre = native
            except Exception as e:  # noqa: BLE001 — build/load can fail many ways
                self._host_pre = False
                self.log(
                    f"[OpticFlow]: host_preprocess unavailable "
                    f"({type(e).__name__}: {e}); preprocessing on device"
                )
        if self._host_pre is False:
            return img, channels
        fs = c.frame_size
        h, w = int(img.shape[0]), int(img.shape[1])
        if channels == 1 and (h, w) == (fs, fs):
            return img, channels  # already the pre-cropped contract; no-op
        xi, yi = cx_eff - fs // 2, h // 2 - fs // 2
        eligible = (
            channels in (1, 3)
            and img.dtype == np.uint8
            and abs(c.scale_factor - 1.0) <= 0.01
            and 0 <= xi
            and xi + fs <= w
            and 0 <= yi
            and yi + fs <= h
        )
        if not eligible:
            self.log_throttled(
                "hostpre",
                "[OpticFlow]: host_preprocess cannot honor this input "
                "(format/scale_factor/edge crop); preprocessing on device",
            )
            return img, channels
        arr = np.asarray(img)
        if channels == 3:
            return self._host_pre.gray_crop(arr, cx_eff, h // 2, fs), 1
        return self._host_pre.crop(arr, cx_eff, h // 2, fs), 1

    def _process_image(self, msg: ImageMsg) -> Optional[TwistWithCovarianceStamped]:
        if self.first_image:
            self.first_image = False
            return None  # wait for two images (src/optic_flow.cpp:1544-1547)
        if not self.got_camera_info:
            self.log_throttled("caminfo", "[OpticFlow]: waiting for camera info!")
            return None
        if not self.got_height:
            self.log_throttled("height", "[OpticFlow]: waiting for uav height!")
            return None

        c = self.config
        height = self.uav_height
        long_range = self._resolve_long_range()

        img = msg.data
        channels = img.shape[2] if img.ndim == 3 else 1
        cx = float(self.camera_matrix[0, 2])
        if abs(c.scale_factor - 1.0) > 0.01:
            cx_eff = int(cx / c.scale_factor)
            # intrinsics of the DOWNSCALED image (rows 0-1 of K scale with
            # the pixels; distortion coefficients act on normalized coords
            # and are unaffected).  The reference decodes scaled-pixel
            # shifts with the raw calibration (camMatrixLocal = camMatrix_,
            # src/optic_flow.cpp:398, after the :1604 resize), which biases
            # every velocity by exactly scale_factor — ARCHITECTURE.md
            # deviation 22.
            cam_eff = np.array(self.camera_matrix, float)
            cam_eff[:2, :] /= c.scale_factor
        else:
            cx_eff = int(cx)
            cam_eff = self.camera_matrix
        if c.host_preprocess:
            img, channels = self._maybe_host_preprocess(img, channels, cx_eff)
        # (the frame programs derive pre_cropped / ul_x themselves from
        # their geometry cache-key args)

        # NOTE: the RANSAC key stream evolves inside the frame programs (one
        # less host->device dispatch per frame); self._key is a device array
        # returned by the last program invocation.
        #
        # detilt (src/optic_flow.cpp:1702): the reference node detilts
        # unconditionally — its tilt_correction / minimum_tilt_correction
        # params are loaded but DEAD (FftMethod receives
        # tilt_corr_enable=false at :1001).  Here they are LIVE:
        # ``tilt_correction: false`` publishes in the tilted body frame, and
        # tilts inside the ``minimum_tilt_correction`` deadband (IMU-noise
        # suppression, the reference's config comment) are left uncorrected.
        # The shipped defaults (true, 0.0) reproduce the reference's actual
        # behavior; ARCHITECTURE.md deviation list.
        tilt = float(np.hypot(self.imu_roll, self.imu_pitch))
        detilted = c.tilt_correction and tilt >= c.minimum_tilt_correction
        if detilted:
            detilt = np_quat_from_rpy(self.imu_roll, self.imu_pitch, 0.0)
        else:
            detilt = np.asarray([0.0, 0.0, 0.0, 1.0])
        # an un-detilted vector lives in the TILTED body frame — label it
        # so (frame_id is the consumer's transform key; publishing a tilted
        # vector as fcu_untilted would make an EKF rotate it wrongly)
        sr_frame_id = self.uav_untilted_frame if detilted else self.uav_frame
        c2b = jnp.asarray(self.c2b_quat, jnp.float32)

        if not isinstance(self.engine, FftMethod):
            # block-matching engines (methods 3/5): single aggregated vector
            # through the simple metric-scaling path
            prog = self._frame_program_simple(img.shape[0], img.shape[1], channels, cx_eff)
            with self._mutex, self.profiler.routine("frame_program_simple"):
                (self.flow_state, self.scale_rot_state, self._key, gray, flow,
                 summary_dev) = prog(
                    self.flow_state,
                    self.scale_rot_state,
                    self._sr_weights(),
                    self._key,
                    jnp.asarray(img),
                    jnp.float32(height),
                    jnp.float32(self.dt),
                    jnp.asarray(cam_eff, jnp.float32),
                    c2b,
                )
            if c.raw_output:
                self.publish("points_raw_out", np.asarray(flow.shifts_raw))
            if c.store_video or c.gui:
                self._record_overlay(msg.stamp, gray, flow)
            # ONE readback: [ok, tran_b(3)(, scale, rot)]
            summary = np.asarray(summary_dev)
            if self.scale_rotation_estimator is not None:
                self._publish_scale_rotation(
                    msg.stamp, float(summary[4]), float(summary[5]), height
                )
            if not bool(summary[0] > 0.5):
                self._note_result(False)
                return None
            tran_b = summary[1:4]
            if not np.all(np.isfinite(tran_b[:2])):
                self._note_result(False)
                return None
            fx = float(cam_eff[0, 0])
            twist = TwistWithCovarianceStamped.make(
                frame_id=self.uav_frame,
                stamp=msg.stamp,
                linear=(float(tran_b[0]), float(tran_b[1]), float("nan")),
                angular=(float("nan"),) * 3,
                cov_xy=(50.0 * height / fx) ** 2,
            )
            self.publish("velocity_out", twist)
            self._note_result(True)
            self._frames_processed += 1
            return twist

        if not long_range:
            # ---- short-range: the whole per-frame chain in one dispatch ----
            # (scale/rotation, when enabled, runs INSIDE this program)
            prog = self._frame_program(img.shape[0], img.shape[1], channels, cx_eff)
            with self._mutex, self.profiler.routine("frame_program"):
                (self.flow_state, self.scale_rot_state, self._key, gray, flow,
                 summary_dev) = prog(
                    self.flow_state,
                    self.scale_rot_state,
                    self._sr_weights(),
                    self._key,
                    jnp.asarray(img),
                    jnp.float32(height),
                    jnp.float32(self.dt),
                    jnp.asarray(cam_eff, jnp.float32),
                    jnp.asarray(self.dist_coeffs, jnp.float32),
                    c2b,
                    jnp.asarray(self.angular_rate_quat, jnp.float32),
                    jnp.asarray(detilt, jnp.float32),
                )

            if c.raw_output:
                self.publish("points_raw_out", np.asarray(flow.shifts_raw))
            if c.store_video or c.gui:
                self._record_overlay(msg.stamp, gray, flow)

            # ONE readback: [ok, tran_b(3), ang(3), n_inliers,
            # ang_diff_rejected(, scale, rot)]
            summary = np.asarray(summary_dev)
            if self.scale_rotation_estimator is not None:
                # published regardless of the flow gate: the estimators are
                # independent (the reference computes SR before the flow
                # vectors, src/optic_flow.cpp:1629-1650)
                self._publish_scale_rotation(
                    msg.stamp, float(summary[9]), float(summary[10]), height
                )
            if not bool(summary[0] > 0.5):
                if bool(summary[8] > 0.5):
                    # src/optic_flow.cpp:682-684 (throttled, 1 Hz)
                    self.log_throttled(
                        "angdiff",
                        "[OpticFlow]: Angle difference greater than pi/4, "
                        "skipping.",
                    )
                self._note_result(False)
                return None
            tran_b = summary[1:4]
            ang = [float(a) for a in summary[4:7]]
            n_inliers = int(summary[7])
            if not np.all(np.isfinite(tran_b)):
                self.log("[OpticFlow]: NaNs in output, returning.")
                self._note_result(False)
                return None
            if np.linalg.norm(tran_b) > 7.0:
                self.log(f"[OpticFlow]: LARGE SPEED: {tran_b}")

            fx = float(cam_eff[0, 0])
            twist = TwistWithCovarianceStamped.make(
                frame_id=sr_frame_id,
                stamp=msg.stamp,
                linear=tuple(float(x) for x in tran_b),
                angular=tuple(ang),
                # 5 px expected error (src/optic_flow.cpp:1757-1763)
                cov_xy=(50.0 * height / fx) ** 2,
            )
            self.publish("velocity_out", twist)
            self._publish_diagnostics(msg.stamp, tran_b[:2], height, fx, n_inliers)
            self._note_result(True)
            self._frames_processed += 1
            return twist

        # ---- long-range branch (src/optic_flow.cpp:1779-1867) ----
        prog = self._frame_program_lr(img.shape[0], img.shape[1], channels, cx_eff)
        with self._mutex, self.profiler.routine("frame_program_lr"):
            # get2DT receives height corrected by the static tilt
            # (src/optic_flow.cpp:1781)
            (self.flow_state, self.scale_rot_state, gray, flow, summary_dev) = prog(
                self.flow_state,
                self.scale_rot_state,
                self._sr_weights(),
                jnp.asarray(img),
                jnp.float32(height / (np.cos(self.imu_pitch) * np.cos(self.imu_roll))),
                jnp.float32(self.dt),
                jnp.asarray(cam_eff, jnp.float32),
                c2b,
                jnp.float32(self.imu_roll_rate),
                jnp.float32(self.imu_pitch_rate),
                jnp.float32(self.cam_yaw),
            )
        if c.raw_output:
            self.publish("points_raw_out", np.asarray(flow.shifts_raw))
        if c.store_video or c.gui:
            # long-range shifts are measured on the ratio-downsampled image;
            # scale into full-res pixels so the overlay matches the
            # reference GUI's relative vector length (FftMethod.cpp:1931-1989
            # draws on the downsampled imView)
            self._record_overlay(msg.stamp, gray, flow,
                                 scale=float(c.long_range_ratio))

        # ONE readback: [ok, tran_b(3), diff_b(3)(, scale, rot)]
        summary = np.asarray(summary_dev)
        if self.scale_rotation_estimator is not None:
            self._publish_scale_rotation(
                msg.stamp, float(summary[7]), float(summary[8]), height
            )
        if not bool(summary[0] > 0.5):
            self._note_result(False)
            return None
        tran_b = summary[1:4]
        if not np.all(np.isfinite(tran_b[:2])):
            self.log("[OpticFlow]: NaNs in output, returning.")
            self._note_result(False)
            return None

        fx = float(cam_eff[0, 0])
        twists = []
        for topic, vec_b in (
            ("velocity_out_longrange", tran_b),
            ("velocity_out_longrange_diff", summary[4:7]),
        ):
            twist = TwistWithCovarianceStamped.make(
                frame_id=self.uav_frame,
                stamp=msg.stamp,
                linear=(float(vec_b[0]), float(vec_b[1]), float("nan")),
                angular=(float("nan"),) * 3,
                cov_xy=(50.0 * height / fx) ** 2,
                cov_z=666.0,
                cov_ang=666.0,  # (src/optic_flow.cpp:1839-1846)
            )
            self.publish(topic, twist)
            twists.append(twist)
        self._note_result(True)
        self._frames_processed += 1
        return twists[0]

    def _publish_diagnostics(self, stamp, v_xy, height, fx, n_inliers):
        """Diagnostics the reference advertises but never publishes
        (``velocity_stddev_out``, ``max_velocity_out``, ``allsac_chosen_out``
        are advertised at ``src/optic_flow.cpp:1036-1045`` with no publish
        sites) — implemented here:

        - ``allsac_chosen_out``: the consensus size of the motion fit (the
          RANSAC inlier count, the live analogue of the allsac chosen count);
        - ``max_velocity_out``: fastest measurable horizontal speed at the
          current height/rate: ``max_pixel_speed * height / (fx * dt)``;
        - ``velocity_stddev_out``: error statistics of flow vs odometry over
          the ``analyze_duration`` window (``analyzeSpeeds``,
          ``src/utilityFunctions.cpp:291-344``).
        """
        from mrs_optic_flow_tpu.filters import SpeedBox, analyze_speeds

        self.publish("allsac_chosen_out", int(n_inliers))
        if self.dt > 0:
            self.publish(
                "max_velocity_out",
                float(self.config.constraints.max_pixel_speed * height / (fx * self.dt)),
            )
        self._speed_history.append(
            SpeedBox(time=stamp, speed=np.asarray(v_xy), odometry_speed=self.odometry_speed.copy())
        )
        cutoff = stamp - self.config.analyze_duration
        self._speed_history = [s for s in self._speed_history if s.time > cutoff - 5.0]
        sd = analyze_speeds(cutoff, self._speed_history)
        if sd.num >= 2:
            self.publish("velocity_stddev_out", (sd.std_dev_x, sd.std_dev_y, 0.0))

    def warmup(self, image_shape=None):
        """Pre-compile the whole per-frame program chain.

        The reference JITs its OpenCL kernel lazily on the first frame
        (``src/FftMethod.cpp:344-345``), stalling the stream for the build;
        an XLA compile stalls it the same way, so production brings the
        node up warm.  Runs one synthetic frame pair through preprocess,
        engine (both modes), and the geometry stage with the current camera;
        requires camera info.  Returns the wall time spent.
        """
        import time as _time

        if not self.got_camera_info:
            raise RuntimeError("warmup needs camera info (on_camera_info first)")
        t0 = _time.perf_counter()
        c = self.config
        shapes = (
            [image_shape]
            if image_shape is not None
            # default: both the raw-BGR path and the pre-cropped grayscale
            # path the native feeder uses
            else [(480, 752, 3), (c.frame_size, c.frame_size)]
        )
        saved = (
            self.flow_state, self.first_image, self._begin, self.dt,
            self.got_height, self.got_odometry, self.got_imu, self.got_tfs,
            self.uav_height, self.got_active_tracker, self.active_tracker,
            # the synthetic zero-frame run must not leak into the live
            # stream: the log-polar carry, the diagnostics history, the
            # health counters, and the RANSAC key stream all get restored
            self.scale_rot_state, list(self._speed_history),
            self._frames_processed,
            getattr(self, "_consecutive_failures", 0), self._key,
        )
        pub = self.publish
        self.publish = lambda *a: None
        # the synthetic zero frames must not reach the recording/GUI either:
        # an instance attribute shadows the bound method for the duration
        self._record_overlay = lambda *a, **k: None
        try:
            self.got_height = self.got_odometry = self.got_imu = self.got_tfs = True
            self.got_active_tracker = True
            self.first_image = False
            self._begin = 0.0
            self.dt = 0.05
            from mrs_optic_flow_tpu.runtime.msgs import ImageMsg

            # compile the SHORT-RANGE resolution explicitly (big height +
            # a non-landoff tracker resolve every policy except always_on
            # to short-range): with e.g. takeoff_based + LandoffTracker at
            # bringup, _process_image alone would only compile the LR
            # program and the first post-takeoff short-range frame would
            # pay a cold multi-second compile mid-flight
            self.active_tracker = "MpcTracker"
            self.uav_height = max(self.uav_height, 1.0,
                                  c.takeoff_height + 1.0)
            for shape in shapes:
                self._process_image(ImageMsg(stamp=0.05, data=np.zeros(shape, np.uint8)))
            # compile the fused long-range program for the same geometries
            if hasattr(self.engine, "step_long_range"):
                for shape in shapes:
                    ch = shape[2] if len(shape) == 3 else 1
                    cx_eff = int(self.camera_matrix[0, 2] / c.scale_factor
                                 if abs(c.scale_factor - 1.0) > 0.01
                                 else self.camera_matrix[0, 2])
                    prog = self._frame_program_lr(shape[0], shape[1], ch, cx_eff)
                    prog(
                        self.engine.init_state(),
                        (self.scale_rotation_estimator.init_state()
                         if self.scale_rotation_estimator is not None else None),
                        self._sr_weights(),
                        jnp.zeros(shape, jnp.uint8),
                        jnp.float32(1.0), jnp.float32(0.05),
                        jnp.asarray(self.camera_matrix, jnp.float32),
                        jnp.asarray([0, 0, 0, 1], jnp.float32),
                        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
                    )
        finally:
            self.publish = pub
            del self._record_overlay  # restore the class method
            (
                self.flow_state, self.first_image, self._begin, self.dt,
                self.got_height, self.got_odometry, self.got_imu, self.got_tfs,
                self.uav_height, self.got_active_tracker, self.active_tracker,
                self.scale_rot_state, self._speed_history,
                self._frames_processed, self._consecutive_failures, self._key,
            ) = saved
        return _time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # state checkpoint / resume + health                                  #
    # ------------------------------------------------------------------ #

    def save_state(self, path: str):
        """Checkpoint the streaming state (previous frame + sensor snapshot).

        The reference has no checkpointing — its only carried state is
        ``imPrev`` (SURVEY.md section 5: "resume = next frame").  For a
        serving deployment, warm-restarting without a first-frame glitch is
        worth having: this captures exactly the state that survives a frame
        boundary.
        """
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it on write; keep the
            # save/load round-trip suffix-stable
        np.savez(
            path,
            prev=np.asarray(self.flow_state.prev),
            first=np.asarray(self.flow_state.first),
            begin=np.asarray(self._begin if self._begin is not None else np.nan),
            first_image=np.asarray(self.first_image),
            uav_height=np.asarray(self.uav_height),
            angular_rate_quat=self.angular_rate_quat,
            c2b_quat=self.c2b_quat,
            cam_yaw=np.asarray(self.cam_yaw),
            camera_matrix=self.camera_matrix if self.camera_matrix is not None else np.zeros(0),
            dist_coeffs=self.dist_coeffs if self.dist_coeffs is not None else np.zeros(0),
            got_height=np.asarray(self.got_height),
            got_tfs=np.asarray(self.got_tfs),
            # scale/rotation carry (like the FleetServer checkpoint's
            # prev_lp): without it a resume re-inits the estimator and the
            # first post-resume frame reports the no-estimate (1, 0)
            sr_lp=(
                np.asarray(self.scale_rot_state.prev_logpolar)
                if self.scale_rot_state is not None
                else np.zeros(0)
            ),
            sr_first=np.asarray(
                bool(self.scale_rot_state.first)
                if self.scale_rot_state is not None
                else True
            ),
        )

    def load_state(self, path: str):
        from mrs_optic_flow_tpu.models.base import FlowState

        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        prev = jnp.asarray(z["prev"])
        proto = self.engine.init_state().prev
        if prev.shape != proto.shape:
            # fail at LOAD time with a clear message — a silently accepted
            # geometry-mismatched carry would instead shape-error inside
            # the fused program on every subsequent frame (swallowed by the
            # per-frame fault containment: the node would publish nothing)
            raise ValueError(
                f"checkpoint flow carry {prev.shape} does not match this "
                f"node's frame geometry {proto.shape}"
            )
        if prev.dtype != proto.dtype:
            # e.g. a float32-carry checkpoint resumed into the 8-bit-carry
            # engine (tpu.quantize_8bit) or vice versa
            if proto.dtype == jnp.uint8:
                from mrs_optic_flow_tpu.ops.preprocess import quantize_u8

                prev = quantize_u8(prev)
            else:
                prev = prev.astype(proto.dtype)
        self.flow_state = FlowState(
            prev=prev, first=jnp.asarray(bool(z["first"]))
        )
        begin = float(z["begin"])
        self._begin = None if np.isnan(begin) else begin
        self.first_image = bool(z["first_image"])
        self.uav_height = float(z["uav_height"])
        self.angular_rate_quat = z["angular_rate_quat"]
        self.c2b_quat = z["c2b_quat"]
        self.cam_yaw = float(z["cam_yaw"])
        if z["camera_matrix"].size:
            self.camera_matrix = z["camera_matrix"]
            self.dist_coeffs = z["dist_coeffs"]
            self.got_camera_info = True
        # readiness flags restore from what the checkpoint actually saw —
        # inferring them from camera presence let a pre-height checkpoint
        # skip the 'waiting for uav height' gate (src/optic_flow.cpp:
        # 1559-1562) and publish height=0 twists after resume. Older
        # checkpoints without the flags keep the legacy inference.
        if "got_height" in z:
            self.got_height = bool(z["got_height"])
            self.got_tfs = bool(z["got_tfs"])
        elif z["camera_matrix"].size:
            self.got_height = self.got_tfs = True
        if (
            self.scale_rotation_estimator is not None
            and "sr_lp" in z
            and z["sr_lp"].size
        ):
            from mrs_optic_flow_tpu.models.scale_rotation import ScaleRotState

            lp = self.scale_rotation_estimator.config.lp_res
            if z["sr_lp"].shape != (lp, lp):
                raise ValueError(
                    f"checkpoint log-polar carry {z['sr_lp'].shape} does not "
                    f"match this node's ({lp}, {lp})"
                )
            carry = jnp.asarray(z["sr_lp"])
            proto = self.scale_rotation_estimator.init_state().prev_logpolar
            if carry.dtype != proto.dtype:
                # float32-carry checkpoint resumed into the 8-bit-carry
                # estimator (quantize_8bit) or vice versa — same adaptation
                # as the flow-state prev above
                if proto.dtype == jnp.uint8:
                    from mrs_optic_flow_tpu.ops.preprocess import quantize_u8

                    carry = quantize_u8(carry)
                else:
                    carry = carry.astype(proto.dtype)
            self.scale_rot_state = ScaleRotState(
                prev_logpolar=carry, first=jnp.asarray(bool(z["sr_first"]))
            )

    @property
    def health(self) -> dict:
        """Failure-detection summary: the reference's defenses are silent
        per-frame skips (SURVEY.md section 5); this exposes them as data."""
        return {
            "frames_processed": self._frames_processed,
            "consecutive_failures": getattr(self, "_consecutive_failures", 0),
            "ready": self.got_camera_info and self.got_height and self.got_odometry
            and self.got_tfs and (self.got_imu or self.config.ang_rate_source != "imu"),
        }

    def _note_result(self, ok: bool):
        n = getattr(self, "_consecutive_failures", 0)
        self._consecutive_failures = 0 if ok else n + 1
        if not ok and self._consecutive_failures in (10, 100, 1000):
            self.log_throttled(
                "health",
                f"[OpticFlow]: {self._consecutive_failures} consecutive frames "
                "without a valid motion estimate",
            )

    def _record_overlay(self, stamp, gray, flow, scale: float = 1.0):
        """``gui`` / ``store_video`` outputs, one overlay render for both.

        ``store_video`` (``src/FftMethod.cpp:1695-1704``, ``:1895-1897``):
        flow-overlay frames written to ``video_path``.  A ``.ofrec`` path
        records a raw timestamped native-Recorder stream (replayable by
        ``runtime.stream``); any other extension writes a standard AVI video
        at ``video_fps`` (``viz.VideoWriter`` — the ``cv::VideoWriter``
        analogue, grayscale overlay like the reference's ``isColor=false``
        open at ``src/FftMethod.cpp:1697``).

        ``gui`` (``src/FftMethod.cpp:1886-1892``, window at
        ``src/optic_flow.cpp:918-924``): live ``cv2.imshow`` of the overlay
        when OpenCV and a display exist; disabled after the first failure
        (headless hosts) instead of raising per frame."""
        from mrs_optic_flow_tpu.runtime.viz import VideoWriter, flow_overlay

        c = self.config
        overlay = None
        if c.gui and not getattr(self, "_gui_failed", False):
            overlay = flow_overlay(
                np.asarray(gray), np.asarray(flow.shifts), c.sample_point_size,
                scale=scale,
            )
            try:
                import cv2

                cv2.imshow("optic_flow", overlay)
                cv2.waitKey(1)
            except Exception as e:  # no OpenCV / no display
                self.log(f"[OpticFlow]: gui disabled: {e}")
                self._gui_failed = True
        if not c.store_video:
            return
        if not hasattr(self, "_recorder"):
            try:
                if self.config.video_path.endswith(".ofrec"):
                    from mrs_optic_flow_tpu import native

                    self._recorder = native.Recorder(
                        self.config.video_path,
                        width=self.config.frame_size,
                        height=self.config.frame_size,
                    )
                else:
                    self._recorder = VideoWriter(
                        self.config.video_path,
                        width=self.config.frame_size,
                        height=self.config.frame_size,
                        fps=self.config.video_fps,
                    )
            except Exception as e:  # no toolchain / unwritable path
                self.log(f"[OpticFlow]: could not open video recorder: {e}")
                self._recorder = None
        if self._recorder is not None:
            if overlay is None:
                overlay = flow_overlay(
                    np.asarray(gray), np.asarray(flow.shifts), c.sample_point_size,
                    scale=scale,
                )
            if isinstance(self._recorder, VideoWriter):
                self._recorder.write(overlay)  # AVI frames carry no stamp
            else:
                self._recorder.write(stamp, overlay)

    def close(self):
        """Release output sinks (the AVI writer's index is finalized here;
        the file is kept valid after every frame regardless)."""
        rec = getattr(self, "_recorder", None)
        if rec is not None and hasattr(rec, "close"):
            rec.close()
        self._recorder = None

    def _publish_scale_rotation(self, stamp, scale: float, rotation: float, height):
        """Scale/rotation outputs (the reference's wiring at
        ``src/optic_flow.cpp:1629-1650``, commented out there; live here).
        ``scale``/``rotation`` are plain floats unpacked from the fused
        frame program's summary readback — no extra device round-trips.
        ``velocity`` mode: vertical speed from scale change; ``altitude``
        mode is the reference's disabled stub (emits 0).

        TILT GATE (deviation 23): the log-polar decode models the flow as
        a centred scale+rotation (``src/scaleRotationEstimator.cpp:
        34-148``); under bank the tilt-rate-induced whole-image translation
        (~f*tan(rate*dt), ~25 px/frame at 1.2 rad/s) locks the correlation
        onto wrong lobes — measured +-pi/2/frame yaw decodes on the banked
        descent (tests/test_flightsim.py).  Beyond the configured tilt or
        tilt-rate deadband the decode is published as NaN (the message
        still goes out every frame — gating is visible, not silent)."""
        c = self.config
        tilt = float(np.hypot(self.imu_roll, self.imu_pitch))
        tilt_rate = float(np.hypot(self.imu_roll_rate, self.imu_pitch_rate))
        if tilt > c.scale_rot_max_tilt or tilt_rate > c.scale_rot_max_tilt_rate:
            scale, rotation = float("nan"), float("nan")
        rot_rate = rotation / self.dt if self.dt > 0 else float("nan")
        if c.scale_rot_output == "velocity":
            vz = (scale - 1.0) / self.dt * height if self.dt > 0 else float("nan")
        else:
            vz = 0.0
        self.publish(
            "scale_rotation_out",
            {"stamp": stamp, "scale": scale, "vz": vz, "yaw_rate": rot_rate,
             "frame_id": self.uav_frame},
        )
