"""Config system — the ``mrs_lib::ParamLoader`` + YAML equivalent.

Mirrors the reference's parameter tree (``config/default.yaml:1-73``) and its
loading semantics (``src/optic_flow.cpp:814-912``):

- **strict loading**: any missing parameter raises (ParamLoader's
  ``loadedSuccessfully`` hard failure, ``src/optic_flow.cpp:1084-1087``);
- **version gate**: the config's ``version`` must match the framework's
  config-schema version or loading aborts (``src/optic_flow.cpp:816-822``);
- **derived normalization at load**: scale-factor division of frame/patch
  sizes (``:867-874``), even frame size (``:945-947``), long-range patch size
  ``2 * sample_point_size`` (``:876``), scan diameter (``:948``); the
  engine-level multiple-of-patch forcing lives in
  :meth:`FftMethodConfig.normalized`.

Overrides (the launch-file override mechanism,
``launch/optic_flow.launch:31-58``) are plain nested dicts merged over the
YAML.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Mapping, Optional

import yaml

#: schema version this binary understands (the VERSION compile-time constant
#: checked at src/optic_flow.cpp:816-822)
CONFIG_VERSION = "1.0.0"


class ConfigError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Physical constraint block (``config/default.yaml:59-73``)."""

    max_pixel_speed: float
    max_horizontal_speed: float
    max_horizontal_acceleration: float
    max_vertical_speed: float
    max_yaw_rate: float
    speed_noise: float


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """(``config/default.yaml:46-49``)"""

    num_of_chosen: int
    num_of_iter: int
    threshold_rad: float


@dataclasses.dataclass(frozen=True)
class OpticFlowConfig:
    version: str
    gui: bool
    debug: bool
    silent_debug: bool
    ang_rate_source: str  # imu | odometry | odometry_diff
    raw_output: bool
    scale_rotation: bool
    scale_rot_magnitude: float
    scale_rot_output: str  # velocity | altitude
    store_video: bool
    video_path: str
    video_fps: int
    long_range_mode: str  # always_off | always_on | height_based | takeoff_based
    takeoff_height: float
    shifted_pts_thr: int
    max_processing_rate: float
    method: int  # 3 BM, 4 FFT, 5 FastSpacedBM (src/optic_flow.cpp:900-902)
    scan_radius: int
    step_size: int
    frame_size: int
    sample_point_size: int
    filter_method: str  # allsac | ransac | average
    apply_abs_bounding: bool
    apply_rel_bounding: bool
    scale_factor: float
    rotation_correction: bool
    tilt_correction: bool
    minimum_tilt_correction: float
    ransac: RansacParams
    analyze_duration: float
    calibration_coeff_x: float
    calibration_coeff_y: float
    constraints: Constraints

    # ---- device-backend knobs (OPTIONAL ``tpu:`` block; absent in
    # reference YAMLs, which must keep loading unchanged — hence defaults,
    # not _require) ----
    backend: str = "fft"  # fft (XLA FFT, cuFFT) | dft (matmul DFT)
    #: long-range downsample ratio — the reference's compile-time
    #: ``LONG_RANGE_RATIO`` (src/FftMethod.cpp:3, default 4); ratio 2
    #: switches get2DT to the inlier-vote policy (src/optic_flow.cpp:414-421)
    long_range_ratio: int = 4
    #: carry imPrev as 8-bit grayscale like the reference's 8U pipeline
    #: (src/optic_flow.cpp:1597, src/FftMethod.cpp:1872); False = float32
    quantize_8bit: bool = True
    #: run the native fused uint8 grayscale+crop on the HOST before the
    #: device dispatch (the reference preprocesses on host too,
    #: src/optic_flow.cpp:1602-1622) — uploads the frame_size² gray window
    #: instead of the full BGR frame (4.7x fewer bytes at the default
    #: 752x480x3 -> 480² geometry).  Whether that wins over PCIe is not
    #: measured yet.  Falls back to device preprocessing when the
    #: native library, geometry (scale_factor != 1, crop at the image edge),
    #: or input format doesn't allow it.
    host_preprocess: bool = False
    #: log-polar interpolator: lanczos4 (the reference's INTER_LANCZOS4,
    #: src/scaleRotationEstimator.cpp:113) | bilinear (cheaper; accuracy
    #: delta quantified in tests/test_logpolar.py)
    scale_rot_interp: str = "lanczos4"
    #: log-polar image size; 0 = frame_size (the reference's square
    #: geometry). Smaller trades decode granularity for speed — decode
    #: constants rescale so the configured magnitude semantics hold
    scale_rot_lp_resolution: int = 0
    #: tilt deadband for the scale/rotation DECODE (deviation 23): the
    #: log-polar similarity model assumes centred zoom+rotation flow
    #: (src/scaleRotationEstimator.cpp:34-148).  Measured on the banked
    #: yawing descent (tests/test_flightsim.py threshold sweep): every
    #: frame at tilt >= 0.058 rad or tilt rate >= 0.6 rad/s decoded
    #: garbage (wrong-lobe peaks wrap the yaw decode +-pi/2 per frame),
    #: and no sweep threshold recovered a usable survivor set.  The
    #: defaults sit below every measured-broken point with margin; the
    #: region between them and the level-flight regime is unmeasured —
    #: conservative users should tighten, not loosen.  Beyond either bound
    #: the published decode is NaN (invalid => NaN convention); raise both
    #: to disable.
    scale_rot_max_tilt: float = 0.05  # [rad]
    scale_rot_max_tilt_rate: float = 0.3  # [rad/s]

    # ---- derived (filled by loader) ----
    sample_point_size_lr: int = 0  # = 2 * sample_point_size (src/optic_flow.cpp:876)
    sample_point_count_sqrt: int = 0  # frame/patch (:877)
    scan_diameter: int = 0  # 2*scan_radius + 1 (:948)

    @property
    def sample_point_count(self) -> int:
        return self.sample_point_count_sqrt**2

    @property
    def ransac_threshold_rad_sq(self) -> float:
        """Squared at load like _RansacThresholdRadSq_ (src/optic_flow.cpp:895)."""
        return self.ransac.threshold_rad**2


#: ``tpu:`` keys that chose among the removed kernels of the first build; a YAML that
#: still sets one fails at load rather than silently meaning nothing
REMOVED_KERNEL_KEYS = (
    "use_pallas", "mxu_passes", "half_spectrum", "bands_per_step",
    "pairs_per_step", "band_stack",
)


def _require(tree: Mapping[str, Any], path: str) -> Any:
    """Strict lookup of a dotted path; missing -> ConfigError."""
    node: Any = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            raise ConfigError(f"missing required parameter: {path!r}")
        node = node[part]
    return node


def _merge(base: dict, override: Mapping[str, Any]) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    path: str | pathlib.Path | None = None,
    overrides: Optional[Mapping[str, Any]] = None,
    *,
    expected_version: str = CONFIG_VERSION,
) -> OpticFlowConfig:
    """Load + validate + normalize a config tree.

    ``path`` defaults to the packaged ``configs/default.yaml``; ``overrides``
    is merged on top (the launch-file override path).
    """
    if path is None:
        path = pathlib.Path(__file__).resolve().parent.parent / "configs" / "default.yaml"
    with open(path) as f:
        tree = yaml.safe_load(f)
    if overrides:
        tree = _merge(tree, overrides)

    version = str(_require(tree, "version"))
    if version != expected_version:
        raise ConfigError(
            f"config version {version!r} does not match the framework's "
            f"{expected_version!r} — please update the config (version gate, "
            "src/optic_flow.cpp:816-822)"
        )

    of = "mrs_optic_flow"
    scale_factor = float(_require(tree, f"{of}/scale_factor"))
    frame_size = int(_require(tree, f"{of}/frame_size"))
    sample_point_size = int(_require(tree, f"{of}/sample_point_size"))
    # scale-factor division (src/optic_flow.cpp:867-874)
    if abs(scale_factor - 1.0) > 0.01:
        frame_size = int(frame_size / scale_factor)
        sample_point_size = int(sample_point_size / scale_factor)
    # even frame size (src/optic_flow.cpp:945-947)
    if frame_size % 2 == 1:
        frame_size -= 1

    method = int(_require(tree, f"{of}/method"))
    if method < 3 or method > 5:
        raise ConfigError(
            f"no such optic-flow method {method} (3 = block matching, "
            "4 = FFT, 5 = spaced block matching; src/optic_flow.cpp:900-902)"
        )

    # defaulted like the reference: loadParam(..., _calibration_coeff_both_,
    # 1.0) at src/optic_flow.cpp:884 — a YAML without the calibration block
    # must still load (the reference's own default.yaml ships it commented)
    calib = tree[of].get("calibration") or {}
    calib_both = float(calib.get("both_velocity_correction_ratio", 1.0))

    filter_method = str(_require(tree, f"{of}/filter_method"))
    ransac = RansacParams(
        num_of_chosen=int(_require(tree, f"{of}/ransac/num_of_chosen")),
        num_of_iter=int(_require(tree, f"{of}/ransac/num_of_iter")),
        threshold_rad=float(_require(tree, f"{of}/ransac/threshold_rad")),
    )
    # the reference's (string-compare-based) condition warns for EVERY
    # non-ransac filter method with num_of_chosen != 2 (src/optic_flow.cpp:
    # 933-935); allsac genuinely cannot honor another value, so that case is
    # strict here (ARCHITECTURE.md deviation 13) while 'average' keeps the
    # reference's warn-and-run behavior
    if filter_method != "ransac" and ransac.num_of_chosen != 2:
        if filter_method == "allsac":
            raise ConfigError("with allsac filtering, ransac/num_of_chosen must be 2")
        import warnings

        warnings.warn(
            "[OpticFlow]: When Allsac is enabled, the ransac/num_of_chosen "
            "can be only 2.", stacklevel=2,
        )

    scan_radius = int(_require(tree, f"{of}/scan_radius"))
    # optional block; a bare `tpu:` header maps to None in YAML
    tpu_block = tree.get("tpu") or {}
    for key in REMOVED_KERNEL_KEYS:
        if key in tpu_block:
            raise ConfigError(
                f"tpu/{key} chose a TPU Pallas kernel, which no longer "
                "exists (the plain XLA path is the one device path); "
                "remove the key from the config"
            )

    return OpticFlowConfig(
        version=version,
        gui=bool(_require(tree, "gui")),
        debug=bool(_require(tree, "debug")),
        silent_debug=bool(_require(tree, "silent_debug")),
        ang_rate_source=str(_require(tree, "ang_rate_source")),
        raw_output=bool(_require(tree, "raw_output")),
        scale_rotation=bool(_require(tree, "scale_rotation")),
        scale_rot_magnitude=float(_require(tree, "scale_rot_magnitude")),
        scale_rot_output=str(_require(tree, "scale_rot_output")),
        # optional (YAML comments document them next to the required trio)
        scale_rot_interp=str(tree.get("scale_rot_interp", "lanczos4")),
        scale_rot_lp_resolution=int(tree.get("scale_rot_lp_resolution", 0)),
        scale_rot_max_tilt=float(tree.get("scale_rot_max_tilt", 0.05)),
        scale_rot_max_tilt_rate=float(
            tree.get("scale_rot_max_tilt_rate", 0.3)
        ),
        store_video=bool(_require(tree, "store_video")),
        video_path=str(_require(tree, "video_path")),
        video_fps=int(_require(tree, "video_fps")),
        long_range_mode=str(_require(tree, f"{of}/long_range_mode")),
        takeoff_height=float(_require(tree, f"{of}/takeoff_height")),
        shifted_pts_thr=int(_require(tree, f"{of}/shifted_pts_thr")),
        max_processing_rate=float(_require(tree, f"{of}/max_processing_rate")),
        method=method,
        scan_radius=scan_radius,
        step_size=int(_require(tree, f"{of}/step_size")),
        frame_size=frame_size,
        sample_point_size=sample_point_size,
        filter_method=filter_method,
        apply_abs_bounding=bool(_require(tree, f"{of}/apply_abs_bouding")),
        apply_rel_bounding=bool(_require(tree, f"{of}/apply_rel_bouding")),
        scale_factor=scale_factor,
        rotation_correction=bool(_require(tree, f"{of}/rotation_correction")),
        tilt_correction=bool(_require(tree, f"{of}/tilt_correction")),
        minimum_tilt_correction=float(_require(tree, f"{of}/minimum_tilt_correction")),
        ransac=ransac,
        analyze_duration=float(_require(tree, f"{of}/filtering/analyze_duration")),
        # fallback chaining for per-axis calibration (src/optic_flow.cpp:882-887)
        calibration_coeff_x=float(calib.get("x_velocity_correction_ratio", calib_both)),
        calibration_coeff_y=float(calib.get("y_velocity_correction_ratio", calib_both)),
        constraints=Constraints(
            max_pixel_speed=float(_require(tree, "constraints/max_pixel_speed")),
            max_horizontal_speed=float(_require(tree, "constraints/max_horizontal_speed")),
            max_horizontal_acceleration=float(
                _require(tree, "constraints/max_horizontal_acceleration")
            ),
            max_vertical_speed=float(_require(tree, "constraints/max_vertical_speed")),
            max_yaw_rate=float(_require(tree, "constraints/max_yaw_rate")),
            speed_noise=float(_require(tree, "constraints/speed_noise")),
        ),
        backend=str(tpu_block.get("backend", "fft")),
        long_range_ratio=int(tpu_block.get("long_range_ratio", 4)),
        quantize_8bit=bool(tpu_block.get("quantize_8bit", True)),
        host_preprocess=bool(tpu_block.get("host_preprocess", False)),
        sample_point_size_lr=2 * sample_point_size,
        sample_point_count_sqrt=frame_size // sample_point_size,
        scan_diameter=2 * scan_radius + 1,
    )
