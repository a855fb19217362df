"""Verify the FUSED scale/rotation node path on the GPU.

``scale_rotation: true`` must keep the node at ONE device dispatch + ONE
packed readback per frame (``OpticFlowNode._frame_program``, the live
version of the reference's in-``processImage`` wiring,
``src/optic_flow.cpp:1629-1650``).

1. functional: drive an SR-enabled node over synthetic rotating/hovering
   frames and check the decoded scale/yaw-rate;
2. perf: per-frame device slope of the fused chain with and without the SR
   leg (``benchlib.measure_device_chain_latency(scale_rotation=...)``).

Run from the repo root: ``python scripts/verify_sr_fused.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from mrs_optic_flow_tpu.utils.device import require_gpu

    # the device these times belong to; no GPU, no timing (NoGpuError)
    print("device:", require_gpu(), flush=True)

    from mrs_optic_flow_tpu.config import load_config
    from mrs_optic_flow_tpu.models.scale_rotation import (
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )
    from mrs_optic_flow_tpu.runtime.msgs import (
        CameraInfo,
        Float64Stamped,
        ImageMsg,
        Imu,
        Odometry,
    )
    from mrs_optic_flow_tpu.runtime.node import OpticFlowNode
    from mrs_optic_flow_tpu.utils import benchlib

    # ---- 1. functional: rotating camera over a textured plane ----------
    import cv2

    rng = np.random.default_rng(0)
    big = rng.integers(0, 255, size=(900, 900), dtype=np.uint8)
    big = cv2.GaussianBlur(big, (0, 0), 1.2)

    published = []
    cfg = load_config(overrides={"scale_rotation": True})
    node = OpticFlowNode(cfg, publish=lambda t, m: published.append((t, m)),
                         log=lambda s: None, enable_profiler=False)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    t0 = 100.0
    node.on_camera_info(CameraInfo(
        k=[420.0, 0, 376.0, 0, 420.0, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.on_imu(Imu(stamp=t0, angular_velocity=(0, 0, 0),
                    orientation=(0, 0, 0, 1)))
    node.on_odometry(Odometry(stamp=t0, orientation=(0, 0, 0, 1)))
    node.on_height(Float64Stamped(stamp=t0, value=2.0))

    dt = 0.05
    yaw_rate = 0.4  # rad/s
    for i in range(6):
        ang_deg = np.degrees(yaw_rate * i * dt)
        m = cv2.getRotationMatrix2D((450.0, 450.0), ang_deg, 1.0)
        frame = cv2.warpAffine(big, m, (900, 900))[210:690, 74:826]
        node.on_image(ImageMsg(stamp=t0 + (i + 1) * dt,
                               data=np.stack([frame] * 3, -1)))
    sr = [m for t, m in published if t == "scale_rotation_out"]
    print(f"sr messages: {len(sr)}", flush=True)
    assert len(sr) >= 3, sr
    scales = np.array([m["scale"] for m in sr[1:]])
    yaws = np.array([m["yaw_rate"] for m in sr[1:]])
    print("scales:", scales, "yaw_rates:", yaws, flush=True)
    assert np.all(np.abs(scales - 1.0) < 0.05), scales
    assert np.all(np.abs(yaws - yaw_rate) < 0.15), yaws
    print("FUNCTIONAL OK (yaw_rate decoded within 0.15 rad/s)", flush=True)

    # ---- 2. perf: fused-chain slope, SR off vs on ----------------------
    base = benchlib.measure_device_chain_latency(100)
    print(f"chain (flow+geometry):      {base['per_frame_ms']:.3f} ms/frame",
          flush=True)
    est = ScaleRotationEstimator(ScaleRotationConfig())
    fused = benchlib.measure_device_chain_latency(100, scale_rotation=est)
    print(f"chain + scale/rotation 480: {fused['per_frame_ms']:.3f} ms/frame",
          flush=True)
    est240 = ScaleRotationEstimator(ScaleRotationConfig(lp_resolution=240))
    fused240 = benchlib.measure_device_chain_latency(100, scale_rotation=est240)
    print(f"chain + scale/rotation 240: {fused240['per_frame_ms']:.3f} ms/frame",
          flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
