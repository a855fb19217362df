"""Run the optic-flow main path once on a GPU and check what comes out.

    python chip_smoke.py [--seed N]      # one GPU: phases 1-4
    python chip_smoke.py --four-cards    # four GPUs: only the mesh path

Everything goes through the entry points a user calls, at the reference
camera geometry (752x480 capture, 480 px crop, 120 px windows in a 4x4
grid: ``configs/default.yaml``, ``BASELINE.md``), on data generated from
``--seed`` by the repo's own synthetic scene and flight simulator:

1. device: JAX's default device must be a GPU (exit 1 otherwise); the
   card's name and power limit come from ``nvidia-smi``, run as a child
   that never imports JAX;
2. flow: ``FftMethod.step_batch`` for each spectral backend on known-shift
   uint8 pairs (``tests/oracle.py::make_accuracy_pairs``), each window held
   to the float64 NumPy oracle and to ground truth;
3. node: ``OpticFlowNode`` driven by ``FrameStream``/``SyntheticScene`` on
   752x480 frames, short range, long range and with scale/rotation fused
   into the node program; then the closed-loop ``--flight banked`` run of
   ``python -m mrs_optic_flow_tpu``, in this process;
4. replay and fleet: ``BatchPipeline`` (crop -> flow -> RANSAC -> twist) at
   the largest replay batch from 1024 pairs down whose compiled memory fits
   the card, then one ``FleetServer`` tick, both held to the node engine's
   shifts and to the scene's velocity.

``--four-cards`` runs only ``__graft_entry__.dryrun_multichip(4)``: the
pipeline, long range, a fleet tick and a carried scale/rotation tick over a
4-device ``data`` mesh, each held equal to the unsharded run.

Each phase prints one line.  A phase that fails raises, and the script exits
non-zero without printing the result line.  The last line of a passing run
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # oracle.py

#: the spectral backends of the plain XLA path
BACKENDS = ("dft", "fft")
#: per window vs the float64 NumPy oracle on the same uint8 pixels
ORACLE_TOL_PX = 0.05
#: vs ground truth: the BASELINE.md budget on each pair's median window,
#: and a bound on every window.  The reference math itself (the oracle)
#: misses truth by up to ~0.2 px on single windows at 25 px shifts (window
#: edge effects + 8-bit quantization), so a per-window 0.1 px bound would
#: fail a perfect implementation.  These and the twist bounds below hold
#: at the reference geometry; smaller windows carry more of the method's
#: own bias, and a pixel of flow is worth more m/s on a smaller image.
TRUTH_MEDIAN_TOL_PX = 0.1
TRUTH_WINDOW_TOL_PX = 0.25
#: node twists vs the scene's velocity [m/s] (short / long range)
NODE_TOL = 0.15
NODE_LR_TOL = 0.3
#: replay / fleet shifts vs the node engine's on the same pairs [px]
SHIFT_MATCH_TOL_PX = 1e-3
#: the fleet tick's RANSAC draws other keys than the replay step [m/s]
FLEET_TRAN_TOL = 0.05
DT = 0.05
HEIGHT = 2.0


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


# --------------------------------------------------------------------- #
# 1. device                                                              #
# --------------------------------------------------------------------- #


def phase_device(expected_count: int = 1) -> dict:
    """The default device as JAX reports it; raises ``NoGpuError`` unless
    it is a GPU, and ``RuntimeError`` with fewer than ``expected_count``."""
    from mrs_optic_flow_tpu.utils.device import gpu_name_and_power, require_gpu

    rec = require_gpu()
    say("device", **rec)
    print(f"[device] nvidia-smi: {gpu_name_and_power()}", flush=True)
    if rec["count"] < expected_count:
        raise RuntimeError(f"need {expected_count} GPUs, JAX sees {rec['count']}")
    return rec


# --------------------------------------------------------------------- #
# 2. flow vs the plain reference                                         #
# --------------------------------------------------------------------- #


def phase_flow(backends=BACKENDS, *, size=480, patch=120, n_pairs=6,
               max_shift=25.0, seed=0) -> dict:
    """``FftMethod.step_batch`` per backend vs the float64 oracle and the
    known shifts; returns ``{backend: errors}``."""
    import jax.numpy as jnp

    from oracle import make_accuracy_pairs

    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu.ops import phase_correlate

    prev, curr, truth, osh = make_accuracy_pairs(
        np.random.default_rng(seed), n_pairs, size=size, patch=patch,
        max_shift=max_shift,
    )
    out = {}
    for backend in backends:
        t0 = time.perf_counter()
        eng = FftMethod(FftMethodConfig(
            frame_size=size, sample_point_size=patch, backend=backend,
        ))
        s = np.asarray(eng.step_batch(jnp.asarray(prev), jnp.asarray(curr)).shifts)
        nan_windows = int(np.isnan(s).any(axis=-1).sum())
        oracle_px = float(np.max(np.abs(s - osh)))
        truth_err = np.abs(s - truth[:, None, :])
        rec = {
            "oracle_px": oracle_px,
            "truth_window_px": float(np.max(truth_err)),
            "truth_median_px": float(np.max(np.median(truth_err, axis=1))),
            "nan_windows": nan_windows,
        }
        say("flow", backend=backend,
            precision=(str(phase_correlate._HIGHEST) if backend == "dft"
                       else "float32 FFT"),
            windows=int(s.shape[0] * s.shape[1]), wall_s=time.perf_counter() - t0,
            **rec)
        if nan_windows:
            raise AssertionError(f"{backend}: {nan_windows} windows NaN")
        if oracle_px > ORACLE_TOL_PX:
            raise AssertionError(f"{backend}: {oracle_px} px from the oracle")
        if rec["truth_median_px"] > TRUTH_MEDIAN_TOL_PX:
            raise AssertionError(f"{backend}: median {rec['truth_median_px']} px from truth")
        if rec["truth_window_px"] > TRUTH_WINDOW_TOL_PX:
            raise AssertionError(f"{backend}: a window {rec['truth_window_px']} px from truth")
        out[backend] = rec
    return out


# --------------------------------------------------------------------- #
# 3. live node and the closed-loop flight                                #
# --------------------------------------------------------------------- #


def run_node(overrides, velocity, *, n_frames=6, seed=1, scene_kw=None):
    """Drive ``OpticFlowNode`` over a constant-velocity synthetic run;
    returns everything it published as ``[(topic, msg)]``."""
    from mrs_optic_flow_tpu.config import load_config
    from mrs_optic_flow_tpu.runtime import FrameStream, OpticFlowNode, SyntheticScene

    published = []
    node = OpticFlowNode(
        load_config(overrides=overrides),
        publish=lambda t, m: published.append((t, m)), log=lambda s: None,
    )
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    scene = SyntheticScene(uav_height=HEIGHT, seed=seed, **(scene_kw or {}))
    stream = FrameStream(node)
    scene.trajectory_events(stream, velocity=velocity, n_frames=n_frames, dt=DT)
    stream.run()
    return published


def _twist_error(published, topic, velocity) -> float:
    """Worst |twist - velocity| over the topic's messages after the first
    (whose previous frame is the seed frame)."""
    msgs = [m for t, m in published if t == topic][1:]
    if not msgs:
        raise AssertionError(f"no {topic} messages after the first")
    v = np.array([np.asarray(m.linear)[:2] for m in msgs], float)
    return float(np.max(np.abs(v - np.asarray(velocity))))


def phase_node(*, overrides=None, n_frames=6, seed=1, scene_kw=None) -> dict:
    """Short range, long range (``always_on``) and scale/rotation fused into
    the node program, each against the scene's velocity."""
    base = dict(overrides or {})
    of = dict(base.get("mrs_optic_flow", {}))
    out = {}
    for name, extra, velocity, topic, tol in (
        ("short_range", {"long_range_mode": "always_off"}, (0.8, -0.3),
         "velocity_out", NODE_TOL),
        ("long_range", {"long_range_mode": "always_on"}, (0.8, -0.3),
         "velocity_out_longrange", NODE_LR_TOL),
        # hovering: the log-polar decode models zoom/rotation about the
        # image centre, which translation breaks (in the reference too)
        ("scale_rotation", {"long_range_mode": "always_off"}, (0.0, 0.0),
         "velocity_out", NODE_TOL),
    ):
        t0 = time.perf_counter()
        ov = {**base, "mrs_optic_flow": {**of, **extra}}
        if name == "scale_rotation":
            ov["scale_rotation"] = True
        published = run_node(ov, velocity, n_frames=n_frames, seed=seed,
                             scene_kw=scene_kw)
        err = _twist_error(published, topic, velocity)
        rec = {"twist_err": err, "tol": tol}
        if name == "scale_rotation":
            sr = [m for t, m in published if t == "scale_rotation_out"][1:]
            if not sr:
                raise AssertionError("no scale_rotation_out after the first")
            rec["scale"] = float(sr[-1]["scale"])
            rec["yaw_rate"] = float(sr[-1]["yaw_rate"])
            # level flight at constant height: scale ~ 1, yaw rate ~ 0
            if not (abs(rec["scale"] - 1.0) < 0.1 and abs(rec["yaw_rate"]) < 0.5):
                raise AssertionError(f"scale/rotation decode off: {rec}")
        say("node", mode=name, wall_s=time.perf_counter() - t0, **rec)
        if not err < tol:
            raise AssertionError(f"{name}: twist {err} m/s from the scene's velocity")
        out[name] = rec
    return out


def phase_flight(profile: str = "banked") -> dict:
    """``python -m mrs_optic_flow_tpu --flight <profile>`` in this process;
    the CLI's own budgets decide its exit code."""
    from mrs_optic_flow_tpu.__main__ import main as cli

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["--flight", profile, "--quiet"])
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
    report = json.loads(lines[-1])
    say("flight", profile=profile, rc=rc, rmse_xy=report["rmse_xy"],
        nees_xy=report["nees_xy"], nan_published=report["nan_published"],
        wall_s=time.perf_counter() - t0)
    if rc != 0:
        raise AssertionError(f"--flight {profile} exited {rc}: {report}")
    return report


# --------------------------------------------------------------------- #
# 4. replay batch and fleet tick                                         #
# --------------------------------------------------------------------- #


def make_replay(scene, batch: int, *, n_distinct: int = 16, seed: int = 0):
    """``batch`` uint8 capture pairs (``[B, H, W]`` gray, the camera's full
    frame) tiled from ``n_distinct`` scene renders at random velocities up
    to 1 m/s; returns ``(prev, curr, velocity [B, 2])``."""
    rng = np.random.default_rng(seed)
    prevs, currs, vels = [], [], []
    for _ in range(n_distinct):
        pos = rng.uniform(-5.0, 5.0, 2)
        v = rng.uniform(-1.0, 1.0, 2)
        for frames, p in ((prevs, pos), (currs, pos + v * DT)):
            frames.append(np.clip(np.rint(scene.render(tuple(p))), 0, 255).astype(np.uint8))
        vels.append(v)
    reps = -(-batch // n_distinct)

    def tile(a):
        a = np.stack(a)
        return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:batch]

    return tile(prevs), tile(currs), tile(vels)


def _fits(pipe, batch, shape, limit):
    """(fits, memory record) of ``pipe.step`` compiled at ``batch``."""
    import jax
    import jax.numpy as jnp

    frames = jax.ShapeDtypeStruct((batch,) + shape, jnp.uint8)
    vec = jax.ShapeDtypeStruct((batch,), jnp.float32)
    quats = jax.ShapeDtypeStruct((batch, 4), jnp.float32)
    keys = jax.ShapeDtypeStruct((batch, 2), jnp.uint32)
    c2b = jax.ShapeDtypeStruct((4,), jnp.float32)
    ma = pipe.step.lower(frames, frames, vec, vec, quats, c2b, keys).compile().memory_analysis()
    rec = {
        "argument_bytes": int(ma.argument_size_in_bytes),
        "output_bytes": int(ma.output_size_in_bytes),
        "temp_bytes": int(ma.temp_size_in_bytes),
    }
    total = sum(rec.values())
    return (limit is None or total < 0.8 * limit), rec


def phase_replay(*, batch: int = 1024, min_batch: int = 64, n_distinct: int = 16,
                 seed: int = 0, overrides=None, scene_kw=None) -> dict:
    """``BatchPipeline.step`` at the largest replay batch (halving from
    ``batch``) whose compiled memory fits the card, then one
    ``FleetServer`` tick on the same pairs; both against the node engine's
    shifts and the scene's velocity."""
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.config import load_config
    from mrs_optic_flow_tpu.parallel import BatchPipeline
    from mrs_optic_flow_tpu.runtime import FleetServer, OpticFlowNode, SyntheticScene

    cfg = load_config(overrides=overrides)
    scene = SyntheticScene(uav_height=HEIGHT, seed=seed, **(scene_kw or {}))
    ci = scene.camera_info()
    pipe = BatchPipeline(
        frame_size=cfg.frame_size, sample_point_size=cfg.sample_point_size,
        camera_matrix=ci.matrix(), dist_coeffs=ci.dist(), backend=cfg.backend,
    )
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    shape = (scene.height_px, scene.width)
    t0 = time.perf_counter()
    while True:
        fits, mem = _fits(pipe, batch, shape, limit)
        if fits or batch <= min_batch:
            break
        say("replay", batch=batch, fits=False, **mem)
        batch //= 2
    if not fits:
        raise AssertionError(f"replay batch {batch} does not fit: {mem}")
    say("replay", batch=batch, fits=True, bytes_limit=limit,
        compile_wall_s=time.perf_counter() - t0, **mem)

    prev, curr, vel = make_replay(scene, batch, n_distinct=n_distinct, seed=seed)
    heights = jnp.full((batch,), HEIGHT, jnp.float32)
    dts = jnp.full((batch,), DT, jnp.float32)
    quats = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), (batch, 1))
    c2b = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    t0 = time.perf_counter()
    out = pipe.step(jnp.asarray(prev), jnp.asarray(curr), heights, dts, quats, c2b, keys)
    ok = np.asarray(out.ok)
    tran = np.asarray(out.tran)
    shifts = np.asarray(out.shifts)
    wall = time.perf_counter() - t0

    # the node's own engine, one frame pair at a time (b=1, step)
    node = OpticFlowNode(cfg, publish=lambda t, m: None, log=lambda s: None)
    eng = node.engine
    node_err = 0.0
    for k in range(min(n_distinct, batch)):
        p = pipe.preprocess(jnp.asarray(prev[k:k + 1]))[0]
        c = pipe.preprocess(jnp.asarray(curr[k:k + 1]))[0]
        _, res = eng.step(eng.set_im_prev(eng.init_state(), p), c)
        node_err = max(node_err, float(np.max(np.abs(np.asarray(res.shifts) - shifts[k]))))
    vel_err = float(np.max(np.abs(tran[:, :2] - vel)))
    rec = {"batch": batch, "ok": int(ok.sum()), "vel_err": float(vel_err),
           "node_shift_err_px": node_err, "wall_s": wall}
    say("replay", **rec)
    if not ok.all():
        raise AssertionError(f"replay: {int((~ok).sum())} pairs without an estimate")
    if not node_err <= SHIFT_MATCH_TOL_PX:
        raise AssertionError(f"replay shifts {node_err} px from the node engine's")
    if not vel_err < NODE_TOL:
        raise AssertionError(f"replay twist {vel_err} m/s from the scene's velocity")

    t0 = time.perf_counter()
    fleet = FleetServer(pipe, batch, seed=seed)
    stamps = np.full(batch, 100.0)
    fleet.tick(prev, stamps, np.full(batch, HEIGHT))
    tick = fleet.tick(curr, stamps + DT, np.full(batch, HEIGHT)).materialize()
    fleet_rec = {
        "streams": batch, "ok": int(tick.ok.sum()),
        "vel_err": float(np.max(np.abs(tick.tran[:, :2] - vel))),
        "shift_vs_replay_px": float(np.max(np.abs(tick.shifts - shifts))),
        "tran_vs_replay": float(np.max(np.abs(tick.tran - tran))),
        "wall_s": time.perf_counter() - t0,
    }
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    say("fleet", peak_bytes_in_use=peak, **fleet_rec)
    if not tick.ok.all():
        raise AssertionError("fleet: streams without an estimate")
    if not fleet_rec["shift_vs_replay_px"] <= SHIFT_MATCH_TOL_PX:
        raise AssertionError(f"fleet shifts differ from the replay step: {fleet_rec}")
    if not fleet_rec["tran_vs_replay"] < FLEET_TRAN_TOL:
        raise AssertionError(f"fleet twists differ from the replay step: {fleet_rec}")
    if not fleet_rec["vel_err"] < NODE_TOL:
        raise AssertionError(f"fleet twist {fleet_rec['vel_err']} m/s from the scene's velocity")
    return {"replay": rec, "fleet": fleet_rec, "memory": mem}


# --------------------------------------------------------------------- #
# main                                                                   #
# --------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path and its unsharded comparison")
    args = ap.parse_args(argv)

    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        rec = phase_device(expected_count=4)
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(4)
        say("four_cards", sharded_equals_unsharded=True,
            wall_s=time.perf_counter() - t0)
    else:
        rec = phase_device()
        phase_flow(seed=args.seed)
        phase_node(seed=args.seed + 1)
        phase_flight()
        phase_replay(seed=args.seed)
    say("done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
