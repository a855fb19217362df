"""Full-pipeline serving throughput: BatchPipeline end to end on the GPU.

The companion to ``bench.py``'s flow-only headline: one compiled program
covering grayscale/crop -> multi-patch phase correlation -> validity gating
-> undistort -> RANSAC homography -> decomposition -> IMU-consistent
solution -> metric velocity (``parallel/pipeline.py``; the reference's
whole ``processImage`` + ``getRT`` path, ``src/optic_flow.cpp:1541-1871``),
batched and measured in steady state with the same harness as the headline
(data-chained iterations, host-materialized checksums, bounded pipeline
depth — ``benchlib``).

Measures, as flushed provisional JSON lines (last line = full record):

- ``value``: pipelined throughput, 8 batches in flight (the
  ``ServingLoop(depth=8)`` shape);
- ``value_single``: the same program single-in-flight (the reference's
  blocking-queue shape, ``src/FftMethod.cpp:398``).

Refuses to run without a GPU and names the device in its record.  Env
knobs: BENCH_BATCH / BENCH_ITERS / BENCH_PIPELINE.  Run from the repo root:
``python scripts/bench_pipeline.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench_guard import Emitter
from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

from mrs_optic_flow_tpu.parallel import BatchPipeline
from mrs_optic_flow_tpu.utils.benchlib import make_chained, measure_chained_stats
from mrs_optic_flow_tpu.utils.device import NoGpuError, require_gpu

BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
ITERS = int(os.environ.get("BENCH_ITERS", "32"))
PIPELINE = int(os.environ.get("BENCH_PIPELINE", "8"))
CAM = np.array([[420.0, 0, 240.0], [0, 420.0, 240.0], [0, 0, 1.0]], np.float32)


def _build_chained():
    """ONE chained program — the expensive compile; pipelined and
    single-in-flight measurements both reuse it (only the host-side
    dispatch depth differs)."""
    pipe = BatchPipeline(
        frame_size=480, sample_point_size=120, camera_matrix=CAM,
        dist_coeffs=np.zeros(5, np.float32),
    )
    b = BATCH
    heights = jnp.full((b,), 2.0, jnp.float32)
    dts = jnp.full((b,), 0.05, jnp.float32)
    rates = jnp.tile(jnp.asarray([0, 0, 0, 1], jnp.float32), (b, 1))
    c2b = jnp.asarray([0, 0, 0, 1], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)

    def step(prev, curr):
        # pre=True: frames are already [B, 480, 480] (the FleetServer /
        # steady-state serving shape)
        out = pipe.step_pre(prev, curr, heights, dts, rates, c2b, keys)
        chk = (jnp.nansum(out.shifts, axis=(1, 2))
               + jnp.nansum(out.tran, axis=-1)
               + out.ok.astype(jnp.float32))  # [B]
        return chk, out.fleet_mean_speed

    return make_chained(step)


def _measure(chained, pipeline: int, prev, curr, progress=None) -> dict:
    return measure_chained_stats(
        chained, prev, curr, items_per_call=BATCH, iters=ITERS,
        pipeline=pipeline, progress=progress,
    )


def main():
    em = Emitter({
        "metric": "pipeline_frame_pairs_per_sec",
        "unit": "fps",
        "batch": BATCH,
        "pipeline_depth": PIPELINE,
    })
    try:
        dev = require_gpu()
    except NoGpuError as e:
        em.emit(final=True, error=str(e))
        raise SystemExit(1)
    em.update(platform=dev["platform"], device_kind=dev["kind"],
              device_count=dev["count"])

    @jax.jit
    def _make_inputs(key):
        kp, kc = jax.random.split(key)
        shape = (BATCH, 480, 480)
        return (jax.random.bits(kp, shape, jnp.uint8),
                jax.random.bits(kc, shape, jnp.uint8))

    try:
        prev, curr = _make_inputs(jax.random.PRNGKey(0))
        chained = _build_chained()
        st = _measure(
            chained, PIPELINE, prev, curr,
            progress=lambda r: em.emit(value=r),
        )
        em.emit(
            value=st["rate"],
            value_windows=st["window_rates"],
            value_min=st["rate_min"],
            value_max=st["rate_max"],
        )
        # same compiled program, host-side single-in-flight (the
        # reference's blocking-queue shape) — no new compile
        single = _measure(chained, 1, prev, curr)
        em.emit(value_single=single["rate"],
                value_single_min=single["rate_min"],
                value_single_max=single["rate_max"])
    except Exception as e:  # noqa: BLE001 — the JSON-line contract holds
        em.emit(final=True, error=f"{type(e).__name__}: {e}")
        raise SystemExit(1)
    em.emit(final=True)


if __name__ == "__main__":
    main()
