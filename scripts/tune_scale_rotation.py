"""Perf-qualify the scale/rotation estimator on the GPU.

When ``scale_rotation: true`` the estimator sits in the node's per-frame
path.  This script measures, at the reference geometry (480x480, ``optimM`` 49.9 —
``src/scaleRotationEstimator.cpp:5,28``):

- the per-frame cost of ``ScaleRotationEstimator.step`` (the node-path
  add-on) for both interpolators (lanczos4 = the reference's request,
  bilinear = the cheaper mode);
- the batched fleet path ``step_batch_carried`` per-frame cost;
- a reduced ``lp_resolution`` (256) showing the speed/granularity trade.

Methodology: ``benchlib.measure_scan_slope`` — two chain lengths, per-rep
value-distinct dispatches, per-item time = the slope (dispatch overhead
cancels exactly).  Prints one JSON line per configuration.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

#: soft budget: later sweep points are skipped, not cut, once it is spent
_BUDGET_S = int(os.environ.get("TUNE_BUDGET_S", "560"))
_T0 = time.monotonic()


def _remaining() -> float:
    """Seconds left of the soft budget."""
    return _BUDGET_S - (time.monotonic() - _T0)


import numpy as np


def _frames(k, n=480):
    # uint8, like the node's grayscale carry — 8-bit-exact inputs let the
    # log-polar resample drop one of its three matmul passes
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(n, n), dtype=np.uint8)
    return np.stack([np.roll(base, 3 * i, axis=0) for i in range(k)])


def measure_step_scan(eng, k=128, reps=9, warmup=2):
    """Per-frame ms of the node-path ``step`` (log-polar + correlate +
    decode), slope between k/4- and k-frame scan chains."""
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.utils.benchlib import measure_scan_slope

    @jax.jit
    def chain(state, frames, bias, sr_w):
        # sr_w: precomputed log-polar weights as ARGUMENTS — traced-over
        # concrete arrays would be embedded as HLO literals (ops/logpolar.py)
        def body(st, frame):
            # the value-distinct bias must not promote the uint8 frames to
            # f32 (that would disable the resample's 8-bit-exact fast path)
            st, res = eng.step_w(st, frame + bias.astype(frame.dtype), sr_w)
            return st, (res.scale, res.rotation)

        st, outs = jax.lax.scan(body, state, frames)
        return st, jnp.sum(outs[0]) + jnp.sum(outs[1])

    def build(kk):
        frames = jnp.asarray(_frames(kk, eng.config.resolution))
        holder = {"state": eng.init_state()}

        def run(i):
            # integer-valued bias: i*1e-2 would truncate to 0 in the uint8
            # cast, losing the per-rep value-distinctness the link requires
            st, chk = chain(
                holder["state"], frames, jnp.float32(1 + i), eng.lp_weights
            )
            float(chk)  # host materialization — the only guaranteed wait
            holder["state"] = st

        return run

    return measure_scan_slope(build, (k // 4, k), reps=reps, warmup=warmup)[
        "per_item_ms"
    ]


def measure_batch_carried(eng, b=16, t=24, reps=9, warmup=2):
    """Fleet path: per-frame ms of ``step_batch_carried`` — T ticks of a
    B-stream batch chained in one scan (log-polar carry + per-tick bias keep
    every tick and rep distinct); slope over T, divided by B."""
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.utils.benchlib import measure_scan_slope

    frames0 = jnp.asarray(_frames(b, eng.config.resolution))

    def make_chain(tt):
        @jax.jit
        def chain(lp, bias, sr_w):
            def body(lp, tick):
                # keep the frames uint8 (see measure_step_scan)
                shifted = frames0 + (bias + tick).astype(frames0.dtype)
                lp, res = eng.step_batch_carried_w(lp, shifted, sr_w)
                return lp, (res.scale, res.rotation)

            lp, outs = jax.lax.scan(body, lp, jnp.arange(tt, dtype=jnp.float32))
            return lp, jnp.sum(outs[0]) + jnp.sum(outs[1])

        return chain

    def build(tt):
        chain = make_chain(tt)
        holder = {"lp": eng.logpolar_batch(frames0)}

        def run(i):
            # integer-valued bias (see measure_step_scan)
            lp, chk = chain(holder["lp"], jnp.float32(1 + i), eng.lp_weights)
            float(chk)  # host materialization — the only guaranteed wait
            holder["lp"] = lp

        return run

    slope = measure_scan_slope(build, (max(t // 4, 2), t), reps=reps, warmup=warmup)
    return slope["per_item_ms"] / b


def main():
    import jax

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator
    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from mrs_optic_flow_tpu.utils.device import require_gpu

    # the device these times belong to; no GPU, no timing (NoGpuError)
    backend = require_gpu()
    only = os.environ.get("BENCH_ONLY")  # comma-separated tag filter
    for tag, cfg in (
        ("lanczos4_480", ScaleRotationConfig(interp="lanczos4")),
        ("bilinear_480", ScaleRotationConfig(interp="bilinear")),
        ("lanczos4_lp256", ScaleRotationConfig(interp="lanczos4", lp_resolution=256)),
    ):
        if only and tag not in only.split(","):
            continue
        row = {
            "metric": f"scale_rotation_{tag}_ms_per_frame",
            "unit": "ms",
            "backend": backend,
        }
        # each measurement pays a fresh compile; gate every section on
        # the time actually left so a tight budget yields partial rows with
        # skip notes once the soft budget is spent
        if _remaining() < 200:
            row["skipped"] = "budget"
            print(json.dumps(row), flush=True)
            continue
        eng = ScaleRotationEstimator(cfg)
        row["step"] = round(measure_step_scan(eng), 4)
        if _remaining() > 200:
            row["batch_carried"] = round(measure_batch_carried(eng), 4)
        else:
            row["batch_carried_skipped"] = "budget"
        # BENCH_LP_CHUNKS="0,1,2,4": sweep the stream-chunked batched
        # resample (``lp_batch_chunk`` — 0 is the round-3 plain-vmap mode,
        # whose t1 temporaries spill the y-pass to HBM at fleet batch;
        # docs/PERFORMANCE.md) on this tag's geometry
        chunks = os.environ.get("BENCH_LP_CHUNKS")
        if chunks and tag == "lanczos4_480":
            import dataclasses

            for g in (int(x) for x in chunks.split(",")):
                key = f"batch_carried_chunk{g}"
                if _remaining() < 200:
                    row[key + "_skipped"] = "budget"
                    continue
                e2 = ScaleRotationEstimator(
                    dataclasses.replace(cfg, lp_batch_chunk=g)
                )
                row[key] = round(measure_batch_carried(e2), 4)
                print(json.dumps(row), flush=True)  # incremental (bench.py rule)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
