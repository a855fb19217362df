"""Slope-method profile of the batched geometry chain on the GPU.

Measures per-frame device time of ``geometry.batched.get_rt_batch`` (the
serving pipeline's getRT: undistort -> RANSAC homography -> Malis-Vargas
decomposition -> IMU-nearest solution, ``src/optic_flow.cpp:515-774``)
across RANSAC iteration counts, the honest way: K steps are chained INSIDE
one compiled program (``lax.while_loop`` with a runtime trip count, so both
chain lengths share a single compile) and the per-frame time is the slope
between two chain lengths (``benchlib.measure_scan_slope``) — per-dispatch
overhead cancels exactly.

Prints one JSON line per configuration.
Env knobs: SWEEP (iteration counts, default "64,256"), BATCH (default 4096).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

#: soft budget: later sweep points are skipped, not cut, once it is spent
_BUDGET_S = int(os.environ.get("TUNE_BUDGET_S", "1500"))
_T0 = time.monotonic()


def _remaining() -> float:
    return _BUDGET_S - (time.monotonic() - _T0)


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from mrs_optic_flow_tpu.geometry.batched import get_rt_batch
    from mrs_optic_flow_tpu.utils.benchlib import measure_scan_slope
    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from mrs_optic_flow_tpu.utils.device import require_gpu

    # the device these times belong to; no GPU, no timing (NoGpuError)
    backend = require_gpu()
    batch = int(os.environ.get("BATCH", "4096"))
    sweep = [int(v) for v in os.environ.get("SWEEP", "64,256").split(",")]

    cam = jnp.asarray(
        [[420.0, 0, 376.0], [0, 420.0, 240.0], [0, 0, 1.0]], jnp.float32
    )
    heights = jnp.full((batch,), 2.0, jnp.float32)
    dts = jnp.full((batch,), 0.02, jnp.float32)
    c2b = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    rates = jnp.tile(c2b[None], (batch, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    ul_x = jnp.float32(376.0 - 240.0)

    shifts0 = jax.jit(
        lambda k: jax.random.uniform(k, (batch, 16, 2), jnp.float32, -3.0, 3.0)
    )(jax.random.PRNGKey(1))

    for iters in sweep:
        if _remaining() < 120:
            print(json.dumps({"ransac_iterations": iters, "skipped": "budget"}))
            continue

        @jax.jit
        def chain(shifts, bias, n, _iters=iters):
            def body(c):
                i, s, acc = c
                rt = get_rt_batch(
                    s + bias * 1e-4, heights, dts, ul_x, cam, None, c2b,
                    rates, keys, frame_size=480, patch=120,
                    shifted_pts_thr=8, ransac_iterations=_iters,
                )
                chk = jnp.nansum(rt.tran, axis=-1) + rt.n_inliers.astype(
                    jnp.float32
                )
                # derive the next shifts from this step's output so no
                # iteration can be elided below the client
                s2 = s + (jnp.nansum(chk) % 3.0 + 1.0) * 1e-3
                return i + 1, s2, acc + jnp.nansum(chk)

            _, _, acc = lax.while_loop(
                lambda c: c[0] < n, body, (jnp.int32(0), shifts, jnp.float32(0.0))
            )
            return acc

        def build(k):
            def run(i):
                float(chain(shifts0, jnp.float32(i), jnp.int32(k)))

            return run

        r = measure_scan_slope(build, (3, 12), reps=5, warmup=2)
        print(
            json.dumps(
                {
                    "metric": "get_rt_batch_us_per_frame",
                    "ransac_iterations": iters,
                    "batch": batch,
                    "value": round(r["per_item_ms"] * 1e3 / batch, 4),
                    "unit": "us/frame",
                    "backend": backend,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
