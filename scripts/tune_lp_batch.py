"""Tune the batched log-polar resample's stream-chunking on the GPU.

The vmapped resample's ``t1`` temporaries grow with the stream batch.  The
structural alternative resamples the streams in chunks of ``k`` under
``lax.map`` while keeping the correlation as ONE batched program.
Bit-identical math (same ops, same order per frame), so the only question
is the measured per-frame time.

This script measures, at the production geometry (480^2, Lanczos4, uint8,
B=16 streams): the shipped full-vmap resample vs chunk sizes {1, 2, 4, 8},
through the full ``step_batch_carried`` shape (log-polar carry + batched
correlation + decode).  Methodology: ``benchlib.measure_scan_slope`` over
tick chains.  Prints one JSON line per variant.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: soft budget: later sweep points are skipped, not cut, once it is spent
_BUDGET_S = int(os.environ.get("TUNE_BUDGET_S", "560"))
_T0 = time.monotonic()


def _remaining() -> float:
    return _BUDGET_S - (time.monotonic() - _T0)


import numpy as np


def _frames(k, n=480):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(n, n), dtype=np.uint8)
    return np.stack([np.roll(base, 3 * i, axis=0) for i in range(k)])


def carried_chunked(eng, prev_lp, frames, weights, chunk):
    """``step_batch_carried_w`` with the resample chunked ``chunk`` streams
    at a time under ``lax.map``; correlation stays one batched program."""
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.models.scale_rotation import ScaleRotResult

    b = frames.shape[0]
    if chunk is None or chunk >= b:
        return eng.step_batch_carried_w(prev_lp, frames, weights)

    def resample(fr):
        return jax.vmap(lambda f: eng._logpolar_w(f, weights))(fr)

    lp_c = jax.lax.map(
        resample, frames.reshape((b // chunk, chunk) + frames.shape[1:])
    )
    lp_c = lp_c.reshape((b,) + lp_c.shape[2:])
    shift, _resp = eng._correlate(lp_c, prev_lp)
    scale, rot = eng._decode(shift, jnp.zeros(shift.shape[:-1], bool))
    return lp_c, ScaleRotResult(scale=scale, rotation=rot)


def measure_carried(eng, chunk, b=16, t=24, reps=9, warmup=2):
    import jax
    import jax.numpy as jnp

    from mrs_optic_flow_tpu.utils.benchlib import measure_scan_slope

    frames0 = jnp.asarray(_frames(b, eng.config.resolution))

    def make_chain(tt):
        @jax.jit
        def chain(lp, bias, sr_w):
            def body(lp, tick):
                shifted = frames0 + (bias + tick).astype(frames0.dtype)
                lp, res = carried_chunked(eng, lp, shifted, sr_w, chunk)
                return lp, (res.scale, res.rotation)

            lp, outs = jax.lax.scan(body, lp, jnp.arange(tt, dtype=jnp.float32))
            return lp, jnp.sum(outs[0]) + jnp.sum(outs[1])

        return chain

    def build(tt):
        chain = make_chain(tt)
        holder = {"lp": eng.logpolar_batch(frames0)}

        def run(i):
            lp, chk = chain(holder["lp"], jnp.float32(1 + i), eng.lp_weights)
            float(chk)
            holder["lp"] = lp

        return run

    slope = measure_scan_slope(build, (max(t // 4, 2), t), reps=reps, warmup=warmup)
    return slope["per_item_ms"] / b


def main():
    import jax

    from mrs_optic_flow_tpu.models import (
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )
    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from mrs_optic_flow_tpu.utils.device import require_gpu

    # the device these times belong to; no GPU, no timing (NoGpuError)
    backend = require_gpu()
    eng = ScaleRotationEstimator(ScaleRotationConfig())
    chunks = [None, 8, 4, 2, 1]
    only = os.environ.get("TUNE_CHUNKS")
    if only:
        chunks = [None if c == "none" else int(c) for c in only.split(",")]
    for chunk in chunks:
        row = {
            "metric": "sr_batch_carried_ms_per_frame",
            "chunk": "vmap" if chunk is None else chunk,
            "unit": "ms",
            "backend": backend,
        }
        if _remaining() < 150:
            row["skipped"] = "budget"
            print(json.dumps(row), flush=True)
            continue
        row["value"] = round(measure_carried(eng, chunk), 4)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
