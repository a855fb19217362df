"""Time the flow step per backend on the GPU: ``FftMethod.step_batch`` at
b=1 (the node's frame) and at the replay batch, on uint8 480x480 frames
with 120 px windows (the reference geometry).

    python scripts/time_flow_backends.py [--batch 1024] [--reps 20]

Every backend runs the same inputs; each time is the median over ``reps``
calls that each end in ``jax.block_until_ready``, after a warm-up that
compiles.  Backends are timed in turns (round-robin over ``--rounds``) so
that clock drift spreads over all of them; the reported time is the median
of the per-round medians.  Before timing, each backend's shifts are
compared with the ``fft`` backend's on the same pairs.  Prints one JSON
line per (backend, batch) and a last line with the card's name and power
limit; exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache
    from mrs_optic_flow_tpu.utils.device import (
        NoGpuError,
        gpu_name_and_power,
        require_gpu,
    )

    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    enable_persistent_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig

    engines = {b: FftMethod(FftMethodConfig(backend=b)) for b in ("fft", "dft")}
    shape = (480, 480)

    # textured frames with a shift, so every window correlates (the oracle
    # comparison itself lives in chip_smoke.py); made on device
    key = jax.random.PRNGKey(0)
    base = jax.random.uniform(key, (args.batch,) + shape) * 255.0
    base = jax.lax.reduce_window(base, 0.0, jax.lax.add, (1, 5, 5), (1, 1, 1), "SAME") / 25.0
    prev = base.astype(jnp.uint8)
    curr = jnp.roll(prev, (3, -5), axis=(1, 2))
    inputs = {1: (prev[:1], curr[:1]), args.batch: (prev, curr)}

    results = {}
    for b, (p, c) in inputs.items():
        ref = None
        for name, eng in engines.items():
            t0 = time.perf_counter()
            s = np.asarray(jax.block_until_ready(eng.step_batch(p, c)).shifts)
            ref = s if ref is None else ref  # the fft backend's, timed first
            results[(name, b)] = {
                "backend": name, "batch": b,
                "first_call_s": time.perf_counter() - t0,
                "max_diff_vs_fft_px": float(np.nanmax(np.abs(s - ref))),
                "nan_windows": int(np.isnan(s).any(axis=-1).sum()),
                "round_medians_ms": [],
            }
        for _ in range(args.rounds):
            for name, eng in engines.items():
                for _ in range(3):
                    jax.block_until_ready(eng.step_batch(p, c))
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(eng.step_batch(p, c))
                    times.append(time.perf_counter() - t0)
                results[(name, b)]["round_medians_ms"].append(
                    statistics.median(times) * 1e3
                )
    for rec in results.values():
        rec["median_ms"] = statistics.median(rec["round_medians_ms"])
        rec["per_pair_us"] = rec["median_ms"] * 1e3 / rec["batch"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"device": dev, "nvidia_smi": gpu_name_and_power()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
