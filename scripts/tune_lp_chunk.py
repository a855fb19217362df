"""One-off sweep: single-frame ``ScaleRotationEstimator.step`` cost vs
``lp_rows_per_chunk`` on the GPU, at the production geometry (480x480,
lanczos4).  The static rho trim shrinks the dense weight temporaries per
chunk, so the best chunk is a measurement, not a constant.

Prints one JSON line per configuration.
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
    return _BUDGET_S - (time.monotonic() - _T0)


def main():
    import jax

    from mrs_optic_flow_tpu.models import ScaleRotationConfig, ScaleRotationEstimator
    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache
    from scripts.tune_scale_rotation import measure_step_scan

    enable_persistent_cache()
    from mrs_optic_flow_tpu.utils.device import require_gpu

    # the device these times belong to; no GPU, no timing (NoGpuError)
    backend = require_gpu()
    sweep = [int(v) for v in os.environ.get("SWEEP", "8,16,32,64").split(",")]
    for rpc in sweep:
        row = {
            "metric": f"scale_rotation_step_rpc{rpc}_ms",
            "unit": "ms",
            "backend": backend,
        }
        if _remaining() < 150:
            row["skipped"] = "budget"
            print(json.dumps(row), flush=True)
            continue
        eng = ScaleRotationEstimator(
            ScaleRotationConfig(interp="lanczos4", lp_rows_per_chunk=rpc)
        )
        row["step"] = round(measure_step_scan(eng), 4)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
