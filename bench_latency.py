"""Latency benchmark: single-frame end-to-end + device-program-only.

Proves the BASELINE.md latency target (<= 2 ms p50 device-side) with a
reproducible artifact.  Two measurements:

- **end-to-end**: ``OpticFlowNode``'s per-frame path driven with raw uint8
  BGR 752x480 frames for >= 1,000 frames — host -> device transfer, the
  fused frame program (preprocess -> flow -> getRT -> detilt), and the
  result readbacks, i.e. the shape of the reference's blocking enqueue +
  readback per frame (``src/FftMethod.cpp:398-407``).
- **device-program-only**: the same per-frame chain run ``k`` and ``k/4``
  times inside ONE dispatch (a ``lax.while_loop`` with a dynamic trip count,
  data-chained through the prev-frame state; one compile covers both
  lengths), per-frame time = the slope between the two — per-dispatch
  overhead cancels exactly (``benchlib.measure_scan_slope``).

Like ``bench.py`` it refuses to run without a GPU, names the device in its
record, and emits every completed measurement immediately as a flushed
provisional JSON line — the LAST line on stdout is the best record.
``BENCH_LATENCY_FRAMES`` / ``BENCH_LATENCY_K`` override the sample counts.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# a raising handler (not the default SIGALRM kill) so an overrun still
# yields a JSON error line instead of a silent 142 exit
from bench_guard import Emitter, budget_clock, install_alarm

#: seconds left before the alarm fires (shared helper — bench_guard)
_remaining = budget_clock(install_alarm(540))


from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from mrs_optic_flow_tpu.utils.benchlib import (  # noqa: E402
    measure_device_chain_latency,
    measure_node_latency,
    measure_node_latency_ab,
)
from mrs_optic_flow_tpu.utils.device import NoGpuError, require_gpu  # noqa: E402


def main():
    n_frames = int(os.environ.get("BENCH_LATENCY_FRAMES", "1000"))
    k = int(os.environ.get("BENCH_LATENCY_K", "100"))
    em = Emitter({"metric": "frame_latency_p50_ms", "unit": "ms"})
    try:
        dev = require_gpu()
    except NoGpuError as e:
        em.emit(final=True, error=str(e))
        raise SystemExit(1)
    em.update(platform=dev["platform"], device_kind=dev["kind"],
              device_count=dev["count"])
    try:
        # jitter-aware + self-escalating slope (benchlib); reserve budget
        # for the two e2e stages below
        chain = measure_device_chain_latency(
            k, budget_s=lambda: _remaining() - 180
        )
        fields = dict(
            value=chain["per_frame_ms"],
            device_per_frame_ms=chain["per_frame_ms"],
            device_chain_k=chain["k"],
            # raw chain medians + jitter scale make a corrupted slope
            # self-evident AND machine-checked (benchlib.measure_scan_slope)
            device_chain_medians_ms=chain["chain_medians_ms"],
            device_delta_ms=chain["delta_ms"],
            device_jitter_ms=chain["jitter_ms"],
            device_escalations=chain["escalations"],
        )
        if not chain["slope_ok"]:
            # the chain-median delta never cleared the measured jitter band
            # even at the escalated chain length (or the slope came out
            # non-positive)
            fields["slope_unreliable"] = True
        em.emit(**fields)
        e2e = measure_node_latency(n_frames)
        em.emit(
            e2e_p50_ms=e2e["p50_ms"],
            e2e_p90_ms=e2e["p90_ms"],
            e2e_p95_ms=e2e["p95_ms"],
            e2e_p99_ms=e2e["p99_ms"],
            e2e_mean_ms=e2e["mean_ms"],
            e2e_frames=e2e["n"],
        )
        # tpu.host_preprocess: native fused gray+crop on the host — the
        # dispatch uploads the 480² gray window instead of the full 1.08 MB
        # BGR frame (4.7x fewer bytes).  INTERLEAVED A/B: the knob
        # alternates every 10 frames within ONE run, so drift cancels in
        # the paired per-round deltas.  delta < 0 = host_preprocess wins.
        ab = measure_node_latency_ab(
            n_frames, overrides_b={"tpu": {"host_preprocess": True}}
        )
        em.update(
            e2e_hostpre_p50_ms=ab["b_p50_ms"],
            e2e_hostpre_delta_ms=ab["delta_p50_ms"],
            e2e_hostpre_sign_consistency=ab["sign_consistency"],
            e2e_hostpre_rounds=ab["n_rounds"],
        )
    except TimeoutError as e:
        em.emit(final=True, error=str(e))
        raise SystemExit(1)
    except Exception as e:  # noqa: BLE001 — the JSON-line contract holds
        em.emit(final=True, error=f"{type(e).__name__}: {e}")
        raise SystemExit(1)
    em.emit(final=True)


if __name__ == "__main__":
    main()
