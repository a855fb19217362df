"""Headline benchmark: multi-point FFT flow throughput on 752x480 frames.

Measures the reference's hot path on the GPU — grayscale-equivalent 480x480
crop, 4x4 grid of 120 px patches, phase correlation + peak + centroid +
validity gating — in steady-state batched mode through
``FftMethod.step_batch`` (the plain XLA path at the engine defaults).  An
ACCURACY stage (the compiled path vs the f64 oracle on known-shift uint8
pairs — the reference's dual-backend conformance axis,
``src/FftMethod.cpp:1824-1836``) emits ``accuracy_px`` against the 0.1 px
budget unless BENCH_ACCURACY=0, and per-frame latency fields (see
``bench_latency.py`` for the full artifact) are appended unless
BENCH_LATENCY=0.

The run refuses to measure anything but a GPU: with no GPU it prints an
error record and exits 1.  Every record names the device (``platform``,
``device_kind``, ``device_count``).  Each milestone prints the full current
record as a flushed JSON line (``"provisional": true`` until the final one);
consumers take the last line on stdout:
  {"metric": "flow_frame_pairs_per_sec", "value": N, "unit": "fps", ...}
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_guard import Emitter, budget_clock, install_alarm

#: seconds left before the alarm fires (shared helper — bench_guard)
_remaining = budget_clock(install_alarm(540))

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu.utils.benchlib import make_chained, measure_chained_stats
from mrs_optic_flow_tpu.utils.device import NoGpuError, require_gpu

BATCH = int(os.environ.get("BENCH_BATCH", "1024"))
# 32 iters at the default 8-deep pipeline = 4 timed windows: the headline
# gets a spread, not a median-of-2
ITERS = int(os.environ.get("BENCH_ITERS", "32"))
PIPELINE = int(os.environ.get("BENCH_PIPELINE", "8"))
ACCURACY_BUDGET_PX = 0.1  # BASELINE.md flow-accuracy target


def _measure_fps(prev, curr, progress=None) -> dict:
    """Steady-state throughput stats (p50/min/max over the timed windows)."""
    engine = FftMethod(FftMethodConfig())

    def step(prev, curr):
        res = engine.step_batch(prev, curr)
        # materialize a CHECKSUM of the shifts, not the [B, P, 2] tensor:
        # the data dependence still forces full execution
        chk = jnp.nansum(res.shifts, axis=(1, 2))  # [B]
        return chk, jnp.sum(res.response)

    chained = make_chained(step)
    return measure_chained_stats(
        chained, prev, curr, items_per_call=BATCH, iters=ITERS,
        pipeline=PIPELINE, progress=progress,
    )


def _measure_accuracy(n_pairs: int = 6) -> dict:
    """Sub-pixel flow error of the COMPILED path on THIS device vs the
    f64 numpy oracle — correctness evidence on the card inside the
    benchmark record (the reference's dual-backend conformance axis,
    ``src/FftMethod.cpp:1824-1836``).  Pair synthesis + oracle answers come from the ONE
    shared definition (``tests/oracle.py::make_accuracy_pairs``) so this
    number and the accuracy table (``scripts/accuracy_report.py``) can
    never drift apart.  NaN'd windows (the shifts are clean textures well
    inside every validity gate — a NaN means the compiled path broke) are
    reported as ``accuracy_px_nan_windows``, which fails the budget check:
    ``nanmax`` alone would silently ignore a regression that
    invalidity-gates windows instead of mis-locating peaks."""
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    )
    from oracle import make_accuracy_pairs

    size, patch = 480, 120
    prev, curr, _truth, osh = make_accuracy_pairs(
        np.random.default_rng(42), n_pairs, size=size, patch=patch
    )
    eng = FftMethod(FftMethodConfig(frame_size=size, sample_point_size=patch))
    s = np.asarray(eng.step_batch(jnp.asarray(prev), jnp.asarray(curr)).shifts)
    err = np.abs(s - osh)
    # null (strict JSON) rather than NaN when EVERY window NaN'd —
    # json.dumps would otherwise emit a bare NaN token, making the record
    # documenting the regression itself unparseable to strict consumers;
    # main() treats None as a budget failure
    out = {"accuracy_px": (None if np.isnan(err).all()
                           else float(np.nanmax(err)))}
    nans = int(np.isnan(s).any(axis=-1).sum())
    if nans:
        out["accuracy_px_nan_windows"] = nans
    return out


def main():
    em = Emitter({"metric": "flow_frame_pairs_per_sec", "unit": "fps"})
    try:
        dev = require_gpu()
    except NoGpuError as e:
        em.emit(final=True, error=str(e))
        raise SystemExit(1)
    em.update(platform=dev["platform"], device_kind=dev["kind"],
              device_count=dev["count"], batch=BATCH)

    # 752x480 capture -> 480x480 crop happens upstream; the flow engine's
    # input contract is the cropped frame.  Frames are uint8 — the camera
    # contract (CV_8U capture, src/optic_flow.cpp:1465).  Generated ON
    # DEVICE (jax.random.bits): host RNG and the upload are set-up costs
    # that do not belong in a device-throughput benchmark.
    @jax.jit
    def _make_inputs(key):
        kp, kc = jax.random.split(key)
        shape = (BATCH, 480, 480)
        return (jax.random.bits(kp, shape, jnp.uint8),
                jax.random.bits(kc, shape, jnp.uint8))

    prev, curr = _make_inputs(jax.random.PRNGKey(0))
    try:
        # the first timed window's rate is emitted immediately (provisional)
        st = _measure_fps(
            prev, curr, progress=lambda r: em.emit(value=r),
        )
        em.update(
            value=st["rate"],
            value_windows=st["window_rates"],
            value_min=st["rate_min"],
            value_max=st["rate_max"],
        )
        em.emit()
    except TimeoutError as e:
        em.emit(final=True, error=str(e))
        raise SystemExit(1)
    except Exception as e:  # noqa: BLE001 — the JSON-line contract holds
        # for every phase: a runtime failure mid-headline must still print
        # a parseable record naming the failing phase
        em.emit(final=True, error=f"headline failed: {type(e).__name__}: {e}")
        raise SystemExit(1)
    # ---- accuracy on THIS device (BENCH_ACCURACY=0 skips) ----
    # compiled-path-vs-oracle parity in the record: CPU tests cannot catch
    # a GPU-compiled regression.  Reserve budget for the latency stage.
    if os.environ.get("BENCH_ACCURACY", "1") == "0":
        pass
    elif _remaining() > 300:
        try:
            acc = _measure_accuracy()
            # every error under budget AND zero NaN'd windows (a compiled
            # regression may invalidity-gate windows instead of
            # mis-locating peaks; nanmax alone would wave that through)
            ok = all(v is not None and v < ACCURACY_BUDGET_PX
                     for k_, v in acc.items()
                     if not k_.endswith("_nan_windows"))
            ok = ok and not any(k_.endswith("_nan_windows") for k_ in acc)
            em.emit(**acc, accuracy_budget_px=ACCURACY_BUDGET_PX,
                    accuracy_ok=ok)
            if not ok:
                em.update(accuracy_error="flow error exceeds the 0.1 px "
                                         "budget (or windows NaN'd) on "
                                         "this device")
        except TimeoutError as e:
            em.emit(final=True, accuracy_error=str(e))
            raise SystemExit(1)
        except Exception as e:  # noqa: BLE001 — headline must still print
            em.update(accuracy_error=f"{type(e).__name__}: {e}")
    else:
        em.update(accuracy_skipped="budget")
    if os.environ.get("BENCH_LATENCY", "1") != "0" and _remaining() < 210:
        em.update(latency_skipped="budget")
    elif os.environ.get("BENCH_LATENCY", "1") != "0":
        try:
            from mrs_optic_flow_tpu.utils.benchlib import (
                measure_device_chain_latency,
                measure_node_latency,
                measure_node_latency_ab,
            )

            # jitter-aware + self-escalating (chain doubles, up to 4x, when
            # the median separation does not clear the rep jitter); keep
            # 120 s of alarm budget for the e2e stages
            chain = measure_device_chain_latency(
                int(os.environ.get("BENCH_LATENCY_K", "100")),
                budget_s=lambda: _remaining() - 120,
            )
            lat_fields = dict(
                latency_device_ms=chain["per_frame_ms"],
                # raw chain medians + the jitter scale: a corrupted slope
                # is self-evident AND machine-checked (benchlib)
                latency_chain_medians_ms=chain["chain_medians_ms"],
                latency_delta_ms=chain["delta_ms"],
                latency_jitter_ms=chain["jitter_ms"],
                latency_chain_k=chain["k"],
                latency_escalations=chain["escalations"],
            )
            if not chain["slope_ok"]:
                # the chain-median delta never cleared the jitter band even
                # at the escalated length: the slope is noise
                lat_fields["latency_slope_unreliable"] = True
            em.emit(**lat_fields)
            # 300 frames keeps the driver bench inside its timeout; the full
            # >=1000-frame artifact lives in bench_latency.py
            e2e = measure_node_latency(
                int(os.environ.get("BENCH_LATENCY_FRAMES", "300"))
            )
            em.emit(latency_p50_ms=e2e["p50_ms"], latency_p99_ms=e2e["p99_ms"])
            if _remaining() > 150:
                # tpu.host_preprocess (native fused gray+crop, 4.7x fewer
                # upload bytes): INTERLEAVED A/B — block-alternating the
                # knob within one run cancels drift
                ab = measure_node_latency_ab(
                    int(os.environ.get("BENCH_LATENCY_FRAMES", "300")),
                    overrides_b={"tpu": {"host_preprocess": True}},
                )
                em.update(
                    latency_p50_hostpre_ms=ab["b_p50_ms"],
                    # negative = host_preprocess wins
                    latency_hostpre_delta_ms=ab["delta_p50_ms"],
                    latency_hostpre_sign_consistency=ab["sign_consistency"],
                )
            else:
                em.update(latency_hostpre_skipped="budget")
        except TimeoutError as e:  # see above — never swallow the one alarm
            em.emit(final=True, latency_error=str(e))
            raise SystemExit(1)
        except Exception as e:  # noqa: BLE001 — headline must still print
            em.update(latency_error=f"{type(e).__name__}: {e}")
    em.emit(final=True)


if __name__ == "__main__":
    main()
