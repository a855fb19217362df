"""Smoke coverage for the shared benchmark harness (``utils/benchlib``).

These are correctness tests, not measurements: tiny geometry on the CPU
backend, asserting the harness runs end to end and returns finite,
well-formed numbers.  Times taken here are CPU times and mean nothing for
the device; the measuring entry points refuse to run without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mrs_optic_flow_tpu.models import FftMethodConfig
from mrs_optic_flow_tpu.utils import benchlib
from mrs_optic_flow_tpu.utils.benchlib import (
    make_chained,
    measure_chained,
    measure_chained_stats,
    measure_device_chain_latency,
    measure_node_latency,
    measure_node_latency_ab,
    measure_scan_slope,
)


def test_make_chained_preserves_dtype_and_forces_dependence():
    calls = []

    def step(prev, curr):
        calls.append(1)
        return prev.astype(jnp.float32).sum(), jnp.float32(1.0)

    chained = make_chained(step)
    prev = jnp.zeros((4, 4), jnp.uint8)
    curr = jnp.ones((4, 4), jnp.uint8)
    nxt, _ = chained(prev, curr)
    assert nxt.dtype == jnp.uint8
    # bump is 1..3, so the chained input genuinely changes every call
    nxt2, _ = chained(nxt, curr)
    assert int(jnp.sum(nxt2)) > int(jnp.sum(nxt)) > 0


def test_measure_chained_returns_positive_rate():
    def step(prev, curr):
        s = (prev.astype(jnp.float32) * curr.astype(jnp.float32)).sum()
        return s, s

    chained = make_chained(step)
    prev = jnp.ones((8, 8), jnp.float32)
    curr = jnp.ones((8, 8), jnp.float32)
    rate = measure_chained(
        chained, prev, curr, items_per_call=8, iters=4, pipeline=2, warmup=1
    )
    assert np.isfinite(rate) and rate > 0


def test_measure_chained_stats_publishes_window_spread():
    """The headline is the p50 of the per-window rates, and the spread ships
    alongside (a single scalar cannot tell drift from a regression)."""
    def step(prev, curr):
        s = (prev.astype(jnp.float32) * curr.astype(jnp.float32)).sum()
        return s, s

    st = measure_chained_stats(
        make_chained(step), jnp.ones((8, 8)), jnp.ones((8, 8)),
        items_per_call=8, iters=8, pipeline=2, warmup=1,
    )
    assert st["n_windows"] == 4
    assert len(st["window_rates"]) == 4
    assert st["rate_min"] <= st["rate"] <= st["rate_max"]
    # headline = the upper-middle TIME, i.e. the SLOWER of the two middle
    # windows (the historical pessimistic-rounding convention) — for 4
    # windows that is the second-slowest rate
    assert st["rate"] == sorted(st["window_rates"])[1]
    assert st["rate"] > 0 and np.isfinite(st["rate"])


class _FakeClock:
    """Scripted perf_counter: each run() call advances by a scripted
    duration, so slope/jitter arithmetic is tested deterministically."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _slope_with_fake_times(monkeypatch, duration_fn, k_pair=(25, 100),
                           reps=7, warmup=2):
    clock = _FakeClock()
    monkeypatch.setattr(benchlib.time, "perf_counter", clock.perf_counter)

    def build(k):
        rep_idx = {"i": 0}

        def run(i):
            clock.t += duration_fn(k, rep_idx["i"])
            rep_idx["i"] += 1

        return run

    return measure_scan_slope(build, k_pair, reps=reps, warmup=warmup)


def test_scan_slope_quiet_link_is_reliable(monkeypatch):
    # clean 0.3 ms/item slope over a 65 ms dispatch constant, zero jitter
    out = _slope_with_fake_times(
        monkeypatch, lambda k, i: 0.065 + 0.0003 * k
    )
    assert out["reliable"] is True
    assert out["per_item_ms"] == pytest.approx(0.3, rel=1e-6)
    assert out["overhead_ms"] == pytest.approx(65.0, rel=1e-6)
    assert out["jitter_ms"] == pytest.approx(0.0, abs=1e-9)
    assert out["delta_ms"] == pytest.approx(0.3 * 75, rel=1e-6)


def test_scan_slope_jitter_artifact_flagged_unreliable(monkeypatch):
    """A positive slope whose chain-median separation sits INSIDE the rep
    jitter band must come back unreliable — positivity alone would wave
    that artifact through."""
    out = _slope_with_fake_times(
        monkeypatch,
        # ~65 ms medians, +-5 ms alternating jitter, true slope ~0.01 ms/item
        lambda k, i: 0.065 + 1e-5 * k + (0.005 if i % 2 else -0.005),
    )
    assert out["per_item_ms"] > 0  # the old guard would have published this
    assert out["reliable"] is False
    assert out["jitter_ms"] >= 3.0  # the alternating +-5 ms lands in the IQR
    assert out["delta_ms"] < 3 * out["jitter_ms"]


def test_scan_slope_negative_slope_unreliable(monkeypatch):
    out = _slope_with_fake_times(
        monkeypatch, lambda k, i: 0.100 - 0.0001 * k
    )
    assert out["per_item_ms"] < 0
    assert out["reliable"] is False


def test_device_chain_latency_tiny_geometry():
    # 48 px frames / 12 px patches: the full fused chain (grayscale -> crop
    # -> flow -> getRT -> detilt) in a dynamic-trip-count while_loop, both
    # chain lengths through ONE compiled program.  max_k=16 pins the chain
    # length (no escalation — CPU timing is inherently jittery here).
    cfg = FftMethodConfig(frame_size=48, sample_point_size=12, backend="fft")
    out = measure_device_chain_latency(
        16, reps=2, warmup=1, config=cfg, width=64, height=48, max_k=16
    )
    assert out["k"] == 16
    assert np.isfinite(out["per_frame_ms"])
    for key in ("delta_ms", "jitter_ms", "escalations"):
        assert key in out
    assert isinstance(out["slope_ok"], bool)


def test_device_chain_latency_escalates_until_reliable(monkeypatch):
    """An unreliable slope doubles the chain length (within max_k and the
    budget) and remeasures — the self-policing contract.  The
    slope measurement itself is stubbed; the real frames stack is built at
    max_k so every escalated length reuses one compiled program."""
    calls = []

    def fake_slope(build, k_pair, reps=7, warmup=2):
        calls.append(tuple(k_pair))
        reliable = k_pair[1] >= 64
        return {
            "per_item_ms": 0.3, "overhead_ms": 65.0,
            "k_pair": list(k_pair),
            "med_ms": {int(k): 65.0 + 0.3 * k for k in k_pair},
            "delta_ms": 0.3 * (k_pair[1] - k_pair[0]),
            "jitter_ms": 0.0 if reliable else 50.0,
            "reliable": reliable,
        }

    monkeypatch.setattr(benchlib, "measure_scan_slope", fake_slope)
    cfg = FftMethodConfig(frame_size=48, sample_point_size=12, backend="fft")
    out = measure_device_chain_latency(
        16, reps=2, warmup=1, config=cfg, width=64, height=48,
        max_k=64, budget_s=10_000.0,
    )
    assert calls == [(4, 16), (8, 32), (16, 64)]
    assert out["k"] == 64
    assert out["escalations"] == 2
    assert out["slope_ok"] is True


def test_device_chain_latency_escalation_respects_budget(monkeypatch):
    """No budget left -> no escalation: publish the honest unreliable
    verdict instead of tripping the caller's alarm mid-refinement."""
    def fake_slope(build, k_pair, reps=7, warmup=2):
        return {
            "per_item_ms": 0.05, "overhead_ms": 65.0,
            "k_pair": list(k_pair),
            "med_ms": {int(k): 65.0 for k in k_pair},
            "delta_ms": 0.5, "jitter_ms": 5.0, "reliable": False,
        }

    monkeypatch.setattr(benchlib, "measure_scan_slope", fake_slope)
    cfg = FftMethodConfig(frame_size=48, sample_point_size=12, backend="fft")
    out = measure_device_chain_latency(
        16, reps=2, warmup=1, config=cfg, width=64, height=48,
        max_k=64, budget_s=0.0,
    )
    assert out["k"] == 16
    assert out["escalations"] == 0
    assert out["slope_ok"] is False


def test_node_latency_ab_interleaved_smoke():
    """The interleaved host_preprocess A/B harness: two nodes, block-
    alternating within one run, paired per-round deltas.  CPU values are
    meaningless — assert the record's shape and internal consistency."""
    overrides = {"mrs_optic_flow": {"frame_size": 96, "sample_point_size": 24}}
    out = measure_node_latency_ab(
        8, block=2, warmup=2, n_distinct=2,
        overrides_a=overrides,
        overrides_b={**overrides, "tpu": {"host_preprocess": True}},
    )
    assert out["n_rounds"] == 2
    assert len(out["round_deltas_ms"]) == 2
    assert np.isfinite(out["delta_p50_ms"])
    assert 0.0 <= out["sign_consistency"] <= 1.0
    assert out["a_p50_ms"] > 0 and out["b_p50_ms"] > 0
    # the paired delta is consistent with the per-config medians' sign at
    # this tiny sample only up to jitter, so just check it is bounded by
    # the raw medians' scale
    assert abs(out["delta_p50_ms"]) < 1e6


def test_node_latency_smoke():
    # a handful of frames through the real node path; just assert the
    # percentile record is well-formed (values are meaningless on CPU)
    out = measure_node_latency(
        n_frames=4,
        warmup=2,
        n_distinct=2,
        overrides={
            "mrs_optic_flow": {"frame_size": 96, "sample_point_size": 24},
        },
    )
    assert out["n"] == 4
    for key in ("p50_ms", "p90_ms", "p95_ms", "p99_ms", "mean_ms"):
        assert np.isfinite(out[key]) and out[key] > 0
    assert out["p50_ms"] <= out["p99_ms"]
