"""The benchmark harness (``bench_guard`` + ``bench.py``) on CPU.

- the incremental :class:`bench_guard.Emitter` (every emission a full,
  parseable, flushed JSON line; ``provisional`` dropped only on the final);
- ``bench.py``'s orchestration with the measurement stubbed: a run
  interrupted mid-flight (TimeoutError after the first measured window)
  still leaves a parseable record carrying the provisional headline value,
  every record names the device, and with no GPU the run refuses to
  measure (error record, exit 1) instead of falling back to the CPU.
"""

import io
import json
import os
import signal
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_guard
from bench_guard import Emitter


# ---------------------------------------------------------------------- #
# Emitter                                                                #
# ---------------------------------------------------------------------- #


def test_emitter_every_line_parseable_and_provisional_flagged():
    buf = io.StringIO()
    em = Emitter({"metric": "m", "unit": "fps"}, stream=buf)
    em.emit(value=1.0)
    em.emit(value_fast=2.0)
    em.emit(final=True)
    lines = buf.getvalue().strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert len(recs) == 3
    assert recs[0] == {"metric": "m", "unit": "fps", "value": 1.0,
                       "provisional": True}
    # fields accumulate: every line is the FULL record so far
    assert recs[1]["value"] == 1.0 and recs[1]["value_fast"] == 2.0
    assert recs[1]["provisional"] is True
    # the final line carries everything and drops the flag
    assert "provisional" not in recs[-1]
    assert recs[-1]["value"] == 1.0 and recs[-1]["value_fast"] == 2.0


def test_emitter_interrupted_run_leaves_best_measurement():
    """The partial-emission contract: die at ANY point after the first
    emission and the last stdout line is a parseable record with the
    measurement."""
    buf = io.StringIO()
    em = Emitter({"metric": "m"}, stream=buf)
    try:
        em.emit(value=59931.7)
        raise TimeoutError("budget exceeded mid-refinement")
    except TimeoutError:
        pass
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last["value"] == 59931.7
    assert last["provisional"] is True


# ---------------------------------------------------------------------- #
# bench.py orchestration (CPU, measurement stubbed)                      #
# ---------------------------------------------------------------------- #


FAKE_GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _stats(v):
    """A measure_chained_stats-shaped record around one scalar rate."""
    return {"rate": v, "rate_min": v - 100.0, "rate_max": v + 100.0,
            "window_rates": [v - 100.0, v, v, v + 100.0], "n_windows": 4}


@pytest.fixture
def bench_module(monkeypatch):
    import bench  # arms a real 540 s SIGALRM at import — disarm for the suite

    signal.alarm(0)
    monkeypatch.setattr(bench, "BATCH", 2)  # _make_inputs stays trivial
    # the module-level budget clock started at import, long before this
    # test — swap in a fresh one so budget gates behave as at process start
    monkeypatch.setattr(bench, "_remaining", lambda: 10_000.0)
    # the orchestration under test, not the device: pretend to be on a card
    monkeypatch.setattr(bench, "require_gpu", lambda: dict(FAKE_GPU))
    monkeypatch.setenv("BENCH_LATENCY", "0")
    monkeypatch.setenv("BENCH_ACCURACY", "0")
    yield bench
    signal.alarm(0)


def test_bench_interrupted_midflight_keeps_provisional_value(
    bench_module, monkeypatch, capsys
):
    """The run overstays its budget AFTER the first measured window.  It
    dies nonzero, but stdout's last line is a parseable record carrying the
    provisional headline."""

    def fake_measure(prev, curr, progress=None):
        if progress is not None:
            progress(1234.5)  # first window landed -> provisional emission
        raise TimeoutError("BENCH_TIMEOUT_S exceeded")

    monkeypatch.setattr(bench_module, "_measure_fps", fake_measure)
    with pytest.raises(SystemExit) as exc:
        bench_module.main()
    assert exc.value.code == 1
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    recs = [json.loads(line) for line in lines]
    assert recs[-2]["value"] == 1234.5 and recs[-2]["provisional"] is True
    # the final error record still carries the measured value
    assert recs[-1]["value"] == 1234.5
    assert "error" in recs[-1] and "provisional" not in recs[-1]


def test_bench_clean_run_emits_final_record(bench_module, monkeypatch, capsys):
    monkeypatch.setattr(
        bench_module, "_measure_fps",
        lambda prev, curr, progress=None: _stats(50000.0),
    )
    bench_module.main()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    recs = [json.loads(line) for line in lines]
    final = recs[-1]
    assert "provisional" not in final
    assert final["value"] == 50000.0
    # the per-window spread ships with the headline
    assert final["value_min"] == 49900.0 and final["value_max"] == 50100.0
    assert len(final["value_windows"]) == 4
    # the record names the device it ran on
    assert final["platform"] == "gpu"
    assert final["device_kind"] == FAKE_GPU["kind"]
    assert final["device_count"] == 1
    # every earlier line parseable and marked provisional
    for r in recs[:-1]:
        assert r["provisional"] is True


def test_bench_accuracy_stage_emitted_and_budget_checked(
    bench_module, monkeypatch, capsys
):
    """The on-device accuracy stage: compiled-path vs oracle error lands in
    the record with an explicit budget verdict."""
    monkeypatch.setenv("BENCH_ACCURACY", "1")
    monkeypatch.setattr(
        bench_module, "_measure_fps",
        lambda prev, curr, progress=None: _stats(50000.0),
    )
    monkeypatch.setattr(
        bench_module, "_measure_accuracy", lambda: {"accuracy_px": 0.0005},
    )
    bench_module.main()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    final = json.loads(lines[-1])
    assert final["accuracy_px"] == 0.0005
    assert final["accuracy_budget_px"] == 0.1
    assert final["accuracy_ok"] is True

    # a budget violation is flagged, not hidden — and the headline survives
    monkeypatch.setattr(
        bench_module, "_measure_accuracy", lambda: {"accuracy_px": 0.5},
    )
    bench_module.main()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    final = json.loads(lines[-1])
    assert final["accuracy_ok"] is False
    assert "accuracy_error" in final
    assert final["value"] == 50000.0

    # the all-windows-NaN'd regression shape: the error field is null
    # (strict JSON — a bare NaN token would make the record documenting
    # the regression unparseable), the NaN count is published, and the
    # budget check fails
    monkeypatch.setattr(
        bench_module, "_measure_accuracy",
        lambda: {"accuracy_px": None, "accuracy_px_nan_windows": 96},
    )
    bench_module.main()
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert '"accuracy_px": null' in lines[-1]  # strict JSON, parseable
    final = json.loads(lines[-1])
    assert final["accuracy_px"] is None
    assert final["accuracy_px_nan_windows"] == 96
    assert final["accuracy_ok"] is False


def test_bench_refuses_without_gpu(bench_module, monkeypatch, capsys):
    """No GPU, no number: the run prints an error record naming the device
    it found and exits 1 — it never falls back to timing the CPU."""
    import jax

    from mrs_optic_flow_tpu.utils import device

    monkeypatch.setattr(bench_module, "require_gpu", device.require_gpu)
    calls = []
    monkeypatch.setattr(
        bench_module, "_measure_fps",
        lambda *a, **k: calls.append(1) or _stats(1.0),
    )
    with pytest.raises(SystemExit) as exc:
        bench_module.main()
    assert exc.value.code == 1
    assert calls == []  # nothing was measured
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    final = json.loads(lines[-1])
    assert "provisional" not in final
    assert "not 'gpu'" in final["error"]
    assert jax.devices()[0].platform in final["error"]
    assert "value" not in final
