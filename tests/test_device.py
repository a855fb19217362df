"""The device record and the refusal to measure without a GPU
(``utils/device.py`` and the measuring entry points that use it)."""

import json
import os
import subprocess
import sys

import jax
import pytest

from mrs_optic_flow_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_record_names_jax_default_device():
    rec = device.device_record()
    assert rec == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_require_gpu_refuses_cpu():
    with pytest.raises(device.NoGpuError, match="not 'gpu'"):
        device.require_gpu()


def test_nvidia_smi_missing_is_reported_not_raised(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert device.gpu_name_and_power().startswith("not available")


@pytest.mark.parametrize("script", [
    "bench.py", "bench_latency.py", os.path.join("scripts", "bench_pipeline.py"),
    os.path.join("scripts", "time_flow_backends.py"),
])
def test_measuring_scripts_refuse_without_gpu(script):
    """Every entry point that reports a device number exits 1 on a host
    whose JAX finds no GPU, with an error record and no value."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    last = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert "not 'gpu'" in last["error"]
    assert "value" not in last


@pytest.mark.parametrize("script", [
    "profile_geometry.py", "tune_lp_batch.py", "tune_lp_chunk.py",
    "tune_scale_rotation.py", "verify_sr_fused.py",
])
def test_tuning_scripts_refuse_without_gpu(script):
    """The tuning scripts time the device too: without a GPU they stop
    before measuring anything."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "NoGpuError" in proc.stderr
    assert "_ms" not in proc.stdout  # no timing line was printed


@pytest.mark.gpu
def test_plain_path_compiled_on_gpu(gpu_device):
    """On a card host: the compiled plain path at the reference geometry
    holds the oracle budget (``chip_smoke.py`` phase 2 as a test)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    out = chip_smoke.phase_flow(n_pairs=2)
    assert all(r["oracle_px"] <= chip_smoke.ORACLE_TOL_PX for r in out.values())
