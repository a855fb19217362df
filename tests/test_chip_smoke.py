"""``chip_smoke.py`` on CPU: its phases at a tiny geometry, and its refusal
to report anything without a GPU.

The phases are the same functions the script runs on the card at the
reference geometry; here they run at 96 px crops of 160x96 captures so the
whole chain (oracle parity, node modes, replay batch, fleet tick) is
checked for wiring and tolerances without a card.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

#: a 160x96 capture with a 96 px crop of 24 px windows (4x4 grid)
TINY_SCENE = {"width": 160, "height_px": 96, "fx": 90.0, "fy": 90.0,
              "texture_scale": 45.0}  # ~1 texel per pixel at 2 m
TINY_CONFIG = {
    "mrs_optic_flow": {"frame_size": 96, "sample_point_size": 24},
    "scale_rot_magnitude": 20.0,
}


def test_device_phase_refuses_cpu():
    from mrs_optic_flow_tpu.utils.device import NoGpuError

    with pytest.raises(NoGpuError, match="not 'gpu'"):
        chip_smoke.phase_device()


@pytest.fixture
def tiny_bounds(monkeypatch):
    """The truth and twist bounds scaled to the tiny geometry: 24 px
    windows carry ~0.5 px of the method's own bias vs truth, and one pixel
    of flow is ~0.44 m/s here (4.7x the reference geometry's).  The oracle
    bound is the one that stays tight at every geometry."""
    for name, value in (("TRUTH_MEDIAN_TOL_PX", 1.0), ("TRUTH_WINDOW_TOL_PX", 1.5),
                        ("NODE_TOL", 0.6), ("NODE_LR_TOL", 1.0)):
        monkeypatch.setattr(chip_smoke, name, value)


@pytest.mark.parametrize("backend", chip_smoke.BACKENDS)
def test_flow_phase_tiny(backend, tiny_bounds):
    out = chip_smoke.phase_flow((backend,), size=96, patch=24, n_pairs=2,
                                max_shift=5.0)
    assert out[backend]["nan_windows"] == 0
    assert out[backend]["oracle_px"] <= chip_smoke.ORACLE_TOL_PX


def test_node_phase_tiny(tiny_bounds):
    out = chip_smoke.phase_node(overrides=TINY_CONFIG, n_frames=4,
                                scene_kw=TINY_SCENE)
    assert set(out) == {"short_range", "long_range", "scale_rotation"}


def test_replay_phase_tiny(tiny_bounds):
    out = chip_smoke.phase_replay(batch=8, min_batch=4, n_distinct=4,
                                  overrides=TINY_CONFIG, scene_kw=TINY_SCENE)
    assert out["replay"]["batch"] == 8 and out["replay"]["ok"] == 8
    assert out["fleet"]["ok"] == 8
    assert out["memory"]["argument_bytes"] > 0


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "ok" in rec:
            return True
    return False


def test_script_exits_nonzero_without_gpu():
    """Run as a user runs it (no arguments), on a host whose JAX finds no GPU: a
    non-zero exit and no result line."""
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "not 'gpu'" in proc.stderr


def test_script_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script cannot reach the program and must not report a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
