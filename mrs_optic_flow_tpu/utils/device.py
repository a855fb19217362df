"""Which device a measurement ran on — and refusing to measure without one.

A number taken on the CPU says how fast XLA's CPU backend is, which nobody
deploys; so every measuring entry point (``bench.py``, ``bench_latency.py``,
``scripts/bench_pipeline.py``, ``scripts/time_flow_backends.py``, the
tuning scripts, ``chip_smoke.py``) calls :func:`require_gpu` first and
names the device in its output instead of falling back.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX found no GPU: there is nothing to measure."""


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """:func:`device_record`, or :class:`NoGpuError` when the default
    platform is not a GPU (including when JAX cannot start a backend)."""
    try:
        rec = device_record()
    except RuntimeError as e:  # no backend could be initialized at all
        raise NoGpuError(f"JAX found no device: {e}") from e
    if rec["platform"] != "gpu":
        raise NoGpuError(
            f"JAX's default platform is {rec['platform']!r} "
            f"({rec['kind']}), not 'gpu'; refusing to report device numbers"
        )
    return rec


def gpu_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints it (one line
    per card), from a child process that never imports JAX — a second JAX
    process on the card would fail for memory.  ``"not available: ..."``
    when the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available: {type(e).__name__}"
    return out or "not available: empty output"
