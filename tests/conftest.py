"""Test harness configuration.

Tests run on CPU with 8 virtual devices so that the multi-device sharding
path (`mrs_optic_flow_tpu.parallel`) is exercised without a card — the
stand-in for the reference's dual-backend useOCL cross-check
(src/optic_flow.cpp:853, src/FftMethod.cpp:1824-1836).

``JAX_PLATFORMS`` defaults to ``cpu`` here; the few tests that need a GPU
carry the ``gpu`` marker and ask for the :func:`gpu_device` fixture, which
skips them when the default device is not a GPU.  Run them on a card host
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

# must be set before the first backend initialization
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The suite's wall-clock is dominated by per-test XLA compiles; the
# persistent jit cache (the program's own helper: JAX_COMPILATION_CACHE_DIR
# when set, else the fixed in-checkout directory) makes every re-run load
# them from disk.  Keyed by HLO hash — a changed program always recompiles.
# Opt out with MRS_TESTS_JIT_CACHE=0 (e.g. to time compiles).
if os.environ.get("MRS_TESTS_JIT_CACHE", "1") != "0":
    from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The default device when it is a GPU; skips the test otherwise.
    Decided here, at run time — never while a module is imported, so every
    test worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
