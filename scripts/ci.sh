#!/usr/bin/env bash
# CI for mrs_optic_flow_tpu — build the native runtime, run the full test
# suite (CPU, 8 virtual devices), and smoke the driver entry points.
# The reference's CI only compiles (SURVEY.md section 4); this one tests.
set -euo pipefail
cd "$(dirname "$0")/.."
# CI runs on CPU; the GPU path is checked by `python chip_smoke.py`
export JAX_PLATFORMS=cpu

echo "== native build =="
make -C native

echo "== native sanitizer stress (TSAN + ASAN) =="
make -C native sanitize

echo "== test suite =="
# the FULL serial lane (slow tests included); the per-change fast lane is
# `python -m pytest tests/ -q -m "not slow"` (see CLAUDE.md).
# TF_CPP_MIN_LOG_LEVEL silences jaxlib 0.9's spurious AOT-loader ERROR on
# every jit-cache hit (see tests/conftest.py) — must be set before the
# interpreter starts, hence here and not in conftest.
TF_CPP_MIN_LOG_LEVEL=${TF_CPP_MIN_LOG_LEVEL:-3} python -m pytest tests/ -q

echo "== entry compile check =="
python - <<'EOF'
import jax
import __graft_entry__ as ge
fn, args = ge.entry()
out = jax.jit(fn)(*args)
print("entry ok:", out[0].shape)
EOF

echo "== multichip dryrun =="
python -c "import __graft_entry__ as ge; ge.dryrun_multichip(8); print('dryrun ok')"

echo "CI PASSED"
