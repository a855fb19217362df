"""Accuracy report: sub-pixel flow error of every backend/mode vs the oracle.

Synthesizes band-limited textures with known non-integer shifts (Fourier
shift — exact to float precision), runs each compute path, and prints
max/mean |error| in pixels.  The acceptance budget is 0.1 px (BASELINE.md);
the table is the evidence behind the accuracy claims in ``PERF.md``.

Usage: python scripts/accuracy_report.py [N_PAIRS]
Runs on whatever device JAX picks and prints which one it was.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
from oracle import make_accuracy_pairs

from mrs_optic_flow_tpu.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

N_PAIRS = int(sys.argv[1]) if len(sys.argv) > 1 else 8
SIZE, PATCH = 480, 120


def main():
    # pair synthesis + oracle answers: the ONE shared definition
    # (tests/oracle.py::make_accuracy_pairs) also used by bench.py's
    # on-chip accuracy stage — uint8-after-Fourier-shift camera contract;
    # "vs ORACLE" isolates backend fidelity, quantization noise lands in
    # "vs truth" where it belongs
    prev, curr, truth, osh = make_accuracy_pairs(
        np.random.default_rng(42), N_PAIRS, size=SIZE, patch=PATCH
    )

    # the oracle itself vs ground truth: the floor of the METHOD — the
    # reference algorithm's intrinsic sub-pixel centroid bias, identical
    # for every faithful implementation
    oerr = np.abs(osh - truth[:, None, :])
    dev0 = jax.devices()[0]
    print(f"device={dev0.platform}/{dev0.device_kind}  pairs={N_PAIRS}  budget=0.1 px")
    print(f"{'path':<42} {'vs truth':>9} {'vs truth':>9} {'vs ORACLE':>10}")
    print(f"{'':<42} {'max':>9} {'mean':>9} {'max':>10}")
    print(f"{'oracle (reference math, f64 numpy)':<42} "
          f"{oerr.max():>9.5f} {oerr.mean():>9.5f} {'-':>10}")

    configs = [
        ("XLA graph, matmul-DFT", dict(backend="dft")),
        ("XLA graph, native FFT", dict(backend="fft")),
    ]
    pj, cj = jnp.asarray(prev), jnp.asarray(curr)
    for name, kw in configs:
        eng = FftMethod(FftMethodConfig(frame_size=SIZE, sample_point_size=PATCH, **kw))
        res = eng.step_batch(pj, cj)
        s = np.asarray(res.shifts)  # [B, q*q, 2], content-motion sign
        err = np.abs(s - truth[:, None, :])
        dev = np.abs(s - osh)  # implementation fidelity vs the oracle
        print(f"{name:<42} {np.nanmax(err):>9.5f} {np.nanmean(err):>9.5f} "
              f"{np.nanmax(dev):>10.5f}")


if __name__ == "__main__":
    main()
