"""Cross-backend conformance checker — the live version of the reference's
dual-path debug machinery.

The reference keeps a dormant debug path that runs both its kernel and the
host reference and diffs the intermediate buffers (``storageA``/``storageB``
at ``src/FftMethod.cpp:1482-1483``, viewer ``showFMat`` ``:10-48``) plus the
``useOCL`` runtime switch.  This module makes that a first-class tool:
:func:`check` runs every spectral backend on the same input batch and
reports the pairwise maximum shift disagreement — usable in CI, at bring-up
on new hardware, or from the CLI.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.ops.phase_correlate import phase_correlate_field


def backends() -> Tuple[str, ...]:
    """The plain XLA spectral backends (one device path, two transforms)."""
    return ("fft", "dft")


def check(curr, prev, *, tolerance_px: float = 0.05) -> Dict[str, float]:
    """Pairwise max |shift| disagreement across backends on one patch batch.

    Returns ``{"a|b": max_abs_diff_px, ...}``; raises AssertionError if any
    pair exceeds ``tolerance_px`` (the <0.1 px conformance budget of
    BASELINE.md, halved as a guard band).
    """
    curr = jnp.asarray(curr, jnp.float32)
    prev = jnp.asarray(prev, jnp.float32)
    outs = {}
    for name in backends():
        s, _ = phase_correlate_field(curr, prev, backend=name)
        outs[name] = np.asarray(s)

    report: Dict[str, float] = {}
    names = list(outs)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            diff = np.abs(outs[a] - outs[b])
            # NaN must FAIL, not mask: the engines' gating produces NaN only
            # downstream of this raw-shift contract, so a NaN here is a
            # backend regression — and a NaN `worst` would compare False
            # against the tolerance, silently passing everything
            if np.isnan(diff).any():
                # both-NaN in the same window is agreement (e.g. a gated
                # variant under test); one-sided NaN is a divergence
                one_sided = np.isnan(outs[a]) != np.isnan(outs[b])
                if one_sided.any():
                    raise AssertionError(
                        f"backend pair {a}|{b}: one-sided NaN shifts "
                        f"({int(one_sided.sum())} windows)"
                    )
                diff = np.where(np.isnan(diff), 0.0, diff)
            report[f"{a}|{b}"] = float(np.max(diff))
    worst = max(report.values())
    if worst > tolerance_px:
        bad = {k: v for k, v in report.items() if v > tolerance_px}
        raise AssertionError(f"backend disagreement over {tolerance_px} px: {bad}")
    return report
