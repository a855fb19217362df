"""Process guards shared by the benchmark entry scripts (``bench.py``,
``bench_latency.py``, ``scripts/bench_pipeline.py``):

- a *raising* SIGALRM handler with a ``BENCH_TIMEOUT_S`` budget, so a run
  that overstays its budget still prints a parseable error record instead
  of being killed silently;
- :class:`Emitter`, the incremental one-JSON-line record.

This module must stay importable BEFORE jax (no jax imports here): the
alarm has to be armed before the first device touch.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time


def _timeout(signum, frame):
    raise TimeoutError("BENCH_TIMEOUT_S exceeded")


def install_alarm(default_s: int = 540) -> int:
    """Arm a raising ``SIGALRM`` with the ``BENCH_TIMEOUT_S`` budget
    (defaulting to ``default_s``); returns the budget in seconds."""
    signal.signal(signal.SIGALRM, _timeout)
    budget = int(os.environ.get("BENCH_TIMEOUT_S", str(default_s)))
    signal.alarm(budget)
    return budget


def budget_clock(budget_s: int):
    """Zero-arg callable returning seconds left of a ``budget_s`` window
    starting NOW — the ``remaining()`` companion to :func:`install_alarm`,
    shared by the entry scripts instead of each keeping its own copy."""
    t0 = time.monotonic()

    def remaining() -> float:
        return budget_s - (time.monotonic() - t0)

    return remaining


class Emitter:
    """Incremental one-JSON-line benchmark record.

    Every ``emit()`` prints the FULL current record as one flushed JSON
    line, so however the process dies afterwards (alarm, crash, kill), the
    LAST complete line on stdout is the best measurement so far.
    Non-final emissions carry ``"provisional": true``; the final one drops
    the flag.  Consumers that take the last JSON line (or the only one,
    when nothing interrupts the run) see a parseable record either way.
    """

    def __init__(self, record: dict | None = None, stream=None):
        self.record = dict(record or {})
        self.stream = stream if stream is not None else sys.stdout

    def update(self, **fields) -> None:
        self.record.update(fields)

    def emit(self, final: bool = False, **fields) -> None:
        self.record.update(fields)
        rec = dict(self.record)
        if final:
            rec.pop("provisional", None)
        else:
            rec["provisional"] = True
        print(json.dumps(rec), file=self.stream, flush=True)
