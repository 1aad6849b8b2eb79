"""The port's host clocks (counterpart of `repro/tune/timer.py`'s `now`
and `wallclock`).

Host time only: it measures device work solely around code that has
already synchronized with the device.
"""
from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds."""
    return time.perf_counter()


def wallclock() -> float:
    """Epoch seconds for metadata stamps (checkpoint manifests), NOT for
    durations; use `now()` spans for those."""
    return time.time()
