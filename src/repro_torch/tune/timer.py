"""The port's one host clock (counterpart of `repro/tune/timer.py::now`).

Host time only: it measures device work solely around code that has
already synchronized with the device.
"""
from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds."""
    return time.perf_counter()
