"""Wall-clock abstraction: the port of ``repro/core/clock.py``.

The paper simulates real-robot timing: 'since data simulation is typically
much faster than real-time, the worker responsible for data collection
sleeps until the time T [200 / control-frequency] elapses' (§5.1). The
VirtualClock reproduces that deterministically: data-collection 'sleeps'
advance simulated time by the trajectory duration; model/policy workers
account their compute against the same timeline via measured host time
scaled by a speed factor.
"""
from __future__ import annotations

import threading
import time


class RealClock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Thread-safe simulated clock.

    ``sleep`` advances a per-thread cursor; ``now`` reports the cursor.
    Used to report 'what wall-clock time WOULD this have taken on the
    robot', matching Figure 2's methodology."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cursors = {}

    def _key(self):
        return threading.get_ident()

    def now(self) -> float:
        with self._lock:
            return self._cursors.get(self._key(), 0.0)

    def sleep(self, seconds: float) -> None:
        with self._lock:
            k = self._key()
            self._cursors[k] = self._cursors.get(k, 0.0) + max(seconds, 0.0)

    def max_time(self) -> float:
        with self._lock:
            return max(self._cursors.values(), default=0.0)
