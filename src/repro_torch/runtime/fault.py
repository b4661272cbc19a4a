"""Fault tolerance & straggler mitigation for the training loop (a copy
of ``repro.runtime.fault``; ``StallWatchdog`` waits for the overload
item, ROADMAP queue 1, item 9).

CPU-testable control plane around the training loop:

* HeartbeatMonitor — tracks per-step wall time; flags stragglers when a
  step exceeds `straggler_factor` × the trailing median, and declares a
  hang after `hang_timeout_s`. At 1000+ nodes, the launcher would feed
  this per-host step acks; here it watches the local loop.
* RestartPolicy — bounded exponential backoff with a restart budget;
  decides restart-vs-abort after a failure.
* run_with_restarts — supervisor: runs a step loop, checkpoint-restores on
  exceptions, enforces the restart budget. A SIGTERM/preemption appears as
  an exception and takes the same path.

On restart the loop re-initializes from the newest checkpoint
(checkpoint/manager.py), which holds whole tensors, not device shards.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    factor: float


class HeartbeatMonitor:
    def __init__(self, *, window: int = 32, straggler_factor: float = 2.0,
                 hang_timeout_s: float = 1800.0):
        self.times: deque[float] = deque(maxlen=window)
        self.factor = straggler_factor
        self.hang_timeout_s = hang_timeout_s
        self._last_beat = time.monotonic()
        self.stragglers: list[StragglerReport] = []

    def beat(self, step: int) -> StragglerReport | None:
        now = time.monotonic()
        dt = now - self._last_beat
        self._last_beat = now
        report = None
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                report = StragglerReport(step, dt, med, dt / med)
                self.stragglers.append(report)
        self.times.append(dt)
        return report

    def hung(self) -> bool:
        return (time.monotonic() - self._last_beat) > self.hang_timeout_s


class RestartPolicy:
    def __init__(self, *, max_restarts: int = 10, base_backoff_s: float = 1.0,
                 max_backoff_s: float = 300.0):
        self.max_restarts = max_restarts
        self.base = base_backoff_s
        self.cap = max_backoff_s
        self.restarts = 0

    def next_backoff(self) -> float | None:
        """Seconds to wait before restart, or None if budget exhausted."""
        if self.restarts >= self.max_restarts:
            return None
        back = min(self.cap, self.base * (2 ** self.restarts))
        self.restarts += 1
        return back


def run_with_restarts(make_loop: Callable[[], Callable[[], None]],
                      policy: RestartPolicy | None = None,
                      sleep=time.sleep) -> int:
    """Supervise `loop()` (which runs until done or raises). Returns the
    number of restarts consumed. `make_loop` is called after each failure so
    the loop re-initializes from the newest checkpoint."""
    policy = policy or RestartPolicy()
    while True:
        loop = make_loop()
        try:
            loop()
            return policy.restarts
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # preemption/node failure
            back = policy.next_backoff()
            if back is None:
                raise RuntimeError(
                    f"restart budget exhausted after {policy.restarts}") from e
            sleep(back)
