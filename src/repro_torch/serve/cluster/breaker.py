"""Per-worker circuit breaker: stop aiming traffic at a failing replica.

The router's power-of-two-choices balancer needs a candidate set that is
not just "process alive" (``ready``) but "recently answering": a worker
that is up-but-failing (proxy truncating its responses, connection flaps,
replies timing out against deadlines) would otherwise keep absorbing half
the traffic and converting it into retries.  The classic three-state
breaker fixes that:

* **closed** — healthy; every request is allowed.  ``failures``
  *consecutive* failures trip it open (any success resets the count).
* **open** — the worker is cut out of the candidate set for ``cooldown``
  seconds; requests route to its siblings instead.
* **half-open** — after the cooldown, exactly ONE probe request is let
  through.  Success closes the breaker; failure re-opens it for another
  cooldown.

The clock is injectable so tests (and the doctest below) are exact:

>>> now = [0.0]
>>> b = CircuitBreaker(failures=2, cooldown=1.0, clock=lambda: now[0])
>>> b.state, b.would_allow()
('closed', True)
>>> b.record_failure(); b.record_failure()      # trip: 2 consecutive
>>> b.state, b.would_allow()
('open', False)
>>> now[0] = 1.5                                # cooldown elapsed
>>> b.would_allow(), b.allow()                  # one half-open probe
(True, True)
>>> b.state, b.allow()                          # ...and only one
('half_open', False)
>>> b.record_success(); b.state                 # probe succeeded
'closed'
"""

from __future__ import annotations

import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    ``would_allow`` is the pure check the balancer uses to *filter*
    candidates (it never consumes the probe); ``allow`` is called for the
    one replica actually chosen and consumes the half-open probe slot.
    """

    __slots__ = ("threshold", "cooldown", "_clock", "_state", "_failures",
                 "_opened_at", "trips")

    def __init__(self, *, failures: int = 3, cooldown: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self.threshold = int(failures)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        #: total closed->open transitions (stats)
        self.trips = 0

    @property
    def state(self) -> str:
        return self._state

    def _cooled(self) -> bool:
        return self._clock() - self._opened_at >= self.cooldown

    def would_allow(self) -> bool:
        """Pure candidate check: may a request be routed here right now?"""
        if self._state == CLOSED:
            return True
        if self._state == OPEN:
            return self._cooled()
        return False  # half-open: the single probe is already in flight

    def allow(self) -> bool:
        """Consuming check for the chosen replica (takes the probe slot)."""
        if self._state == CLOSED:
            return True
        if self._state == OPEN and self._cooled():
            self._state = HALF_OPEN
            return True
        return False

    def record_success(self) -> None:
        self._state = CLOSED
        self._failures = 0

    def record_failure(self) -> None:
        if self._state == HALF_OPEN:  # the probe failed: back to open
            self._open()
            return
        self._failures += 1
        if self._state == CLOSED and self._failures >= self.threshold:
            self._open()

    def _open(self) -> None:
        if self._state != OPEN:
            self.trips += 1
        self._state = OPEN
        self._failures = 0
        self._opened_at = self._clock()

    def stats(self) -> dict:
        return {"state": self._state, "trips": self.trips,
                "consecutive_failures": self._failures}
