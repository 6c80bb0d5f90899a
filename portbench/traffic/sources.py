"""Frame sources handed to the app: a closed loop and a camera's paced grab.

Both cycle the pool and record, for each frame k they hand, its pool index,
its due time and the time it was handed; the paced source also records the
intervals it spent blocked, waiting for a frame's due time. Times are
`time.perf_counter()` seconds. A source ends (StopIteration) at the end of
its window, so the app's stream drains and stops.

`span` is a context factory wrapped around each call (a profiler annotation
in a traced run); it is called with the span's name.
"""

from __future__ import annotations

import contextlib
import time

from portbench.traffic.scene import eyes

SPIN_S = 5e-4    # the paced source spins the last half millisecond before a due time


def _no_span(name):
    return contextlib.nullcontext()


class _Source:
    def __init__(self, pool, span=_no_span):
        self.pool = pool
        self.span = span
        self.index: list[int] = []
        self.due: list[float] = []
        self.handed: list[float] = []
        self.blocked: list[tuple[float, float]] = []

    def __iter__(self):
        return self

    def _hand(self, due: float, handed: float):
        i = len(self.index) % len(self.pool)
        self.index.append(i)
        self.due.append(due)
        self.handed.append(handed)
        return eyes(self.pool[i])


class ClosedSource(_Source):
    """Hands the next frame as soon as the app asks for it, until `t_end`
    (or `limit` frames). A frame is due when it is handed."""

    def __init__(self, pool, t_end: float = float("inf"), limit: int | None = None,
                 span=_no_span):
        super().__init__(pool, span)
        self.t_end = t_end
        self.limit = limit

    def __next__(self):
        with self.span("portbench.source_next"):
            now = time.perf_counter()
            if now >= self.t_end or (self.limit is not None and len(self.index) >= self.limit):
                raise StopIteration
            return self._hand(now, now)


class PacedSource(_Source):
    """A camera at `rate` frames a second from `t0`: frame k is due at
    t0 + k / rate, and the app's call for it blocks until then, as a grab
    does. Hands the frames due before `t_end`; a call after a due time
    returns at once (the frame waited in the camera's buffer)."""

    def __init__(self, pool, t0: float, t_end: float, rate: float, span=_no_span):
        super().__init__(pool, span)
        self.t0, self.t_end, self.rate = t0, t_end, rate

    def __next__(self):
        with self.span("portbench.source_next"):
            due = self.t0 + len(self.index) / self.rate
            if due >= self.t_end:
                raise StopIteration
            start = time.perf_counter()
            if start < due:
                if due - start > SPIN_S:
                    time.sleep(due - start - SPIN_S)
                while time.perf_counter() < due:
                    pass
                self.blocked.append((start, time.perf_counter()))
            return self._hand(due, time.perf_counter())


def make_source(traffic: dict, pool, t0: float, seconds: float, span=_no_span) -> _Source:
    """The cell's window source: `traffic["loop"]` is "closed" or "open"
    (paced at `traffic["rate_fps"]`)."""
    if traffic["loop"] == "closed":
        return ClosedSource(pool, t_end=t0 + seconds, span=span)
    if traffic["loop"] == "open":
        return PacedSource(pool, t0, t0 + seconds, float(traffic["rate_fps"]), span=span)
    raise ValueError(f"unknown loop {traffic['loop']!r}")
