"""Shared clock layer: the port's own copy of ``repro.clock``.

``SystemClock`` is wall time behind the ``Clock`` interface;
``VirtualClock`` is simulated time, advanced tick by tick (serving replay,
``repro_torch.serving.loadgen``) or by events popped from a heap in
``(time, seq)`` order; ``use_clock`` / ``now`` select the active clock in a
scope. Pure Python, identical in behaviour to the JAX package's module.
"""
from __future__ import annotations

import contextlib
import contextvars
import heapq
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple


class Clock:
    """Minimal clock interface: ``now()`` in (possibly simulated) seconds."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class SystemClock(Clock):
    def now(self) -> float:
        return time.time()


class VirtualClock(Clock):
    """Deterministic simulated time with a tick counter and an event heap."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.ticks = 0
        self._seq = 0
        self._heap: List[Tuple[float, int, Callable, tuple]] = []

    # ------------------------------------------------------------- #
    def now(self) -> float:
        return self._now

    def tick(self, dt: float = 1.0) -> float:
        """Tick-driven advancement (serving replay): one scheduler step."""
        self._now += dt
        self.ticks += 1
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"clock cannot run backwards: {t} < {self._now}")
        self._now = t

    # ------------------------------------------------------------- #
    def schedule(self, delay: float, fn: Callable, *args: Any) -> int:
        """Queue ``fn(*args)`` at ``now + delay``; returns a cancel handle."""
        return self.schedule_at(self._now + max(0.0, delay), fn, *args)

    def schedule_at(self, t: float, fn: Callable, *args: Any) -> int:
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, fn, args))
        return self._seq

    def cancel(self, handle: int) -> None:
        """Lazy cancel: the event is dropped when it reaches the heap top."""
        for i, ev in enumerate(self._heap):
            if ev[1] == handle:
                self._heap[i] = (ev[0], ev[1], _cancelled, ())
                return

    @property
    def pending(self) -> int:
        return sum(1 for ev in self._heap if ev[2] is not _cancelled)

    def run(self, until: Optional[float] = None,
            max_events: int = 10_000_000) -> int:
        """Pop events in ``(time, seq)`` order until the heap drains, the
        horizon passes, or ``max_events`` fires. Returns events fired."""
        fired = 0
        while self._heap and fired < max_events:
            t, _seq, fn, args = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            if fn is _cancelled:
                continue
            self.advance_to(max(t, self._now))
            fn(*args)
            fired += 1
        if until is not None:
            self._now = max(self._now, until)
        return fired


def _cancelled() -> None:  # sentinel body for cancelled events
    pass


# ------------------------------------------------------------------ #
# Active-clock selection (scoped, like repro.api.backends.use_backend)
# ------------------------------------------------------------------ #
_SYSTEM = SystemClock()
_active: contextvars.ContextVar[Clock] = contextvars.ContextVar(
    "repro_active_clock", default=_SYSTEM)


def current_clock() -> Clock:
    return _active.get()


@contextlib.contextmanager
def use_clock(clock: Clock) -> Iterator[Clock]:
    """Scope ``clock`` as the active time source for ``repro.clock.now()``."""
    token = _active.set(clock)
    try:
        yield clock
    finally:
        _active.reset(token)


def now() -> float:
    """Time from the active clock (virtual inside ``use_clock``, else wall)."""
    return _active.get().now()
