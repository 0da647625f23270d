"""Injectable time source for timed waits (the port's copy of
`node_replication_tpu/utils/clock.py`).

`now()` is monotonic seconds, `sleep(s)` blocks, `wait(cond, timeout)`
waits on an already-held `threading.Condition` and returns False iff
the timeout elapsed without a notification. The process-global default
is `RealClock`; `set_clock`/`installed` swap it. `SimClock` is the
virtual twin the simulation plane (`sim/`) installs: time advances only
through `advance()` (or instantly inside `sleep()` with
`auto_advance=True`), so a seeded schedule decides which timeouts fire
and in what order.
"""

from __future__ import annotations

import contextlib
import threading
import time

from node_replication_torch.analysis.locks import make_condition


class Clock:
    """Injectable time source."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait(self, cond: threading.Condition,
             timeout: float | None = None) -> bool:
        raise NotImplementedError


class RealClock(Clock):
    """The default: thin veneer over the OS monotonic clock."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def wait(self, cond: threading.Condition,
             timeout: float | None = None) -> bool:
        return cond.wait(timeout)


class SimClock(Clock):
    """Virtual monotonic clock for deterministic simulation.

    Time moves only when someone moves it: `advance(dt)` /
    `advance_to(t)` from the stepping thread, or, with `auto_advance=True`
    (the single-stepper mode), instantly inside `sleep()`, so a backoff
    or an injected stall costs no wall time and still shows in virtual
    timelines.

    A timed condition wait (`wait(cond, t)`) registers a virtual
    deadline and blocks on the condition with NO real timeout: the
    waiter wakes on a real `notify` or when `advance()` crosses its
    deadline (the clock notifies the registered condition). Threads
    that run under a SimClock either make no timed waits (for example
    `batch_linger_s=0`) or are paired with a thread that advances the
    clock; `waiters()` lists the registered deadlines so a stepper can
    advance exactly to the next one.
    """

    def __init__(self, start: float = 0.0, auto_advance: bool = True):
        self._cond = make_condition("SimClock._cond")
        self._now = float(start)
        self.auto_advance = bool(auto_advance)
        # timed condition waiters: [deadline, cond] entries (a list:
        # one cond may carry several deadlines)
        self._waiters: list[list] = []

    def now(self) -> float:
        with self._cond:
            return self._now

    def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._cond:
            deadline = self._now + seconds
            if self.auto_advance:
                self._advance_locked(deadline)
                return
            while self._now < deadline:
                self._cond.wait()

    def wait(self, cond: threading.Condition,
             timeout: float | None = None) -> bool:
        if timeout is None:
            # the predicate loop lives at the caller (the Clock.wait
            # contract mirrors Condition.wait); spurious wakeups are
            # re-checked there
            # nrlint: disable=condition-wait-without-predicate-loop
            cond.wait()
            return True
        with self._cond:
            if timeout <= 0:
                return False
            entry = [self._now + timeout, cond]
            self._waiters.append(entry)
        try:
            # no real timeout: a real notify, or the clock crossing the
            # deadline (advance notifies `cond`), wakes us; the caller's
            # predicate loop absorbs spurious wakeups
            # nrlint: disable=condition-wait-without-predicate-loop
            cond.wait()
        finally:
            with self._cond:
                if entry in self._waiters:
                    self._waiters.remove(entry)
                expired = self._now >= entry[0]
        return not expired

    def advance(self, dt: float) -> float:
        """Move virtual time forward by `dt`, waking every sleeper and
        timed waiter whose deadline the step crosses; returns the new
        time."""
        with self._cond:
            return self._advance_locked(self._now + float(dt))

    def advance_to(self, t: float) -> float:
        """Move virtual time to absolute `t` (no-op when in the past)."""
        with self._cond:
            return self._advance_locked(float(t))

    def _advance_locked(self, t: float) -> float:
        if t > self._now:
            self._now = t
        expired = [c for (d, c) in self._waiters if d <= self._now]
        self._cond.notify_all()  # wake blocking sleepers
        now = self._now
        # notify outside our lock: a woken waiter takes OUR lock to
        # unregister (order cond -> clock there), so taking cond under
        # the clock lock here would be the reverse order, a deadlock
        if expired:
            self._cond.release()
            try:
                for c in {id(c): c for c in expired}.values():
                    with c:
                        c.notify_all()
            finally:
                self._cond.acquire()
        return now

    def waiters(self) -> list[float]:
        """Registered timed-wait deadlines, sorted
        (`advance_to(waiters()[0])` fires exactly the next timeout)."""
        with self._cond:
            return sorted(d for d, _ in self._waiters)


_clock: Clock = RealClock()


def get_clock() -> Clock:
    """The process-global clock (default: `RealClock`)."""
    return _clock


def set_clock(clock: Clock) -> Clock:
    """Install `clock` globally; returns the previous one."""
    global _clock
    prev = _clock
    _clock = clock
    return prev


@contextlib.contextmanager
def installed(clock: Clock):
    """Install `clock`, restore the previous one on exit."""
    prev = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(prev)
