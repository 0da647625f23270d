"""Injectable time source for timed waits (the port's copy of
`node_replication_tpu/utils/clock.py`, minus the simulation clock,
which arrives with the port of `sim/`).

`now()` is monotonic seconds, `sleep(s)` blocks, `wait(cond, timeout)`
waits on an already-held `threading.Condition`. The process-global
default is `RealClock`; `set_clock`/`installed` swap it.
"""

from __future__ import annotations

import contextlib
import threading
import time


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
