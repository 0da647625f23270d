"""Lock factory for the port's subsystem locks.

Every lock is built through `make_lock` / `make_rlock` /
`make_condition` with a NAME matching the lock-order graph's node
naming (`<Class>.<attr>`), as in the reference package, so the
order-checking mode can be added behind these three functions without
touching any construction site. In this package they are plain
passthroughs to the `threading` primitives (the `NR_TPU_LOCKCHECK`
checked mode arrives with the port of `analysis/`).

Stdlib only: imported by core/, obs/ and fault/ at module-import time.
"""

from __future__ import annotations

import threading

__all__ = ["make_lock", "make_rlock", "make_condition"]


def make_lock(name: str):
    """A `threading.Lock`; `name` is its lock-order graph node."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of `make_lock`."""
    del name
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A `threading.Condition`, on `lock` when given (the paired
    `_lock`/`_cond` idiom), else on a private lock."""
    del name
    return threading.Condition(lock)
