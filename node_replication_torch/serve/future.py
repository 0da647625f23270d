"""Per-request future: the response handle `ServeFrontend.submit` returns.

The port's copy of `node_replication_tpu/serve/future.py`.

A deliberately small, allocation-light future (the stdlib
`concurrent.futures.Future` carries executor/cancel machinery the serve
path never uses). One request = one future = exactly one resolution —
the frontend resolves it with the combiner response or rejects it with
a typed error (`serve/errors.py`), never both, never twice.

Memory ordering: `_resolve`/`_reject` write the payload under the
condition's lock and publish with `notify_all`; `result()` waits on the
same condition, so the woken read observes a fully-written payload
(the `queue.Queue`/`concurrent.futures` idiom). Timed waits route
through the injectable clock (`utils/clock.py`), so a simulated run
(`sim/`) resolves result timeouts in virtual time.

Done-callbacks run on the WORKER thread that resolves the future (or
inline on the caller when added after resolution), so they must never
block — machine-checked by the nrlint `blocking-in-handler` rule.
"""

from __future__ import annotations

import logging

from node_replication_torch.analysis.locks import make_condition
from typing import Any, Callable

from node_replication_torch.utils.clock import get_clock

logger = logging.getLogger("node_replication_torch")


class ServeFuture:
    """Write-once response slot for one submitted op."""

    __slots__ = (
        "_cond", "_done", "_value", "_exc", "_callbacks",
        "rid", "deadline", "t_submit", "t_done",
    )

    def __init__(self, rid: int, deadline: float | None = None):
        self._cond = make_condition("ServeFuture._cond")
        self._done = False
        self._value: Any = None
        self._exc: BaseException | None = None
        self._callbacks: list[Callable[["ServeFuture"], None]] = []
        #: replica the request was admitted on
        self.rid = rid
        #: absolute monotonic deadline (None = no deadline)
        self.deadline = deadline
        #: monotonic admission stamp (set by the frontend at enqueue)
        self.t_submit = get_clock().now()
        #: monotonic resolution stamp (None until done)
        self.t_done: float | None = None

    # ------------------------------------------------------------ caller API

    def done(self) -> bool:
        return self._done  # GIL-atomic flag read

    def _wait_done(self, timeout: float | None) -> bool:
        clock = get_clock()
        t_end = None if timeout is None else clock.now() + timeout
        with self._cond:
            while not self._done:
                rem = None if t_end is None else t_end - clock.now()
                if rem is not None and rem <= 0:
                    return False
                clock.wait(self._cond, rem)
            return True

    def result(self, timeout: float | None = None):
        """Block until resolved and return the response (or raise the
        typed rejection). `timeout` bounds THIS wait only — it is not
        the request deadline, which the frontend enforces queue-side."""
        if not self._wait_done(timeout):
            raise TimeoutError(
                f"response still pending after {timeout}s "
                f"(request deadline is enforced by the frontend)"
            )
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: float | None = None) -> BaseException | None:
        """Block until resolved; return the rejection (None on success)."""
        if not self._wait_done(timeout):
            raise TimeoutError(f"response still pending after {timeout}s")
        return self._exc

    @property
    def latency_s(self) -> float | None:
        """Admission-to-resolution latency (None until resolved)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def add_done_callback(
        self, fn: Callable[["ServeFuture"], None]
    ) -> None:
        """Run `fn(future)` when the future resolves — on the resolving
        worker thread, or inline right now if already resolved. Handlers
        must not block (nrlint `blocking-in-handler`); exceptions are
        logged and swallowed so one bad handler cannot kill the batch
        loop."""
        run_now = False
        with self._cond:
            if self._done:
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            self._run_callback(fn)

    # ---------------------------------------------------------- frontend API

    def _finish(self, value: Any, exc: BaseException | None) -> bool:
        """Resolve exactly once; returns False if already resolved
        (late resolutions — e.g. a drain racing a deadline sweep — are
        dropped, first writer wins)."""
        with self._cond:
            if self._done:
                return False
            self._value = value
            self._exc = exc
            self.t_done = get_clock().now()
            cbs = self._callbacks
            self._callbacks = []
            self._done = True
            self._cond.notify_all()
        for fn in cbs:
            self._run_callback(fn)
        return True

    def _resolve(self, value: Any) -> bool:
        return self._finish(value, None)

    def _reject(self, exc: BaseException) -> bool:
        return self._finish(None, exc)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            logger.exception("serve done-callback raised; ignored")
