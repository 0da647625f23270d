"""Typed serve-layer errors.

The port's copy of `node_replication_tpu/serve/errors.py`, without
`NotPrimary` and the shard plane's errors (they come with the ports
of `repl/` and `shard/`).

The serving frontend (`serve/frontend.py`) communicates every
production edge as a TYPED exception so callers can route on it
(retry, shed, fail fast) instead of string-matching. The hierarchy is
flat under `ServeError`:

- `Overloaded` — admission control rejected the request because the
  replica's bounded submission queue is full (load shedding, the
  backpressure signal). Transient by design: `serve/client.py` retries
  it with backoff.
- `DeadlineExceeded` — the request's deadline passed before its batch
  executed; the op was dropped WITHOUT touching the log (a queued
  request is cancellable right up to batch assembly).
- `FrontendClosed` — submitted after `close()`, or still queued when a
  non-draining close tore the queue down. Permanent: retrying cannot
  help.
- `ReplicaFailed` — the replica serving this request died (worker
  exception, injected fault, quarantine fence). Retryable when the op
  provably never reached the log (`maybe_executed=False`):
  `serve/client.py:call_with_retry` then transparently re-routes the
  op to a healthy replica. When the failure struck after the append
  (`maybe_executed=True`) the op WILL replay and only its response was
  lost — resubmitting could duplicate it, so the client must decide
  (the log is the source of truth; a read can disambiguate).
- `StaleRead` — a bounded-staleness read (`read(min_pos=...)`) found
  the serving replica's applied position still behind the requested
  bound after the allowed wait. The read had no effect; retry later or
  loosen the bound.
- `CircuitOpen` — the CLIENT-side circuit breaker
  (`serve/client.py:CircuitBreaker`) refused the call before it
  reached the frontend: enough consecutive transient failures opened
  the circuit and the cool-down has not elapsed. The op was never
  submitted (zero log effect by construction); retry after
  `retry_after_s`, when the breaker's half-open probe window opens.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for every serve-frontend error."""


class Overloaded(ServeError):
    """Admission queue full: the request was shed at the door.

    Carries the replica id and the admission limit observed at
    rejection so callers (and the bench's shed-rate accounting) can
    report where the pressure is. With the overload plane on
    (`ServeConfig.overload`), `depth` is the ADAPTIVE limit of the
    moment (<= the static queue depth), `priority` names the shed
    op's class, and `evicted=True` marks an op that WAS admitted but
    was evicted from the queue by a higher-priority arrival — in
    every case the op never reached the log, so retrying is always
    safe.
    """

    def __init__(self, rid: int, depth: int,
                 priority: int | None = None, evicted: bool = False):
        how = "evicted by a higher-priority arrival" if evicted \
            else "request shed"
        prio = "" if priority is None else f" (priority {priority})"
        super().__init__(
            f"replica {rid} admission queue full ({depth} "
            f"admitted){prio}; {how}"
        )
        self.rid = rid
        self.depth = depth
        self.priority = priority
        self.evicted = evicted


class DeadlineExceeded(ServeError):
    """The request's deadline passed while it waited in the queue.

    The op was dropped during batch assembly and never appended to the
    log, so it has no effect — a late caller observes a clean timeout,
    not a maybe-executed write.
    """

    def __init__(self, rid: int, late_by_s: float):
        super().__init__(
            f"request deadline exceeded on replica {rid} "
            f"({late_by_s * 1e3:.2f}ms late); op dropped before append"
        )
        self.rid = rid
        self.late_by_s = late_by_s


class FrontendClosed(ServeError):
    """The frontend is closed (or closed non-draining with this request
    still queued); no further requests are accepted."""

    def __init__(self, detail: str = "frontend closed"):
        super().__init__(detail)


class ReplicaFailed(ServeError):
    """The serving replica died under this request (`fault/`).

    `maybe_executed=False` (the in-flight-batch and queued-request
    failover paths, which fire BEFORE the batch touches the log)
    guarantees the op had no effect — resubmitting is exactly-once
    safe, and `call_with_retry` does so automatically, re-routed to a
    healthy replica. `maybe_executed=True` means the failure struck
    after the append: the op will replay (the log survives the
    replica), only its response was lost — automatic retry is refused
    because it could duplicate the op.
    """

    def __init__(self, rid: int, cause: BaseException | None = None,
                 maybe_executed: bool = False):
        detail = f" ({type(cause).__name__}: {cause})" if cause else ""
        effect = (
            "op may have reached the log; response lost"
            if maybe_executed else "op never reached the log"
        )
        super().__init__(
            f"replica {rid} failed{detail}; {effect}"
        )
        self.rid = rid
        self.cause = cause
        self.maybe_executed = maybe_executed

    @property
    def retryable(self) -> bool:
        return not self.maybe_executed


class StaleRead(ServeError):
    """A bounded-staleness read could not be served within its bound.

    The serving replica's applied position (`applied_pos`) still
    trails the requested minimum (`min_pos`) after the caller's
    allowed wait. The read dispatched nothing; the client can retry
    or loosen the bound.
    """

    def __init__(self, rid: int, applied_pos: int, min_pos: int):
        super().__init__(
            f"replica {rid} applied position {applied_pos} trails the "
            f"requested staleness bound {min_pos}"
        )
        self.rid = rid
        self.applied_pos = applied_pos
        self.min_pos = min_pos


class CircuitOpen(ServeError):
    """The client-side circuit breaker is open: the call was refused
    BEFORE submission (`serve/client.py:CircuitBreaker`).

    Enough consecutive transient failures (`Overloaded`, retryable
    `ReplicaFailed`) tripped the breaker; until the cool-down elapses
    every call fails fast here instead of adding load to a frontend
    that is already shedding. The op was never submitted — zero log
    effect by construction — so retrying after `retry_after_s` is
    always safe (`call_with_retry` does so, with backoff, and the
    breaker lets a single half-open probe through first).
    """

    def __init__(self, retry_after_s: float, failures: int):
        super().__init__(
            f"circuit open after {failures} consecutive transient "
            f"failures; retry in {retry_after_s * 1e3:.0f}ms"
        )
        self.retry_after_s = retry_after_s
        self.failures = failures
