"""Typed serve-layer errors.

The port's copy of `node_replication_tpu/serve/errors.py`, the shard
plane's five errors included.

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
- `NotPrimary` — a write reached a read-only (follower-mode) frontend
  (`repl/follower.py`); the op was never admitted, so retrying against
  the primary is always safe.
- `WrongShard` — the fleet-sharding plane (`shard/`): an op whose key
  routes to a different shard under the current `ShardMap`, or a
  submit carrying a stale map version. The op was rejected before any
  log effect; refresh the map and re-route
  (`serve/client.py:call_with_retry` does so when the frontend
  exposes `refresh_map()`).
- `ShardUnavailable` — the op's shard cannot serve right now (its
  primary died, its backend connection dropped, or its promotion is
  in flight). Transient by design when `maybe_executed=False`;
  `call_with_retry` backs off and retries, and the router re-routes
  once the shard's `PromotionManager` re-homes it.
- `TxnConflict` — an op touched a key locked by a prepared-but-
  undecided cross-shard transaction (`shard/txn.py`). Zero log
  effect; retryable by design (`call_with_retry` backs off — the
  lock clears as soon as the transaction resolves).
- `TxnAborted` — a cross-shard transaction aborted during prepare.
  Presumed-abort 2PC guarantees ZERO log effect on every
  participant, so retrying the WHOLE transaction is exactly-once
  safe (the coordinator's caller decides; per-op retry machinery
  never sees this).
- `TxnInDoubt` — the coordinator lost a participant AFTER the
  durable decision was published (or could not finish phase 2). The
  transaction's outcome is decided and will be enforced by
  recovery — but this caller cannot prove it applied yet. Never
  auto-retried; resolve by decision lookup
  (`TxnCoordinator.recover` / participant `resolve_in_doubt`) or a
  read.
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


class NotPrimary(ServeError):
    """A write reached a read-only (follower-mode) frontend.

    Followers serve bounded-staleness reads only; every write belongs
    on the primary. A promotion (`ServeFrontend.enable_writes`, driven
    by `repl/promote.py`) flips the frontend into write serving —
    until then the op was never admitted and retrying AGAINST THE
    PRIMARY is always safe.
    """

    def __init__(self, rid: int):
        super().__init__(
            f"replica {rid} is serving read-only (follower mode); "
            f"route writes to the primary or promote this follower"
        )
        self.rid = rid


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


class WrongShard(ServeError):
    """The op's key does not belong to the shard it reached — or the
    caller's `ShardMap` version disagrees with the shard's.

    The fleet-level congruence contract (`shard/ring.py:ShardMap`,
    lifted from `models/partitioned.py`): shard `s` of `N` owns every
    key `k` with `k % N == s`, and routers and shards must agree on
    the SAME map version before any ack. A key mismatch means a
    caller bypassed the router; a version mismatch means a stale map
    on one side (a re-published map after a promotion the other side
    has not loaded yet). Either way the op was rejected BEFORE any
    log effect — refresh the map (`durable_publish`'d, so a reload
    always observes a complete file) and re-route; `call_with_retry`
    does both when the frontend exposes `refresh_map()`.
    """

    def __init__(self, key: int, shard: int, expected_shard: int,
                 map_version: int, peer_version: int | None = None):
        if peer_version is not None and peer_version != map_version:
            why = (f"map version {peer_version} does not match the "
                   f"shard's version {map_version}")
        else:
            why = (f"key {key} routes to shard {expected_shard} "
                   f"under map v{map_version}")
        super().__init__(
            f"shard {shard}: {why}; op rejected before any log effect"
        )
        self.key = key
        self.shard = shard
        self.expected_shard = expected_shard
        self.map_version = map_version
        self.peer_version = peer_version


class ShardUnavailable(ServeError):
    """The op's shard cannot serve it right now (`shard/router.py`).

    Raised when a shard's backend is down — its primary process died,
    the connection dropped mid-exchange, or a promotion is re-homing
    its writes. `maybe_executed` has `ReplicaFailed` semantics: False
    means the sub-batch provably never reached the shard's log, so a
    resubmit is exactly-once safe (`call_with_retry` retries it with
    backoff, re-routed once the router repoints the shard); True means
    the connection died AFTER the ops were sent — they may commit and
    replay, so only the caller can decide (a read disambiguates).

    Cross-shard batches are NOT atomic (the CNR contract): when a
    multi-shard batch raises this, sub-batches on OTHER shards may
    have committed and acked independently.
    """

    def __init__(self, shard: int, cause: BaseException | None = None,
                 maybe_executed: bool = False):
        detail = f" ({type(cause).__name__}: {cause})" if cause else ""
        effect = (
            "sub-batch may have reached the shard's log; response lost"
            if maybe_executed
            else "sub-batch never reached the shard's log"
        )
        super().__init__(f"shard {shard} unavailable{detail}; {effect}")
        self.shard = shard
        self.cause = cause
        self.maybe_executed = maybe_executed

    @property
    def retryable(self) -> bool:
        return not self.maybe_executed


class TxnConflict(ServeError):
    """The op's key is locked by a prepared-but-undecided cross-shard
    transaction (`shard/txn.py:TxnParticipant`).

    A prepared intent blocks CONFLICTING KEYS, not the shard: every
    other key serves normally, and this op was rejected before any
    log effect. Retrying with backoff is always safe — the lock
    clears the moment the transaction's decision arrives (or, for a
    dead coordinator generation, when presumed abort releases it);
    `call_with_retry` classifies this exactly like `Overloaded`.
    """

    def __init__(self, key: int, txn: str):
        super().__init__(
            f"key {key} is locked by prepared transaction {txn}; "
            f"op rejected before any log effect"
        )
        self.key = key
        self.txn = txn
        self.maybe_executed = False  # rejected at the door, always

    @property
    def retryable(self) -> bool:
        return True


class TxnAborted(ServeError):
    """The cross-shard transaction aborted during prepare
    (`shard/txn.py:TxnCoordinator`).

    Presumed-abort 2PC's clean failure: some participant voted no
    (conflict, wrong shard, unavailable) before any decision was
    published, every prepared intent was (or will be, by presumed
    abort) dropped, and NO participant applied anything — the whole
    transaction had zero log effect, so resubmitting the whole
    transaction is exactly-once safe. The caller retries; the per-op
    retry machinery never sees this error.
    """

    def __init__(self, txn: str, cause: BaseException | None = None):
        detail = f" ({type(cause).__name__}: {cause})" if cause else ""
        super().__init__(
            f"transaction {txn} aborted during prepare{detail}; "
            f"zero log effect on every participant"
        )
        self.txn = txn
        self.cause = cause


class TxnInDoubt(ServeError):
    """The transaction's durable decision exists but this caller
    could not confirm phase 2 completed on every participant.

    The `maybe_executed=True` of the transaction layer: the decision
    record (`durable/txnlog.py:DecisionLog`) is the truth and
    recovery WILL enforce it — participants re-resolve by decision
    lookup, the restarted coordinator re-drives commits — but right
    now some sub-batch may or may not have applied. Never
    auto-retried (a blind resubmit could double-apply); the caller
    resolves via `TxnCoordinator.recover()`, participant
    `resolve_in_doubt()`, or a read of the affected keys.
    """

    def __init__(self, txn: str, decision: str | None = None,
                 cause: BaseException | None = None):
        detail = f" ({type(cause).__name__}: {cause})" if cause else ""
        dec = f"decision={decision!r}" if decision else "undecided"
        super().__init__(
            f"transaction {txn} in doubt ({dec}){detail}; recovery "
            f"will enforce the durable decision — do not blindly retry"
        )
        self.txn = txn
        self.decision = decision
        self.cause = cause
