"""Client-side retry-with-backoff + circuit breaking over the serve
frontend.

The port's copy of `node_replication_tpu/serve/client.py`, the shard
plane's retry causes and its map refresh included.

`Overloaded` is the frontend's TRANSIENT backpressure signal: the op
was shed at admission (or evicted from the queue by a higher-priority
arrival) and never touched the log, so resubmitting is always safe
(exactly-once is preserved — a shed op has no effect to duplicate).
This module layers the standard client responses on top:

- capped exponential backoff with full jitter (`RetryPolicy`,
  `call_with_retry`), giving the combiner time to drain between
  attempts instead of hammering the admission lock;
- a **circuit breaker** (`CircuitBreaker`): after enough CONSECUTIVE
  transient failures the breaker opens and every call fails fast with
  typed `CircuitOpen` — no submission, no admission-lock contention,
  no log effect — until the cool-down elapses; then exactly one
  half-open PROBE is allowed through, whose outcome closes the
  circuit (success) or re-opens it for another cool-down (failure).
  This is the client half of graceful degradation: a fleet of
  breaker-wrapped clients converts a retry storm into a trickle of
  probes, which is what lets the server-side AIMD controller
  (`serve/overload.py`) actually recover.

`ReplicaFailed` (failover mode, `fault/`) is retried ONLY when the
frontend proved the op never reached the log
(`maybe_executed=False`) — and the retry transparently RE-ROUTES to a
healthy replica (`frontend.healthy_rids()`), so a client survives its
replica dying mid-conversation without seeing anything but latency. A
`maybe_executed=True` failure propagates: the op will replay from the
log and resubmitting could duplicate it.

`DeadlineExceeded` and `FrontendClosed` are NOT retried here —
deadline'd work is stale by definition and a closed frontend is
permanent; both propagate to the caller.

The shard plane (`shard/router.py`) rides the same loop when the
"frontend" is a `ShardRouter`: `ShardUnavailable` with
`maybe_executed=False` retries with backoff (the sub-batch provably
never reached the shard's log), `maybe_executed=True` propagates
(same exactly-once reasoning as `ReplicaFailed`), and `WrongShard`
triggers the router's `refresh_map()` before the retry so a
promotion's re-published map re-homes the resubmission mid-loop.

Every retry is observable by CAUSE: the
`serve.retry.{overloaded,replica_failed,circuit_open,
shard_unavailable,wrong_shard}` counters and the `serve-retry` trace
event (cause + attempt + delay) keep overload retries
distinguishable from failover retries in `obs/report`.

Two budgets bound a call, both enforced here:

- `max_attempts` bounds total submissions (first try included);
- `total_deadline_s` bounds total elapsed time ACROSS attempts — a
  retry whose backoff would outlive the remaining budget re-raises
  the transient error instead of sleeping into a guaranteed timeout
  (so no backoff ever runs past the budget), each attempt's per-call
  `timeout` is clamped to the remainder, and a budget found already
  spent re-raises the LAST transient error rather than submitting an
  op doomed to time out. Without it, per-attempt timeouts compose
  into an unbounded worst case (`max_attempts × (timeout +
  backoff)`), which is no deadline at all from the caller's point of
  view.
"""

from __future__ import annotations

import dataclasses
import random

from node_replication_torch.analysis.locks import make_lock

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.serve.errors import (
    CircuitOpen,
    Overloaded,
    ReplicaFailed,
    ShardUnavailable,
    TxnConflict,
    WrongShard,
)
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter + a total budget.

    Attempt i (0-based) sleeps `uniform(0, min(base * 2**i, cap))` —
    the AWS "full jitter" schedule, which decorrelates a thundering
    herd of shed clients better than fixed backoff. `max_attempts`
    bounds total submissions (first try included); attempt
    `max_attempts` re-raises the final `Overloaded`. `total_deadline_s`
    (None = unbounded, the pre-budget behavior) is the wall budget for
    the WHOLE call — attempts, backoffs, and result waits together.
    """

    max_attempts: int = 8
    base_backoff_s: float = 0.001
    max_backoff_s: float = 0.100
    total_deadline_s: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.total_deadline_s is not None and self.total_deadline_s <= 0:
            raise ValueError("total_deadline_s must be > 0 (or None)")

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        cap = min(self.base_backoff_s * (2 ** attempt),
                  self.max_backoff_s)
        return rng.uniform(0.0, cap)


#: breaker states (`CircuitBreaker.state`)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Client-side circuit breaker with half-open probing.

    Share one instance across a client's calls (it is thread-safe;
    one breaker per frontend per client process is the intended
    grain). Wire it through `call_with_retry(breaker=...)`, or drive
    it manually from an open-loop submitter:

        breaker.before_call()        # raises CircuitOpen while open
        try:
            resp = frontend.call(op)
        except (Overloaded, ...):
            breaker.record_failure()
            raise
        breaker.record_success()

    Semantics: `failure_threshold` CONSECUTIVE transient failures flip
    CLOSED -> OPEN; while open, `before_call` fails fast with typed
    `CircuitOpen` (the op is never submitted — zero log effect by
    construction). After `cooldown_s` the next `before_call` admits
    exactly ONE probe (OPEN -> HALF_OPEN); its `record_success` closes
    the circuit, its `record_failure` re-opens it for another full
    cool-down. Counted in `serve.circuit.{opened,probes}` and emitted
    as `serve-circuit` transitions.
    """

    def __init__(self, failure_threshold: int = 8,
                 cooldown_s: float = 0.25):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("cooldown_s must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        # nrcheck: lock-order CircuitBreaker._lock -> Counter._lock — trip/recover counters bump under the breaker lock
        self._lock = make_lock("CircuitBreaker._lock")
        self._state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probing = False
        self._probe_deadline = 0.0  # lease: a lost probe expires
        reg = get_registry()
        self._m_opened = reg.counter("serve.circuit.opened")
        self._m_probes = reg.counter("serve.circuit.probes")
        self._m_fastfail = reg.counter("serve.circuit.fast_failed")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def before_call(self) -> None:
        """Gate one call attempt. Raises `CircuitOpen` while the
        circuit is open (or while another probe is already in flight
        during half-open)."""
        now = get_clock().now()
        with self._lock:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                if now < self._open_until:
                    self._m_fastfail.inc()
                    raise CircuitOpen(self._open_until - now,
                                      self._failures)
                self._state = HALF_OPEN
                self._probing = False
                get_tracer().emit("serve-circuit", state=HALF_OPEN)
            # HALF_OPEN: one probe at a time; concurrent callers fail
            # fast until the probe resolves the circuit either way.
            # The probe holds a LEASE (one cool-down long): a probe
            # whose caller never reported back — crashed mid-call, or
            # failed with something outside the breaker's accounting —
            # must not wedge the circuit half-open forever, so an
            # expired lease lets the next caller take the probe over.
            if self._probing and now < self._probe_deadline:
                self._m_fastfail.inc()
                raise CircuitOpen(self._probe_deadline - now,
                                  self._failures)
            self._probing = True
            self._probe_deadline = now + self.cooldown_s
            self._m_probes.inc()

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._failures = 0
            self._probing = False
        if was != CLOSED:
            get_tracer().emit("serve-circuit", state=CLOSED)

    def record_failure(self) -> None:
        """One transient failure (shed / retryable replica failure).
        Consecutive failures open the circuit; a half-open probe's
        failure re-opens it immediately."""
        now = get_clock().now()
        opened = False
        with self._lock:
            self._failures += 1
            failures = self._failures
            self._probing = False
            if (self._state == HALF_OPEN
                    or (self._state == CLOSED
                        and self._failures >= self.failure_threshold)):
                self._state = OPEN
                self._open_until = now + self.cooldown_s
                opened = True
        if opened:
            self._m_opened.inc()
            get_tracer().emit("serve-circuit", state=OPEN,
                              failures=failures,
                              cooldown_s=self.cooldown_s)

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "open_for_s": max(
                    0.0, self._open_until - get_clock().now()
                ) if self._state == OPEN else 0.0,
            }


_RETRY_CAUSES = {
    Overloaded: "overloaded",
    ReplicaFailed: "replica_failed",
    CircuitOpen: "circuit_open",
    # the shard plane (`shard/router.py`): both are rejections with
    # zero log effect (WrongShard by construction; ShardUnavailable
    # when maybe_executed=False), so the retry is exactly-once safe
    ShardUnavailable: "shard_unavailable",
    WrongShard: "wrong_shard",
    # the txn plane (`shard/txn.py`): a key locked by a prepared-but-
    # undecided transaction; zero log effect, and the lock clears the
    # moment the decision arrives — Overloaded-shaped backoff applies.
    # TxnAborted/TxnInDoubt are deliberately ABSENT: they are whole-
    # transaction outcomes the coordinator's caller routes on, never
    # per-op transients.
    TxnConflict: "txn_conflict",
}


def _note_retry(e: Exception, attempt: int, rid: int,
                delay: float) -> None:
    """Per-cause retry accounting: `serve.retry.<cause>` counter +
    `serve-retry` event, so overload retries stay distinguishable
    from failover retries in `obs/report`."""
    cause = _RETRY_CAUSES[type(e)]
    get_registry().counter(f"serve.retry.{cause}").inc()
    tracer = get_tracer()
    if tracer.enabled:
        tracer.emit("serve-retry", cause=cause, attempt=attempt,
                    rid=rid, delay_s=delay)


def call_with_retry(
    frontend,
    op: tuple,
    rid: int = 0,
    policy: RetryPolicy | None = None,
    deadline_s: float | None = None,
    timeout: float | None = None,
    rng: random.Random | None = None,
    on_shed=None,
    priority: int | None = None,
    breaker: CircuitBreaker | None = None,
):
    """Closed-loop `frontend.call` that retries `Overloaded` (with
    backoff), retryable `ReplicaFailed` (with backoff AND a re-route
    to a healthy replica), and — when a `breaker` is wired —
    `CircuitOpen` (with backoff riding out the cool-down), inside the
    policy's attempt and total-deadline budgets. `on_shed(attempt,
    delay_s)` (optional) observes each `Overloaded` rejection — the
    bench uses it to count retries without threading state through.
    `priority` forwards to `frontend.submit` when given (the overload
    plane's priority classes). Returns the op's response; re-raises
    the last transient error when either budget is exhausted."""
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    clock = get_clock()
    t_end = (
        None if policy.total_deadline_s is None
        else clock.now() + policy.total_deadline_s
    )
    kwargs = {} if priority is None else {"priority": priority}
    last_transient: Exception | None = None
    for attempt in range(policy.max_attempts):
        eff_timeout = timeout
        if t_end is not None:
            rem = t_end - clock.now()
            if rem <= 0 and last_transient is not None:
                # the budget was spent while backing off (scheduler
                # jitter can oversleep): submitting now would only
                # reach a guaranteed TimeoutError — and the op might
                # still execute, which a resubmitting caller could
                # duplicate. Surface the known transient state.
                raise last_transient
            # per-attempt result wait never outlives the total budget
            eff_timeout = rem if timeout is None else min(timeout, rem)
        try:
            if breaker is not None:
                breaker.before_call()
            try:
                resp = frontend.call(op, rid=rid, deadline_s=deadline_s,
                                     timeout=eff_timeout, **kwargs)
            except BaseException:
                # EVERY non-success outcome counts as a failure —
                # DeadlineExceeded and TimeoutError are overload
                # symptoms too, and a half-open probe must never end
                # without reporting back (a silent exit would strand
                # the circuit until the probe lease expires)
                if breaker is not None:
                    breaker.record_failure()
                raise
            if breaker is not None:
                breaker.record_success()
            return resp
        except (Overloaded, ReplicaFailed, CircuitOpen,
                ShardUnavailable, WrongShard, TxnConflict) as e:
            if isinstance(e, (ReplicaFailed, ShardUnavailable)) \
                    and e.maybe_executed:
                # the op may already be in the log (it WILL replay;
                # only its response was lost) — resubmitting could
                # duplicate it, so exactly-once forbids auto-retry
                raise
            last_transient = e
            exhausted = attempt + 1 >= policy.max_attempts
            delay = (
                0.0 if exhausted else policy.backoff_s(attempt, rng)
            )
            if isinstance(e, CircuitOpen) and not exhausted:
                # backing off less than the remaining cool-down would
                # only buy another fast-fail; wait it out (jittered
                # past the boundary so probes do not synchronize)
                delay = max(delay, e.retry_after_s)
            if t_end is not None and not exhausted:
                budget = t_end - clock.now()
                if budget <= delay:
                    # the total deadline budget is spent (or the drawn
                    # backoff would outlive it): retrying could not
                    # complete in time, so the budget exhausts the
                    # policy exactly like the attempt cap does —
                    # re-raise now instead of sleeping into a
                    # guaranteed timeout
                    exhausted = True
                    delay = 0.0
            if isinstance(e, Overloaded) and on_shed is not None:
                # the final, exhausted rejection is observed too —
                # shed accounting must see every attempt
                on_shed(attempt, delay)
            if exhausted:
                raise
            _note_retry(e, attempt, rid, delay)
            if isinstance(e, ReplicaFailed):
                # transparent failover: re-route the resubmission to a
                # healthy replica when the frontend can name one
                healthy = getattr(frontend, "healthy_rids", None)
                if healthy is not None:
                    alt = [r for r in healthy() if r != e.rid]
                    if alt:
                        rid = alt[attempt % len(alt)]
            if isinstance(e, (WrongShard, ShardUnavailable)):
                # shard-plane re-route: a promotion re-published the
                # ShardMap with a bumped version; adopting it re-homes
                # the resubmission (keys are PINNED to shards by the
                # congruence map, so re-routing means a new map, never
                # a different shard)
                refresh = getattr(frontend, "refresh_map", None)
                if refresh is not None:
                    refresh()
            if delay > 0:
                clock.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
