"""Concurrent batching frontend over a replicated-log wrapper.

The port of `node_replication_tpu/serve/frontend.py`; everything
behaves as in the reference. `ServeConfig(obs_port=...)` builds the
node's `obs/export.py:MetricsExporter` (role `follower` when read-only,
`primary` otherwise) and `ServeConfig(profile_hz=...)` a started
`obs/profile.py:SamplingProfiler`; `threads()` maps the live threads to
the profiler's roles. The replication plane's hooks are here as in the
reference: follower mode
(`read_only=True`, writes raise `NotPrimary` until `enable_writes()`),
the `ack_barrier` a `repl/shipper.py:ReplicationShipper` installs for
ship-before-ack, and `add_backpressure_source`. Over a meshed fleet
`device_of_rid` maps each served replica to its shard's device
(`replica_device`), and `stats()["mesh"]` counts the replicas per
device. On a
hashmap fleet with the fused tier each combiner round is one kernel
launch (K1, `csrc/hashmap_replay.cu`), issued on the worker thread's
current CUDA stream; a future resolves only after `finish_mut_batch`
has read the round's responses back to the host. Over a
`MultiLogReplicated` a batch splits into one combiner pass per mapped
log, each one K1 launch on a hashmap fleet.

Turns `NodeReplicated` into a servable system: many OS-thread clients
submit ops; each replica has a BOUNDED
submission queue and one dedicated worker — the statically-elected
combiner for that replica (the reference elects a combiner per
contention window with a CAS, `nr/src/replica.rs:508-540`; here
election is the queue→worker ownership, decided once) — that drains
the queue into an adaptive batch and executes it as a single
flat-combining round via `execute_mut_batch` (one append + one replay
pass under the wrapper's reentrant combiner lock, `core/replica.py`).

Production edges, each with a typed signal (`serve/errors.py`):

- **admission control** — the per-replica queue is bounded
  (`ServeConfig.queue_depth`); a full queue sheds the request with
  `Overloaded` BEFORE it costs anything. Memory held per replica is
  therefore `O(queue_depth + batch_max_ops)`, never load-proportional.
- **deadlines** — a request may carry an absolute deadline; batch
  assembly drops expired requests with `DeadlineExceeded` *before*
  appending, so a timed-out op is guaranteed to have had no effect.
- **backpressure** — clients see `Overloaded` the moment service lags
  admission; `serve/client.py` layers retry-with-backoff (and a
  circuit breaker) on top for closed-loop callers.
- **overload plane** (`ServeConfig.overload`, `serve/overload.py`) —
  the static bound becomes an ADAPTIVE limit: an AIMD controller per
  replica keyed to measured queue delay, strict-priority shedding
  (`submit(priority=)`: BULK evicts first, CRITICAL last, with the
  inversion counter proving it), brownout reads (degrade to the
  bounded-staleness `execute_stale` path instead of shedding), and
  a downstream-lag watermark (the WAL's fsync lag) that throttles
  admission before any backlog grows unbounded.
- **graceful drain** — `close()` stops admission, flushes every queued
  op through the combiner, resolves all futures, and joins the
  workers; `close(drain=False)` rejects the backlog instead.
- **failover** (`ServeConfig.failover=True`, the `fault/` lifecycle
  integration) — a worker whose batch round throws retires its replica
  instead of limping: in-flight requests are completed exceptionally
  with typed `ReplicaFailed` (retryable when the batch provably never
  reached the log, so `call_with_retry` transparently re-routes),
  queued requests are re-homed onto a healthy replica's queue, and the
  `on_replica_failed` callback hands the corpse to the lifecycle
  manager (`fault/repair.py`) for quarantine + repair-by-replay;
  `restart_replica` readmits the repaired replica with a fresh queue
  and worker. Off (default), a failed batch rejects its own futures
  and the worker keeps serving — the pre-fault behavior.
- **durable acks** (`ServeConfig(durability="batch"|"always")`, the
  `durable/` integration) — a batch's futures resolve only after its
  WAL records are fsynced (one fsync per batch in `"batch"` mode —
  group commit riding the existing batching; per-append in
  `"always"`), so a response a client has seen survives kill -9.
  `ServeFrontend.from_recovery(dir, dispatch, ...)` reopens
  mid-traffic state after a crash: newest valid snapshot + WAL-tail
  replay, bit-identical, WAL re-attached, serving resumed.

Reads bypass the write queue entirely: `read()` dispatches against the
caller's replica through the wrapper's read-sync path (`execute`),
which waits only for this replica to pass the completed tail — read
latency stays off the write batch, per the reference's read-only path
(`nr/src/replica.rs:404-410`).

Wire protocol with the wrapper is just the two batch entry points
(`execute_mut_batch`, `execute`), so the frontend survives
`grow_fleet` — `grow()` adds replicas AND spins up
their queues/workers while traffic is in flight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading

from node_replication_torch.analysis.locks import (
    make_condition,
    make_lock,
)
from collections import deque
from typing import Callable, Sequence

from node_replication_torch.core.replica import ReplicaFencedError
from node_replication_torch.fault.inject import FaultError, fault_hook
from node_replication_torch.obs.metrics import COUNT_BUCKETS, get_registry
from node_replication_torch.serve.errors import (
    DeadlineExceeded,
    FrontendClosed,
    NotPrimary,
    Overloaded,
    ReplicaFailed,
    StaleRead,
)
from node_replication_torch.serve.future import ServeFuture
from node_replication_torch.serve.overload import (
    CRITICAL,
    NORMAL,
    PRIORITIES,
    PRIORITY_NAMES,
    LagSource,
    OverloadConfig,
    OverloadGovernor,
)
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

logger = logging.getLogger("node_replication_torch")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frontend tuning knobs (all per replica).

    - `queue_depth` — admission bound; the (queue_depth+1)-th pending
      request is shed with `Overloaded`.
    - `batch_max_ops` — size trigger: a batch executes as soon as this
      many ops are staged.
    - `batch_linger_s` — deadline trigger: once the first op of a batch
      arrives, the worker waits at most this long for the batch to
      fill (0 = drain whatever is queued immediately). The linger is
      adaptive: it is skipped entirely whenever the queue already holds
      a full batch, so a saturated queue never pays added latency.
    - `default_deadline_s` — relative deadline applied to every request
      that does not pass its own (None = no deadline).
    - `drain_timeout_s` — how long `close(drain=True)` waits for the
      workers to flush before giving up and rejecting the remainder.
    - `failover` — retire a replica whose batch round throws (typed
      `ReplicaFailed` to in-flight callers, queued requests re-homed,
      `on_replica_failed` lifecycle callback) instead of rejecting the
      batch and limping on. See the module docstring and `fault/`.
    - `overload` — the adaptive overload plane (`serve/overload.py`):
      an `OverloadConfig` turns on the per-replica AIMD admission
      controller (limit adapts to measured queue delay each combiner
      round), brownout reads (past the watermark, reads degrade to the
      bounded-staleness `execute_stale` path instead of shedding), and
      downstream-lag backpressure (the WAL's fsync lag registers
      when a WAL is attached). None (default) keeps the static `queue_depth` bound only. Priority
      classes on `submit()` and strict-priority shedding (BULK evicts
      first, CRITICAL last) are active either way — without a
      governor they order shedding at the static bound.
    - `wal_lag_low` / `wal_lag_high` — watermarks (log positions) for
      the auto-registered WAL fsync-lag backpressure source (only
      read when `overload` is set and a WAL is attached).
    - `pipeline_depth` — serve-pipeline overlap depth (default 0 =
      today's fully serial worker, the safety switch). At depth 1 the
      per-replica worker splits into an ASSEMBLY stage (drain queue,
      sweep deadlines, build the batch, `begin_mut_batch`) and a
      COMPLETION stage (`finish_mut_batch`, durable-ack barrier,
      resolve futures), with at most ONE round in flight per replica:
      round N+1's host work overlaps round N's device work. Capped at
      1 — a second in-flight round would interleave response delivery
      across rounds (breaking future ordering), make post-append
      failure attribution (`maybe_executed`) ambiguous, and split the
      WAL group-commit unit; depth 1 already hides the host work, so
      deeper pipelines buy latency risk for nothing.
    - `durability` — the durable-ack contract against the wrapper's
      attached write-ahead log (`durable/wal.py`). `"none"` (default):
      acks are in-memory only (the pre-durability semantics, WAL or
      not). `"batch"`: after each combiner round the worker fsyncs the
      WAL ONCE and only then resolves the batch's futures — a response
      a client has seen is on disk, amortizing one fsync over the
      whole batch. `"always"`: the WAL itself fsyncs inside every
      append (policy `always`), so durability precedes even response
      delivery inside the wrapper; the worker adds nothing. Both
      durable modes REQUIRE a WAL attached at frontend construction
      (`ValueError` otherwise — a silent non-durable "durable" mode
      would be a lie to every client).
    """

    queue_depth: int = 256
    batch_max_ops: int = 64
    batch_linger_s: float = 0.002
    default_deadline_s: float | None = None
    drain_timeout_s: float = 30.0
    failover: bool = False
    pipeline_depth: int = 0
    durability: str = "none"
    overload: OverloadConfig | None = None
    wal_lag_low: int = 1024
    wal_lag_high: int = 8192
    #: fleet observability (`obs/export.py`): a port (0 = ephemeral)
    #: starts a `MetricsExporter` serving this process's registry
    #: snapshot + trace tail + frontend stats on a side socket
    #: (`frontend.exporter.address`); None (default) starts NOTHING —
    #: zero added work on any path, not even a branch
    obs_port: int | None = None
    #: exporter identity label (defaults to $NR_TPU_NODE_ID or
    #: `<role>-<pid>`); only read when `obs_port` is set
    obs_node_id: str | None = None
    #: host-path sampling profiler (`obs/profile.py`): a rate in Hz
    #: starts a `SamplingProfiler` with the frontend (per-role folded
    #: stacks, duty-cycle gauge, host-budget input; attached to the
    #: exporter's `profile-fetch` when `obs_port` is also set); None
    #: (default) builds NOTHING — the object does not exist, zero
    #: hot-path branches
    profile_hz: float | None = None

    def __post_init__(self):
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.batch_max_ops < 1:
            raise ValueError("batch_max_ops must be >= 1")
        if self.batch_linger_s < 0:
            raise ValueError("batch_linger_s must be >= 0")
        if self.pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 (serial) or 1 (one round "
                f"in flight); got {self.pipeline_depth} — deeper "
                f"pipelines would interleave response delivery across "
                f"rounds and break maybe_executed attribution"
            )
        if self.durability not in ("none", "batch", "always"):
            raise ValueError(
                f"unknown durability {self.durability!r} "
                f"(none | batch | always)"
            )
        if not 0 <= self.wal_lag_low < self.wal_lag_high:
            raise ValueError(
                "wal lag watermarks need 0 <= low < high"
            )
        if self.profile_hz is not None and not self.profile_hz > 0:
            raise ValueError(
                f"profile_hz must be > 0 (or None to not build a "
                f"profiler at all); got {self.profile_hz}"
            )
        if (self.overload is not None
                and self.overload.target_delay_s
                <= self.batch_linger_s):
            # the AIMD signal (oldest wait at batch assembly) includes
            # the deliberate linger at light load; a target at or
            # below it would read an idle frontend as congested and
            # pin admission at the floor
            raise ValueError(
                f"overload.target_delay_s "
                f"({self.overload.target_delay_s}) must exceed "
                f"batch_linger_s ({self.batch_linger_s}): the "
                f"queue-delay signal includes the linger"
            )


@dataclasses.dataclass
class _Request:
    op: tuple
    future: ServeFuture
    priority: int = NORMAL


class _ReplicaDown(Exception):
    """Internal worker-loop signal: this batch round killed the
    replica (failover mode); the loop retires it and exits.

    Carries the batch's unresolved requests so the LOOP can reject
    them AFTER `_fail_replica` has marked the replica failed and
    spawned the lifecycle callback — a client that wakes on its
    `ReplicaFailed` must observe the failover already in motion
    (`wait_idle` on the manager, `healthy_rids` on the frontend),
    never a pre-failover limbo."""

    def __init__(self, cause: BaseException, pending: list[_Request],
                 maybe_executed: bool):
        super().__init__(str(cause))
        self.cause = cause
        self.pending = pending
        self.maybe_executed = maybe_executed


class _OfferResult:
    """Outcome of one admission attempt (`_SubmissionQueue.offer`).

    `expired` and `evicted` carry requests the queue REMOVED under its
    lock; the frontend rejects their futures after releasing it (a
    future's done-callbacks run user code — never under the queue
    lock). `inversion` marks the invariant breach the priority plane
    exists to prevent: a CRITICAL shed while a lower-priority op sat
    queued (structurally impossible via eviction; measured anyway)."""

    __slots__ = ("admitted", "expired", "evicted", "inversion")

    def __init__(self, admitted, expired, evicted, inversion=False):
        self.admitted = admitted
        self.expired = expired
        self.evicted = evicted
        self.inversion = inversion


class _Staged:
    """One assembled-and-begun round in the assembly→completion
    handoff (`ServeConfig.pipeline_depth > 0`): the wrapper's pending
    round handle plus everything the completion stage needs to
    deliver it (live requests, sweep accounting, the assembly-time
    queue-delay already fed to the governor)."""

    __slots__ = ("pending", "live", "missed", "taken", "t0", "delay")

    def __init__(self, pending, live, missed, taken, t0, delay):
        self.pending = pending
        self.live = live
        self.missed = missed
        self.taken = taken
        self.t0 = t0
        self.delay = delay


class _PipelineChannel:
    """Capacity-1 handoff between one replica's assembly and
    completion stages, plus the one-round-in-flight barrier.

    A round is *busy* from `put` (assembly has begun it) until the
    completion stage's `device_done` — which fires right after
    `finish_mut_batch` returns, BEFORE the durable-ack barrier and
    future resolution. That early signal is where the pipeline's
    overlap lives: the assembly stage's `wait_clear` wakes while
    round N's completion host work (fsync, callbacks,
    accounting) is still running, drains the queue that filled during
    round N, and begins round N+1 — whose device work (append, or the
    whole fused kernel) then runs under round N's remaining host work
    and round N+1's own assembly. The wrapper-level invariant holds
    throughout: `begin(N+1)` happens only after `finish(N)` returned,
    so at most one split round is ever open per replica.

    On a completion-stage death (`round_done(exc)`), the channel is
    poisoned: `wait_clear` returns the killer, and a `put` racing the
    death is refused (returning the killer) so the assembly stage can
    tear its already-begun round down honestly instead of stranding
    it in a slot nobody will drain. All waits route through the
    injectable clock (`utils/clock.py`) so simulated runs stay
    deterministic."""

    __slots__ = ("_lock", "_slot", "_busy", "_closed", "_dead")

    def __init__(self):
        self._lock = make_condition("_PipelineChannel._lock")
        self._slot: _Staged | None = None
        self._busy = False
        self._closed = False
        self._dead: BaseException | None = None

    def wait_clear(self) -> BaseException | None:
        """Block until the in-flight round's device half is done (or
        the channel is poisoned); returns the completion stage's
        killing exception (None when clear and alive)."""
        clock = get_clock()
        with self._lock:
            while self._busy and self._dead is None:
                clock.wait(self._lock)
            return self._dead

    def put(self, staged: _Staged) -> BaseException | None:
        """Hand one begun round to the completion stage. Returns None
        on success, or the channel-poisoning exception when the
        completion stage died between the caller's `wait_clear` and
        now — the round is already begun (post-append), so the caller
        must tear it down, not retry it."""
        with self._lock:
            if self._dead is not None:
                return self._dead
            self._slot = staged
            self._busy = True
            self._lock.notify_all()
            return None

    def take(self) -> _Staged | None:
        """Completion stage: next round, or None once closed and
        drained (the stage's exit signal)."""
        clock = get_clock()
        with self._lock:
            while self._slot is None and not self._closed:
                clock.wait(self._lock)
            staged = self._slot
            self._slot = None
            return staged

    def device_done(self) -> None:
        """Completion stage: `finish_mut_batch` returned — the round's
        device work is complete and the wrapper slot is free, so the
        assembly stage may begin the next round while delivery
        continues."""
        with self._lock:
            self._busy = False
            self._lock.notify_all()

    def round_done(self, exc: BaseException | None = None) -> None:
        """Completion stage: the round died (with `exc`: poison the
        channel so the assembly stage stops) or ended without reaching
        `device_done`. Called AFTER `_fail_replica` on the failure
        path, so a woken assembly stage observes the failover already
        in motion."""
        with self._lock:
            self._busy = False
            if exc is not None:
                self._dead = exc
            self._lock.notify_all()

    def drain_slot(self) -> _Staged | None:
        """Pop a staged round nobody will serve (completion-death
        teardown): the assembly stage may have begun and handed off
        round N+1 while round N was mid-delivery."""
        with self._lock:
            staged = self._slot
            self._slot = None
            return staged

    def close(self) -> None:
        """Assembly stage exit: no more rounds will be put; the
        completion stage drains the in-flight one and exits."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()


class _SubmissionQueue:
    """Bounded, priority-aware MPSC admission queue for one replica.

    Many client threads `offer`; one worker `take_batch`es. All state
    lives under one condition (`_lock`): depth check + enqueue is a
    single critical section, so admission control cannot over-admit
    under contention. Counters (accepted / shed / completed / missed)
    live here too so `stats()` needs no frontend-level lock.

    Priority discipline: one FIFO deque per class (CRITICAL / NORMAL /
    BULK). Batches drain strictly by class; at a full queue an
    arriving request EVICTS the newest queued request of a strictly
    lower class rather than shedding itself, so BULK always sheds
    first and a CRITICAL op sheds only into a queue of CRITICALs.
    Deadline-expired requests are swept OUT at admission time (they
    were dead weight holding admission slots — the pre-fix behavior
    kept them until batch assembly, so a queue full of corpses shed
    live traffic).
    """

    __slots__ = ("_lock", "_items", "_depth", "_closed", "_in_service",
                 "_held", "accepted", "shed", "completed",
                 "deadline_missed",
                 "evicted", "shed_by_prio", "priority_inversions",
                 "_reg", "_m_wait", "_m_linger")

    def __init__(self, depth: int):
        self._lock = make_condition("_SubmissionQueue._lock")
        # queue-wait accounting (host-budget input): how long the
        # worker sat on the condition before the first op arrived, and
        # how long it lingered for the batch to fill. One `enabled`
        # branch per take_batch when metrics are off (obs/metrics.py
        # cost rule); handles are created once, not per call.
        self._reg = get_registry()
        self._m_wait = self._reg.histogram("serve.queue.wait_s")
        self._m_linger = self._reg.histogram("serve.queue.linger_s")
        self._items: tuple[deque[_Request], ...] = tuple(
            deque() for _ in PRIORITIES
        )
        self._depth = depth
        self._closed = False
        self._in_service = 0  # ops taken by the worker, not yet finished
        self._held = 0  # open `ServeFrontend.staging` blocks
        self.accepted = 0
        self.shed = 0
        self.completed = 0
        self.deadline_missed = 0
        self.evicted = 0
        self.shed_by_prio = [0 for _ in PRIORITIES]
        self.priority_inversions = 0

    def _depth_unlocked(self) -> int:
        return sum(len(d) for d in self._items)

    def _sweep_expired_unlocked(self, now: float) -> list[_Request]:
        """Remove deadline-expired queued requests (all classes) and
        return them for rejection — the eager sweep that keeps corpses
        from occupying admission slots until batch assembly.

        Cost discipline: each class is walked ONLY while its head is
        expired — per-class FIFO arrival makes the head the oldest
        deadline whenever requests share a `deadline_s` (the common
        case), so the gate is O(1) per offer and each swept request is
        removed exactly once (amortized O(1) per admission). An
        unconditional full walk here measurably strangled the queue
        lock under flood arrivals — submitters sweeping O(depth) per
        offer starved the worker's `take_batch` on the same condition.
        A corpse hiding behind a younger head (mixed per-request
        deadlines) still drops at batch assembly, the pre-fix
        behavior."""
        expired: list[_Request] = []
        for d in self._items:
            while d:
                dl = d[0].future.deadline
                if dl is None or now <= dl:
                    break
                expired.append(d.popleft())
        if expired:
            # nrlint: disable=lock-discipline — caller (offer) holds it
            self.deadline_missed += len(expired)
        return expired

    def offer(self, req: _Request, limit: int,
              now: float) -> _OfferResult:
        """Admit, evict-to-admit, or shed, against the (possibly
        adaptive) `limit`. Expired queued requests are swept first
        whenever the queue is at its limit."""
        with self._lock:
            if self._closed:
                raise FrontendClosed()
            expired: list[_Request] = []
            if self._depth_unlocked() >= limit:
                expired = self._sweep_expired_unlocked(now)
            if self._depth_unlocked() < limit:
                self._items[req.priority].append(req)
                self.accepted += 1
                self._lock.notify()
                return _OfferResult(True, expired, None)
            # full at the adaptive limit: strict-priority shedding —
            # evict the NEWEST queued request of the LOWEST class
            # strictly below this one (BULK goes first)
            for p in range(len(PRIORITIES) - 1, req.priority, -1):
                if self._items[p]:
                    evicted = self._items[p].pop()
                    self._items[req.priority].append(req)
                    self.accepted += 1
                    self.evicted += 1
                    self.shed += 1
                    self.shed_by_prio[evicted.priority] += 1
                    self._lock.notify()
                    return _OfferResult(True, expired, evicted)
            self.shed += 1
            self.shed_by_prio[req.priority] += 1
            inversion = req.priority == CRITICAL and any(
                self._items[p]
                for p in range(CRITICAL + 1, len(PRIORITIES))
            )
            if inversion:
                self.priority_inversions += 1
            return _OfferResult(False, expired, None, inversion)

    def readmit(self, req: _Request) -> bool:
        """Enqueue a request re-homed from a FAILED replica's queue
        WITHOUT counting a second admission — the original queue
        already counted it `accepted` (and its counters fold into the
        frontend aggregates), so `offer` here would double-count.
        Bounded by the STATIC depth (re-homing is not subject to the
        adaptive limit — the op was already admitted once). False when
        closed or full (not a shed: the caller rejects with
        `ReplicaFailed`, not `Overloaded`)."""
        with self._lock:
            if self._closed or self._depth_unlocked() >= self._depth:
                return False
            self._items[req.priority].append(req)
            self._lock.notify()
            return True

    def hold(self) -> None:
        """Keep the worker from taking a partial batch (a full one, or
        a queue at its static depth, still goes) until `release`."""
        with self._lock:
            self._held += 1

    def release(self) -> None:
        with self._lock:
            self._held -= 1
            if not self._held:
                self._lock.notify_all()

    def _ready_unlocked(self, max_ops: int) -> bool:
        n = self._depth_unlocked()
        return bool(n) and (not self._held
                            or n >= min(max_ops, self._depth))

    def take_batch(
        self, max_ops: int, linger_s: float
    ) -> list[_Request] | None:
        """Block for the next batch; None = closed and fully drained.
        Waits for the first op (while a `staging` block is open: for a
        full batch, or its end), then lingers up to `linger_s` for the
        batch to fill — unless a full batch is already queued or the
        queue is closing (drain fast). Drains strictly by priority
        class (CRITICAL first), FIFO within each class."""
        clock = get_clock()
        with self._lock:
            t_wait = (
                clock.now()
                if self._reg.enabled and not self._depth_unlocked()
                and not self._closed else None
            )
            while not self._ready_unlocked(max_ops) and not self._closed:
                clock.wait(self._lock)
            if t_wait is not None:
                self._m_wait.observe(clock.now() - t_wait)
            if not self._depth_unlocked():
                return None  # closed and empty: worker exits
            if (linger_s > 0 and self._depth_unlocked() < max_ops
                    and not self._closed):
                t_end = clock.now() + linger_s
                while (self._depth_unlocked() < max_ops
                       and not self._closed):
                    rem = t_end - clock.now()
                    if rem <= 0:
                        break
                    clock.wait(self._lock, rem)
                if self._reg.enabled:
                    # t_end - linger_s is the linger start; no extra
                    # clock call was spent on the disabled path
                    self._m_linger.observe(
                        clock.now() - (t_end - linger_s)
                    )
            batch: list[_Request] = []
            for d in self._items:
                while d and len(batch) < max_ops:
                    batch.append(d.popleft())
            # additive: a pipelined frontend can have one round in
            # flight AND the next batch taken for assembly, and
            # wait_idle must see both (serial mode only ever holds one)
            self._in_service += len(batch)
            return batch

    def batch_done(self, completed: int, missed: int,
                   taken: int) -> None:
        """Retire one taken batch (`taken` = its size at `take_batch`,
        whatever later happened to its requests). Clamped: the worker
        loop's last-resort guard cannot know whether the failed round
        already retired itself."""
        with self._lock:
            self._in_service = max(0, self._in_service - taken)
            self.completed += completed
            self.deadline_missed += missed
            self._lock.notify_all()  # wake wait_idle


    def depth(self) -> int:
        with self._lock:
            return self._depth_unlocked()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no op is queued or in service (drain barrier)."""
        clock = get_clock()
        t_end = (
            None if timeout is None else clock.now() + timeout
        )
        with self._lock:
            while self._depth_unlocked() or self._in_service:
                rem = (
                    None if t_end is None else t_end - clock.now()
                )
                if rem is not None and rem <= 0:
                    return False
                clock.wait(self._lock, rem)
            return True

    def close(self, drain: bool) -> list[_Request]:
        """Stop admission. `drain=True` leaves queued ops for the
        worker to flush; `drain=False` returns them for rejection."""
        with self._lock:
            self._closed = True
            leftovers: list[_Request] = []
            if not drain:
                for d in self._items:
                    leftovers.extend(d)
                    d.clear()
            self._lock.notify_all()
            return leftovers

    def stats(self) -> dict:
        with self._lock:
            return {
                "queued": self._depth_unlocked(),
                "queued_by_priority": {
                    PRIORITY_NAMES[p]: len(self._items[p])
                    for p in PRIORITIES
                },
                "in_service": self._in_service,
                "accepted": self.accepted,
                "shed": self.shed,
                "shed_by_priority": {
                    PRIORITY_NAMES[p]: self.shed_by_prio[p]
                    for p in PRIORITIES
                },
                "evicted": self.evicted,
                "priority_inversions": self.priority_inversions,
                "completed": self.completed,
                "deadline_missed": self.deadline_missed,
            }


class ServeFrontend:
    """Request frontend over a `NodeReplicated`/`MultiLogReplicated`.

    One bounded queue + one worker (the elected combiner) per replica.
    Use as a context manager for guaranteed drain-on-exit:

        with ServeFrontend(nr) as fe:
            fut = fe.submit((HM_PUT, k, v), rid=0)
            ...
            assert fut.result() == 0

    `auto_start=False` builds the frontend paused (requests queue up,
    nothing executes) — deterministic admission/deadline tests and
    warm-up staging; call `start()` to begin service.
    """

    def __init__(
        self,
        nr,
        config: ServeConfig | None = None,
        rids: Sequence[int] | None = None,
        auto_start: bool = True,
        read_only: bool = False,
    ):
        if not hasattr(nr, "execute_mut_batch"):
            raise TypeError(
                f"{type(nr).__name__} has no execute_mut_batch; the "
                f"frontend serves NodeReplicated/MultiLogReplicated"
            )
        self._nr = nr
        self.cfg = config or ServeConfig()
        if self.cfg.pipeline_depth > 0 and not hasattr(
                nr, "begin_mut_batch"):
            raise TypeError(
                f"{type(nr).__name__} has no begin_mut_batch/"
                f"finish_mut_batch; pipelined serving needs the "
                f"split-round protocol (core/replica.py)"
            )
        # durable-ack wiring (`durable/`): both durable modes need the
        # WAL present NOW — discovering its absence at the first batch
        # would resolve futures that were promised durability
        if self.cfg.durability != "none":
            wal = getattr(nr, "wal", None)
            if wal is None:
                raise ValueError(
                    f"durability={self.cfg.durability!r} requires a "
                    f"WAL attached to the wrapper (attach_wal)"
                )
            if (self.cfg.durability == "always"
                    and wal.policy != "always"):
                raise ValueError(
                    "durability='always' needs WAL fsync policy "
                    f"'always' (WAL has {wal.policy!r}); with a "
                    "weaker policy acks would outrun fsync"
                )
        # fsync barrier per batch only in "batch" mode ("always" is
        # already durable inside the wrapper's append)
        self._durable_sync = self.cfg.durability == "batch"
        #: adaptive overload plane (`serve/overload.py`); None = the
        #: static queue_depth bound only (the pre-overload behavior)
        self.governor: OverloadGovernor | None = None
        if self.cfg.overload is not None:
            self.governor = OverloadGovernor(
                self.cfg.overload, self.cfg.queue_depth,
                deadline_s=self.cfg.default_deadline_s,
                pipeline_depth=self.cfg.pipeline_depth,
            )
            if hasattr(nr, "wal"):
                # end-to-end backpressure: the journal's unfsynced
                # backlog throttles admission before it can grow
                # unbounded. The WAL is resolved at POLL time, not construction:
                # attach_wal after the frontend is built (the normal
                # flow under durability="none") must still wire
                # this leg — a construction-time snapshot would leave
                # it silently dead. No WAL attached = lag 0.
                def _wal_fsync_lag():
                    wal = getattr(self._nr, "wal", None)
                    return 0 if wal is None else wal.fsync_lag()

                self.governor.add_source(LagSource(
                    "wal-fsync", _wal_fsync_lag,
                    self.cfg.wal_lag_low, self.cfg.wal_lag_high,
                ))
        # guards _queues/_workers/_read_tokens/_closed topology changes
        # (grow, close); the hot submit path reads the dicts lock-free
        # (GIL-atomic lookups; workers are keyed once at creation).
        # Declared nestings the analyzer cannot type (`self._nr` is a
        # duck-typed wrapper; queues live in a dict):
        # nrcheck: lock-order ServeFrontend._lock -> NodeReplicated._lock — close/grow/stats call into the wrapper under the frontend lock
        # nrcheck: lock-order ServeFrontend._lock -> MultiLogReplicated._lock — same nesting through the CNR wrapper
        # nrcheck: lock-order ServeFrontend._lock -> _SubmissionQueue._lock — queue close/drain runs under the frontend lock
        self._lock = make_lock("ServeFrontend._lock")
        self._closed = False
        self._started = False
        self._queues: dict[int, _SubmissionQueue] = {}
        self._workers: dict[int, threading.Thread] = {}
        # pipelined serving (`pipeline_depth > 0`): per-replica
        # completion-stage threads + handoff channels; empty in serial
        # mode so nothing below pays for the feature being off
        self._completers: dict[int, threading.Thread] = {}
        self._channels: dict[int, _PipelineChannel] = {}
        self._read_tokens: dict[int, object] = {}
        self._depth_gauges: dict[int, object] = {}
        # failover state: failed rid -> the exception that killed its
        # worker; counters folded from retired (replaced) queues so
        # aggregate stats survive a restart's queue swap
        self._failed: dict[int, BaseException] = {}
        self._retired: dict[str, int] = {}
        self._retired_prio: dict[str, int] = {}
        self._rehomed = 0
        #: lifecycle callback `fn(rid, exc)` — the `fault/` manager
        #: installs itself here to quarantine + repair + restart
        self.on_replica_failed: Callable[[int, BaseException], None] | None = None
        #: set by `from_recovery` (durable/recovery.py:RecoveryReport)
        self.recovery_report = None
        # follower mode (`repl/`): writes reject with NotPrimary until
        # a promotion flips the frontend via enable_writes()
        self._read_only = bool(read_only)
        #: replication ack barrier `fn(durable_pos)` — the `repl/`
        #: shipper installs `shipper.barrier` here so a durable-ack
        #: batch resolves only after its records are SHIPPED to the
        #: follower feed as well as fsynced (ship-before-ack: the
        #: semi-synchronous mode whose acks survive primary loss
        #: because a promoted follower provably holds them). A tree
        #: root extends it with downstream receipt:
        #: `repl/transport.py:make_tree_barrier(shipper, server)`.
        self.ack_barrier: Callable[[int], None] | None = None

        reg = get_registry()
        self._m_submitted = reg.counter("serve.submitted")
        self._m_completed = reg.counter("serve.completed")
        self._m_shed = reg.counter("serve.shed")
        self._m_miss = reg.counter("serve.deadline_miss")
        self._m_batches = reg.counter("serve.batches")
        self._m_rehomed = reg.counter("serve.rehomed")
        self._m_batch_size = reg.histogram("serve.batch.size",
                                           buckets=COUNT_BUCKETS)
        self._m_batch_dur = reg.histogram("serve.batch.duration_s")
        self._m_req_lat = reg.histogram("serve.request.latency_s")
        # requests that expired while their round was in flight and
        # still resolved successfully (the completion-stage second
        # sweep): delivered — first resolution wins, the op executed —
        # but counted so SLO accounting stays honest
        self._m_late = reg.counter("serve.deadline_late_success")

        #: meshed fleet (`NodeReplicated(mesh=...)`): served replica ->
        #: the device its shard lives on, the one its worker's rounds
        #: land on (`stats()["mesh"]`)
        self.device_of_rid: dict[int, str] = {}

        with self._lock:
            for rid in (rids if rids is not None
                        else range(nr.n_replicas)):
                rid = int(rid)
                if rid in self._queues:
                    raise ValueError(f"replica {rid} served twice")
                self._store_replica(rid, self._new_replica(rid))
                self._record_device(rid)

        #: fleet observability side port (`ServeConfig.obs_port`,
        #: `obs/export.py`): the node's scrape endpoint, labeled by
        #: role — a read-only (follower-mode) frontend announces
        #: itself as such so the fleet dashboard draws the tree right
        self.exporter = None
        if self.cfg.obs_port is not None:
            from node_replication_torch.obs.export import MetricsExporter

            self.exporter = MetricsExporter(
                node_id=self.cfg.obs_node_id,
                role="follower" if self._read_only else "primary",
                port=self.cfg.obs_port,
            )
            self.exporter.add_stats("serve", self.stats)
        #: host sampling profiler (`ServeConfig.profile_hz`,
        #: `obs/profile.py`): same existence discipline as the
        #: exporter — None by default, so profiling costs nothing
        #: unless a rate was asked for
        self.profiler = None
        if self.cfg.profile_hz is not None:
            from node_replication_torch.obs.profile import SamplingProfiler

            self.profiler = SamplingProfiler(hz=self.cfg.profile_hz)
            self.profiler.start()
            if self.exporter is not None:
                # remote capture serves the frontend's profiler; its
                # lifecycle stays here (exporter.close won't stop it)
                self.exporter.attach_profiler(self.profiler)
        if auto_start:
            self.start()

    def _record_device(self, rid: int) -> None:
        if getattr(self._nr, "mesh", None) is not None:
            self.device_of_rid[rid] = str(self._nr.replica_device(rid))

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def from_recovery(
        cls,
        directory: str,
        dispatch,
        config: "ServeConfig | None" = None,
        rids: Sequence[int] | None = None,
        auto_start: bool = True,
        nr_kwargs: dict | None = None,
    ) -> "ServeFrontend":
        """Reopen serving state after a crash: `recover_fleet` rebuilds
        the wrapper from `directory` (newest valid snapshot + WAL tail
        replayed through the same dispatch scan — bit-identical to the
        pre-crash fleet), re-attaches the WAL at the recovered tail,
        and this builds a frontend over it so traffic resumes where the
        fsync-acked history ends. The WAL's fsync policy follows
        `config.durability` (`"none"`/`"batch"`/`"always"`); the
        `RecoveryReport` is exposed as `frontend.recovery_report`.
        A missing/empty directory boots (and starts journaling) a
        fresh fleet — `from_recovery` is therefore also the canonical
        cold-start entry for a durable serve deployment."""
        from node_replication_torch.durable.recovery import recover_fleet

        config = config or ServeConfig()
        # WAL fsync policy mirrors the ack contract; "none" durability
        # still journals (batch-style, caller/close syncs only)
        policy = (
            config.durability if config.durability != "none"
            else "batch"
        )
        nr, report = recover_fleet(
            directory, dispatch, policy=policy, attach=True,
            nr_kwargs=nr_kwargs,
        )
        fe = cls(nr, config, rids=rids, auto_start=auto_start)
        fe.recovery_report = report
        return fe

    @property
    def nr(self):
        """The wrapped `NodeReplicated`/`MultiLogReplicated` (read
        access for recovery verification and ops tooling; mutate it
        only through the frontend)."""
        return self._nr

    def _spawn_workers(self, rid: int, q: "_SubmissionQueue"):
        """Worker thread(s) for one replica: the serial combiner loop,
        or (`pipeline_depth > 0`) the assembly + completion stage pair
        joined by a capacity-1 handoff channel. Returns
        `(worker, completer, channel)` — the latter two None in serial
        mode. The CALLER stores them into the topology dicts under
        `_lock`; threads start only via `start()`."""
        if self.cfg.pipeline_depth > 0:
            chan = _PipelineChannel()
            asm = threading.Thread(
                target=self._assembly_loop, args=(rid, q, chan),
                name=f"serve-asm-r{rid}", daemon=True,
            )
            cpl = threading.Thread(
                target=self._completion_loop, args=(rid, q, chan),
                name=f"serve-cpl-r{rid}", daemon=True,
            )
            return asm, cpl, chan
        t = threading.Thread(
            target=self._worker_loop, args=(rid, q),
            name=f"serve-worker-r{rid}", daemon=True,
        )
        return t, None, None

    def _new_replica(self, rid: int):
        """Build the queue/worker(s)/token/gauge set for one replica;
        the CALLER stores them into the topology dicts under `_lock`
        (so every write to the guarded dicts is visibly locked). The
        workers start only via `start()`."""
        q = _SubmissionQueue(self.cfg.queue_depth)
        t, cpl, chan = self._spawn_workers(rid, q)
        token = self._nr.register(rid)
        gauge = get_registry().gauge(f"serve.queue_depth.r{rid}")
        if self.governor is not None:
            self.governor.register_replica(rid)
        return q, t, cpl, chan, token, gauge

    def _store_replica(self, rid: int, built) -> None:
        """Store one `_new_replica` result into the topology dicts;
        caller holds `_lock`."""
        q, t, cpl, chan, token, gauge = built
        # both callers (the constructor and grow()) hold _lock, which
        # is non-reentrant — re-acquiring here would deadlock
        self._queues[rid] = q  # nrlint: disable=lock-discipline — caller holds _lock
        self._workers[rid] = t  # nrlint: disable=lock-discipline — caller holds _lock
        if cpl is not None:
            self._completers[rid] = cpl  # nrlint: disable=lock-discipline — caller holds _lock
            self._channels[rid] = chan  # nrlint: disable=lock-discipline — caller holds _lock
        self._read_tokens[rid] = token  # nrlint: disable=lock-discipline — caller holds _lock
        self._depth_gauges[rid] = gauge  # nrlint: disable=lock-discipline — caller holds _lock

    def start(self) -> None:
        """Start every not-yet-running worker (idempotent)."""
        with self._lock:
            if self._closed:
                raise FrontendClosed("cannot start a closed frontend")
            self._started = True
            for t in (list(self._workers.values())
                      + list(self._completers.values())):
                if not t.is_alive() and not t.ident:
                    t.start()

    @property
    def rids(self) -> list[int]:
        with self._lock:  # grow() can resize the dict mid-iteration
            return sorted(self._queues)

    def threads(self) -> dict[str, list[str]]:
        """Live worker threads by profiler role (`obs.profile.role_of`):
        the frontend's own workers/completers plus the exporter's
        accept thread and the profiler's sampler when those exist.
        Names are unique (each embeds its rid or node id), so the dict
        is loss-free."""
        from node_replication_torch.obs.profile import role_of

        with self._lock:
            live = [
                t for t in (list(self._workers.values())
                            + list(self._completers.values()))
                if t.is_alive()
            ]
        for extra in (
            self.exporter.accept_thread
            if self.exporter is not None else None,
            self.profiler.thread
            if self.profiler is not None else None,
        ):
            if extra is not None and extra.is_alive():
                live.append(extra)
        out: dict[str, list[str]] = {}
        for t in live:
            out.setdefault(role_of(t.name), []).append(t.name)
        for names in out.values():
            names.sort()
        return out

    def grow(self, k: int = 1) -> list[int]:
        """Add `k` replicas to the live fleet (`grow_fleet`) and start
        serving them — queues and workers spin up while existing
        traffic keeps flowing (elasticity under load)."""
        if not hasattr(self._nr, "grow_fleet"):
            raise TypeError(
                f"{type(self._nr).__name__} has no grow_fleet"
            )
        with self._lock:
            if self._closed:
                raise FrontendClosed("cannot grow a closed frontend")
            new_rids = self._nr.grow_fleet(k)
            for rid in new_rids:
                rid = int(rid)
                if rid in self._queues:
                    raise ValueError(f"replica {rid} served twice")
                self._store_replica(rid, self._new_replica(rid))
                self._record_device(rid)
            started = self._started
        get_tracer().emit("serve-grow", rids=list(map(int, new_rids)))
        if started:
            self.start()
        return new_rids

    # ------------------------------------------------------------ failover

    def healthy_rids(self) -> list[int]:
        """Served replicas currently accepting admissions (rids minus
        failed ones) — `call_with_retry`'s re-route domain."""
        with self._lock:
            return sorted(r for r in self._queues
                          if r not in self._failed)

    def _rehome(self, req: _Request,
                targets: list[_SubmissionQueue]) -> bool:
        """Move a failed replica's queued request onto a healthy
        replica's queue (admission-order preserved within the batch of
        leftovers; `readmit` — the request was already counted
        accepted once). False when no target admits it."""
        for q in targets:
            if q.readmit(req):
                return True
        return False

    def _fail_replica(self, rid: int, q: _SubmissionQueue,
                      exc: BaseException) -> None:
        """Retire replica `rid` from admission (worker death path):
        mark it failed, re-home its queued requests onto healthy
        replicas (rejecting with retryable `ReplicaFailed` only when
        none admits), and hand the corpse to `on_replica_failed`.
        Runs on the dying worker thread; idempotent."""
        with self._lock:
            already = rid in self._failed
            if not already:
                self._failed[rid] = exc
        if already:
            return
        leftovers = q.close(drain=False)
        # one topology snapshot for the whole leftover batch (per-
        # request healthy_rids() would hammer the frontend lock from
        # the dying worker while clients contend on submit)
        with self._lock:
            targets = [self._queues[r] for r in sorted(self._queues)
                       if r != rid and r not in self._failed]
        rehomed = 0
        for req in leftovers:
            if self._rehome(req, targets):
                rehomed += 1
            else:
                req.future._reject(
                    ReplicaFailed(rid, exc, maybe_executed=False)
                )
        with self._lock:
            self._rehomed += rehomed
            gauge = self._depth_gauges.get(rid)
        # retire the replica's per-rid depth gauge with it: a gauge
        # for a replica no one serves would haunt every scrape (and
        # the registry) with its last pre-death value forever;
        # `restart_replica` re-registers the name on readmission.
        # Handle-owned removal: after a restart re-registered a fresh
        # gauge, a straggling retire from the OLD worker must not
        # remove the live one. (Two co-resident frontends serving the
        # same rid share the name outright — but then the gauge was
        # already last-write-wins noise; per-node metrics are
        # process-grained, obs/export.py docstring.)
        get_registry().remove(f"serve.queue_depth.r{rid}", gauge)
        if rehomed:
            self._m_rehomed.inc(rehomed)
            get_tracer().emit("serve-rehome", rid=rid, n=rehomed)
        get_tracer().emit(
            "serve-replica-failed", rid=rid, rehomed=rehomed,
            queued=len(leftovers), cause=type(exc).__name__,
        )
        logger.warning(
            "serve worker r%d retired after %s: %s (%d queued "
            "request(s) re-homed)", rid, type(exc).__name__, exc,
            rehomed,
        )
        cb = self.on_replica_failed
        if cb is not None:
            try:
                cb(rid, exc)
            # the replica failure is already recorded (self._failed +
            # every future rejected) before this guard; it only shields
            # the worker exit from a buggy USER lifecycle handler
            # nrlint: disable=swallowed-worker-exception
            except Exception:
                logger.exception(
                    "on_replica_failed handler raised; replica %d "
                    "stays failed", rid,
                )

    def restart_replica(self, rid: int) -> None:
        """Readmit a failed replica after repair (`fault/repair.py`):
        fresh queue + worker; the read token is reused (registration is
        permanent). The retired queue's counters fold into the
        frontend-level aggregates so `stats()` stays cumulative."""
        with self._lock:
            if self._closed:
                raise FrontendClosed(
                    "cannot restart a replica on a closed frontend"
                )
            if rid not in self._failed:
                raise ValueError(f"replica {rid} has not failed")
            old = self._queues[rid].stats()
            for k in ("accepted", "shed", "completed",
                      "deadline_missed", "evicted",
                      "priority_inversions"):
                self._retired[k] = self._retired.get(k, 0) + old[k]
            for name, v in old["shed_by_priority"].items():
                self._retired_prio[name] = (
                    self._retired_prio.get(name, 0) + v
                )
            q = _SubmissionQueue(self.cfg.queue_depth)
            t, cpl, chan = self._spawn_workers(rid, q)
            self._queues[rid] = q
            self._workers[rid] = t
            if cpl is not None:
                self._completers[rid] = cpl
                self._channels[rid] = chan
            # fresh gauge registration: `_fail_replica` removed the
            # retired replica's name from the registry
            self._depth_gauges[rid] = get_registry().gauge(
                f"serve.queue_depth.r{rid}"
            )
            del self._failed[rid]
            started = self._started
        get_tracer().emit("serve-replica-restart", rid=rid)
        if started:
            t.start()
            if cpl is not None:
                cpl.start()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every queue is empty and no batch is in flight.
        Returns False on timeout. Admission stays open — this is a
        flush barrier, not a shutdown."""
        with self._lock:  # grow() can resize the dict mid-iteration
            qs = list(self._queues.values())
        clock = get_clock()
        t_end = (
            None if timeout is None else clock.now() + timeout
        )
        for q in qs:
            rem = None if t_end is None else t_end - clock.now()
            if not q.wait_idle(rem):
                return False
        return True

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        """Stop admission and shut down. `drain=True` (default)
        flushes every queued op through the combiner first;
        `drain=False` rejects the backlog with `FrontendClosed`.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            queues = list(self._queues.items())
            workers = (list(self._workers.values())
                       + list(self._completers.values()))
            gauges = dict(self._depth_gauges)
            started = self._started
        leftovers: list[_Request] = []
        for _, q in queues:
            leftovers.extend(q.close(drain))
        for req in leftovers:
            req.future._reject(FrontendClosed("closed before service"))
        if timeout is None:
            timeout = self.cfg.drain_timeout_s
        clock = get_clock()
        t_end = clock.now() + timeout
        if started:
            for t in workers:
                t.join(max(0.0, t_end - clock.now()))
        # paused frontend (never started) or drain timeout: requests
        # may still sit in the queues — reject, never strand a future
        for _, q in queues:
            for req in q.close(drain=False):
                req.future._reject(
                    FrontendClosed("closed before service")
                )
        # every served replica retires with the frontend: their
        # per-rid depth gauges leave the registry (the scrape surface)
        # instead of reporting a dead frontend's last depths forever
        # (handle-owned removal — see _fail_replica)
        reg = get_registry()
        for rid, _ in queues:
            reg.remove(f"serve.queue_depth.r{rid}", gauges.get(rid))
        if self.profiler is not None:
            self.profiler.stop()
        if self.exporter is not None:
            self.exporter.close()
        get_tracer().emit("serve-close", drained=drain)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # ------------------------------------------------------------ client API

    def submit(self, op: tuple, rid: int = 0,
               deadline_s: float | None = None,
               priority: int = NORMAL) -> ServeFuture:
        """Stage one write op on replica `rid`; returns its future.
        Raises `Overloaded` when the admission queue is full at its
        (possibly adaptive) limit, `FrontendClosed` after `close()`,
        (failover mode) `ReplicaFailed` while the replica is down, and
        (follower mode) `NotPrimary` while writes are disabled — all
        BEFORE the op can have any effect.

        `priority` (`serve.overload.CRITICAL/NORMAL/BULK`) orders
        shedding, strictly: at a full queue a higher-priority arrival
        evicts the newest queued lower-priority request (whose future
        rejects with `Overloaded(evicted=True)`) instead of shedding
        itself, so BULK traffic always sheds first. Deadline-expired
        queued requests are swept out at admission time — a corpse
        never costs a live request its slot."""
        if self._read_only:
            # follower mode (`repl/`): no write is ever admitted, so a
            # rejected caller can safely resubmit against the primary
            raise NotPrimary(rid)
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} (CRITICAL=0 NORMAL=1 "
                f"BULK=2)"
            )
        # closed wins over failed: a closed frontend is PERMANENT and
        # must not hand retry loops a retryable ReplicaFailed.
        # Admission fast path: GIL-atomic flag/dict reads — a racing
        # failover is caught again below (`q.offer` under its lock)
        # nrcheck: unshared — GIL-atomic reads; re-checked under lock
        if not self._closed and rid in self._failed:
            # nrcheck: unshared — GIL-atomic dict read
            raise ReplicaFailed(rid, self._failed.get(rid),
                                maybe_executed=False)
        q = self._queues.get(rid)  # nrcheck: unshared — GIL-atomic read
        if q is None:
            raise ValueError(f"replica {rid} is not served "
                             f"(have {self.rids})")
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        now = get_clock().now()
        deadline = None if deadline_s is None else now + deadline_s
        gov = self.governor
        limit = (
            self.cfg.queue_depth if gov is None
            else min(self.cfg.queue_depth, gov.limit(rid))
        )
        fut = ServeFuture(rid, deadline=deadline)
        try:
            res = q.offer(_Request(op, fut, priority), limit, now)
        except FrontendClosed:
            # a per-replica queue closed while the frontend is open can
            # only mean this replica failed (or is mid-restart): that
            # is the retryable signal, not a permanent closure
            # nrcheck: unshared — GIL-atomic flag read
            if not self._closed:
                raise ReplicaFailed(
                    # nrcheck: unshared — GIL-atomic dict read
                    rid, self._failed.get(rid), maybe_executed=False
                ) from None
            raise
        self._finish_offer(rid, res, limit, now)
        if not res.admitted:
            self._m_shed.inc()
            if gov is not None:
                gov.note_shed(priority)
            get_tracer().emit("serve-shed", rid=rid, depth=limit,
                              prio=PRIORITY_NAMES[priority])
            raise Overloaded(rid, limit, priority=priority)
        self._m_submitted.inc()
        return fut

    @contextlib.contextmanager
    def staging(self, rid: int = 0):
        """Stage several `submit`s on replica `rid` as one unit: its
        worker takes no partial batch until the block exits (full
        batches still go), so the rounds a multi-op submission lands in
        do not depend on how the threads interleave. Each `submit` in
        the block admits, sheds or raises exactly as outside it."""
        q = self._queues.get(rid)  # nrcheck: unshared — GIL-atomic read
        if q is None:
            yield
            return
        q.hold()
        try:
            yield
        finally:
            q.release()

    def _finish_offer(self, rid: int, res: _OfferResult, limit: int,
                      now: float) -> None:
        """Resolve the futures `offer` removed under its lock — the
        eagerly swept expired requests and the priority eviction —
        and do their accounting (outside the queue lock: rejection
        runs user done-callbacks)."""
        for req in res.expired:
            late = now - (req.future.deadline or now)
            req.future._reject(DeadlineExceeded(rid, late))
        if res.expired:
            self._m_miss.inc(len(res.expired))
            get_tracer().emit("serve-deadline-miss", rid=rid,
                              n=len(res.expired), swept=1)
        ev = res.evicted
        if ev is not None:
            self._m_shed.inc()
            if self.governor is not None:
                self.governor.note_shed(ev.priority, evicted=True)
            get_tracer().emit("serve-evict", rid=rid,
                              prio=PRIORITY_NAMES[ev.priority])
            ev.future._reject(Overloaded(
                rid, limit, priority=ev.priority, evicted=True,
            ))
        if res.inversion:
            # the queue already counted it (priority_inversions, the
            # invariant the sim/bench gates assert stays zero); make
            # it loud in the trace too
            get_tracer().emit("serve-priority-inversion", rid=rid)

    def call(self, op: tuple, rid: int = 0,
             deadline_s: float | None = None,
             timeout: float | None = None,
             priority: int = NORMAL):
        """Closed-loop convenience: `submit` + `result`."""
        return self.submit(op, rid, deadline_s,
                           priority=priority).result(timeout)

    def add_backpressure_source(self, name: str, fn, low: int,
                                high: int) -> None:
        """Attach a downstream lag feed to the admission controller
        (`serve/overload.py:LagSource` semantics: no influence below
        `low`, growth pause between, multiplicative decrease at/above
        `high`). Raises when the overload plane is off — silently
        ignoring a backpressure wire would let the backlog it guards
        grow unbounded."""
        if self.governor is None:
            raise ValueError(
                "backpressure needs the overload plane: construct the "
                "frontend with ServeConfig(overload=OverloadConfig())"
            )
        self.governor.add_source(LagSource(name, fn, low, high))

    @property
    def read_only(self) -> bool:
        """True while serving in follower mode (writes rejected)."""
        return self._read_only

    def enable_writes(self) -> None:
        """Promotion re-home (`repl/promote.py`): flip a read-only
        (follower-mode) frontend into write serving. The queues and
        workers were live all along — only admission changes — so the
        first write after promotion needs no warm-up. Idempotent."""
        if not self._read_only:
            return
        self._read_only = False
        get_tracer().emit("serve-enable-writes")

    def read(self, op: tuple, rid: int = 0,
             min_pos: int | None = None, wait_s: float = 0.0):
        """Read against replica `rid` via the wrapper's read-sync path
        (`execute`): waits only for THIS replica to pass the completed
        tail, then dispatches locally — never enters the write queue
        or the log (`nr/src/replica.rs:404-410`).

        `min_pos` is the bounded-staleness cursor: the read
        dispatches only once replica `rid`'s applied position
        (`ltails[rid]`) has reached `min_pos`, waiting up to `wait_s`
        seconds and then rejecting with a typed `StaleRead` — a client
        never silently observes state older than its bound.

        **Brownout** (`ServeConfig.overload`): while the governor is
        in brownout, a read WITHOUT an explicit `min_pos` degrades to
        the bounded-staleness path instead of paying read-sync — it
        dispatches against the replica's current state
        (`execute_stale`) when the replica's lag is within
        `OverloadConfig.brownout_max_lag`, falling back to the synced
        path when it is not. A brownout read can therefore never
        exceed its staleness bound; the worst lag actually served is
        recorded (`governor.stats()['max_brownout_lag']`). An
        explicit `min_pos` (read-your-writes) always takes the synced
        path — a client that asked for a bound gets that bound."""
        # nrcheck: unshared — GIL-atomic dict read; read fast path
        token = self._read_tokens.get(rid)
        if token is None:
            raise ValueError(f"replica {rid} is not served "
                             f"(have {self.rids})")
        gov = self.governor
        if (min_pos is None and gov is not None and gov.brownout()
                and hasattr(self._nr, "execute_stale_bounded")):
            # bound check + dispatch are ONE lock acquisition inside
            # the wrapper — a separate read_lag peek would race a
            # concurrent batch advancing the completed tail and serve
            # (and under-record) beyond the bound
            hit = self._nr.execute_stale_bounded(
                op, token, gov.cfg.brownout_max_lag
            )
            if hit is not None:
                value, lag = hit
                gov.note_brownout_read(lag)
                return value
            # replica too far behind for the brownout bound: pay the
            # synced path rather than serve beyond the bound
        if min_pos is not None:
            min_pos = int(min_pos)
            ltail = getattr(self._nr, "ltail", None)
            if ltail is None:
                raise TypeError(
                    f"{type(self._nr).__name__} has no ltail "
                    f"accessor; bounded-staleness reads need it"
                )
            clock = get_clock()
            deadline = clock.now() + max(0.0, wait_s)
            while True:
                # locked cursor peek: an unlocked log read races the
                # exec round's buffer donation (core/replica.ltail)
                applied = ltail(rid)
                if applied >= min_pos:
                    break
                if clock.now() >= deadline:
                    raise StaleRead(rid, applied, min_pos)
                clock.sleep(0.0002)
        return self._nr.execute(op, token)

    def stats(self) -> dict:
        """Aggregate + per-replica frontend counters (plain ints,
        independent of the metrics registry's enable flag). Counters of
        queues retired by failover restarts are folded into the
        aggregates; `rehomed`/`failed` expose the failover state."""
        with self._lock:  # grow() can resize the dict mid-iteration
            queues = sorted(self._queues.items())
            retired = dict(self._retired)
            retired_prio = dict(self._retired_prio)
            rehomed = self._rehomed
            failed = sorted(self._failed)
            dev_map = dict(self.device_of_rid)
        per = {rid: q.stats() for rid, q in queues}
        agg = {
            k: sum(s[k] for s in per.values())
            for k in ("queued", "in_service", "accepted", "shed",
                      "completed", "deadline_missed", "evicted",
                      "priority_inversions")
        }
        agg["shed_by_priority"] = {
            name: sum(s["shed_by_priority"][name]
                      for s in per.values())
            + retired_prio.get(name, 0)
            for name in PRIORITY_NAMES
        }
        for k, v in retired.items():
            agg[k] += v
        agg["rehomed"] = rehomed
        agg["failed"] = failed
        agg["replicas"] = per
        if self.governor is not None:
            agg["overload"] = self.governor.stats()
        if dev_map:
            per_dev: dict[str, int] = {}
            for dev in dev_map.values():
                per_dev[dev] = per_dev.get(dev, 0) + 1
            agg["mesh"] = {
                "devices": len(per_dev),
                "replicas_per_device": per_dev,
                "device_of_rid": dict(sorted(dev_map.items())),
            }
        return agg

    # ------------------------------------------------------------ worker

    def _worker_loop(self, rid: int, q: _SubmissionQueue) -> None:
        cfg = self.cfg
        while True:
            batch = q.take_batch(cfg.batch_max_ops,
                                 cfg.batch_linger_s)
            if batch is None:
                return
            try:
                self._run_batch(rid, q, batch)
            except _ReplicaDown as down:
                # failover: retire the replica FIRST (marks it failed,
                # re-homes the queue, spawns the lifecycle callback),
                # THEN complete the in-flight futures — a caller woken
                # by its ReplicaFailed must find the failover already
                # in motion, not a pre-failover limbo
                self._fail_replica(rid, q, down.cause)
                for req in down.pending:
                    req.future._reject(ReplicaFailed(
                        rid, down.cause,
                        maybe_executed=down.maybe_executed,
                    ))
                return
            except Exception as e:  # pragma: no cover - last resort
                logger.exception(
                    "serve worker r%d: unexpected batch failure", rid
                )
                if cfg.failover:
                    self._fail_replica(rid, q, e)
                # never strand a caller: reject whatever _run_batch
                # had not resolved (first resolution wins, so futures
                # it DID resolve are untouched)
                for req in batch:
                    req.future._reject(e)
                q.batch_done(0, 0, len(batch))
                if cfg.failover:
                    return

    def _sweep_batch(self, rid: int, q: _SubmissionQueue,
                     batch: list[_Request]):
        """Batch-assembly head shared by the serial round and the
        pipelined assembly stage: the AIMD update (the queue-delay
        control signal is measured HERE, at assembly — a pipelined
        round's in-flight time must not double-count into the
        governor's sojourn signal) and the pre-append deadline sweep.
        Returns `(live, missed, delay)`."""
        now = get_clock().now()
        delay = 0.0
        if batch:
            delay = max(
                0.0, now - min(r.future.t_submit for r in batch)
            )
        if self.governor is not None and batch:
            # the control signal: how long the batch's OLDEST request
            # waited between admission and assembly (CoDel's sojourn
            # time) — one AIMD update per combiner round
            self.governor.on_round(rid, delay, len(batch))
        live: list[_Request] = []
        missed = 0
        for req in batch:
            dl = req.future.deadline
            if dl is not None and now > dl:
                missed += 1
                req.future._reject(
                    DeadlineExceeded(rid, now - dl)
                )
            else:
                live.append(req)
        if missed:
            self._m_miss.inc(missed)
            get_tracer().emit("serve-deadline-miss", rid=rid, n=missed)
        return live, missed, delay

    def _run_batch(self, rid: int, q: _SubmissionQueue,
                   batch: list[_Request]) -> None:
        """One combiner round: sweep expired deadlines, execute the
        survivors as a single `execute_mut_batch`, resolve futures.
        In failover mode a round that throws completes its requests
        with `ReplicaFailed` and raises `_ReplicaDown` so the loop
        retires the replica."""
        try:
            # injection choke point (`fault/inject.py`): fires BEFORE
            # any op can touch the log, so a kill here is pre-append
            # and every in-flight request is exactly-once retryable
            fault_hook("serve-batch", rid, self._nr)
        except Exception as e:
            if not self.cfg.failover:
                raise
            q.batch_done(0, 0, len(batch))
            raise _ReplicaDown(e, batch, maybe_executed=False) from e
        live, missed, delay = self._sweep_batch(rid, q, batch)
        if not live:
            q.batch_done(0, missed, len(batch))
            return
        t0 = get_clock().now()
        try:
            resps = self._nr.execute_mut_batch(
                [req.op for req in live], rid
            )
        except Exception as e:
            if self.cfg.failover:
                # `maybe_executed`: a failure out of the wrapper is
                # only provably pre-append when it is the fence guard
                # or an append-site injection (both fire before the
                # batch reaches the log). Anything else may have struck
                # mid-replay — the ops WILL replay, only responses are
                # lost — so auto-retry must be refused (exactly-once).
                pre_append = isinstance(e, ReplicaFencedError) or (
                    isinstance(e, FaultError) and e.site == "append"
                )
                q.batch_done(0, missed, len(batch))
                logger.exception(
                    "serve worker r%d: batch of %d failed; retiring "
                    "replica", rid, len(live)
                )
                raise _ReplicaDown(
                    e, live, maybe_executed=not pre_append
                ) from e
            for req in live:
                req.future._reject(e)
            q.batch_done(0, missed, len(batch))
            logger.exception(
                "serve worker r%d: batch of %d failed", rid, len(live)
            )
            return
        self._finish_delivery(rid, q, live, missed, len(batch),
                              resps, t0, delay)

    def _finish_delivery(self, rid: int, q: _SubmissionQueue,
                         live: list[_Request], missed: int,
                         taken: int, resps: list, t0: float,
                         delay: float) -> None:
        """Delivery tail shared by the serial round and the pipelined
        completion stage: durable-ack barrier, the SECOND deadline
        sweep (late successes delivered but counted —
        `serve.deadline_late_success`), future resolution, accounting,
        and the `serve-batch` trace event. Raises `_ReplicaDown` on a
        barrier failure in failover mode, exactly like the execute
        path (post-append: `maybe_executed=True`)."""
        barrier = self.ack_barrier
        if self._durable_sync or barrier is not None:
            # durable-ack barrier (`ServeConfig(durability="batch")`):
            # ONE fsync covers the whole batch; futures resolve only
            # past it, so an acked response is on disk. With a
            # replication `ack_barrier` installed (`repl/shipper.py`)
            # the batch additionally waits until the feed holds its
            # records (ship-before-ack), so an acked response also
            # survives PRIMARY loss via promotion. A failed fsync or
            # ship is post-append by definition (the ops are in the
            # log and WILL replay in-process) — reject with
            # maybe_executed semantics rather than ack a durability
            # promise the disk (or the feed) refused.
            try:
                if self._durable_sync:
                    durable = self._nr.wal_sync()
                else:
                    # barrier without batch-fsync (durability="always"
                    # keeps durable_tail == tail): gate on the journal
                    # TAIL, which covers this batch's records — gating
                    # on durable_tail would let a policy="none" WAL
                    # ack unshipped ops silently; this way the shipper
                    # (which ships only fsynced records) times the
                    # barrier out instead, and the misconfiguration
                    # is loud
                    wal = getattr(self._nr, "wal", None)
                    durable = None if wal is None else wal.tail
                if barrier is not None:
                    if durable is None:
                        # an installed barrier with no journal to gate
                        # on would otherwise be skipped silently — acks
                        # would claim replication that never happened
                        raise RuntimeError(
                            "ack_barrier installed but no WAL is "
                            "attached; ship-before-ack needs the "
                            "journal"
                        )
                    barrier(durable)
            except Exception as e:
                q.batch_done(0, missed, taken)
                logger.exception(
                    "serve worker r%d: durable-ack barrier failed for "
                    "batch of %d", rid, len(live)
                )
                if self.cfg.failover:
                    raise _ReplicaDown(
                        e, live, maybe_executed=True
                    ) from e
                for req in live:
                    req.future._reject(e)
                return
        now2 = get_clock().now()
        dur = now2 - t0
        # second deadline sweep, at delivery: a request that expired
        # while its round was in flight DID execute — deliver the
        # response (first resolution wins; nothing changes for the
        # future) but count it, so SLO accounting never claims an
        # in-deadline success that wasn't
        late = sum(
            1 for req in live
            if req.future.deadline is not None
            and now2 > req.future.deadline
        )
        if late:
            self._m_late.inc(late)
        for req, resp in zip(live, resps):
            req.future._resolve(resp)
            lat = req.future.latency_s
            if lat is not None:
                self._m_req_lat.observe(lat)
        q.batch_done(len(live), missed, taken)
        depth = q.depth()
        self._m_batches.inc()
        self._m_completed.inc(len(live))
        self._m_batch_size.observe(len(live))
        self._m_batch_dur.observe(dur)
        # the map is written under _lock at replica creation, before
        # this worker exists, so the lock-free lookup cannot race it
        # nrcheck: unshared — GIL-atomic dict read
        self._depth_gauges[rid].set(depth)
        tracer = get_tracer()
        if tracer.enabled:
            # which combiner-round engine served this batch
            # (pallas_fused / combined / scan). Per-rid lookup:
            # this worker alone runs the rounds of its replica, so
            # the stamp cannot be overwritten by a concurrent worker's
            # round the way a wrapper-wide field would be.
            tier_of = getattr(self._nr, "round_tier", None)
            # per-record trace join key (`obs/` fleet tracing): the
            # log position this batch appended at, read per-rid for
            # the same reason as the tier. With it the serve-batch
            # event IS the record's submit→ack hop: `queue_delay_s`
            # (admission → assembly) + `duration_s` (assembly → ack)
            # reconstruct the submit time from the ack stamp.
            pos_of = getattr(self._nr, "round_pos", None)
            tracer.emit(
                "serve-batch", rid=rid, n=len(live), expired=missed,
                queue_depth=depth, duration_s=dur,
                queue_delay_s=delay,
                late_success=late,
                pos=(pos_of(rid) if pos_of is not None else None),
                engine=(tier_of(rid) if tier_of is not None
                        else getattr(self._nr, "last_round_tier",
                                     None)),
            )

    # ----------------------------------------------------- pipelined worker

    def _assembly_loop(self, rid: int, q: _SubmissionQueue,
                       chan: _PipelineChannel) -> None:
        """Assembly stage (`pipeline_depth > 0`, thread
        `serve-asm-r{rid}`): wait for the in-flight round's device
        half (`wait_clear` — the queue keeps FILLING through the whole
        round, so batches stay as large as the serial worker's), then
        drain the queue, sweep deadlines, begin the round
        (`begin_mut_batch` — the batch is appended and, on the fused
        tier, the kernel launched when it returns), and hand off. The
        drain + sweep + begin of round N+1 overlap round N's
        completion-stage host work (barrier, future resolution), and
        round N+1's device work overlaps both.

        Death discipline mirrors `_worker_loop`: a begin failure in
        failover mode retires the replica FIRST, then rejects. When
        the completion stage died instead, a not-yet-begun batch never
        exists here (the queue was already closed and re-homed by
        `_fail_replica`) — but a begun round whose `put` the poisoned
        channel refused is post-append, and is torn down honestly
        (`_abort_staged`)."""
        cfg = self.cfg
        while True:
            dead = chan.wait_clear()
            if dead is not None:
                # completion died and already retired the replica
                # (`_fail_replica` ran before `round_done(exc)`);
                # queued requests were re-homed there, nothing is
                # taken or begun on this side — just exit
                return
            batch = q.take_batch(cfg.batch_max_ops,
                                 cfg.batch_linger_s)
            if batch is None:
                chan.close()  # completion drains in-flight, exits
                return
            try:
                staged = self._assemble(rid, q, batch)
            except _ReplicaDown as down:
                chan.close()
                self._fail_replica(rid, q, down.cause)
                for req in down.pending:
                    req.future._reject(ReplicaFailed(
                        rid, down.cause,
                        maybe_executed=down.maybe_executed,
                    ))
                return
            except Exception as e:  # pragma: no cover - last resort
                logger.exception(
                    "serve assembly r%d: unexpected failure", rid
                )
                q.batch_done(0, 0, len(batch))
                for req in batch:
                    req.future._reject(e)
                if cfg.failover:
                    chan.close()
                    self._fail_replica(rid, q, e)
                    return
                continue
            if staged is None:
                continue  # whole batch expired at the sweep
            dead = chan.put(staged)
            if dead is not None:
                # completion died between wait_clear and put: the
                # round IS begun (appended) — post-append teardown
                self._abort_staged(rid, q, staged, dead)
                return

    def _abort_staged(self, rid: int, q: _SubmissionQueue,
                      staged: _Staged, cause: BaseException) -> None:
        """Tear down a begun round nobody will finish (completion-
        stage death): release the wrapper's in-flight slot and drop
        its deliveries (`abort_mut_batch` — the ops are appended and
        WILL replay; only responses are lost), then reject with
        post-append `maybe_executed=True` honesty. `_fail_replica`
        already ran on the completion thread."""
        q.batch_done(0, staged.missed, staged.taken)
        abort = getattr(self._nr, "abort_mut_batch", None)
        if abort is not None:
            try:
                abort(staged.pending)
            # the guard only shields the teardown's slot release; the
            # failure IS recorded — every future of the staged round
            # rejects typed immediately below, and the replica is
            # already marked failed (`_fail_replica` ran first)
            # nrlint: disable=swallowed-worker-exception
            except Exception:  # pragma: no cover - teardown guard
                logger.exception(
                    "serve r%d: abort_mut_batch failed during "
                    "failover teardown", rid
                )
        for req in staged.live:
            req.future._reject(ReplicaFailed(
                rid, cause, maybe_executed=True,
            ))

    def _assemble(self, rid: int, q: _SubmissionQueue,
                  batch: list[_Request]) -> "_Staged | None":
        """One assembly pass: injection choke point, AIMD update +
        deadline sweep (`_sweep_batch` — the queue-delay signal is
        measured here, never at completion), `begin_mut_batch`.
        Returns the staged round for the completion stage (None when
        every request expired). Raises `_ReplicaDown` in failover
        mode; the begin failure is pre-append retryable exactly when
        it is the fence guard or an append/serve-batch-site injection
        — the same classification as the serial path."""
        try:
            # pre-append injection site, same as the serial worker: a
            # kill here fires before any op can touch the log
            fault_hook("serve-batch", rid, self._nr)
        except Exception as e:
            if not self.cfg.failover:
                raise
            q.batch_done(0, 0, len(batch))
            raise _ReplicaDown(e, batch, maybe_executed=False) from e
        clock = get_clock()
        t_asm = clock.now()
        live, missed, delay = self._sweep_batch(rid, q, batch)
        if not live:
            q.batch_done(0, missed, len(batch))
            return None
        t0 = clock.now()
        try:
            pending = self._nr.begin_mut_batch(
                [req.op for req in live], rid
            )
        except Exception as e:
            pre_append = isinstance(e, ReplicaFencedError) or (
                isinstance(e, FaultError) and e.site == "append"
            )
            q.batch_done(0, missed, len(batch))
            logger.exception(
                "serve assembly r%d: begin of %d failed", rid,
                len(live)
            )
            if self.cfg.failover:
                raise _ReplicaDown(
                    e, live, maybe_executed=not pre_append
                ) from e
            for req in live:
                req.future._reject(e)
            return None
        tracer = get_tracer()
        if tracer.enabled:
            # the assembly half of the overlap picture (obs/report's
            # serve section pairs this with the serve-batch span to
            # show assembly-vs-device busy fractions)
            tracer.emit(
                "serve-assemble", rid=rid, n=len(live),
                expired=missed, duration_s=clock.now() - t_asm,
                queue_delay_s=delay,
            )
        return _Staged(pending, live, missed, len(batch), t0, delay)

    def _completion_loop(self, rid: int, q: _SubmissionQueue,
                         chan: _PipelineChannel) -> None:
        """Completion stage (thread `serve-cpl-r{rid}`): finish the
        in-flight round (`finish_mut_batch` — the device replay /
        fused readback), signal `device_done` (the assembly stage may
        begin the next round NOW), then run the durable-ack barrier,
        resolve futures, fire `batch_done` and accounting. A round
        that dies here is post-append by construction
        (`maybe_executed=True`); the replica is retired BEFORE
        `round_done(exc)` wakes the assembly stage, so every observer
        finds the failover in motion — and a round the assembly began
        during our delivery is drained and torn down with the same
        post-append honesty."""
        while True:
            staged = chan.take()
            if staged is None:
                return
            try:
                self._complete(rid, q, staged, chan)
            except _ReplicaDown as down:
                self._fail_replica(rid, q, down.cause)
                for req in down.pending:
                    req.future._reject(ReplicaFailed(
                        rid, down.cause,
                        maybe_executed=down.maybe_executed,
                    ))
                stale = chan.drain_slot()
                if stale is not None:
                    # begun (appended) while round N was mid-delivery;
                    # nobody will finish it — post-append teardown
                    self._abort_staged(rid, q, stale, down.cause)
                chan.round_done(down.cause)
                return
            except Exception as e:  # pragma: no cover - last resort
                logger.exception(
                    "serve completion r%d: unexpected failure", rid
                )
                for req in staged.live:
                    req.future._reject(e)
                q.batch_done(0, 0, staged.taken)
                if self.cfg.failover:
                    self._fail_replica(rid, q, e)
                    stale = chan.drain_slot()
                    if stale is not None:
                        self._abort_staged(rid, q, stale, e)
                    chan.round_done(e)
                    return
                chan.round_done()
                continue

    def _complete(self, rid: int, q: _SubmissionQueue,
                  staged: _Staged, chan: _PipelineChannel) -> None:
        """One completion pass: post-append injection site, finish the
        round, release the assembly stage (`device_done`), shared
        delivery tail (`_finish_delivery`: barrier, second deadline
        sweep, future resolution, accounting)."""
        live, missed, taken = staged.live, staged.missed, staged.taken
        try:
            # post-append injection site: the round is begun — a kill
            # here loses responses, never ops (maybe_executed=True)
            fault_hook("serve-complete", rid, self._nr)
            resps = self._nr.finish_mut_batch(staged.pending)
        except Exception as e:
            q.batch_done(0, missed, taken)
            logger.exception(
                "serve completion r%d: finish of %d failed", rid,
                len(live)
            )
            # release the wrapper's in-flight slot: when the failure
            # struck BEFORE finish_mut_batch (the serve-complete
            # injection site) the begun round is still registered, and
            # a restarted worker's first begin would refuse forever.
            # Idempotent — a no-op when finish's own cleanup already
            # ran (or fence_replica's crash semantics will).
            abort = getattr(self._nr, "abort_mut_batch", None)
            if abort is not None:
                abort(staged.pending)
            if self.cfg.failover:
                raise _ReplicaDown(
                    e, live, maybe_executed=True
                ) from e
            for req in live:
                req.future._reject(e)
            # non-failover: the replica keeps serving — release the
            # assembly stage (the round left flight unsuccessfully;
            # without this the channel stays busy and every later
            # submission wedges in wait_clear)
            chan.round_done()
            return
        # the overlap release point: the wrapper slot is free and the
        # responses are in hand — everything below is host-only work
        # that round N+1's assembly (and device work) runs under
        chan.device_done()
        self._finish_delivery(rid, q, live, missed, taken, resps,
                              staged.t0, staged.delay)
