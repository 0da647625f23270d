"""Overload plane: adaptive admission, priority shedding, brownout.

The port's copy of `node_replication_tpu/serve/overload.py`.

The static `queue_depth` bound degrades binarily under
sustained overload: every request either queues toward a deadline miss
or sheds as `Overloaded`, and nothing upstream ever slows the primary.
The classic overload-control results (CoDel's queue-DELAY control,
SEDA's adaptive admission — PAPERS.md) all key the control signal to
*measured latency*, not queue length: a standing queue is the failure,
not the depth number. This module is that control plane:

- **AIMD admission** (`OverloadGovernor`): each replica's admission
  limit adapts every combiner round. The control signal is the round's
  measured *queue delay* — how long the oldest request of the batch
  waited between admission and batch assembly (exactly the sojourn
  time CoDel controls). Delay above `target_delay_s` (or backpressure
  past its high watermark, or the live `serve.request.latency_s`
  histogram's p99 crossing the configured deadline) halves the limit
  (multiplicative decrease); a clean round with no backpressure adds
  `increase` slots (additive increase). Between the watermarks the
  limit HOLDS — lag that is present but below the ceiling stops
  growth without collapsing admission.
- **Priority shedding** (`CRITICAL`/`NORMAL`/`BULK` on `submit`):
  when the adaptive limit is reached, an arriving higher-priority
  request EVICTS the newest queued lower-priority one (its future
  rejects with `Overloaded`) instead of shedding itself — so BULK
  traffic always sheds first and a CRITICAL op is shed only when the
  queue holds nothing but CRITICAL ops. The invariant is *measured*,
  not assumed: `priority_inversions` counts any CRITICAL shed that
  happened while a lower-priority op sat queued (structurally zero;
  the sim property and the bench gate assert it stays zero).
- **Brownout reads**: past the brownout watermark (queue-delay EWMA >
  `brownout_enter` × target, with hysteresis on exit) reads degrade to
  the bounded-staleness path instead of paying read-sync
  (`NodeReplicated.execute_stale` dispatches against the replica's
  current state; the frontend first checks `read_lag(rid)` against
  `brownout_max_lag` and falls back to the synced path when the
  replica is too far behind, so a brownout read can never exceed its
  staleness bound — `max_brownout_lag` records the worst lag actually
  served).
- **End-to-end backpressure** (`LagSource`): downstream lag feeds the
  controller through low/high watermark pairs — here the WAL's fsync
  lag (`durable/wal.py:fsync_lag`, registered by the frontend when a
  WAL is attached). Below `low`: no pressure. Between: the admission
  limit stops growing. At/above `high`: multiplicative decrease every
  round, so the unfsynced backlog can never grow unbounded.

The governor is deliberately lock-light: workers update it once per
combiner round under one small lock; the submit hot path reads the
per-replica limit with a single GIL-atomic dict lookup.
"""

from __future__ import annotations

import dataclasses

from node_replication_torch.analysis.locks import make_lock
from typing import Callable

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.trace import get_tracer

#: priority classes for `ServeFrontend.submit(op, priority=...)`.
#: Lower value = more important; shedding order is strictly reversed
#: (BULK first, CRITICAL last).
CRITICAL = 0
NORMAL = 1
BULK = 2
PRIORITIES = (CRITICAL, NORMAL, BULK)
PRIORITY_NAMES = ("critical", "normal", "bulk")


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Adaptive-admission tuning (`ServeConfig(overload=...)`).

    - `target_delay_s` — the queue-delay setpoint: admitted requests
      should wait about this long for batch assembly. The AIMD loop
      shrinks admission whenever a round's measured delay exceeds it.
    - `min_limit` / `increase` / `decrease` — the AIMD schedule:
      `limit = max(min_limit, limit * decrease)` on a congested round,
      `limit = min(queue_depth, limit + increase)` on a clean one.
    - `brownout_enter` / `brownout_exit` — hysteresis watermarks on
      the queue-delay EWMA, as multiples of `target_delay_s`: brownout
      engages above `enter`, disengages below `exit` (exit < enter so
      the mode cannot flap round-to-round).
    - `brownout_max_lag` — the staleness bound (log positions) a
      brownout read may serve at; a replica lagging further falls back
      to the synced read path.
    - `deadline_p99` — when the metrics registry is live and the
      frontend has a default deadline, a `serve.request.latency_s`
      p99 above `deadline_p99 × deadline` also counts as congestion
      (the p99-vs-deadline signal from the existing obs histograms).
    """

    target_delay_s: float = 0.010
    min_limit: int = 4
    increase: int = 4
    decrease: float = 0.5
    brownout_enter: float = 2.0
    brownout_exit: float = 0.75
    brownout_max_lag: int = 4096
    ewma_alpha: float = 0.3
    deadline_p99: float = 1.0

    def __post_init__(self):
        if self.target_delay_s <= 0:
            raise ValueError("target_delay_s must be > 0")
        if self.min_limit < 1:
            raise ValueError("min_limit must be >= 1")
        if self.increase < 1:
            raise ValueError("increase must be >= 1")
        if not 0.0 < self.decrease < 1.0:
            raise ValueError("decrease must be in (0, 1)")
        if self.brownout_exit >= self.brownout_enter:
            raise ValueError(
                "brownout_exit must be < brownout_enter (hysteresis)"
            )
        if self.brownout_max_lag < 0:
            raise ValueError("brownout_max_lag must be >= 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class LagSource:
    """One downstream lag feed with its low/high watermarks.

    `fn()` returns the current lag (log positions, or any monotone
    unit the watermarks share). Pressure is the clamped fraction
    `(lag - low) / (high - low)`: 0 below `low` (no influence), in
    (0, 1) between (admission growth pauses), >= 1 at/above `high`
    (admission shrinks multiplicatively every round)."""

    name: str
    fn: Callable[[], int]
    low: int
    high: int

    def __post_init__(self):
        if not 0 <= self.low < self.high:
            raise ValueError(
                f"lag source {self.name!r} needs 0 <= low < high "
                f"(got {self.low}, {self.high})"
            )

    def pressure(self) -> float:
        lag = float(self.fn())
        return (lag - self.low) / (self.high - self.low)


class OverloadGovernor:
    """Per-frontend adaptive-admission state (one AIMD loop per
    replica, one shared brownout mode + backpressure view).

    The frontend constructs one when `ServeConfig.overload` is set,
    registers each served replica, calls `on_round` from every worker
    after its batch, and consults `limit(rid)` at admission and
    `brownout()` on the read path. All methods are thread-safe."""

    def __init__(self, cfg: OverloadConfig, queue_depth: int,
                 deadline_s: float | None = None,
                 pipeline_depth: int = 0):
        self.cfg = cfg
        self._depth = int(queue_depth)
        self._deadline_s = deadline_s
        #: serve-pipeline overlap depth (`ServeConfig.pipeline_depth`).
        #: The controller needs no special casing for it — the
        #: queue-delay signal it keys on is measured at batch ASSEMBLY
        #: (`ServeFrontend._sweep_batch`), so a pipelined round's
        #: in-flight time never double-counts into the sojourn signal;
        #: pipelining simply shrinks the measured delay, and the AIMD
        #: loop converts that into admission headroom. Recorded here
        #: so `stats()` (and the bench CSVs) can attribute a run's
        #: limits to its overlap mode.
        self.pipeline_depth = int(pipeline_depth)
        self._lock = make_lock("OverloadGovernor._lock")
        self._limits: dict[int, float] = {}
        self._gauges: dict[int, object] = {}
        self._sources: list[LagSource] = []
        self._ewma: float = 0.0
        self._brownout = False
        self._brownout_reads = 0
        self._max_brownout_lag = 0

        reg = get_registry()
        self._m_delay = reg.histogram("serve.queue_delay_s")
        self._m_brownout = reg.counter("serve.brownout.entered")
        self._m_brownout_reads = reg.counter("serve.brownout.reads")
        self._m_evicted = reg.counter("serve.evicted")
        self._m_shed_prio = [
            reg.counter(f"serve.shed.{n}") for n in PRIORITY_NAMES
        ]
        self._g_pressure = reg.gauge("serve.backpressure")
        self._m_lat = reg.histogram("serve.request.latency_s")

    # --------------------------------------------------------- topology

    def register_replica(self, rid: int) -> None:
        """Start replica `rid` at the full static depth (the controller
        only *removes* admission under measured congestion — a cold
        start must not shed)."""
        with self._lock:
            self._limits.setdefault(rid, float(self._depth))
            self._gauges.setdefault(
                rid, get_registry().gauge(f"serve.admit_limit.r{rid}")
            )

    def add_source(self, source: LagSource) -> None:
        """Attach a downstream lag feed (see module docstring for the
        built-in wirings). Sources are polled once per `on_round`."""
        with self._lock:
            if any(s.name == source.name for s in self._sources):
                raise ValueError(
                    f"lag source {source.name!r} already attached"
                )
            self._sources.append(source)

    # -------------------------------------------------------- hot reads

    def limit(self, rid: int) -> int:
        """Current admission bound for replica `rid` (falls back to
        the static depth for a replica never registered)."""
        # nrcheck: unshared — GIL-atomic dict read; admission hot path
        lim = self._limits.get(rid)
        return self._depth if lim is None else int(lim)

    def brownout(self) -> bool:
        # nrcheck: unshared — GIL-atomic flag read; admission hot path
        return self._brownout

    # ------------------------------------------------------ control loop

    def backpressure(self) -> float:
        """Max pressure over the attached lag sources (0 = none,
        >= 1 = past a high watermark). Polled outside the lock — a
        source callback touching the wrapper must not deadlock a
        concurrent `on_round`."""
        with self._lock:
            sources = list(self._sources)
        pressure = 0.0
        for s in sources:
            pressure = max(pressure, s.pressure())
        return max(0.0, pressure)

    def on_round(self, rid: int, queue_delay_s: float,
                 n_ops: int) -> int:
        """One AIMD update from replica `rid`'s combiner round whose
        oldest request waited `queue_delay_s`. Returns the new limit
        (also published to the `serve.admit_limit.r{rid}` gauge)."""
        cfg = self.cfg
        pressure = self.backpressure()
        congested = (
            queue_delay_s > cfg.target_delay_s or pressure >= 1.0
        )
        if (not congested and self._deadline_s is not None
                and queue_delay_s > cfg.target_delay_s / 2):
            # the p99-vs-deadline signal: only meaningful once the
            # live histogram has enough samples to estimate a tail,
            # and only when the CURRENT round's delay corroborates —
            # the histogram is cumulative (process-global, never
            # decays), so without the corroboration gate one past
            # overload episode would read as congestion forever and
            # pin the limit at the floor long after recovery
            reg = get_registry()
            if reg.enabled and self._m_lat.count >= 64:
                p99 = self._m_lat.percentile(0.99)
                congested = p99 > cfg.deadline_p99 * self._deadline_s
        self._m_delay.observe(queue_delay_s)
        self._g_pressure.set(pressure)
        with self._lock:
            lim = self._limits.get(rid, float(self._depth))
            if congested:
                lim = max(float(cfg.min_limit), lim * cfg.decrease)
            elif pressure <= 0.0:
                lim = min(float(self._depth), lim + cfg.increase)
            # else: between watermarks — hold
            self._limits[rid] = lim
            a = cfg.ewma_alpha
            self._ewma = (1.0 - a) * self._ewma + a * queue_delay_s
            flipped = self._update_brownout_locked(pressure)
            gauge = self._gauges.get(rid)
            ewma = self._ewma
        if gauge is not None:
            gauge.set(lim)
        tracer = get_tracer()
        if flipped is not None:
            if flipped:
                self._m_brownout.inc()
            tracer.emit("serve-brownout", on=int(flipped),
                        ewma_delay_s=ewma, pressure=pressure)
        if tracer.enabled:
            tracer.emit("serve-admit-limit", rid=rid, limit=int(lim),
                        delay_s=queue_delay_s, pressure=pressure,
                        n=n_ops)
        return int(lim)

    def _update_brownout_locked(self, pressure: float) -> bool | None:
        """Hysteresis flip; returns the new mode on a transition,
        None when unchanged. Caller holds `_lock`."""
        cfg = self.cfg
        hot = (self._ewma > cfg.brownout_enter * cfg.target_delay_s
               or pressure >= 1.0)
        cool = (self._ewma < cfg.brownout_exit * cfg.target_delay_s
                and pressure < 1.0)
        if not self._brownout and hot:
            self._brownout = True
            return True
        if self._brownout and cool:
            self._brownout = False
            return False
        return None

    # ------------------------------------------------------- accounting

    def note_shed(self, priority: int, evicted: bool = False) -> None:
        """Metrics for one shed (or eviction) of a `priority`-class
        op. Plain-int accounting lives in `_SubmissionQueue` (the
        single source of truth the frontend aggregates — incl. the
        priority-inversion invariant counter); the governor only
        publishes the obs instruments."""
        self._m_shed_prio[priority].inc()
        if evicted:
            self._m_evicted.inc()

    def note_brownout_read(self, lag: int) -> None:
        self._m_brownout_reads.inc()
        with self._lock:
            self._brownout_reads += 1
            if lag > self._max_brownout_lag:
                self._max_brownout_lag = int(lag)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit("serve-brownout-read", lag=int(lag))

    def stats(self) -> dict:
        """Controller state incl. a live backpressure poll (the poll
        runs the source callbacks outside the governor lock — see
        `backpressure`). Shed/eviction/inversion counts are NOT here:
        `_SubmissionQueue` owns those and `ServeFrontend.stats()`
        aggregates them."""
        with self._lock:
            out = {
                "limits": {r: int(v)
                           for r, v in sorted(self._limits.items())},
                "pipeline_depth": self.pipeline_depth,
                "ewma_delay_s": self._ewma,
                "brownout": self._brownout,
                "brownout_reads": self._brownout_reads,
                "max_brownout_lag": self._max_brownout_lag,
                "sources": [s.name for s in self._sources],
            }
        out["backpressure"] = self.backpressure()
        return out
