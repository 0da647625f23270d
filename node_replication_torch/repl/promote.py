"""Promotion: primary-death detection, election, measured-RTO failover.

The port's copy of `node_replication_tpu/repl/promote.py`, over the
port's `fault/health.py` state machine.

The coordinator half of `repl/` failover, built on the SAME health
machine the in-process replica lifecycle uses (`fault/health.py`):
the `PromotionManager` tracks the PRIMARY PROCESS as replica
`health_rid` of a `HealthTracker` and walks it

    HEALTHY -> SUSPECT -> QUARANTINED

on missed heartbeats, exactly as a dead serve worker walks an
in-process replica. Detection is heartbeat-CHANGE based: the shipper
refreshes a beacon in the feed every loop (`repl/shipper.py`), and
the watcher compares successive reads with its OWN monotonic clock —
no wall-clock agreement between processes is required, so NTP steps
and clock skew cannot fake (or mask) a death.

On QUARANTINED the manager elects the MOST-ADVANCED follower (max
`applied_pos()` — with ship-before-ack every acked write is at or
below the feed tail, and the drain during `Follower.promote` brings
the winner to the tail, so no acked write can be lost by electing
any live follower; electing the most advanced just minimizes drain
time) and promotes it: epoch fence + drain + WAL fsync + write
re-home (`Follower.promote`; fence-first, so the drain is bounded and
no zombie record can land mid-drain).

The `PromotionReport` carries the measured recovery timeline:
`detect_s` (last observed heartbeat change -> quarantine),
`promote_s` (drain/fence/re-home duration), and `rto_s` (their sum —
outage start to writes-served-again, the RTO `chip_smoke.py`'s
replicated flagship reports).
"""

from __future__ import annotations

import dataclasses
import logging
import threading

from node_replication_torch.analysis.locks import make_lock

from node_replication_torch.fault.health import (
    HEALTHY,
    QUARANTINED,
    SUSPECT,
    HealthTracker,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

logger = logging.getLogger("node_replication_torch")


@dataclasses.dataclass
class PromotionReport:
    """One completed failover, timed (JSON-safe)."""

    follower: str  # elected follower's name
    new_epoch: int
    applied_pos: int
    drained_records: int
    detect_s: float  # heartbeat silence -> primary declared dead
    promote_s: float  # drain + fence + re-home
    rto_s: float  # outage start -> writes served again

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PromotionManager:
    """Watches a primary's heartbeat; elects and promotes on death.

    `check()` is one watch step (call it on any cadence);
    `start()`/`wait()` run the watch on a daemon thread and hand back
    the `PromotionReport` once a promotion completes. `promote_now()`
    is the operator's manual failover entry (skips detection).
    """

    def __init__(
        self,
        feed,
        followers,
        heartbeat_timeout_s: float = 0.5,
        check_interval_s: float = 0.05,
        health: HealthTracker | None = None,
        health_rid: int = 0,
    ):
        if not followers:
            raise ValueError("need at least one follower to promote")
        self._feed = feed
        self.followers = list(followers)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.check_interval_s = float(check_interval_s)
        # the primary occupies slot `health_rid` of the tracker — the
        # same machine (and the same legality rules) the in-process
        # lifecycle walks; 3 missed-beat strikes suspect it, silence
        # past 2x the timeout quarantines it
        self.health = health or HealthTracker(
            max(1, health_rid + 1), stall_threshold=3
        )
        self.health_rid = int(health_rid)

        # nrcheck: lock-order PromotionManager._lock -> HealthTracker._lock — election consults replica health under the manager lock
        self._lock = make_lock("PromotionManager._lock")
        self._last_hb: str | None = None
        self._last_change = get_clock().now()
        # silence counts only once a primary has been OBSERVED: a
        # watcher armed before the primary finishes booting (or with
        # no primary at all) must not fail over onto thin air —
        # promotion presumes there was acked history to take over
        self._seen = False
        self._report: PromotionReport | None = None
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        self._stop = False
        # `repl.promotions` itself is counted inside Follower.promote;
        # the manager only adds the detection timing on top
        get_registry().counter("repl.promotions")

    # ------------------------------------------------------------ watch

    def check(self) -> str:
        """One watch step: read the beacon, credit a change, strike
        silence. Returns the primary's current health state; when the
        step quarantines the primary, the caller should promote
        (`run()`/the watch thread do so automatically)."""
        now = get_clock().now()
        hb = self._feed.read_heartbeat()
        with self._lock:
            if hb is None and not self._seen:
                # no primary has ever beaconed on this feed: nothing
                # to detect the death of (yet)
                self._last_change = now
                return self.health.state(self.health_rid)
            if hb != self._last_hb:
                self._seen = True
                self._last_hb = hb
                self._last_change = now
                if self.health.state(self.health_rid) == SUSPECT:
                    # the primary spoke again during probation
                    self.health.clear_suspect(self.health_rid)
                return self.health.state(self.health_rid)
            silent = now - self._last_change
        state = self.health.state(self.health_rid)
        if silent >= self.heartbeat_timeout_s and state == HEALTHY:
            # each silent check past the timeout is one stall strike;
            # stall_threshold of them suspect the primary
            state = self.health.report_stall(self.health_rid)
        if silent >= 2 * self.heartbeat_timeout_s and state == SUSPECT:
            self.health.quarantine(self.health_rid)
            state = QUARANTINED
        return state

    def elect(self):
        """The most-advanced live follower (max applied position)."""
        live = [f for f in self.followers if f.error is None]
        if not live:
            live = self.followers  # last resort: promote anyway
        return max(live, key=lambda f: f.applied_pos())

    def promote_now(self, detect_s: float = 0.0) -> PromotionReport:
        """Elect and promote immediately (detection already done, or
        operator-initiated failover)."""
        chosen = self.elect()
        t0 = get_clock().now()
        rep = chosen.promote()
        promote_s = get_clock().now() - t0
        report = PromotionReport(
            follower=rep["name"],
            new_epoch=rep["epoch"],
            applied_pos=rep["applied"],
            drained_records=rep["drained_records"],
            detect_s=detect_s,
            promote_s=promote_s,
            rto_s=detect_s + promote_s,
        )
        with self._lock:
            self._report = report
        self._done.set()
        get_tracer().emit(
            "repl-rto", follower=report.follower,
            detect_s=report.detect_s, promote_s=report.promote_s,
            rto_s=report.rto_s,
        )
        return report

    def run(self, timeout: float | None = None) -> PromotionReport | None:
        """Watch until the primary dies, then promote; returns the
        report (None when `timeout` expires with the primary alive).
        The watch thread (`start()`) runs exactly this."""
        clock = get_clock()
        t_end = (
            None if timeout is None else clock.now() + timeout
        )
        while True:
            with self._lock:
                if self._stop:
                    return self._report
            state = self.check()
            if state == QUARANTINED:
                with self._lock:
                    silence = clock.now() - self._last_change
                logger.warning(
                    "primary declared dead after %.2fs of heartbeat "
                    "silence; promoting", silence,
                )
                return self.promote_now(detect_s=silence)
            if t_end is not None and clock.now() >= t_end:
                return None
            clock.sleep(self.check_interval_s)

    # --------------------------------------------------------- threaded

    def start(self) -> None:
        """Run the watch on a daemon thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            t = threading.Thread(
                target=self._watch_loop, name="repl-promotion-watch",
                daemon=True,
            )
            self._thread = t
        t.start()

    def _watch_loop(self) -> None:
        try:
            self.run()
        # the watch dying silently would turn primary death into an
        # unbounded outage — record health and release waiters
        except Exception as e:
            logger.exception("promotion watch failed")
            self.health.report_worker_exception(self.health_rid, e)
        finally:
            self._done.set()

    def stop(self) -> None:
        """Stop the watch; `wait()` callers release (report may be
        None — the primary was alive when the watch stopped)."""
        with self._lock:
            self._stop = True
        self._done.set()

    def wait(self, timeout: float | None = None) -> PromotionReport | None:
        """Block until a promotion completes (None on timeout)."""
        self._done.wait(timeout)
        with self._lock:
            return self._report

    @property
    def report(self) -> PromotionReport | None:
        with self._lock:
            return self._report
