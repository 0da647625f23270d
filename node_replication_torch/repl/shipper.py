"""WAL shipper: streams a primary's write-ahead log into a feed.

The port's copy of `node_replication_tpu/repl/shipper.py`, over the
port's `durable/wal.py` (whose records are the reference's bytes).

The primary half of log-shipping replication (`repl/`): a background
thread follows the primary's `durable/wal.py:WriteAheadLog` — closed
segments first, then a tailing read of the active segment, both
through the WAL's own position-ordered `records()` reader — and
publishes every fsynced record into a `repl/feed.py:Feed`, stamped
with the primary's epoch. Only records at or below `durable_tail` are
shipped: the feed never holds an op the primary could still lose, so
follower state is always a prefix-fold of durable primary history.

Reclamation safety: the shipper PINS the WAL at its ship cursor
(`WriteAheadLog.set_pin`) and advances the pin only after the record
is published, so segment reclamation (snapshot floor + GC head,
`maybe_reclaim`) can never delete an unshipped segment out from under
the follower fleet.

Ship-before-ack (`barrier`): installed as the serve frontend's
`ack_barrier`, a durable-ack batch resolves only once the feed holds
its records — semi-synchronous replication. An ack then implies BOTH
"on the primary's disk" and "visible to the follower feed", which is
what makes promotion lossless for acked writes: the most-advanced
follower provably holds every acknowledged op (the zero-lost-acks
check of `chip_smoke.py`'s replicated flagship rests on exactly this).

Liveness: every ship loop iteration refreshes the feed's heartbeat
beacon (a monotonically increasing counter — the promotion watcher
detects CHANGE with its own monotonic clock, so no wall-clock
coordination is needed across processes). A shipper failure is never
swallowed: the error is recorded for `barrier` callers to observe
(acks stop — correct, they can no longer be replicated), reported to
the optional `fault/health.py:HealthTracker`, and counted.
"""

from __future__ import annotations

import logging
import threading

from node_replication_torch.analysis.locks import (
    make_condition,
    make_lock,
)

from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer, pos_sampled

logger = logging.getLogger("node_replication_torch")

#: WAL reclamation pin-name PREFIX (`WriteAheadLog.set_pin`). Each
#: shipper pins under its own `ship:<n>` key — pins are a shared
#: namespace on the WAL, and a fan-out primary can run several
#: consumers at once (two shippers, a snapshot transfer's
#: `snapshot-server:<n>` pin, `repl/transport.py`), so one consumer's
#: `clear_pin` must never release another's reclaim floor.
SHIP_PIN = "ship"

_pin_seq = 0
_pin_seq_lock = make_lock("shipper._pin_seq_lock")


def _next_pin_name() -> str:
    global _pin_seq
    with _pin_seq_lock:
        n = _pin_seq
        _pin_seq += 1
    return f"{SHIP_PIN}:{n}"


class ShipError(RuntimeError):
    """The shipper cannot (or can no longer) replicate — construction
    found an unshippable WAL, or `barrier` observed a dead/stopped
    ship loop. Acks gated on the barrier fail with this."""


class ReplicationShipper:
    """Follows a WAL and publishes its durable records into a feed.

    One shipper per primary per feed. `barrier(pos)` is the
    ship-before-ack hook for `ServeFrontend.ack_barrier`; `stats()`
    exposes the cursor/lag for ops tooling. Thread-safe: the ship
    loop, barrier callers (serve workers), and stop() all synchronize
    on one condition.
    """

    def __init__(
        self,
        wal,
        feed,
        epoch: int | None = None,
        poll_s: float = 0.002,
        heartbeat_interval_s: float = 0.05,
        barrier_timeout_s: float = 30.0,
        health=None,
        health_rid: int = 0,
        auto_start: bool = True,
        pin_name: str | None = None,
    ):
        self._wal = wal
        self._feed = feed
        #: this shipper's own WAL reclamation pin key (unique per
        #: instance by default; see `SHIP_PIN`)
        self.pin_name = pin_name or _next_pin_name()
        #: this primary's fencing epoch (stamped on every record). A
        #: fresh primary adopts the feed's current epoch; a promoted
        #: one passes the bumped epoch explicitly.
        self.epoch = feed.epoch() if epoch is None else int(epoch)
        self.poll_s = float(poll_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.barrier_timeout_s = float(barrier_timeout_s)
        #: optional `fault/health.py:HealthTracker` + the rid the
        #: shipper's failures are attributed to (the primary's slot)
        self.health = health
        self.health_rid = int(health_rid)

        # resume where the feed ends: re-publishing from 0 would be
        # idempotent (pos-keyed messages overwrite) but wasteful
        self._cursor = feed.tail_pos()
        if self._cursor < wal.base:
            raise ShipError(
                f"feed ends at {self._cursor} but the WAL has "
                f"reclaimed up to {wal.base}: positions "
                f"[{self._cursor}, {wal.base}) are unshippable — "
                f"re-seed the feed (the ship pin prevents this on a "
                f"live attachment)"
            )
        wal.set_pin(self.pin_name, self._cursor)

        self._cond = make_condition("ReplicationShipper._cond")
        self._published = self._cursor
        self._error: BaseException | None = None
        self._stop = False
        self._hb_seq = 0
        self._hb_due = 0.0  # monotonic deadline for the next beacon

        reg = get_registry()
        self._m_records = reg.counter("repl.shipped_records")
        self._m_ops = reg.counter("repl.shipped_ops")
        self._m_errors = reg.counter("repl.ship_errors")
        self._g_lag_pos = reg.gauge("repl.ship_lag_pos")
        self._g_lag_bytes = reg.gauge("repl.ship_lag_bytes")

        self._thread = threading.Thread(
            target=self._ship_loop, name="repl-shipper", daemon=True,
        )
        if auto_start:
            self.start()

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self._thread.is_alive() and not self._thread.ident:
            self._thread.start()

    def stop(self, clear_pin: bool = True,
             timeout: float | None = 5.0) -> None:
        """Stop the ship loop (joins it) and, by default, release the
        WAL reclamation pin — call with `clear_pin=False` to keep
        unshipped segments protected for a successor shipper."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.ident:
            self._thread.join(timeout)
        if clear_pin:
            self._wal.clear_pin(self.pin_name)

    # -------------------------------------------------------- ship loop

    def _ship_loop(self) -> None:
        while True:
            try:
                self._ship_once()
            # a dead shipper must never be silent: the failure is
            # recorded for barrier callers (durable acks stop) and
            # reported to the health tracker when one is attached
            except Exception as e:
                self._record_failure(e)
                return
            with self._cond:
                if self._stop:
                    return
                if self._error is None and \
                        self._cursor >= self._wal.durable_tail:
                    get_clock().wait(self._cond, self.poll_s)

    def _ship_once(self) -> None:
        fault_hook("ship", -1, self)
        self._maybe_heartbeat()
        target = self._wal.durable_tail
        # nrcheck: unshared — ship thread is _cursor's only writer
        cur = self._cursor
        if cur >= target:
            return
        tracer = get_tracer()
        aw = getattr(self._wal, "arg_width", 3)
        for rec in self._wal.records(start=cur):
            if rec.pos >= target:
                break  # past the fsync boundary: not yet shippable
            self._feed.publish_record(self.epoch, rec)
            end = rec.pos + rec.count
            with self._cond:
                self._cursor = end
                self._published = end
                self._cond.notify_all()
            # pin AFTER publish: reclamation may now pass this record
            self._wal.set_pin(self.pin_name, end)
            self._m_records.inc()
            self._m_ops.inc(rec.count)
            lag = max(0, self._wal.durable_tail - end)
            self._g_lag_pos.set(lag)
            # payload bytes per op are fixed by the arg width (the
            # WAL's dense int32 framing), so position lag converts
            # exactly
            self._g_lag_bytes.set(lag * 4 * (1 + aw))
            # per-record hop event, thinned by the fleet sampling
            # modulus (NR_TPU_TRACE_SAMPLE) so tracing stays
            # affordable under load; sampling is a pure function of
            # `pos`, so every process narrates the SAME records
            if tracer.enabled and pos_sampled(rec.pos):
                tracer.emit("repl-ship", pos=rec.pos, n=rec.count,
                            epoch=self.epoch, lag=lag)
            self._maybe_heartbeat()

    def _maybe_heartbeat(self) -> None:
        now = get_clock().now()
        if now < self._hb_due:
            return
        self._hb_due = now + self.heartbeat_interval_s
        self._hb_seq += 1
        self._feed.write_heartbeat(
            # nrcheck: unshared — ship thread, own write
            f"{self.epoch} {self._hb_seq} {self._cursor}"
        )

    def _record_failure(self, exc: BaseException) -> None:
        """Surface a ship-loop failure: wake barrier waiters (their
        acks must fail, not hang), count it, report it to the health
        tracker. The sanctioned worker-exception path the nrlint
        `swallowed-worker-exception` sweep recognizes."""
        with self._cond:
            self._error = exc
            self._cond.notify_all()
        self._m_errors.inc()
        get_tracer().emit("repl-ship-error", epoch=self.epoch,
                          # nrcheck: unshared — ship thread, own write
                          cursor=self._cursor,
                          cause=type(exc).__name__)
        logger.exception("replication shipper failed at cursor %d",
                         # nrcheck: unshared — ship thread, own write
                         self._cursor)
        if self.health is not None:
            self.health.report_worker_exception(self.health_rid, exc)

    # ---------------------------------------------------------- barrier

    def barrier(self, pos: int, timeout: float | None = None) -> None:
        """Block until the feed holds every record below `pos` — the
        ship-before-ack hook (`ServeFrontend.ack_barrier`). Raises
        `ShipError` when the ship loop has died, was stopped, or the
        timeout (default `barrier_timeout_s`) expires; the serve layer
        maps that to its maybe_executed rejection (the ops are in the
        log and WILL replay; they were just never replicated, so an
        ack would overpromise)."""
        pos = int(pos)
        if timeout is None:
            timeout = self.barrier_timeout_s
        clock = get_clock()
        t_end = clock.now() + timeout
        with self._cond:
            self._cond.notify_all()  # kick the ship loop's poll wait
            while self._published < pos:
                if self._error is not None:
                    raise ShipError(
                        f"shipper failed; records below {pos} are not "
                        f"replicated"
                    ) from self._error
                if self._stop:
                    raise ShipError("shipper stopped")
                rem = t_end - clock.now()
                if rem <= 0:
                    raise ShipError(
                        f"ship barrier timed out after {timeout}s "
                        f"(published {self._published} < {pos})"
                    )
                clock.wait(self._cond, min(rem, 0.05))

    # ------------------------------------------------------------ state

    @property
    def cursor(self) -> int:
        """Next unshipped logical position."""
        # nrcheck: unshared — lock-free poll; one int load
        return self._cursor

    @property
    def error(self) -> BaseException | None:
        # nrcheck: unshared — lock-free poll; one reference load
        return self._error

    def lag(self) -> int:
        """Positions fsynced on the primary but not yet shipped."""
        # nrcheck: unshared — lock-free poll; approximate by design
        return max(0, self._wal.durable_tail - self._cursor)

    def install_backpressure(self, frontend, low: int = 512,
                             high: int = 4096) -> None:
        """Feed this shipper's lag into the frontend's admission
        controller (`serve/overload.py:LagSource` watermarks): between
        `low` and `high` admission stops growing; at/above `high` it
        shrinks multiplicatively every round. Combined with
        `barrier` installed as the frontend's `ack_barrier`
        (ship-before-ack), this closes the loop the overload plane
        promises — semi-sync replication can never build an unbounded
        ship backlog, because the primary slows admission instead.
        Requires the frontend's overload plane
        (`ServeConfig(overload=...)`); raises otherwise."""
        frontend.add_backpressure_source("ship", self.lag, low, high)

    def stats(self) -> dict:
        with self._cond:
            return {
                "epoch": self.epoch,
                "cursor": self._cursor,
                "published": self._published,
                "lag_pos": self.lag(),
                "stopped": self._stop,
                "error": (
                    None if self._error is None
                    else f"{type(self._error).__name__}: {self._error}"
                ),
            }
