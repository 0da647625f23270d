"""Follower: replays a replication feed and serves bounded-staleness
reads.

The port's copy of `node_replication_tpu/repl/follower.py`. The fleet
is the port's `NodeReplicated`, built by `recover_fleet(...,
nr_kwargs=)` on the card unless `nr_kwargs` asks for another device.
On a hashmap fleet with `engine="pallas"` every applied record is one
fused combiner round: one K1 launch (`csrc/hashmap_replay.cu`) at R =
the fleet's replicas and W = the record's op count, issued on the apply
thread's current CUDA stream. No response is read back, so the applied
cursor advances once K1 is queued; a read (`execute` on the reading
thread) is ordered after it because both threads issue on the device's
default stream, and its host read-back waits for the kernel. `obs_port`
needs `obs/export.py`, which this package does not have yet, and
raises `NotImplementedError`. One knob is the port's own: `rids=`
names the replicas the read-only frontend serves (None, the default,
serves every replica, as the reference does). The frontend starts one
worker thread per served replica, and a fleet of 4096 replicas would
start 4096 of them, more threads than some hosts allow one process
(a sandboxed H100 host killed one at 2,000-4,000).

The read-scale-out half of `repl/`: a follower process boots from its
own durability directory (`durable/recovery.py:recover_fleet` — empty
dir = fresh boot, populated dir = crash-resume at the journaled tail),
then follows the primary's feed on an apply thread. Every received
record replays through the SAME combiner protocol live primary
traffic uses (`NodeReplicated._append_and_replay`), and is journaled
into the follower's OWN write-ahead log by that protocol — so
follower state is bit-identical to the primary's fold at every common
position (deterministic replay, the repo's recovery property), and a
follower can itself be promoted, crash-recovered, or used to seed
further followers.

Apply rules (the feed's delivery edge cases, `repl/feed.py`):

- records that chain onto the applied cursor apply;
- records wholly below it are DUPLICATES and skip idempotently
  (`repl.duplicate_records`) — re-shipping is always safe;
- records straddling it are sliced (the overlap is the duplicate
  prefix);
- a record starting past it is a typed `FeedGapError` — the apply
  thread records the failure (health API + error slot) rather than
  silently skipping acknowledged history;
- a record with an epoch OLDER than one already applied is a zombie
  primary's late write: fenced (`repl.fenced_records`), never applied.

Reads go through a read-only `ServeFrontend` (writes reject with
`NotPrimary` until promotion) at a bounded-staleness cursor:
`read(op, max_lag_pos=K)` resolves the bound against the feed's
readable tail and waits until the serving replica has applied within
K positions of it, rejecting with typed `StaleRead` past the allowed
wait — a client can buy freshness with latency, per-read.

`promote()` is the failover half (`repl/promote.py` drives it): stop
applying, bump the feed's fencing epoch so the dead primary's late
records are rejected at the transport (fence-first bounds the drain
and closes the mid-drain zombie window), drain every remaining
readable record from the feed (torn-tail rules: an incomplete
trailing message is dropped — ship-before-ack means nothing acked was
on it), fsync the follower's WAL, and flip the frontend into write
serving (`enable_writes`). Durable-ack serving resumes exactly where
the acked history ends.
"""

from __future__ import annotations

import logging
import threading
from typing import Sequence

from node_replication_torch.analysis.locks import make_condition

from node_replication_torch.durable.recovery import recover_fleet
from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.repl.feed import FeedGapError
from node_replication_torch.serve.errors import StaleRead
from node_replication_torch.serve.frontend import ServeConfig, ServeFrontend
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer, pos_sampled, span

logger = logging.getLogger("node_replication_torch")


class Follower:
    """One follower node: recovered wrapper + apply thread + read-only
    serve frontend.

        feed = DirectoryFeed(shared_dir)
        f = Follower(dispatch, feed, directory=my_dir)
        v = f.read((HM_GET, k), max_lag_pos=64)   # bounded staleness
        ...primary dies...
        f.promote()                               # now serves writes
    """

    def __init__(
        self,
        dispatch,
        feed,
        directory: str,
        config: ServeConfig | None = None,
        poll_s: float = 0.002,
        health=None,
        health_rid: int = 0,
        nr_kwargs: dict | None = None,
        auto_start: bool = True,
        name: str = "follower",
        bootstrap: bool = True,
        obs_port: int | None = None,
        obs_node_id: str | None = None,
        rids: Sequence[int] | None = None,
    ):
        if obs_port is not None:
            raise NotImplementedError(
                "Follower(obs_port=...) needs obs/export.py, which this "
                "package does not have yet"
            )
        self.name = name
        self._feed = feed
        self._poll_s = float(poll_s)
        self.health = health
        self.health_rid = int(health_rid)

        # snapshot bootstrap (the cold-follower fast path): when the
        # feed can serve snapshots (`repl/transport.py:SocketFeed`
        # against a `FeedServer` with a snapshot source), fetch the
        # newest one strictly past what this directory already covers
        # BEFORE recovery — `recover_fleet` then digest-validates it,
        # boots from it, and the apply thread streams only
        # `[snapshot_pos, tail)` instead of replaying the whole
        # history. Bounded catch-up; a fetch failure falls back to
        # full replay (counted), never a dead follower.
        self.bootstrap_report: tuple[int, str] | None = None
        fetch = getattr(feed, "fetch_snapshot", None)
        if bootstrap and fetch is not None:
            self.bootstrap_report = self._bootstrap_snapshot(
                directory, fetch
            )

        # boot (or crash-resume) from the follower's own durability
        # directory; the WAL comes back attached at the recovered
        # tail, so applied records keep journaling seamlessly
        self.nr, self.recovery_report = recover_fleet(
            directory, dispatch, policy="batch", attach=True,
            nr_kwargs=nr_kwargs,
        )
        self._cond = make_condition("Follower._cond")
        self._applied = int(self.nr.log.tail)
        #: highest epoch among APPLIED records (the zombie fence
        #: floor) — starts at 0, NOT feed.epoch(): a follower seeded
        #: (or crash-resumed) behind a promotion point must still
        #: apply the older epochs' history below the fence; the floor
        #: rises as records apply, which is the documented rule
        self.epoch = 0
        self._error: BaseException | None = None
        self._stop = False
        self._promoted = False

        # durable-ack config by default: the frontend refuses durable
        # modes without a WAL, and recover_fleet attached one — so a
        # promoted follower serves the same ack contract the primary
        # did without rebuilding anything
        cfg = config or ServeConfig(durability="batch")
        self.frontend = ServeFrontend(self.nr, cfg, rids=rids,
                                      read_only=True)

        reg = get_registry()
        self._m_records = reg.counter("repl.applied_records")
        self._m_ops = reg.counter("repl.applied_ops")
        self._m_dups = reg.counter("repl.duplicate_records")
        self._m_fenced = reg.counter("repl.fenced_records")
        self._m_gaps = reg.counter("repl.feed_gaps")
        self._m_stale = reg.counter("repl.stale_reads")
        self._m_errors = reg.counter("repl.apply_errors")
        self._g_lag = reg.gauge("repl.apply_lag_pos")
        self._g_staleness = reg.gauge("repl.read_staleness_pos")

        self._thread = threading.Thread(
            target=self._apply_loop, name=f"repl-apply-{name}",
            daemon=True,
        )
        if auto_start:
            self.start()

    # -------------------------------------------------------- bootstrap

    def _bootstrap_snapshot(self, directory: str,
                            fetch) -> tuple[int, str] | None:
        """Fetch the newest upstream snapshot strictly past what this
        directory's own newest snapshot covers. Returns `(pos, path)`
        when one landed (then `recover_fleet` validates its digest and
        boots from it — a corrupt transfer is skipped there, falling
        back to older bases + longer replay, never trusted blindly)."""
        from node_replication_torch.durable.recovery import list_snapshots

        have = 0
        snaps = list_snapshots(directory)
        if snaps:
            have = snaps[0][0]
        try:
            got = fetch(directory, min_pos=have)
        except Exception as e:
            # a degraded sidecar is not fatal: the apply thread can
            # always replay the full feed instead
            get_registry().counter(
                "repl.snapshot.bootstrap_failures"
            ).inc()
            get_tracer().emit("repl-bootstrap-failed", name=self.name,
                             cause=type(e).__name__)
            logger.warning(
                "follower %s: snapshot bootstrap failed (%s: %s); "
                "falling back to full replay", self.name,
                type(e).__name__, e,
            )
            return None
        if got is None:
            return None
        pos, path = got
        get_registry().counter("repl.snapshot.bootstraps").inc()
        get_tracer().emit("repl-bootstrap", name=self.name,
                         pos=int(pos), had=have)
        return int(pos), path

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self._thread.is_alive() and not self._thread.ident:
            self._thread.start()

    def stop_apply(self, timeout: float | None = 5.0) -> None:
        """Stop the apply thread (idempotent; promotion's first step)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.ident:
            self._thread.join(timeout)

    def close(self) -> None:
        """Stop applying, close the frontend, release the WAL."""
        self.stop_apply()
        self.frontend.close()
        wal = self.nr.detach_wal()
        if wal is not None:
            wal.close()

    # ------------------------------------------------------- apply loop

    def _apply_loop(self) -> None:
        while True:
            try:
                self._apply_once()
            # gap/corruption/replay failures must surface: readers
            # keep serving (bounded staleness still holds at the
            # stalled cursor) but the lag stops shrinking — record
            # the error and report replica health instead of spinning
            except Exception as e:
                self._record_failure(e)
                return
            with self._cond:
                if self._stop:
                    return
                get_clock().wait(self._cond, self._poll_s)

    def _apply_once(self, drain: bool = False) -> int:
        """Poll the feed once and apply everything readable. Returns
        the number of records applied. `drain=True` (the promotion
        path) ignores the stop flag so the backlog flushes whole."""
        fault_hook("repl-apply", -1, self)
        # _applied/epoch reads in the apply path below: the apply
        # thread is their only writer after __init__ (promote() joins
        # the thread first), so lock-free reads here cannot be stale
        records = self._feed.poll(self._applied)  # nrcheck: unshared
        applied = 0
        tail = (
            records[-1].pos + records[-1].count if records else 0
        )
        for rec in records:
            if self._apply_record(rec, feed_tail=tail):
                applied += 1
            with self._cond:
                if self._stop and not drain:
                    break
        if records:
            # nrcheck: unshared — apply thread, own write
            self._g_lag.set(max(0, tail - self._applied))
        return applied

    def _apply_record(self, rec, feed_tail: int = 0) -> bool:
        """Apply one feed record against the cursor rules; returns
        True when it advanced the applied position. `feed_tail` (the
        poll batch's end position) feeds the per-record lag stamp on
        the `repl-apply` event."""
        expected = self._applied  # nrcheck: unshared — apply-only write
        end = rec.pos + rec.count
        if rec.epoch < self.epoch:  # nrcheck: unshared — apply-only write
            # zombie fence: a record stamped by a superseded primary
            # arriving after a newer epoch was applied — reject, the
            # new primary's history owns these positions
            self._m_fenced.inc()
            get_tracer().emit("repl-fenced-record", pos=rec.pos,
                              # nrcheck: unshared — apply thread
                              epoch=rec.epoch, current=self.epoch)
            return False
        if end <= expected:
            # duplicate delivery (shipper resume / re-ship): skip
            self._m_dups.inc()
            get_tracer().emit("repl-dup", pos=rec.pos, n=rec.count)
            return False
        if rec.pos > expected:
            self._m_gaps.inc()
            raise FeedGapError(expected, rec.pos)
        ops = rec.ops()[expected - rec.pos:]  # slice the overlap away
        # the SAME combiner protocol live traffic uses — and the
        # follower's own attached WAL journals the batch inside it; on
        # a fused hashmap fleet this is one K1 launch
        self.nr._append_and_replay(ops, 0, [])
        with self._cond:
            self._applied = expected + len(ops)
            if rec.epoch > self.epoch:
                self.epoch = rec.epoch
            self._cond.notify_all()
        self._m_records.inc()
        self._m_ops.inc(len(ops))
        tracer = get_tracer()
        # per-record hop event, sampled on `pos` like every other hop
        # (NR_TPU_TRACE_SAMPLE) — a sampled record's apply is always
        # narrated, an unsampled one never is, on every follower alike
        if tracer.enabled and pos_sampled(rec.pos):
            tracer.emit("repl-apply", pos=rec.pos, n=len(ops),
                        # nrcheck: unshared — apply thread, own write
                        epoch=rec.epoch, applied=self._applied,
                        # nrcheck: unshared — apply thread, own write
                        lag=max(0, feed_tail - self._applied),
                        name=self.name)
        return True

    def _record_failure(self, exc: BaseException) -> None:
        """Surface an apply failure (the nrlint-sanctioned worker
        exception path): error slot for callers, health report when a
        tracker is attached, counter + trace event."""
        with self._cond:
            self._error = exc
            self._cond.notify_all()
        self._m_errors.inc()
        # nrcheck: unshared — apply thread, own write
        get_tracer().emit("repl-apply-error", applied=self._applied,
                          cause=type(exc).__name__)
        logger.exception("follower %s apply failed at %d", self.name,
                         # nrcheck: unshared — apply thread, own write
                         self._applied)
        if self.health is not None:
            self.health.report_worker_exception(self.health_rid, exc)

    # ------------------------------------------------------------ state

    def applied_pos(self) -> int:
        """Logical position this follower has applied (and journaled)
        up to — the promotion election key."""
        with self._cond:
            return self._applied

    def lag(self) -> int:
        """Positions the feed holds that this follower has not yet
        applied — the apply-lag backpressure signal. Register it on
        the primary frontend's admission controller
        (`frontend.add_backpressure_source("apply", follower.lag,
        low, high)`, in-process deployments) so a follower falling
        behind slows primary admission instead of lagging without
        bound; cross-process deployments feed the same number from
        `repl.apply_lag_pos` through their own channel."""
        with self._cond:
            applied = self._applied
        return max(0, self._feed.tail_pos() - applied)

    @property
    def error(self) -> BaseException | None:
        # nrcheck: unshared — lock-free poll; one reference load
        return self._error

    @property
    def promoted(self) -> bool:
        # nrcheck: unshared — lock-free poll; one bool load
        return self._promoted

    def wait_applied(self, pos: int,
                     timeout: float | None = None) -> bool:
        """Block until the applied cursor reaches `pos` (test/ops
        barrier). False on timeout or a dead apply thread."""
        clock = get_clock()
        t_end = (
            None if timeout is None else clock.now() + timeout
        )
        with self._cond:
            while self._applied < pos:
                if self._error is not None or self._stop:
                    return False
                rem = (
                    None if t_end is None else t_end - clock.now()
                )
                if rem is not None and rem <= 0:
                    return False
                clock.wait(
                    self._cond, rem if rem is None else min(rem, 0.05)
                )
            return True

    def stats(self) -> dict:
        with self._cond:
            return {
                "applied": self._applied,
                "epoch": self.epoch,
                "promoted": self._promoted,
                "stopped": self._stop,
                "error": (
                    None if self._error is None
                    else f"{type(self._error).__name__}: {self._error}"
                ),
            }

    # ------------------------------------------------------------- read

    def read_result(self, op: tuple, rid: int = 0,
                    max_lag_pos: int | None = None,
                    min_pos: int | None = None,
                    wait_s: float = 0.5) -> tuple:
        """Bounded-staleness read; returns `(value, applied, bound)`.

        `max_lag_pos=K` resolves to the absolute bound
        `feed.tail_pos() - K` — the read reflects every op except at
        most the K newest the feed holds. An explicit `min_pos`
        (read-your-writes: pass the position an earlier ack reported)
        composes with it; the tighter bound wins. Waits up to
        `wait_s`, then rejects with `StaleRead` (counted in
        `repl.stale_reads`)."""
        bound = min_pos
        tail = None  # one feed scan per read, reused for the gauge
        if max_lag_pos is not None:
            tail = self._feed.tail_pos()
            lag_bound = max(0, tail - int(max_lag_pos))
            bound = lag_bound if bound is None else max(bound, lag_bound)
        try:
            value = self.frontend.read(op, rid=rid, min_pos=bound,
                                       wait_s=wait_s)
        except StaleRead as e:
            self._m_stale.inc()
            get_tracer().emit("repl-stale-read", rid=rid,
                              applied=e.applied_pos, bound=e.min_pos)
            raise
        applied = self.applied_pos()
        if bound is not None and applied < bound:
            # the bound was enforced against the replica's ltail
            # inside the read; the feed cursor trails it by a few
            # statements in _apply_record — report the position the
            # read actually observed, never one below its own bound
            applied = int(self.nr.ltail(rid))
        if bound is not None:
            if tail is None:
                tail = self._feed.tail_pos()
            self._g_staleness.set(max(0, tail - applied))
        return value, applied, (0 if bound is None else bound)

    def read(self, op: tuple, rid: int = 0,
             max_lag_pos: int | None = None,
             min_pos: int | None = None, wait_s: float = 0.5):
        """`read_result` returning just the value."""
        return self.read_result(op, rid=rid, max_lag_pos=max_lag_pos,
                                min_pos=min_pos, wait_s=wait_s)[0]

    # -------------------------------------------------------- promotion

    def promote(self, drain_timeout_s: float = 10.0) -> dict:
        """Take over as primary (the election already happened —
        `repl/promote.py` picks the most-advanced follower and calls
        this). Returns a report dict; also counted
        (`repl.promotions`) and emitted as `repl-promote`.

        Steps, in order: stop applying; FENCE the feed's epoch above
        every epoch ever applied, so the old primary's late records
        are rejected at the transport — fencing FIRST makes the drain
        bounded (nothing new can land) and closes the window where a
        still-live zombie slips a record into the feed mid-drain that
        a second follower would apply, silently diverging; DRAIN
        every remaining readable feed record (the dead primary's last
        shipped batches — an incomplete trailing message is dropped
        under the torn-tail rule, and ship-before-ack means no acked
        op was on it; the apply-side epoch floor stays at the OLD
        epoch until the drain completes, so the drained records are
        not self-fenced); fsync the follower's WAL (the drained
        records become durable history HERE before any new ack is
        issued); re-home write serving (`enable_writes`)."""
        t0 = get_clock().now()
        self.stop_apply()
        if self._thread.ident and self._thread.is_alive():
            # a wedged apply thread and the drain below would both
            # fold the same feed records — duplicated history; fail
            # the promotion so the election can pick another follower
            raise RuntimeError(
                f"follower {self.name}: apply thread still alive "
                f"after stop; draining now could double-apply"
            )
        # epoch/_applied reads below are safe lock-free: the apply
        # thread (their only other writer) was stopped and verified
        # dead above, so promotion is now the sole accessor
        new_epoch = self._feed.fence(
            # nrcheck: unshared — apply thread joined above
            max(self.epoch, self._feed.epoch()) + 1
        )
        # nrcheck: unshared — apply thread joined above
        with span("repl-promote-drain", applied=self._applied):
            drained = self._apply_once(drain=True)
            # keep draining until a poll finds nothing new: the feed
            # is fenced, so no writer can extend it — this terminates
            while True:
                more = self._apply_once(drain=True)
                if not more:
                    break
                drained += more
            # drain VERIFICATION: an empty poll is not proof over a
            # network feed — `SocketFeed.poll` degrades to [] on a
            # transient transport failure by design, and concluding
            # "drained" from a blip would silently drop acked records
            # the upstream still holds. The fence just succeeded over
            # the same transport and froze the tail, so re-poll until
            # the applied cursor covers the feed's readable tail;
            # past the deadline, FAIL the promotion loudly (the
            # election can pick another follower) rather than serve a
            # truncated history. (Local feeds exit on the first
            # check: their polls never lie.)
            clock = get_clock()
            t_dead = clock.now() + float(drain_timeout_s)
            while True:
                tail = int(self._feed.tail_pos())
                # nrcheck: unshared — apply thread joined above
                if self._applied >= tail:
                    break
                if clock.now() >= t_dead:
                    raise RuntimeError(
                        f"follower {self.name}: promotion drain "
                        # nrcheck: unshared — apply thread joined above
                        f"stalled at {self._applied} below the "
                        f"fenced feed tail {tail} (transport "
                        f"degraded?) — refusing to serve a "
                        f"truncated history"
                    )
                drained += self._apply_once(drain=True)
                clock.sleep(min(self._poll_s, 0.01))
        with self._cond:
            self.epoch = new_epoch
            self._promoted = True
        self.nr.wal_sync()
        self.frontend.enable_writes()
        dur = get_clock().now() - t0
        applied = self.applied_pos()
        get_registry().counter("repl.promotions").inc()
        get_tracer().emit(
            "repl-promote", epoch=new_epoch, applied=applied,
            drained_records=drained, duration_s=dur, name=self.name,
        )
        logger.warning(
            "follower %s promoted to primary: epoch %d, applied %d "
            "(%d record(s) drained, %.1fms)", self.name, new_epoch,
            applied, drained, dur * 1e3,
        )
        return {
            "name": self.name,
            "epoch": new_epoch,
            "applied": applied,
            "drained_records": drained,
            "duration_s": dur,
        }
