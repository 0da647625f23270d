"""Relay: a feed-of-feeds fan-out node for cross-host follower trees.

The port's copy of `node_replication_tpu/repl/relay.py`. It runs on the
host alone (no fleet, no kernel). `obs_port` needs `obs/export.py`,
which this package does not have yet, and raises
`NotImplementedError`.

A `RelayNode` is the interior node of a replication tree (1 primary →
R relays → N followers): it consumes ONE upstream record stream
(normally a `repl/transport.py:SocketFeed`, any feed-shaped source
works), journals every record into its own local `DirectoryFeed`, and
serves any number of downstream consumers from that journal through
its own `FeedServer`. Each primary record therefore crosses each tree
EDGE exactly once — a 1→8→64 tree costs the primary 8 downstream
streams, not 64 — and a relay crash loses nothing: the local journal
is the cursor, and the pump resumes from `local.tail_pos()`.

The pump applies the follower's delivery rules (`repl/feed.py`) on the
forwarding path:

- records chaining onto the journal cursor republish AS-IS (same
  epoch, same position — the journal is a byte-faithful copy, so
  downstream bit-identity composes through any relay depth);
- records wholly below the cursor are duplicates (upstream resume /
  re-ship) and skip idempotently;
- a record starting past the cursor is a typed `FeedGapError` — the
  relay surfaces it (health API + error slot) rather than forwarding
  a hole to its whole subtree;
- a record with an epoch older than the local journal's fence is a
  zombie primary's late write: the journal's own `EpochFencedError`
  rejects the publish, the relay counts it and drops the record —
  fenced history never reaches the subtree.

Promotion composes through relays: a downstream follower's
`promote()` fences its upstream feed — this relay's server fences the
LOCAL journal (so the pump can forward nothing older) and the relay
propagates the fence toward the primary best-effort (`on_fence` →
`upstream.fence`; a dead primary's unreachable server is fine — its
own late publishes die against apply-side fences and this journal's).

The heartbeat is forwarded VERBATIM: downstream watchers
(`repl/promote.py`) detect change in the PRIMARY's beacon, so a dead
primary is detected at every leaf even though the relay between them
is alive. (A dead relay also reads as silence below it — correct: its
subtree really is cut off.)

Snapshot bootstrap composes too: a downstream `fetch_snapshot` is
served from the relay's local snapshot cache, refreshed from upstream
at most once per newer-snapshot request — snapshots also ship once
per edge, not once per leaf.
"""

from __future__ import annotations

import logging
import os
import threading

from node_replication_torch.analysis.locks import (
    make_condition,
    make_lock,
)

from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.repl.feed import (
    DirectoryFeed,
    EpochFencedError,
    FeedGapError,
)
from node_replication_torch.repl.transport import FeedServer
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer, pos_sampled

logger = logging.getLogger("node_replication_torch")

#: local journal / snapshot-cache subdirectories of a relay directory
FEED_SUBDIR = "feed"
SNAP_CACHE_SUBDIR = "snapshots"


class RelayNode:
    """One interior tree node: upstream consumer + local journal +
    downstream server.

        up = SocketFeed(primary_host, primary_port, arg_width=aw)
        relay = RelayNode(up, directory=my_dir, arg_width=aw)
        host, port = relay.address        # hand to the subtree
    """

    def __init__(
        self,
        upstream,
        directory: str,
        arg_width: int = 3,
        host: str = "127.0.0.1",
        port: int = 0,
        poll_s: float = 0.002,
        health=None,
        health_rid: int = 0,
        auto_start: bool = True,
        name: str = "relay",
        obs_port: int | None = None,
        obs_node_id: str | None = None,
    ):
        if obs_port is not None:
            raise NotImplementedError(
                "RelayNode(obs_port=...) needs obs/export.py, which this "
                "package does not have yet"
            )
        self.name = name
        self.upstream = upstream
        self._poll_s = float(poll_s)
        self.health = health
        self.health_rid = int(health_rid)
        self._snap_cache = os.path.join(directory, SNAP_CACHE_SUBDIR)

        self.local = DirectoryFeed(
            os.path.join(directory, FEED_SUBDIR), arg_width=arg_width
        )
        # resume from the journal: everything below its tail already
        # reached (and is re-servable to) the subtree
        self._cursor = self.local.tail_pos()
        #: highest epoch among FORWARDED records (starts 0 like the
        #: follower's apply floor: a relay booted behind a promotion
        #: must still forward the older epochs' history below it)
        self.epoch = 0
        self._cond = make_condition("RelayNode._cond")
        self._error: BaseException | None = None
        self._stop = False
        self._last_hb: str | None = None
        self._snap_lock = make_lock("RelayNode._snap_lock")

        reg = get_registry()
        self._m_forwarded = reg.counter("repl.relay.forwarded_records")
        self._m_ops = reg.counter("repl.relay.forwarded_ops")
        self._m_dups = reg.counter("repl.relay.duplicate_records")
        self._m_fenced = reg.counter("repl.relay.fenced_records")
        self._m_errors = reg.counter("repl.relay.errors")
        self._g_lag = reg.gauge("repl.relay.lag_pos")

        self.server = FeedServer(
            self.local,
            host=host,
            port=port,
            snapshot_provider=self._snapshot_provider,
            on_fence=self._propagate_fence,
            auto_start=auto_start,
            name=f"{name}-server",
        )
        self._thread = threading.Thread(
            target=self._pump_loop, name=f"repl-relay-{name}",
            daemon=True,
        )
        if auto_start:
            self.start()

    @property
    def address(self) -> tuple[str, int]:
        """`(host, port)` the subtree connects to."""
        return self.server.address

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.server.start()
        if not self._thread.is_alive() and not self._thread.ident:
            self._thread.start()

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the pump (joins it); the server keeps serving the
        journal until `close()` — a wedged upstream must not cut off
        the subtree's reads."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.ident:
            self._thread.join(timeout)

    def close(self) -> None:
        self.stop()
        self.server.close()
        close = getattr(self.upstream, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "RelayNode":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- pump

    def _pump_loop(self) -> None:
        while True:
            try:
                self._pump_once()
            # a silent relay failure would starve the whole subtree:
            # record it (error slot + health + counter) and stop
            except Exception as e:
                self._record_failure(e)
                return
            with self._cond:
                if self._stop:
                    return
                get_clock().wait(self._cond, self._poll_s)

    def _pump_once(self) -> int:
        """Poll upstream once and journal everything readable;
        returns records forwarded. Single-driver (the pump thread, or
        tests calling it directly with `auto_start=False`)."""
        fault_hook("relay-pump", -1, self)
        # _cursor reads below: the pump is _cursor's only writer, and
        # this method is single-driver (see docstring) — a lock-free
        # read in the writing thread cannot be stale
        records = self.upstream.poll(self._cursor)  # nrcheck: unshared
        forwarded = 0
        tracer = get_tracer()
        for rec in records:
            end = rec.pos + rec.count
            if end <= self._cursor:  # nrcheck: unshared — pump-only write
                self._m_dups.inc()
                continue
            if rec.pos > self._cursor:  # nrcheck: unshared — pump-only write
                raise FeedGapError(self._cursor, rec.pos)  # nrcheck: unshared
            with self._cond:
                # snapshot the forwarding floor under the lock: a
                # server-thread fence (`_propagate_fence`) can raise
                # it concurrently, and a stale read here would
                # forward a record below the new floor
                epoch_floor = self.epoch
            if rec.epoch < epoch_floor:
                # zombie record below the forwarding floor: drop it
                # and advance PAST it — these positions belong to a
                # superseded history no consumer may ever see, and
                # re-polling them forever would wedge the pump
                self._m_fenced.inc()
                tracer.emit("relay-fenced", pos=rec.pos,
                            epoch=rec.epoch, current=epoch_floor)
                with self._cond:
                    self._cursor = end
                continue
            try:
                self.local.publish(rec.epoch, rec.pos, rec.opcodes,
                                   rec.args)
            except EpochFencedError:
                # the JOURNAL is fenced ahead of us (a downstream
                # promotion landed through the server): same rule
                self._m_fenced.inc()
                tracer.emit("relay-fenced", pos=rec.pos,
                            epoch=rec.epoch,
                            current=self.local.epoch())
                with self._cond:
                    self._cursor = end
                continue
            with self._cond:
                self._cursor = end
                if rec.epoch > self.epoch:
                    self.epoch = int(rec.epoch)
                self._cond.notify_all()
            forwarded += 1
            self._m_forwarded.inc()
            self._m_ops.inc(rec.count)
            # the record's relay hop (`obs/` fleet tracing): sampled
            # on `pos` like ship/apply, so a sampled record's chain
            # includes every relay it crossed — the join that answers
            # "which relay is the lag bottleneck"
            if tracer.enabled and pos_sampled(rec.pos):
                tracer.emit("relay-forward", pos=rec.pos, n=rec.count,
                            epoch=rec.epoch, name=self.name)
        # the poll response already carried tail + heartbeat: read the
        # transport's cache instead of issuing two more STAT RPCs per
        # pump cycle (at a 1ms poll that would triple every relay's
        # request load on the primary); plain local feeds answer the
        # method calls directly — they cost no wire round-trip
        peek = getattr(self.upstream, "peek_stat", None)
        if peek is not None:
            up_tail, _, hb = peek()
        else:
            up_tail = self.upstream.tail_pos()
            hb = self.upstream.read_heartbeat()
        if hb is not None and hb != self._last_hb:
            # verbatim: leaves must observe the PRIMARY's beacon
            self.local.write_heartbeat(hb)
            self._last_hb = hb
        with self._cond:
            cur = self._cursor
        self._g_lag.set(max(0, int(up_tail) - cur))
        return forwarded

    def _record_failure(self, exc: BaseException) -> None:
        """The sanctioned worker-exception path (`repl/` contract):
        error slot for callers, health report when attached, counter +
        trace event."""
        with self._cond:
            self._error = exc
            self._cond.notify_all()
        self._m_errors.inc()
        get_tracer().emit("relay-error", name=self.name,
                          # nrcheck: unshared — pump thread, own write
                          cursor=self._cursor,
                          cause=type(exc).__name__)
        logger.exception("relay %s pump failed at cursor %d",
                         # nrcheck: unshared — pump thread, own write
                         self.name, self._cursor)
        if self.health is not None:
            self.health.report_worker_exception(self.health_rid, exc)

    # ------------------------------------------------------------ fence

    def _propagate_fence(self, epoch: int) -> None:
        """Server hook: the local journal just fenced to `epoch`
        (a downstream promotion). Raise the pump's forwarding floor
        and push the fence toward the primary, best effort — an
        unreachable (dead) upstream is the EXPECTED case during a
        failover, and the journal fence already protects the subtree."""
        with self._cond:
            if epoch > self.epoch:
                self.epoch = int(epoch)
        try:
            self.upstream.fence(epoch)
        except Exception as e:
            get_registry().counter(
                "repl.relay.fence_propagation_failures"
            ).inc()
            get_tracer().emit("relay-fence-unpropagated",
                              epoch=int(epoch),
                              cause=type(e).__name__)
            logger.warning(
                "relay %s: fence %d not propagated upstream (%s: %s)",
                self.name, epoch, type(e).__name__, e,
            )

    # --------------------------------------------------------- snapshot

    def _snapshot_provider(self, min_pos: int):
        """Downstream bootstrap source: serve from the local cache,
        refreshing from upstream when the cache cannot satisfy
        `min_pos` — one upstream transfer per NEW snapshot, however
        many leaves bootstrap below this node."""
        from node_replication_torch.durable.recovery import list_snapshots

        fetch = getattr(self.upstream, "fetch_snapshot", None)
        with self._snap_lock:
            cached = list_snapshots(self._snap_cache)
            have = cached[0][0] if cached else 0
            if fetch is not None:
                try:
                    got = fetch(self._snap_cache, min_pos=have)
                except Exception as e:
                    got = None  # degraded: the cache still serves
                    get_registry().counter(
                        "repl.relay.snapshot_refresh_failures"
                    ).inc()
                    logger.warning(
                        "relay %s: upstream snapshot refresh failed "
                        "(%s: %s)", self.name, type(e).__name__, e,
                    )
                if got is not None:
                    cached = [got] + cached
            for pos, path in cached:
                if pos > min_pos:
                    return pos, path
                break  # newest first
            return None

    # ------------------------------------------------------------ state

    @property
    def error(self) -> BaseException | None:
        # nrcheck: unshared — lock-free poll; one reference load
        return self._error

    def cursor(self) -> int:
        with self._cond:
            return self._cursor

    def lag(self) -> int:
        """Positions upstream holds that this relay has not journaled
        (served from the transport's cached tail while upstream is
        unreachable — a partitioned relay reads as a lagging one)."""
        with self._cond:
            cur = self._cursor
        return max(0, int(self.upstream.tail_pos()) - cur)

    def wait_forwarded(self, pos: int,
                       timeout: float | None = None) -> bool:
        """Block until the journal covers `pos` (test/ops barrier).
        False on timeout or a dead pump."""
        clock = get_clock()
        t_end = None if timeout is None else clock.now() + timeout
        with self._cond:
            while self._cursor < pos:
                if self._error is not None or self._stop:
                    return False
                rem = None if t_end is None else t_end - clock.now()
                if rem is not None and rem <= 0:
                    return False
                clock.wait(self._cond,
                           0.05 if rem is None else min(rem, 0.05))
            return True

    def prune(self, floor: int) -> int:
        """Prune the local journal below `floor`, clamped to the
        slowest LIVE downstream cursor the server knows — a connected
        straggler is never pruned into a `FeedGapError`; a
        disconnected one may be (it re-seeds via snapshot bootstrap,
        by design)."""
        cursors = self.server.downstream_cursors()
        if cursors:
            floor = min(int(floor), min(cursors.values()))
        return self.local.prune(int(floor))

    def stats(self) -> dict:
        with self._cond:
            return {
                "name": self.name,
                "address": list(self.address),
                "cursor": self._cursor,
                "epoch": self.epoch,
                "stopped": self._stop,
                "error": (
                    None if self._error is None
                    else f"{type(self._error).__name__}: {self._error}"
                ),
            }
