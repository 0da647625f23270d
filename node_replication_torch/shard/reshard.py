"""`ReshardPlan`: live keyspace splits (and quiesced merges) on a
sharded fleet.

The port's copy of `node_replication_tpu/shard/reshard.py`. On a
hashmap fleet with `engine="pallas"` the re-homed class is served by
the donor's promoted follower, one K1 launch a round.

The congruence refinement that makes an ONLINE split possible at all:
shard `s` of `N` owns class `s (mod N)`, and that class partitions
EXACTLY into classes `{s, s + N}` under `mod 2N` — so doubling the
map (`ShardMap.refine`) moves only the keys whose new class is
re-homed, and every other key keeps its shard without copying a byte.
The recipient for the moved half is the donor's OWN standby: the
follower already holds a full, continuously-caught-up copy of the
donor's state (seeded through the replication feed), so "seed the
recipient" is the replication plane's steady state, not a bulk copy.

Split cutover, in order:

1. **catch-up** — wait until the follower's applied cursor is at the
   donor's durable tail (bounds the drain below);
2. **stage** — build backends (and 2PC participants) for every
   refined class and `router.attach_backend` them: inert, because no
   key routes to a class beyond the current map;
3. **fence** — publish the refined map and `router.adopt` it. From
   this instant moved-key submits land on the recipient's backend,
   which refuses retryably (`NotPrimary` → `ShardUnavailable`) until
   its promotion completes — the moved keys' unavailability clock
   starts here, and ship-before-ack guarantees every PREVIOUSLY
   acked moved-key write is already in the feed;
4. **consume the standby** — stop the donor's shipper and drop its
   ack barrier (the follower it shipped to is being promoted away;
   the donor keeps serving its half WAL-durable and un-replicated
   until the operator attaches a new standby);
5. **promote** — the follower fences the feed epoch, drains the
   remaining records (bounded: the shipper is stopped), fsyncs, and
   enables writes. Moved keys are available again the moment this
   returns: the unavailability window is the FENCE WINDOW
   (catch-up lag + drain), never proportional to state size.

The recipient retains fenced copies of the donor's unmoved keys
(and vice versa) — unreachable by construction, since every submit
path re-checks the congruence at the door (`LocalBackend`,
nrlint rule `unrouted-key-in-shard-path`).

`merge` is the inverse, but QUIESCED, not live: the moved class's
history is replayed through the survivor's frontend, so the merge
window is proportional to the folded class's HISTORY SIZE — the
documented asymmetry (splits are cheap and online; merges are an
operator maintenance action). Order matters here too: the folded
shard's frontend is closed FIRST (acks drained), the history
replayed SECOND, and the coarsened map adopted LAST — adopting
before the replay would route moved keys to the survivor's stale
copy and let a fresh ack be overwritten by replayed history.
"""

from __future__ import annotations

import dataclasses
import os

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.shard.router import LocalBackend
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer


class ReshardError(RuntimeError):
    """A split/merge precondition failed — nothing was changed."""


@dataclasses.dataclass
class ReshardReport:
    """What one split/merge did (JSON-safe)."""

    kind: str                 # "split" | "merge"
    donor: int                # class that split (or absorbed)
    moved: int                # the re-homed class (donor + N)
    old_version: int
    new_version: int
    catchup_s: float          # split: follower catch-up wait
    fence_s: float            # moved-key unavailability window
    drained_records: int      # split: promote drain / merge: replayed
    duration_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ReshardPlan:
    """One split (and its optional inverse merge) on a `ShardGroup`.

        plan = ReshardPlan(group, donor=0)
        report = plan.split()          # class 0 of N → {0, N} of 2N
        ...
        report = plan.merge()          # fold class N back into 0

    The plan object owns the split's bookkeeping (which follower
    became which shard), so the merge knows exactly what to fold
    back. One plan = one split; run another plan to split again.
    """

    def __init__(self, group, donor: int):
        self.group = group
        self.donor = int(donor)
        self.split_report: ReshardReport | None = None
        self._recipient = None        # the promoted Follower
        self._recipient_txn = None
        self._alias_txns: list = []
        if not (0 <= self.donor < len(group.primaries)):
            raise ReshardError(f"donor {donor} out of range")

    # ------------------------------------------------------------ split

    def split(self, catchup_timeout_s: float = 10.0,
              drain_timeout_s: float = 10.0) -> ReshardReport:
        """Refine the map in place: class `donor` of `N` splits into
        `{donor, donor + N}` of `2N`, the moved half re-homed onto
        the donor's promoted follower. Live except for the moved
        keys' fence window (measured, returned)."""
        g = self.group
        p = g.primaries[self.donor]
        clock = get_clock()
        t0 = clock.now()
        if self.split_report is not None:
            raise ReshardError("plan already split; build a new plan")
        if p._primary_dead:
            raise ReshardError(f"donor {self.donor} primary is dead")
        if p.follower is None or p.follower.promoted:
            raise ReshardError(
                f"donor {self.donor} has no promotable follower to "
                f"receive the moved class"
            )
        if p.txn is not None and p.txn.has_locks():
            # a prepared-but-undecided txn's locked keys may be in the
            # MOVED half; committing it after the cutover would apply
            # through the donor's frontend onto a fenced copy. The
            # operator quiesces the coordinator first.
            raise ReshardError(
                f"donor {self.donor} has prepared transactions in "
                f"flight; resolve them before splitting"
            )
        old_map = g.map
        n = old_map.n_shards
        moved = self.donor + n

        # 1. catch-up: bound the promote drain by waiting until the
        # follower has applied (and journaled) the donor's current
        # durable tail. New writes keep landing — that remainder is
        # exactly what the drain folds inside the fence window.
        target = p.wal.tail
        p.follower.wait_applied(target, timeout=catchup_timeout_s)
        t_caught = clock.now()

        # 2. stage: a backend (+ participant) for every refined class,
        # attached without a map change — inert until adoption.
        new_map = old_map.refine()
        from node_replication_torch.shard.txn import TxnParticipant

        def _participant(shard, frontend, wal):
            if g.decisions is None:
                return None
            t = TxnParticipant(
                shard, frontend, new_map,
                os.path.join(g.base_dir, f"r{shard}", "txn"),
                decisions=g.decisions, wal=wal,
            )
            g.extra_participants.append(t)
            return t

        for d in range(n):
            if d == self.donor:
                continue
            q = g.primaries[d]
            alias_txn = _participant(d + n, q.live_frontend, q.wal)
            self._alias_txns.append(alias_txn)
            g.router.attach_backend(
                d + n,
                LocalBackend(d + n, q.live_frontend, new_map,
                             participant=alias_txn),
            )
        self._recipient = p.follower
        self._recipient_txn = _participant(
            moved, p.follower.frontend, p.follower.nr.wal
        )
        g.router.attach_backend(
            moved,
            LocalBackend(moved, p.follower.frontend, new_map,
                         participant=self._recipient_txn),
        )

        # 3. fence: publish + adopt. Moved-key submits now land on
        # the recipient backend and refuse retryably until the
        # promotion below completes — the unavailability clock.
        t_fence = clock.now()
        donor_backend = g.router.backend(self.donor)
        new_map.publish(g.base_dir)
        g.router.adopt(new_map, reason=f"split-s{self.donor}")

        # 3b. quiesce the OLD epoch: a submit that passed the donor's
        # old-version check just before the adopt may still be in its
        # check-then-stage window — wait for those calls to finish
        # acking (ship barrier still armed) so no acked moved-key
        # write can miss the drain below.
        if donor_backend is not None and not donor_backend.quiesce(
                timeout=drain_timeout_s):
            raise ReshardError(
                f"donor {self.donor} submit pipeline failed to "
                f"quiesce within {drain_timeout_s}s"
            )

        # 4. the split consumes the donor's standby: stop shipping
        # (the promote's epoch fence would reject it anyway) and drop
        # the ack barrier — the donor serves on WAL durability alone
        # until a new standby is attached.
        p.shipper.stop(clear_pin=False)
        p.frontend.ack_barrier = None

        # 5. promote: feed epoch fence + bounded drain + fsync +
        # enable_writes. Every moved-key ack issued before the fence
        # was shipped before it was acked, so the drain carries ALL
        # of them into the recipient.
        promo = p.follower.promote(drain_timeout_s=drain_timeout_s)
        t_open = clock.now()

        # bookkeeping: the follower now IS shard `moved`, not the
        # donor's standby — detach it so `live_frontend` (and any
        # later promotion of the donor) stays the donor's own stack.
        p.follower = None
        p.manager = None
        g.map = new_map
        for q in g.primaries:
            q.map = new_map
            if q.txn is not None:
                q.txn.set_map(new_map)

        rep = ReshardReport(
            kind="split", donor=self.donor, moved=moved,
            old_version=old_map.version, new_version=new_map.version,
            catchup_s=t_caught - t0, fence_s=t_open - t_fence,
            drained_records=int(promo.get("drained_records", 0)),
            duration_s=clock.now() - t0,
        )
        self.split_report = rep
        get_registry().counter("shard.splits").inc()
        get_tracer().emit(
            "shard-split", donor=self.donor, moved=moved,
            map_version=new_map.version, fence_s=rep.fence_s,
        )
        return rep

    # ------------------------------------------------------------ merge

    def merge(self, apply_timeout_s: float = 10.0) -> ReshardReport:
        """Fold class `donor + N` back into class `donor`: quiesce
        the moved class, replay its FULL history through the donor's
        frontend, then adopt the coarsened map. The window is
        history-sized — a maintenance action, not a live cutover."""
        g = self.group
        if self.split_report is None:
            raise ReshardError("nothing to merge: plan never split")
        if self.split_report.kind == "merge":
            raise ReshardError("plan already merged")
        clock = get_clock()
        t0 = clock.now()
        p = g.primaries[self.donor]
        old_map = g.map
        n2 = old_map.n_shards
        moved = self.donor + n2 // 2
        recip = self._recipient
        wal = recip.nr.wal
        if wal.base > 0:
            raise ReshardError(
                f"shard {moved}'s WAL history starts at {wal.base}, "
                f"not 0 (reclaimed): the folded class cannot be "
                f"reconstructed by replay"
            )
        for t in ([p.txn, self._recipient_txn] + self._alias_txns):
            if t is not None and t.has_locks():
                raise ReshardError(
                    "prepared transactions in flight; resolve them "
                    "before merging"
                )

        # 1. quiesce the moved class: close its frontend (drains
        # in-flight acks first). Moved-key submits now refuse
        # retryably — the merge window opens.
        t_fence = clock.now()
        recip.frontend.close(drain=True)

        # 2. replay the moved class's history, in order, through the
        # donor. The recipient's WAL holds the donor's FULL pre-split
        # history plus the post-split writes; filtering to the moved
        # congruence class replays exactly the keys being folded
        # back, and a deterministic state machine replayed from
        # position 0 reproduces the recipient's final values.
        replayed = 0
        futs = []
        for rec in wal.records(0):
            for op in rec.ops():
                if old_map.shard_of_op(op) != moved:
                    continue
                futs.append(p.frontend.submit(tuple(op)))
                replayed += 1
        for f in futs:
            f.result(apply_timeout_s)

        # 3. coarsen + publish + adopt LAST: only now do moved keys
        # route to the donor, whose state is caught up. The merge
        # window closes.
        new_map = old_map.coarsen()
        new_map.publish(g.base_dir)
        g.router.adopt(new_map, reason=f"merge-s{moved}")
        t_open = clock.now()

        g.map = new_map
        for q in g.primaries:
            q.map = new_map
            if q.txn is not None:
                q.txn.set_map(new_map)
        recip.close()

        rep = ReshardReport(
            kind="merge", donor=self.donor, moved=moved,
            old_version=old_map.version, new_version=new_map.version,
            catchup_s=0.0, fence_s=t_open - t_fence,
            drained_records=replayed,
            duration_s=clock.now() - t0,
        )
        self.split_report = rep
        get_registry().counter("shard.merges").inc()
        get_tracer().emit(
            "shard-merge", donor=self.donor, moved=moved,
            map_version=new_map.version, fence_s=rep.fence_s,
            replayed=replayed,
        )
        return rep
