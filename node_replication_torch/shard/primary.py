"""`ShardPrimary` / `ShardGroup`: N primaries, each owning a keyspace
slice with its OWN replication stack.

The port's copy of `node_replication_tpu/shard/primary.py`. Each shard's
fleet is the port's `NodeReplicated`, on the card unless `nr_kwargs`
asks for another device. On a hashmap fleet with `engine="pallas"`
every round of a shard's primary is one fused combiner round: one K1
launch (`csrc/hashmap_replay.cu`); so is every record its follower
applies and every record replayed when `recover=True`. All shards of a
group share one process and the device's default stream, so their
launches run one after another on the card. One knob is the port's
own: `rids=` names the replicas the primary's frontend and the
follower's read-only frontend serve (None, the default, serves every
replica, as the reference does). Each frontend starts one worker
thread per served replica; three shards of a 4096-replica fleet, each
with a follower, would start 24,576 of them, more threads than some
hosts allow one process (`repl/follower.py`).

The fleet-level lift of CNR's per-log partitioning: where
`MultiLogReplicated` gives each congruence class its own in-process
log, a `ShardPrimary` gives it a whole primary — its own
`NodeReplicated` wrapper, attached WAL, epoch, `ReplicationShipper`
feed, and (optionally) a follower + `PromotionManager`. NOTHING here
is new machinery: promotion, fencing, snapshot bootstrap, and
recovery are the existing per-primary planes, instantiated once per
shard — the subsystem's job is composition and the routing contract,
not a second replication implementation.

`ShardGroup` is the all-in-one composition (tests, examples, the
embeddable deployment): N `ShardPrimary`s under one directory, a
durably-published `ShardMap`, and a `ShardRouter` over
`LocalBackend`s. Its failure story is the per-shard one: killing one
shard's primary (`kill_primary`) fails exactly that keyspace slice —
the other shards' frontends never see it — and `promote` re-homes the
slice onto the shard's follower, bumps + re-publishes the map, and
repoints the router, after which stale-map peers are fenced
(`WrongShard`) and `call_with_retry` re-routes via `refresh_map`.
Multi-process deployments (`bench.py --sharded`, the CI smoke) keep
the same shapes but put each `ShardPrimary`'s stack in its own
process behind a `ShardServer`.
"""

from __future__ import annotations

import os

from node_replication_torch.shard.ring import ShardMap
from node_replication_torch.shard.router import LocalBackend, ShardRouter


def _default_nr_kwargs() -> dict:
    # the follower-fleet bench's per-primary sizing: one replica per
    # shard process keeps the scaling measurement about SHARDS
    return dict(n_replicas=1, log_entries=1 << 15, gc_slack=512,
                exec_window=256)


class ShardPrimary:
    """One shard's complete primary stack over its keyspace slice.

    Layout under `base_dir`: `primary/` (WAL + snapshots), `feed/`
    (the shipper's directory feed), `follower/` (the standby's WAL).
    The frontend acks ship-before-ack (`ack_barrier =
    shipper.barrier`), so the group's zero-lost-acks property holds
    per shard across a promotion — an acked op is fsynced AND in the
    feed the follower drains.
    """

    def __init__(self, shard: int, dispatch, base_dir: str,
                 shard_map: ShardMap, config=None,
                 nr_kwargs: dict | None = None,
                 with_follower: bool = True,
                 heartbeat_timeout_s: float = 0.5,
                 poll_s: float = 0.002,
                 auto_start_watch: bool = False,
                 recover: bool = False,
                 with_txn: bool = True,
                 decisions=None,
                 rids=None):
        from node_replication_torch import NodeReplicated
        from node_replication_torch.durable import WriteAheadLog
        from node_replication_torch.repl import (
            DirectoryFeed,
            Follower,
            PromotionManager,
            ReplicationShipper,
        )
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        self.shard = int(shard)
        self.map = shard_map
        self.base_dir = base_dir
        rids = None if rids is None else [int(r) for r in rids]
        self.primary_dir = os.path.join(base_dir, "primary")
        self.feed_dir = os.path.join(base_dir, "feed")
        self.follower_dir = os.path.join(base_dir, "follower")
        for p in (self.primary_dir, self.feed_dir, self.follower_dir):
            os.makedirs(p, exist_ok=True)
        cfg = config or ServeConfig(durability="batch")
        if cfg.durability != "batch":
            raise ValueError(
                "sharded primaries require durable acks "
                "(ServeConfig(durability='batch'))"
            )
        self.dispatch = dispatch
        self.recovery = None
        if recover:
            # restart-in-place: rebuild this slice from its own
            # snapshots + WAL; the shipper then resumes at the feed's
            # persisted tail (ship-before-ack means nothing acked is
            # missing from either artifact)
            from node_replication_torch.durable.recovery import \
                recover_fleet
            self.nr, self.recovery = recover_fleet(
                self.primary_dir, dispatch,
                nr_kwargs=nr_kwargs or _default_nr_kwargs(),
            )
            self.wal = self.nr.wal
        else:
            self.nr = NodeReplicated(
                dispatch, **(nr_kwargs or _default_nr_kwargs())
            )
            self.wal = WriteAheadLog(
                os.path.join(self.primary_dir, "wal"), policy="batch"
            )
            self.nr.attach_wal(self.wal)
        self.feed = DirectoryFeed(
            self.feed_dir, arg_width=self.nr.spec.arg_width
        )
        self.shipper = ReplicationShipper(
            self.wal, self.feed, poll_s=poll_s,
            heartbeat_interval_s=0.02,
        )
        self.frontend = ServeFrontend(self.nr, cfg, rids=rids)
        self.frontend.ack_barrier = self.shipper.barrier
        self.follower = None
        self.manager = None
        if with_follower:
            self.follower = Follower(
                dispatch, self.feed, self.follower_dir,
                config=cfg, poll_s=poll_s,
                nr_kwargs=nr_kwargs or _default_nr_kwargs(),
                rids=rids,
            )
            self.manager = PromotionManager(
                self.feed, [self.follower],
                heartbeat_timeout_s=heartbeat_timeout_s,
                check_interval_s=0.03,
            )
            if auto_start_watch:
                self.manager.start()
        self.txn = None
        if with_txn:
            # 2PC participant over THIS shard's frontend + WAL. Costs
            # the non-txn path nothing: `submit_batch` consults it
            # through one `has_locks()` flag read and the intent log
            # is an empty fsynced file until the first prepare.
            from node_replication_torch.shard.txn import TxnParticipant
            self.txn = TxnParticipant(
                self.shard, self.frontend, shard_map,
                os.path.join(base_dir, "txn"),
                decisions=decisions, wal=self.wal,
            )
        self._primary_dead = False

    @property
    def live_frontend(self):
        """The frontend currently serving this shard's writes — the
        primary's until `promote()`, the promoted follower's after."""
        if (self.follower is not None and self.follower.promoted):
            return self.follower.frontend
        return self.frontend

    def kill_primary(self) -> None:
        """Fail this shard's primary abruptly (in-process stand-in for
        SIGKILL): stop shipping — heartbeat silence is what the
        `PromotionManager` detects — and tear the frontend down
        non-draining so queued requests reject instead of hanging."""
        if self._primary_dead:
            return
        self._primary_dead = True
        self.shipper.stop(clear_pin=False)
        self.frontend.close(drain=False)

    def promote(self, detect_s: float = 0.0):
        """Promote this shard's follower (detection done by the
        caller's watch, or operator-initiated). Returns the
        `PromotionReport`; `live_frontend` then serves writes."""
        if self.manager is None:
            raise RuntimeError(f"shard {self.shard} has no follower")
        return self.manager.promote_now(detect_s=detect_s)

    def close(self) -> None:
        if self.txn is not None:
            self.txn.close()
        if not self._primary_dead:
            self.shipper.stop()
            self.frontend.close()
        if self.follower is not None:
            self.follower.close()
        wal = self.nr.detach_wal()
        if wal is not None:
            wal.close()


class ShardGroup:
    """N `ShardPrimary`s + a published `ShardMap` + a `ShardRouter`.

        group = ShardGroup(3, make_hashmap(1024), base_dir=d)
        router = group.router
        router.call((HM_SET, key, value))     # routed by key % 3
        ...
        group.kill_primary(1)                 # one slice fails
        group.promote(1)                      # its follower takes over
        router.call((HM_SET, key1, value))    # re-routed, still acked

    `promote` bumps and RE-PUBLISHES the map before repointing the
    router, so external routers watching the published file
    (`refresh_map`) converge on the new topology, and any peer still
    submitting under the old version gets `WrongShard` — the zombie
    fence at the routing tier.
    """

    def __init__(self, n_shards: int, dispatch, base_dir: str,
                 config=None, nr_kwargs: dict | None = None,
                 with_followers: bool = True,
                 heartbeat_timeout_s: float = 0.5,
                 concurrent_router: bool = True,
                 with_txn: bool = True,
                 recover: bool = False,
                 rids=None):
        from node_replication_torch.durable import DecisionLog

        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.decisions_dir = os.path.join(base_dir, "decisions")
        self.decisions = DecisionLog(self.decisions_dir) \
            if with_txn else None
        #: participants created by a reshard (`shard/reshard.py`) for
        #: the refined classes — owned here so `close()` reaps them
        self.extra_participants: list = []
        if recover:
            # restart-in-place: adopt the published map (version and
            # all) instead of stamping a fresh version-1 map over it
            self.map = ShardMap.load(base_dir)
            if self.map.n_shards != n_shards:
                raise ValueError(
                    f"published map has {self.map.n_shards} shards, "
                    f"caller expected {n_shards}"
                )
        else:
            self.map = ShardMap(n_shards)
            self.map.publish(base_dir)
        self.primaries = [
            ShardPrimary(
                s, dispatch,
                os.path.join(base_dir, f"s{s}"),
                self.map, config=config, nr_kwargs=nr_kwargs,
                with_follower=with_followers,
                heartbeat_timeout_s=heartbeat_timeout_s,
                recover=recover, with_txn=with_txn,
                decisions=self.decisions, rids=rids,
            )
            for s in range(n_shards)
        ]
        self.router = ShardRouter(
            self.map,
            {
                s: LocalBackend(
                    s, self.primaries[s].frontend, self.map,
                    participant=self.primaries[s].txn,
                )
                for s in range(n_shards)
            },
            map_path=base_dir,
            concurrent=concurrent_router,
        )

    def coordinator(self, name: str = "coord"):
        """A `TxnCoordinator` over this group's router, sharing the
        fleet's decision directory — the one participants consult in
        `resolve_in_doubt`. Each construction durably bumps the
        coordinator epoch (older generations' undecided intents
        become presumed-abortable)."""
        if self.decisions is None:
            raise RuntimeError("group built with with_txn=False")
        from node_replication_torch.shard.txn import TxnCoordinator
        return TxnCoordinator(self.router, self.decisions_dir,
                              name=name)

    def resolve_in_doubt(self) -> dict:
        """Run every participant's in-doubt resolution against the
        shared decision log (the restart path after a coordinator or
        participant crash). Returns `{shard: {txn: outcome}}`."""
        epoch = self.decisions.epoch() if self.decisions else 0
        out = {}
        parts = [p.txn for p in self.primaries] + \
            list(self.extra_participants)
        for t in parts:
            if t is not None:
                out[t.shard] = t.resolve_in_doubt(
                    decisions=self.decisions, epoch=epoch
                )
        return out

    @property
    def n_shards(self) -> int:
        return self.map.n_shards

    def kill_primary(self, shard: int) -> None:
        self.primaries[int(shard)].kill_primary()

    def promote(self, shard: int, detect_s: float = 0.0):
        """Promote `shard`'s follower and re-home its writes: publish
        the bumped map FIRST (external routers must be able to prove
        the old version stale before the new home acks), then repoint
        this group's router onto the promoted frontend."""
        s = int(shard)
        p = self.primaries[s]
        report = p.promote(detect_s=detect_s)
        new_map = self.map.with_address(s, None)
        new_map.publish(self.base_dir)
        self.map = new_map
        for q in self.primaries:
            q.map = new_map
            if q.txn is not None:
                q.txn.set_map(new_map)
        if p.txn is not None:
            # re-home the participant too: prepared intents survive
            # (the intent log is the shard's, not the primary's) and
            # future commits apply through the promoted frontend
            p.txn.set_frontend(p.live_frontend,
                               wal=p.follower.nr.wal)
        self.router.repoint(
            s, LocalBackend(s, p.live_frontend, new_map,
                            participant=p.txn),
            new_map=new_map,
        )
        return report

    def close(self) -> None:
        self.router.close()
        for t in self.extra_participants:
            if t is not None:
                t.close()
        for p in self.primaries:
            p.close()
