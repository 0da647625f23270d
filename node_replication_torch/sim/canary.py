"""Deliberately re-injectable bugs: proof the harness catches what it
claims to catch (the port's copy of `node_replication_tpu/sim/canary.py`;
each canary patches the port's class, never the reference's).

A property harness that has never failed proves nothing — maybe the
system is correct, maybe the checker is vacuous. Each canary here
re-opens one REAL bug class the system already closed (or one crash
semantics the durability plane exists to prevent), behind a context
manager, so `explore.py --canary <name>` can assert that a bounded
seed sweep catches it, that the failing seed replays byte-identically,
and that the shrinker reduces it — the `sim-smoke` CI job runs
exactly that loop.

Canaries:

- ``reclaim-ignores-pins`` — re-opens the reclaim-vs-ship race
  (`durable/wal.py:reclaim` re-clamps the floor to the pins
  under the lock): reclamation ignores the shipper's pin, so a
  snapshot-floor + GC-head advance deletes WAL segments the feed has
  not shipped yet. Caught by the repl flavor as a ``replication-gap``
  (the follower hits a `FeedGapError`) once a seeded schedule lets
  the shipper lag across a snapshot+sync.
- ``ack-before-fsync`` — `WriteAheadLog.sync` advances `durable_tail`
  WITHOUT fsyncing (an ack that lies about durability). Caught by the
  crash flavor as ``durable-ack-survival``: the simulated kill -9
  truncates the active segment to its last *actually fsynced* size,
  so the lying acks vanish and recovery comes back below the
  "durable" tail.
- ``ack-before-decision`` — `DecisionLog.publish` silently drops the
  decision document: the 2PC coordinator proceeds to ack
  commit with NO durable commit point. Caught by the sharded flavor
  as ``txn-atomicity`` on a crash-variant ``stxn`` step: the
  coordinator dies right after its (now vanished) decision publish,
  and restart recovery presumed-aborts a transaction the coordinator
  had decided to commit.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _reclaim_ignores_pins():
    from node_replication_torch.durable import wal as wal_mod

    orig = wal_mod.WriteAheadLog._pin_floor_locked
    wal_mod.WriteAheadLog._pin_floor_locked = (
        lambda self, floor: floor  # the bug: pins no longer clamp
    )
    try:
        yield
    finally:
        wal_mod.WriteAheadLog._pin_floor_locked = orig


@contextlib.contextmanager
def _ack_before_fsync():
    from node_replication_torch.durable import wal as wal_mod

    orig = wal_mod.WriteAheadLog.sync

    def lying_sync(self):
        with self._lock:
            self._check_usable()
            self._durable = self._tail  # the bug: no fsync happened
            return self._durable

    wal_mod.WriteAheadLog.sync = lying_sync
    try:
        yield
    finally:
        wal_mod.WriteAheadLog.sync = orig


@contextlib.contextmanager
def _ack_before_decision():
    from node_replication_torch.durable import txnlog as txnlog_mod

    orig = txnlog_mod.DecisionLog.publish

    def lost_publish(self, txn, outcome, shards=()):
        return None  # the bug: the decision never reaches disk

    txnlog_mod.DecisionLog.publish = lost_publish
    try:
        yield
    finally:
        txnlog_mod.DecisionLog.publish = orig


CANARIES = {
    "reclaim-ignores-pins": _reclaim_ignores_pins,
    "ack-before-fsync": _ack_before_fsync,
    "ack-before-decision": _ack_before_decision,
}

#: the flavor whose property set catches each canary — `explore.py
#: --canary` narrows its sweep to this flavor so the catch is cheap
CANARY_FLAVOR = {
    "reclaim-ignores-pins": "repl",
    "ack-before-fsync": "crash",
    "ack-before-decision": "sharded",
}


def armed(name: str):
    """Context manager re-injecting canary bug `name`."""
    try:
        return CANARIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown canary {name!r} "
            f"(have: {', '.join(sorted(CANARIES))})"
        ) from None
