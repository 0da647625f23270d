#!/usr/bin/env python
"""Keyspace-sharded primary fleet example: route, fence, re-home, on the
port.

Runs the whole `shard/` story in one process: a `ShardMap` carving the
keyspace into congruence classes (`key % n_shards`), a `ShardGroup` of
per-shard primary stacks (each with its own log, WAL, feed, and
follower), a `ShardRouter` fanning a mixed batch out and reassembling
responses in submission order, the typed `WrongShard` fence a
mis-routed or version-stale submit hits BEFORE any log effect, an
ATOMIC cross-shard transfer through the 2PC layer — one that an
injected coordinator crash mid-prepare provably cannot half-apply
(presumed abort cleans up, balances untouched) — the per-op-outcome
contract of plain (non-txn) cross-shard batches, and finally one
shard's death — its follower promotes, the bumped map re-publishes,
and `call_with_retry` rides the outage without the caller ever seeing
it. Every shard's primary and follower fleet lives on the one device
the example runs on.

Run: python examples/torch/sharded_hashmap.py [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch.fault.inject import (
    FaultError,
    FaultPlan,
    FaultSpec,
)
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.serve import (
    RetryPolicy,
    ShardUnavailable,
    WrongShard,
    call_with_retry,
)
from node_replication_torch.shard import LocalBackend, ShardGroup, ShardMap
from node_replication_torch.utils.device import resolve_device

N_SHARDS = 3
N_KEYS = 64


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    base = tempfile.mkdtemp(prefix="nr-sharded-example-")
    g = None
    try:
        g = ShardGroup(N_SHARDS, make_hashmap(N_KEYS), base,
                       nr_kwargs=dict(n_replicas=1, log_entries=1 << 10,
                                      gc_slack=32, device=dev))
        r = g.router

        # --- congruence routing: one mixed batch, three keyspace slices ----
        ops = [(HM_PUT, k, 100 + k) for k in range(12)]
        out = r.execute_batch(ops)
        assert len(out) == 12  # reassembled in submission order
        for k in range(12):
            fe = g.primaries[k % N_SHARDS].live_frontend
            assert int(fe.read((HM_GET, k, 0), rid=0)) == 100 + k
        print(f"routed 12 ops across {N_SHARDS} slices: shard s owns "
              f"every key k with k % {N_SHARDS} == s")

        # --- the WrongShard fence: typed, and provably before the log ------
        m = ShardMap.load(base)
        stray = LocalBackend(0, g.primaries[0].live_frontend, m)
        try:
            stray.submit_batch([(HM_PUT, 1, 5)], m.version)
            raise AssertionError("mis-routed submit must be refused")
        except WrongShard as e:
            print(f"mis-routed key {e.key} refused: belongs to shard "
                  f"{e.expected_shard}, and shard 0's log never moved")

        # --- cross-shard transfer: atomic, and crash-proof -----------------
        # keys 2 (shard 2) and 4 (shard 1) hold balances; a transfer must
        # debit one and credit the other on DIFFERENT primaries with no
        # half-applied state, ever — the 2PC layer's contract
        def balance(k):
            fe = g.primaries[g.map.shard_of(k)].live_frontend
            return int(fe.read((HM_GET, k, 0), rid=0))

        coord = g.coordinator()
        a, b = balance(2), balance(4)
        coord.execute_txn([(HM_PUT, 2, a - 30), (HM_PUT, 4, b + 30)])
        assert balance(2) == a - 30 and balance(4) == b + 30
        print(f"cross-shard transfer committed atomically: "
              f"k2 {a}->{a - 30} (shard 2), k4 {b}->{b + 30} (shard 1); "
              f"the commit decision was durable before the ack")

        # now the coordinator "dies" mid-prepare: shard 2's yes-vote is
        # journaled and its key locked, but no decision was ever
        # published. Recovery bumps the coordinator epoch and every
        # participant PRESUMED-ABORTS the orphaned intent — the transfer
        # either happened everywhere or nowhere, even across the crash
        a, b = balance(2), balance(4)
        crash = FaultPlan([FaultSpec(site="txn-prepare", action="raise",
                                     rid=-1, after=1)])
        with crash.armed():
            try:
                coord.execute_txn([(HM_PUT, 2, a - 30), (HM_PUT, 4, b + 30)])
                raise AssertionError("injected crash must surface")
            except FaultError:
                pass
        g.coordinator(name="recovery")       # durable epoch bump
        outcomes = g.resolve_in_doubt()
        assert balance(2) == a and balance(4) == b  # NOT half-applied
        assert int(r.call((HM_PUT, 2, a))) >= 0     # locks released
        print(f"coordinator killed mid-prepare: in-doubt intent resolved "
              f"{dict((s, o) for s, o in outcomes.items() if o)} by "
              f"presumed abort — balances untouched, locks released, "
              f"zero half-applied state")

        # --- one slice dies: unavailability is typed AND contained ---------
        g.kill_primary(0)
        try:
            r.call((HM_PUT, 0, 1))
            raise AssertionError("dead slice must be unavailable")
        except ShardUnavailable as e:
            assert e.retryable  # never reached the log: safe to resubmit
        assert int(r.call((HM_PUT, 1, 201))) >= 0  # slice 1 never noticed
        print("shard 0 dead: its slice is typed-unavailable "
              "(maybe_executed=False), the other slices serve on")

        # plain (non-txn) cross-shard batches keep per-op outcomes: ops
        # on live slices commit even when another slice is down — use
        # `coord.execute_txn` when all-or-nothing is the requirement
        out = r.execute_batch([(HM_PUT, 0, 7), (HM_PUT, 2, 8)],
                              return_exceptions=True)
        assert isinstance(out[0], ShardUnavailable)
        assert int(out[1]) >= 0  # shard 2 committed independently
        print("non-txn batch under the outage: op on the dead slice "
              "rejected, op on a live slice committed (per-op outcomes, "
              "by contract; execute_txn is the atomic surface)")

        # --- promote + re-home: bumped map, fenced zombie, acks survive ----
        report = g.promote(0)
        assert ShardMap.load(base).version == m.version + 1
        fe0 = g.primaries[0].live_frontend
        assert int(fe0.read((HM_GET, 0, 0), rid=0)) == 100  # acked history
        print(f"shard 0's follower promoted: epoch {report.new_epoch}, "
              f"map v{m.version} -> v{m.version + 1} re-published "
              f"(a zombie submitting under v{m.version} is fenced), "
              f"acked write k=0 survived")

        # --- call_with_retry hides all of it from the caller ---------------
        val = call_with_retry(r, (HM_PUT, 0, 300),
                              policy=RetryPolicy(max_attempts=20))
        assert int(val) >= 0
        assert int(fe0.read((HM_GET, 0, 0), rid=0)) == 300
        print(f"sharded_hashmap OK: {N_SHARDS} slices, typed fences, "
              f"kill -> promote -> re-home at epoch {report.new_epoch}, "
              f"writes serving on the promoted follower")
    finally:
        if g is not None:
            g.close()
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
