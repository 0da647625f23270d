#!/usr/bin/env python
"""Replication example: bounded-staleness follower reads + promotion,
on the port.

Runs the whole `repl/` story in one process: a primary fleet with a
write-ahead log and a shipper publishing fsynced records into a
directory feed, a follower replaying that feed into its own fleet and
serving reads at a bounded-staleness cursor, then a simulated primary
death — heartbeat silence, election, promotion — after which the
follower serves durable-ack writes at a fenced epoch. Both fleets live
on the one device the example runs on.

Run: python examples/torch/follower_reads.py [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.durable import WriteAheadLog
from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
from node_replication_torch.repl import (
    DirectoryFeed,
    EpochFencedError,
    Follower,
    PromotionManager,
    ReplicationShipper,
)
from node_replication_torch.serve.errors import NotPrimary, StaleRead
from node_replication_torch.utils.device import resolve_device

CLIENTS = 4
OPS_PER_CLIENT = 16


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    base = tempfile.mkdtemp(prefix="nr-follower-example-")
    dispatch = make_seqreg(CLIENTS)
    nr = shipper = f = None
    try:
        # --- primary: fleet + WAL + shipper ----------------------------
        nr = NodeReplicated(dispatch, n_replicas=1, log_entries=2048,
                            gc_slack=64, device=dev)
        wal = WriteAheadLog(os.path.join(base, "primary-wal"),
                            policy="batch")
        nr.attach_wal(wal)
        feed = DirectoryFeed(os.path.join(base, "feed"),
                             arg_width=nr.spec.arg_width)
        shipper = ReplicationShipper(wal, feed, heartbeat_interval_s=0.02)

        tok = nr.register(0)
        for i in range(1, OPS_PER_CLIENT + 1):
            for c in range(CLIENTS):
                nr.execute_mut((SR_SET, c, i), tok)
        nr.wal_sync()  # fsync -> these records become shippable
        total = CLIENTS * OPS_PER_CLIENT
        shipper.barrier(total)  # ship-before-ack: feed now holds them all

        # --- follower: replay the feed, serve bounded-staleness reads --
        f = Follower(dispatch, feed, os.path.join(base, "follower"),
                     nr_kwargs=dict(n_replicas=1, log_entries=2048,
                                    gc_slack=64, device=dev))
        assert f.wait_applied(total, timeout=30.0)
        v, applied, bound = f.read_result((SR_GET, 0), max_lag_pos=8)
        assert v == OPS_PER_CLIENT, (v, applied, bound)
        print(f"follower read: value {v} at applied {applied} "
              f"(staleness bound {bound}, max_lag_pos=8)")
        try:
            f.read((SR_GET, 0), min_pos=total + 100, wait_s=0.05)
        except StaleRead as e:
            print(f"unreachable bound rejects typed: {e}")
        try:
            f.frontend.submit((SR_SET, 0, 99))
        except NotPrimary as e:
            print(f"writes belong on the primary: {e}")

        # --- primary dies: detect by heartbeat silence, promote --------
        shipper.stop(clear_pin=False)  # the "death": the beacon goes quiet
        mgr = PromotionManager(feed, [f], heartbeat_timeout_s=0.2,
                               check_interval_s=0.02)
        report = mgr.run(timeout=30.0)
        assert report is not None and f.promoted
        print(f"promoted {report.follower}: epoch {report.new_epoch} at "
              f"position {report.applied_pos}; RTO "
              f"{report.rto_s * 1e3:.0f}ms (detect "
              f"{report.detect_s * 1e3:.0f}ms + promote "
              f"{report.promote_s * 1e3:.0f}ms)")

        # the zombie's late publish is fenced at the transport
        try:
            feed.publish(report.new_epoch - 1, f.applied_pos(),
                         *[[0], [[0, 0, 0]]])
            raise AssertionError("zombie publish was not fenced")
        except EpochFencedError as e:
            print(f"zombie fenced: {e}")

        # durable-ack write serving resumed exactly where acks ended
        for c in range(CLIENTS):
            resp = f.frontend.call((SR_SET, c, OPS_PER_CLIENT + 1), rid=0)
            assert resp == OPS_PER_CLIENT, resp
        print(f"follower_reads OK: {total} replicated ops, "
              f"{CLIENTS} post-promotion writes served at epoch "
              f"{report.new_epoch}")
    finally:
        if f is not None:
            f.close()
        if shipper is not None:
            shipper.stop(clear_pin=False)
        if nr is not None and nr.wal is not None:
            nr.detach_wal().close()
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
