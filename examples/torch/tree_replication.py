#!/usr/bin/env python
"""Multi-host replication tree example: sockets, relays, bootstrap, on
the port.

Runs the whole `repl/transport.py` + `repl/relay.py` story on
localhost: a primary fleet whose WAL ships into a feed served over TCP
alongside its newest durable snapshot, a relay journaling that stream
and re-serving it downstream, a follower that COLD-BOOTSTRAPS from the
shipped snapshot (streaming only the suffix instead of replaying the
whole history), and finally a simulated primary death — the fence
travels over the socket into the relay's journal, and the zombie's
late records never reach the subtree. The primary's and the leaf's
fleets live on the one device the example runs on; the relay holds no
fleet.

Run: python examples/torch/tree_replication.py [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

from node_replication_torch import NodeReplicated
from node_replication_torch.durable import (
    WriteAheadLog,
    save_durable_snapshot,
)
from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
from node_replication_torch.repl import (
    DirectoryFeed,
    FeedServer,
    Follower,
    PromotionManager,
    RelayNode,
    ReplicationShipper,
    SocketFeed,
)
from node_replication_torch.utils.device import resolve_device

CLIENTS = 4
OPS_PER_CLIENT = 16


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    base = tempfile.mkdtemp(prefix="nr-tree-example-")
    dispatch = make_seqreg(CLIENTS)
    aw = dispatch.arg_width
    nr = shipper = srv = relay = f = None
    feeds = []  # the socket clients made here, closed before the relay
    try:
        # --- primary: fleet + WAL + shipper + TCP feed server ----------
        nr = NodeReplicated(dispatch, n_replicas=1, log_entries=2048,
                            gc_slack=64, device=dev)
        wal = WriteAheadLog(os.path.join(base, "primary-wal"),
                            policy="batch")
        nr.attach_wal(wal)
        feed = DirectoryFeed(os.path.join(base, "feed"), arg_width=aw)
        shipper = ReplicationShipper(wal, feed, heartbeat_interval_s=0.02)
        snap_dir = os.path.join(base, "primary-snaps")

        tok = nr.register(0)
        half = OPS_PER_CLIENT // 2
        for i in range(1, half + 1):
            for c in range(CLIENTS):
                nr.execute_mut((SR_SET, c, i), tok)
        save_durable_snapshot(nr, snap_dir)  # snap-<half*CLIENTS>.npz
        for i in range(half + 1, OPS_PER_CLIENT + 1):
            for c in range(CLIENTS):
                nr.execute_mut((SR_SET, c, i), tok)
        nr.wal_sync()
        total = CLIENTS * OPS_PER_CLIENT
        shipper.barrier(total)

        srv = FeedServer(feed, snapshot_dir=snap_dir, wal=wal)
        print(f"primary serving feed + snapshots at {srv.address}")

        # --- relay: one upstream stream in, any number out --------------
        feeds.append(SocketFeed(*srv.address, arg_width=aw))
        relay = RelayNode(feeds[-1],
                          os.path.join(base, "relay"), arg_width=aw,
                          poll_s=0.001, name="relay0")
        assert relay.wait_forwarded(total, timeout=30.0)
        print(f"relay journaled {relay.cursor()} positions; serving at "
              f"{relay.address}")

        # --- follower: snapshot bootstrap, then stream the suffix -------
        feeds.append(SocketFeed(*relay.address, arg_width=aw))
        f = Follower(dispatch, feeds[-1],
                     os.path.join(base, "follower"),
                     nr_kwargs=dict(n_replicas=1, log_entries=2048,
                                    gc_slack=64, device=dev),
                     poll_s=0.001)
        assert f.bootstrap_report is not None
        print(f"cold follower bootstrapped from snapshot at position "
              f"{f.bootstrap_report[0]} (recovery replayed "
              f"{f.recovery_report.wal_ops} op(s), not {total})")
        assert f.wait_applied(total, timeout=30.0)
        v, applied, bound = f.read_result((SR_GET, 0), max_lag_pos=8)
        assert v == OPS_PER_CLIENT, (v, applied, bound)
        print(f"leaf read through the tree: value {v} at applied "
              f"{applied} (bound {bound})")

        # --- primary dies: detect through the relay, fence over the wire
        shipper.stop(clear_pin=False)  # the "death": the beacon goes quiet
        srv.close()                    # ...and the primary's server with it
        feeds.append(SocketFeed(*relay.address, arg_width=aw))
        mgr = PromotionManager(feeds[-1], [f], heartbeat_timeout_s=0.2,
                               check_interval_s=0.02)
        report = mgr.run(timeout=30.0)
        assert report is not None and f.promoted
        print(f"promoted {report.follower} mid-tree: epoch "
              f"{report.new_epoch}, RTO {report.rto_s * 1e3:.0f}ms "
              f"(fence forwarded into the relay's journal)")

        # the zombie RESTARTS: it re-serves its old feed on the old port
        # and publishes a record stamped with its superseded epoch — the
        # relay's client reconnects and delivers it, and the fence the
        # promotion pushed into the relay drops it before the subtree
        relay.stop()  # take over the pump: the probe below is single-driver
        ztail = relay.local.tail_pos()
        zcursor = relay.cursor()
        feed.publish(0, zcursor, np.zeros(1, np.int32),
                     np.zeros((1, aw), np.int32))
        zsrv = FeedServer(feed, host=srv.address[0], port=srv.address[1])
        relay._pump_once()  # deterministic: drive one pump by hand
        relay.upstream.close()  # else the zombie's server waits on it
        zsrv.close()
        assert relay.cursor() == zcursor + 1  # delivered, not lost in the wire
        assert relay.local.tail_pos() == ztail  # ...and NOT forwarded
        print("zombie record fenced at the relay: delivered over the "
              "wire, dropped before the subtree")

        # durable-ack write serving resumed exactly where acks ended
        for c in range(CLIENTS):
            resp = f.frontend.call((SR_SET, c, OPS_PER_CLIENT + 1), rid=0)
            assert resp == OPS_PER_CLIENT, resp
        print(f"tree_replication OK: {total} ops through "
              f"primary -> relay -> follower, snapshot bootstrap at "
              f"{f.bootstrap_report[0]}, {CLIENTS} post-promotion writes "
              f"at epoch {report.new_epoch}")
    finally:
        if f is not None:
            f.close()
        # an open client holds a relay connection thread in its read
        for feed_client in feeds:
            feed_client.close()
        if relay is not None:
            relay.close()
        if srv is not None:
            srv.close()
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
