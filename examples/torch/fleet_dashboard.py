#!/usr/bin/env python
"""Fleet observability example: exporters, collector, dashboard, and
per-record cross-process tracing on a 1→2→2 replication tree, on the
port.

Builds the replication-tree topology in one process — a primary serve
frontend whose WAL ships into a TCP feed, two relays fanning it out,
two leaf followers — with a `MetricsExporter` on every node
(`ServeConfig(obs_port=0)`, `RelayNode(obs_port=0)`,
`Follower(obs_port=0)`), then:

- scrapes all five exporters with a `FleetCollector` into a merged
  `fleet.jsonl` (each event stamped `node_id`/`role`/`t_fleet`),
- prints one live-dashboard frame (`obs/top.py:render_frame`),
- runs `obs/report.py` over the merged trace and shows the Fleet
  section: every node, plus a sampled record's hop timeline
  (submit→append→wal-sync→ship→relay-forward→apply) with per-edge
  latencies.

The primary's and both leaves' fleets live on the one device the
example runs on; the relays hold no fleet. The example installs its
own ring-mode tracer, which replaces one an `NR_TPU_TRACE` run set up.

Run: python examples/torch/fleet_dashboard.py [--device cpu]
"""

import argparse
import io
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.durable import WriteAheadLog
from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
from node_replication_torch.obs import (
    get_registry,
    get_tracer,
    report,
    set_trace_sample,
)
from node_replication_torch.obs.collect import FleetCollector
from node_replication_torch.obs.export import scrape, to_prometheus
from node_replication_torch.obs.top import render_frame
from node_replication_torch.repl import (
    DirectoryFeed,
    FeedServer,
    Follower,
    RelayNode,
    ReplicationShipper,
    SocketFeed,
)
from node_replication_torch.serve import ServeConfig, ServeFrontend
from node_replication_torch.utils.device import resolve_device

CLIENTS = 4
OPS_PER_CLIENT = 24
SAMPLE = 2  # trace every 2nd log position across the whole fleet


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    base = tempfile.mkdtemp(prefix="nr-fleet-example-")
    dispatch = make_seqreg(CLIENTS)
    aw = dispatch.arg_width

    # fleet-wide observability on: metrics registry, ring-mode flight
    # recorder (the exporters serve its tail), per-record sampling
    get_registry().enable()
    get_tracer().enable(None, ring=4096)
    set_trace_sample(SAMPLE)

    nr = shipper = fe = srv = coll = None
    relays, leaves, leaf_feeds = [], [], []
    try:
        # --- primary: fleet + WAL + shipper + frontend with an exporter
        nr = NodeReplicated(dispatch, n_replicas=1, log_entries=2048,
                            gc_slack=64, device=dev)
        wal = WriteAheadLog(os.path.join(base, "primary-wal"),
                            policy="batch")
        nr.attach_wal(wal)
        feed = DirectoryFeed(os.path.join(base, "feed"), arg_width=aw)
        shipper = ReplicationShipper(wal, feed, heartbeat_interval_s=0.02)
        fe = ServeFrontend(nr, ServeConfig(
            durability="batch", batch_linger_s=0.0,
            obs_port=0, obs_node_id="primary",
        ))
        fe.ack_barrier = shipper.barrier  # ship-before-ack
        srv = FeedServer(feed, wal=wal)

        # --- two relays, two leaves, an exporter on every node ---------
        for r in range(2):
            relays.append(RelayNode(
                SocketFeed(*srv.address, arg_width=aw),
                os.path.join(base, f"relay{r}"), arg_width=aw,
                poll_s=0.001, name=f"relay{r}", obs_port=0))
        for i in range(2):
            leaf_feeds.append(SocketFeed(*relays[i].address, arg_width=aw))
            leaves.append(Follower(
                dispatch, leaf_feeds[i],
                os.path.join(base, f"leaf{i}"),
                nr_kwargs=dict(n_replicas=1, log_entries=2048,
                               gc_slack=64, device=dev),
                poll_s=0.001, name=f"leaf{i}", obs_port=0,
                bootstrap=False))
        exporters = {
            "primary": fe.exporter,
            "relay0": relays[0].exporter,
            "relay1": relays[1].exporter,
            "leaf0": leaves[0].frontend.exporter,
            "leaf1": leaves[1].frontend.exporter,
        }
        print("exporters:", {k: f"{e.address[0]}:{e.address[1]}"
                             for k, e in exporters.items()})

        # --- collector: scrape everyone while traffic flows ------------
        fleet_path = os.path.join(base, "fleet.jsonl")
        coll = FleetCollector([e.address for e in exporters.values()],
                              interval_s=0.1, out_path=fleet_path)
        coll.start()
        for i in range(1, OPS_PER_CLIENT + 1):
            for c in range(CLIENTS):
                fe.call((SR_SET, c, i), rid=0)
        total = CLIENTS * OPS_PER_CLIENT
        for leaf in leaves:
            assert leaf.wait_applied(total, timeout=30.0)
            v = leaf.read((SR_GET, 0), max_lag_pos=16)
            assert v == OPS_PER_CLIENT, v
        coll.stop()  # final cycle folds the last events in

        # one raw Prometheus scrape, for the curious (and for curl users)
        text = to_prometheus(scrape(*exporters["primary"].address))
        print("\n--- prometheus exposition (primary, excerpt) ---")
        print("\n".join(text.splitlines()[:8]))

        # --- the dashboard frame (obs.top renders this live) -----------
        print("\n--- fleet dashboard frame ---")
        print(render_frame(coll.latest(), now_s=coll.uptime_s()), end="")

        # an Autoscaler-shaped consumer: the collector's time-series rings
        applied = coll.series("leaf0", "stats.follower.applied")
        assert applied and applied[-1][1] == total, applied[-3:]
        print(f"leaf0 applied-position series: {len(applied)} sample(s), "
              f"last={applied[-1][1]}")

        # --- the merged-trace report: Fleet section + hop timelines ----
        rep = report.analyze(report.load_events(fleet_path))
        fleet = rep["fleet"]
        assert fleet is not None and len(fleet["nodes"]) == 5, fleet
        assert fleet["records"] > 0, "no sampled records were traced"
        assert fleet["complete_records"] > 0, "no full submit->ack chain"
        assert "submit->ack" in fleet["edges"]
        buf = io.StringIO()
        report.render(rep, out=buf)
        text = buf.getvalue()
        print("\n--- obs.report fleet section ---")
        print(text[text.index("== fleet =="):].rstrip())
        print(f"\nfleet_dashboard OK: {total} acked ops traced across "
              f"{len(fleet['nodes'])} nodes, {fleet['records']} sampled "
              f"record(s) joined, merged trace at {fleet_path}")
    finally:
        # --- teardown --------------------------------------------------
        if coll is not None:
            coll.close()
        # an open socket client holds its server's connection thread in
        # a read: each client closes before the server it reads from
        for leaf in leaves:
            leaf.close()
        for leaf_feed in leaf_feeds:
            leaf_feed.close()
        for r in relays:
            r.close()
            r.upstream.close()
        if srv is not None:
            srv.close()
        if shipper is not None:
            shipper.stop()
        if fe is not None:
            fe.close()
        if nr is not None and nr.wal is not None:
            nr.detach_wal().close()
        get_tracer().disable()
        set_trace_sample(1)
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
