#!/usr/bin/env python
"""Serving example: a hashmap behind the batching frontend, on the port.

Starts a `ServeFrontend` over 2 lock-step replicas, drives it from 4
client OS threads (closed loop with retry-on-`Overloaded` backoff),
reads through the local-replica read path, prints a latency summary,
and drains gracefully — the serve-layer analog of
`examples/torch/nr_hashmap.py`.

Run: python examples/torch/serve_hashmap.py [--device cpu]
"""

import argparse
import os
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.serve import (
    RetryPolicy,
    ServeConfig,
    ServeFrontend,
    call_with_retry,
)
from node_replication_torch.utils.device import resolve_device

CLIENTS = 4
OPS_PER_CLIENT = 64
KEYS = 1 << 10


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    nr = NodeReplicated(
        make_hashmap(KEYS), n_replicas=2, log_entries=2048, gc_slack=64,
        device=dev,
    )
    cfg = ServeConfig(queue_depth=128, batch_max_ops=32,
                      batch_linger_s=0.001)
    latencies = []
    lat_lock = threading.Lock()

    def client(fe: ServeFrontend, c: int) -> None:
        rid = c % 2  # this client's "local" replica
        for i in range(OPS_PER_CLIENT):
            k = c * OPS_PER_CLIENT + i
            t0 = time.monotonic()
            resp = call_with_retry(
                fe, (HM_PUT, k, k * 7), rid=rid, policy=RetryPolicy()
            )
            assert resp == 0, resp
            with lat_lock:
                latencies.append(time.monotonic() - t0)

    with ServeFrontend(nr, cfg) as fe:  # __exit__ drains gracefully
        threads = [
            threading.Thread(target=client, args=(fe, c))
            for c in range(CLIENTS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # reads go through the caller's replica, never the write queue
        for c in range(CLIENTS):
            k = c * OPS_PER_CLIENT
            got = fe.read((HM_GET, k), rid=c % 2)
            assert got == k * 7, (k, got)
        stats = fe.stats()

    nr.sync()
    assert nr.replicas_equal()
    lat_ms = sorted(v * 1e3 for v in latencies)
    n = len(lat_ms)
    print(
        f"serve_hashmap OK: {stats['completed']} ops from {CLIENTS} "
        f"clients ({stats['shed']} shed, "
        f"{stats['deadline_missed']} deadline-missed); latency "
        f"p50={statistics.median(lat_ms):.2f}ms "
        f"p95={lat_ms[min(n - 1, int(0.95 * n))]:.2f}ms "
        f"max={lat_ms[-1]:.2f}ms"
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
