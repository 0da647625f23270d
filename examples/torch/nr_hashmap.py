#!/usr/bin/env python
"""NR hashmap example (`nr/examples/hashmap.rs` parity), on the port.

The reference spawns 3 threads over 2 replicas of a HashMap behind one log
(`nr/examples/hashmap.rs:55-105`); here 3 logical threads register on 2
lock-step replicas and drive puts/gets through `NodeReplicated`. On the
card its default `engine="auto"` calibrates the fused round (K1) against
the chain and keeps the faster.

Run: python examples/torch/nr_hashmap.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.utils.device import resolve_device

CAPACITY = 1 << 10


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    nr = NodeReplicated(
        make_hashmap(CAPACITY), n_replicas=2, log_entries=2048, gc_slack=64,
        device=dev,
    )
    # three logical threads: two on replica 0, one on replica 1
    tokens = [nr.register(0), nr.register(0), nr.register(1)]

    for i, tok in enumerate(tokens * 32):
        nr.execute_mut((HM_PUT, i, i * 2), tok)

    # reads see every write regardless of issuing replica (ctail gate)
    for i in range(96):
        got = nr.execute((HM_GET, i), tokens[i % 3])
        assert got == i * 2, (i, got)

    nr.sync()
    assert nr.replicas_equal()
    print(f"nr_hashmap OK: 96 puts visible on both replicas, "
          f"log tail={int(nr.log.tail)}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
