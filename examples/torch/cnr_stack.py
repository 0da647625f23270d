#!/usr/bin/env python
"""CNR stack example (`cnr/examples/stack.rs` parity), on the port.

The reference's cnr stack uses a concurrent queue as the data structure
(ops on it commute). Here the commuting structure is the sorted set
(distinct keys commute, `models/sortedset.py`), partitioned over 2 logs by
key — membership after replay is identical on every replica.

Run: python examples/torch/cnr_stack.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch.core.multilog import (
    MultiLogSpec,
    make_multilog_step,
    multilog_init,
    partition_ops,
)
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.models import (
    SS_CONTAINS,
    SS_INSERT,
    SS_RANGE_COUNT,
    make_sortedset,
    sortedset_log_mapper,
)
from node_replication_torch.ops.encoding import encode_ops
from node_replication_torch.utils.device import resolve_device

NLOGS, REPLICAS, KEYS = 2, 2, 128


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    d = make_sortedset(KEYS)
    spec = MultiLogSpec(nlogs=NLOGS, capacity=1 << 10, n_replicas=REPLICAS,
                        gc_slack=32)
    step = make_multilog_step(d, spec, writes_per_log=16, reads_per_replica=2)
    ml = multilog_init(spec, device=dev)
    states = replicate_state(d.init_state(dev), REPLICAS)

    ops = [(SS_INSERT, (k,)) for k in range(20)]
    opc, args, counts, _ = partition_ops(
        sortedset_log_mapper, NLOGS, ops, d.arg_width, pad_to=16,
        device=dev,
    )
    rd_opc, rd_args, _ = encode_ops(
        [(SS_CONTAINS, 7), (SS_RANGE_COUNT, 0, 20)], d.arg_width, device=dev
    )
    ml, states, _, rd = step(
        ml, states, opc, args, counts,
        rd_opc.expand(REPLICAS, 2),
        rd_args.expand(REPLICAS, 2, d.arg_width),
    )
    assert rd.tolist() == [[1, 20]] * REPLICAS
    print(f"cnr_stack OK: 20 inserts over {NLOGS} logs, "
          f"contains(7)=1 and range_count=20 on every replica")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
