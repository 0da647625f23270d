#!/usr/bin/env python
"""CNR hashmap example (`cnr/examples/hashmap.rs` parity), on the port.

The multi-log variant: ops partition over 4 logs by key (the LogMapper
contract — equal keys conflict and share a log, distinct keys commute,
`cnr/src/lib.rs:123-137`), replayed through the fused multi-log step.

Run: python examples/torch/cnr_hashmap.py [--device cpu]
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
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.ops.encoding import encode_ops
from node_replication_torch.utils.device import resolve_device

NLOGS, REPLICAS, KEYS = 4, 2, 256


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    d = make_hashmap(KEYS)
    spec = MultiLogSpec(nlogs=NLOGS, capacity=1 << 10, n_replicas=REPLICAS,
                        gc_slack=32)
    step = make_multilog_step(d, spec, writes_per_log=8, reads_per_replica=4)
    ml = multilog_init(spec, device=dev)
    states = replicate_state(d.init_state(dev), REPLICAS)

    # 32 puts partitioned over the 4 logs by key (the LogMapper)
    ops = [(HM_PUT, (k, 100 + k)) for k in range(32)]
    opc, args, counts, placements = partition_ops(
        lambda opcode, a: a[0], NLOGS, ops, d.arg_width, pad_to=8,
        device=dev,
    )
    rd_opc, rd_args, _ = encode_ops(
        [(HM_GET, k) for k in range(4)], d.arg_width, device=dev
    )
    ml, states, wr_resps, rd_resps = step(
        ml, states,
        opc, args, counts,
        rd_opc.expand(REPLICAS, 4),
        rd_args.expand(REPLICAS, 4, d.arg_width),
    )
    # the per-log tails as numpy scalars, as the reference prints them
    tails = list(ml.tail.cpu().numpy())
    assert tails == [8] * NLOGS
    assert rd_resps.tolist() == [[100, 101, 102, 103]] * REPLICAS
    print(f"cnr_hashmap OK: 32 puts over {NLOGS} logs, "
          f"per-log tails={tails}, reads consistent")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
