#!/usr/bin/env python
"""NR stack example (`nr/examples/stack.rs` parity), on the port.

Push/pop through the log; pops report the popped value, empty pops report
-1 (the `Option<u32>` encoding, `nr/examples/stack.rs:46-49`). The stack
has no fused kernel: every round runs the chain.

Run: python examples/torch/nr_stack.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.models import ST_PEEK, ST_POP, ST_PUSH, make_stack
from node_replication_torch.utils.device import resolve_device


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    nr = NodeReplicated(
        make_stack(1 << 12), n_replicas=2, log_entries=2048, gc_slack=64,
        device=dev,
    )
    t0, t1 = nr.register(0), nr.register(1)

    for v in range(100):
        nr.execute_mut((ST_PUSH, v), t0 if v % 2 == 0 else t1)

    assert nr.execute((ST_PEEK,), t1) == 99
    popped = [nr.execute_mut((ST_POP,), t1) for _ in range(100)]
    assert popped == list(range(99, -1, -1))
    assert nr.execute_mut((ST_POP,), t0) == -1  # empty

    nr.sync()
    assert nr.replicas_equal()
    print("nr_stack OK: 100 pushes popped in LIFO order on either replica")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
