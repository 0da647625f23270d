#!/usr/bin/env python
"""Elasticity + recovery example, on the port.

The reference registers replicas against a live log at any time
(`Log::register`, `nr/src/log.rs:272-292`) and recovers state by
replaying from a deterministic default. This walks the port's versions
of both: a replica JOINS a live fleet after the ring has already
wrapped (the donor-snapshot join — the reference's join-at-position-0
would read overwritten slots here); the fleet checkpoints and restores;
and after further writes the replica states are "crashed" and rebuilt
by replaying the post-snapshot log delta through the union-window
combined catch-up engine.

Run: python examples/torch/nr_elastic.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

from node_replication_torch import NodeReplicated
from node_replication_torch.core.checkpoint import load_snapshot
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.utils.device import resolve_device

KEYS = 256
LOG_ENTRIES = 512  # small ring so the drive below WRAPS it


def main(device=None):
    dev = resolve_device(device)  # None: the card, raising without one
    nr = NodeReplicated(
        make_hashmap(KEYS), n_replicas=2, log_entries=LOG_ENTRIES,
        gc_slack=32, device=dev,
    )
    t0 = nr.register(0)

    # drive enough writes that the ring wraps several times
    n_ops = 3 * LOG_ENTRIES
    for i in range(n_ops):
        nr.execute_mut((HM_PUT, i % KEYS, i), t0)
    assert int(nr.log.tail) > nr.spec.capacity, "ring should have wrapped"

    # a replica joins the LIVE fleet post-wrap: it clones the most
    # caught-up replica's state at its cursor and catches up combined
    [rid] = nr.grow_fleet(1)
    t_new = nr.register(rid)
    assert nr.replicas_equal()
    last_of_7 = n_ops - KEYS + 7  # last write of key 7
    assert nr.execute((HM_GET, 7), t_new) == last_of_7
    print(f"joined replica {rid} post-wrap: fleet of {nr.n_replicas}, "
          f"bit-equal, reads serve immediately")

    # the newcomer participates: its writes are visible everywhere
    nr.execute_mut((HM_PUT, 7, 777_000), t_new)
    assert nr.execute((HM_GET, 7), t0) == 777_000

    with tempfile.TemporaryDirectory() as tmp:
        # checkpoint, restore in a fresh process-equivalent
        snap = os.path.join(tmp, "fleet.npz")
        nr.checkpoint(snap)
        restored = NodeReplicated.restore(snap, make_hashmap(KEYS),
                                          device=dev)
        t_r = restored.register(0)
        assert restored.n_replicas == nr.n_replicas
        assert restored.execute((HM_GET, 7), t_r) == 777_000
        print(f"restored {restored.n_replicas}-replica fleet from "
              f"{os.path.basename(snap)}: state survives the crash")

        # keep working past the snapshot, then "crash" the replica
        # states and REBUILD BY REPLAY from the snapshot base — the
        # recovery model proper: deterministic base + replay of the
        # delta through the union-window combined catch-up
        for i in range(100):
            restored.execute_mut((HM_PUT, i % KEYS, 900_000 + i), t_r)
        _, base_log, base_states = load_snapshot(snap, restored.states)
        restored.recover(base_states=base_states,
                         base_pos=int(base_log.tail))
        assert restored.replicas_equal()
        t_r2 = restored.register(0)
        assert restored.execute((HM_GET, 99), t_r2) == 900_099
        assert restored.execute((HM_GET, 7), t_r2) == 900_007
        print("recovered by replay: 100 post-snapshot writes "
              "reconstructed from the log delta")

    print(f"nr_elastic OK: wrap at tail={int(nr.log.tail)}, join, "
          f"checkpoint/restore, recover-by-replay all bit-exact")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    main(p.parse_args().device)
