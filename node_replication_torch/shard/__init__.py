"""Fleet-level keyspace sharding: the paper's CNR partitioning lifted
from logs to primaries.

The port of `node_replication_tpu/shard/`, with the reference's 14
names; control files and frames are byte-identical to the reference's.

- `ring`: `ShardMap` — the deterministic `key % N` congruence map,
  versioned + durably published, with `refine`/`coarsen` for live
  splits and merges.
- `router`: `ShardRouter` (split → fan out → reassemble) over
  `LocalBackend` / `SocketShardClient` backends, and `ShardServer`,
  the shard primary's CRC-framed submit endpoint.
- `primary`: `ShardPrimary` / `ShardGroup` — N primaries, each with
  its own WAL, epoch, shipper, and follower tree.
- `txn`: `TxnCoordinator` / `TxnParticipant` — presumed-abort 2PC
  for atomic cross-shard transactions (durable intent journal,
  durable decision publish BEFORE any ack).
- `reshard`: `ReshardPlan` — online split of a congruence class
  (`s` of `N` → `{s, s+N}` of `2N`) and its quiesced merge inverse.

Cross-shard BATCHES remain explicitly NOT atomic (the CNR contract);
atomic cross-shard writes go through the transaction layer. See
`shard/router.py`, `shard/txn.py`, and README "Keyspace sharding".
"""

from node_replication_torch.shard.primary import ShardGroup, ShardPrimary
from node_replication_torch.shard.reshard import (
    ReshardError,
    ReshardPlan,
    ReshardReport,
)
from node_replication_torch.shard.ring import (
    MAP_FILENAME,
    ShardMap,
    ShardMapCorruptError,
)
from node_replication_torch.shard.router import (
    LocalBackend,
    ShardRouter,
    ShardServer,
    SocketShardClient,
)
from node_replication_torch.shard.txn import TxnCoordinator, TxnParticipant

__all__ = [
    "MAP_FILENAME",
    "LocalBackend",
    "ReshardError",
    "ReshardPlan",
    "ReshardReport",
    "ShardGroup",
    "ShardMap",
    "ShardMapCorruptError",
    "ShardPrimary",
    "ShardRouter",
    "ShardServer",
    "SocketShardClient",
    "TxnCoordinator",
    "TxnParticipant",
]
