"""durable/: write-ahead persistence + crash-consistent recovery.

The port of `node_replication_tpu/durable/`, with `txnlog.py` (the
two-phase-commit journals of `shard/txn.py`).

The durability plane: the repo's recovery property — any
replica is the deterministic fold of the log — made to survive the
PROCESS, not just a replica. Every combiner append is journaled into a
segmented, CRC-framed write-ahead log (`durable.wal`), snapshots are
fsync-published and digest-sealed (`core/checkpoint.py`), and a
restart replays snapshot + WAL tail through the same dispatch scan
live traffic uses (`durable.recovery`) — bit-identical to a fleet
that never died. The serve layer rides it for durable acks
(`ServeConfig(durability="batch"|"always")`: a future resolves only
after its records are fsynced) and reopens mid-traffic state with
`ServeFrontend.from_recovery`.

    from node_replication_torch.durable import (
        WriteAheadLog, recover_fleet, save_durable_snapshot,
    )

    nr.attach_wal(WriteAheadLog(dir + "/wal", policy="batch"))
    ...traffic...
    save_durable_snapshot(nr, dir)      # base + floor for reclamation
    ...kill -9...
    nr2, report = recover_fleet(dir, dispatch)   # bit-identical
"""

from node_replication_torch.durable.recovery import (
    RecoveryReport,
    WAL_SUBDIR,
    list_snapshots,
    recover_fleet,
    save_durable_snapshot,
    snapshot_path,
)
from node_replication_torch.durable.txnlog import (
    DecisionLog,
    TxnIntentLog,
    TxnLogCorruptError,
)
from node_replication_torch.durable.wal import (
    FSYNC_POLICIES,
    WalCorruptError,
    WalError,
    WalRecord,
    WriteAheadLog,
)

__all__ = [
    "DecisionLog",
    "FSYNC_POLICIES",
    "RecoveryReport",
    "TxnIntentLog",
    "TxnLogCorruptError",
    "WAL_SUBDIR",
    "WalCorruptError",
    "WalError",
    "WalRecord",
    "WriteAheadLog",
    "list_snapshots",
    "recover_fleet",
    "save_durable_snapshot",
    "snapshot_path",
]
