"""node_replication_torch: the node-replication framework on PyTorch and
CUDA for an NVIDIA H100.

The port of `node_replication_tpu` (which stays the reference): the same
`Dispatch` / shared-log / replica semantics, bit-identical to the
reference on the same op streams, with the reference's Pallas TPU
kernels rewritten by hand for Hopper (`csrc/`). This package imports
torch and never jax.

Entry points run on the card unless the caller asks for another
device: `device=None` means `torch.device("cuda")` and raises without
one; pass `device="cpu"` for the CPU.

Ported so far (ROADMAP.md queue 1 lists the rest): every model of the
reference, the log, the lock-step step, `NodeReplicated` (with
`grow_fleet`, the WAL and snapshots), CNR (`core/multilog.py`,
`MultiLogReplicated`, the partitioned models), every replay and
fused-round kernel, the serving path: `serve/` (`ServeFrontend`),
`fault/` (injection, health, repair) and `durable/` (WAL, recovery,
the 2PC journals), mesh placement: `parallel/` (`NodeReplicated(mesh=...)`,
`MultiLogReplicated(mesh=...)`, the shmap, gspmd, mesh-fused and ring
tiers), the replication plane: `repl/` (WAL shipping, followers,
promotion, the TCP transport and relays), and the shard plane: `shard/`
(`ShardGroup`, one primary stack per `key % N` class; `ShardRouter`
over local and socket backends; presumed-abort 2PC; online splits).
"""

from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.log import (
    DEFAULT_LOG_ENTRIES,
    GC_FROM_HEAD,
    LogSpec,
    LogState,
    is_replica_synced_for_reads,
    log_append,
    log_exec_all,
    log_init,
    log_reset,
    log_space,
)
from node_replication_torch.core.replica import (
    MAX_PENDING_OPS,
    MAX_THREADS_PER_REPLICA,
    NodeReplicated,
    ReplicaToken,
)
from node_replication_torch.core.step import make_step
from node_replication_torch.models.hashmap import (
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    make_hashmap,
)
from node_replication_torch.ops.encoding import (
    NOOP,
    Dispatch,
    apply_read,
    apply_write,
    encode_ops,
)
from node_replication_torch.parallel import (
    MachineTopology,
    MeshFusedEngine,
    ReplicaStrategy,
    make_mesh,
    make_ring_exec,
    make_shmap_exec,
    make_shmap_step,
    place,
    replica_mesh,
    shard_step,
)

__all__ = [
    "DEFAULT_LOG_ENTRIES", "GC_FROM_HEAD", "LogSpec", "LogState",
    "is_replica_synced_for_reads", "log_append", "log_exec_all",
    "log_init", "log_reset", "log_space", "MAX_PENDING_OPS",
    "MAX_THREADS_PER_REPLICA", "NodeReplicated", "ReplicaToken",
    "MultiLogReplicated", "make_step", "HM_GET", "HM_PUT", "HM_REMOVE",
    "make_hashmap", "NOOP",
    "Dispatch", "apply_read", "apply_write", "encode_ops",
    "MeshFusedEngine", "ReplicaStrategy", "make_mesh", "make_ring_exec",
    "make_shmap_exec", "make_shmap_step", "place", "replica_mesh",
    "shard_step", "MachineTopology",
]
