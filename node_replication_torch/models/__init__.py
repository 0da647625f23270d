"""Models of the port: every model of the reference (the dense and
open-addressing hashmaps, the stack, queue, sorted set, memfs,
synthetic, vspace (flat and 4-level radix) and sequence register), and
the CNR state partitions (`PartitionedModel`)."""

from node_replication_torch.models.hashmap import (
    ABSENT,
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    make_hashmap,
)
from node_replication_torch.models.memfs import (
    FS_READ,
    FS_READ_LOGGED,
    FS_SIZE,
    FS_TRUNCATE,
    FS_WRITE,
    make_memfs,
    memfs_log_mapper,
)
from node_replication_torch.models.oahashmap import (
    DROPPED,
    OA_GET,
    OA_PUT,
    OA_REMOVE,
    make_oahashmap,
)
from node_replication_torch.models.partitioned import (
    PartitionedModel,
    make_partitioned_hashmap,
    make_partitioned_memfs,
    make_partitioned_sortedset,
)
from node_replication_torch.models.queue import (
    Q_DEQ,
    Q_ENQ,
    Q_FRONT,
    Q_LEN,
    make_queue,
)
from node_replication_torch.models.seqreg import SR_GET, SR_SET, make_seqreg
from node_replication_torch.models.sortedset import (
    SS_CONTAINS,
    SS_INSERT,
    SS_RANGE_COUNT,
    SS_RANK,
    SS_REMOVE,
    make_sortedset,
    sortedset_log_mapper,
)
from node_replication_torch.models.stack import (
    ST_PEEK,
    ST_POP,
    ST_PUSH,
    make_stack,
)
from node_replication_torch.models.synthetic import (
    SYN_READ,
    SYN_WRITE,
    make_synthetic,
)
from node_replication_torch.models.vspace import (
    UNMAPPED,
    VS_IDENTIFY,
    VS_MAP,
    VS_RESOLVED,
    VS_UNMAP,
    VSR_IDENTIFY,
    VSR_MAP,
    VSR_MAP_DEVICE,
    VSR_RESOLVED,
    VSR_TABLES,
    VSR_UNMAP,
    VSR_UNMAP_TABLE,
    make_vspace,
    make_vspace_radix,
)

__all__ = [
    "ABSENT", "HM_GET", "HM_PUT", "HM_REMOVE", "make_hashmap",
    "ST_PEEK", "ST_POP", "ST_PUSH", "make_stack",
    "SYN_READ", "SYN_WRITE", "make_synthetic",
    "UNMAPPED", "VS_IDENTIFY", "VS_MAP", "VS_RESOLVED", "VS_UNMAP",
    "make_vspace", "make_vspace_radix",
    "VSR_IDENTIFY", "VSR_MAP", "VSR_MAP_DEVICE", "VSR_RESOLVED",
    "VSR_TABLES", "VSR_UNMAP", "VSR_UNMAP_TABLE",
    "FS_READ", "FS_READ_LOGGED", "FS_SIZE", "FS_TRUNCATE", "FS_WRITE",
    "make_memfs", "memfs_log_mapper",
    "Q_DEQ", "Q_ENQ", "Q_FRONT", "Q_LEN", "make_queue",
    "DROPPED", "OA_GET", "OA_PUT", "OA_REMOVE", "make_oahashmap",
    "PartitionedModel", "make_partitioned_hashmap",
    "make_partitioned_memfs", "make_partitioned_sortedset",
    "SS_CONTAINS", "SS_INSERT", "SS_RANGE_COUNT", "SS_RANK", "SS_REMOVE",
    "make_sortedset", "sortedset_log_mapper",
    "SR_GET", "SR_SET", "make_seqreg",
]
