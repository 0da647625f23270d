"""Models of the port: the dense hashmap, the open-addressing hashmap and
the vspace (flat and 4-level radix); the others follow the order in
ROADMAP.md queue 1."""

from node_replication_torch.models.hashmap import (
    ABSENT,
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    make_hashmap,
)
from node_replication_torch.models.oahashmap import (
    DROPPED,
    OA_GET,
    OA_PUT,
    OA_REMOVE,
    make_oahashmap,
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

__all__ = ["ABSENT", "HM_GET", "HM_PUT", "HM_REMOVE", "make_hashmap",
           "DROPPED", "OA_GET", "OA_PUT", "OA_REMOVE", "make_oahashmap",
           "UNMAPPED", "VS_IDENTIFY", "VS_MAP", "VS_RESOLVED", "VS_UNMAP",
           "VSR_IDENTIFY", "VSR_MAP", "VSR_MAP_DEVICE", "VSR_RESOLVED",
           "VSR_TABLES", "VSR_UNMAP", "VSR_UNMAP_TABLE", "make_vspace",
           "make_vspace_radix"]
