"""Models of the port (the hashmap and the flat vspace so far; the
others follow the order in ROADMAP.md queue 1)."""

from node_replication_torch.models.hashmap import (
    ABSENT,
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    make_hashmap,
)
from node_replication_torch.models.vspace import (
    UNMAPPED,
    VS_IDENTIFY,
    VS_MAP,
    VS_RESOLVED,
    VS_UNMAP,
    make_vspace,
)

__all__ = ["ABSENT", "HM_GET", "HM_PUT", "HM_REMOVE", "make_hashmap",
           "UNMAPPED", "VS_IDENTIFY", "VS_MAP", "VS_RESOLVED", "VS_UNMAP",
           "make_vspace"]
