"""Models of the port (the hashmap for now; the others follow the
order in ROADMAP.md queue 1)."""

from node_replication_torch.models.hashmap import (
    ABSENT,
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    make_hashmap,
)

__all__ = ["ABSENT", "HM_GET", "HM_PUT", "HM_REMOVE", "make_hashmap"]
