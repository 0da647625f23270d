"""Mesh placement and the explicit-collective mesh tiers (the port of
`node_replication_tpu/parallel/`, with its ten names)."""

from node_replication_torch.parallel.collectives import (
    MeshFusedEngine,
    make_ring_exec,
    make_shmap_exec,
    make_shmap_step,
)
from node_replication_torch.parallel.mesh import (
    ReplicaStrategy,
    make_mesh,
    place,
    replica_mesh,
    shard_step,
)
from node_replication_torch.parallel.topology import MachineTopology

__all__ = [
    "MeshFusedEngine",
    "ReplicaStrategy",
    "make_mesh",
    "make_ring_exec",
    "make_shmap_exec",
    "make_shmap_step",
    "place",
    "replica_mesh",
    "shard_step",
    "MachineTopology",
]
