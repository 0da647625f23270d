"""Benchmark/test harness: the mkbench equivalent (`benches/mkbench.rs`).

The port of `node_replication_tpu/harness/`, with its twelve names:

- `trait`     — the ReplicaTrait abstraction: one runner protocol that NR
                fleets, CNR multi-log fleets, partitioned comparisons,
                single concurrent-DS baselines, mesh-sharded fleets and
                the native CPU engine all implement
                (`benches/mkbench.rs:77-139`).
- `workloads` — op-stream generators (uniform/zipf keys, write-ratio mix),
                the port of `benches/hashmap.rs:131-162`.
- `mkbench`   — ScaleBenchBuilder sweeps, baseline_comparison, CSV output,
                `>> X Mops` reporting (`benches/mkbench.rs:189-319`,
                `950-1182`), and the kernel, mesh, serve, chaos and
                native measurements.
"""

from node_replication_torch.harness.trait import (
    ConcurrentDsRunner,
    FleetRunner,
    MultiLogRunner,
    NativeRunner,
    PartitionedRunner,
    ReplicatedRunner,
    ShardedRunner,
)
from node_replication_torch.harness.workloads import (
    WorkloadSpec,
    generate_batches,
    zipf_keys,
)
from node_replication_torch.harness.mkbench import (
    ScaleBenchBuilder,
    baseline_comparison,
)

__all__ = [
    "FleetRunner",
    "ReplicatedRunner",
    "MultiLogRunner",
    "PartitionedRunner",
    "ConcurrentDsRunner",
    "NativeRunner",
    "ShardedRunner",
    "WorkloadSpec",
    "generate_batches",
    "zipf_keys",
    "ScaleBenchBuilder",
    "baseline_comparison",
]
