"""fault/: replica lifecycle — injection, health, quarantine, repair.

The port of `node_replication_tpu/fault/`: the robustness layer that turns the repo's structural
recovery property (any replica is the fold of the log from
deterministic init — `core/checkpoint.py:recover_states`) into live
high availability:

- `fault.inject`  — deterministic, seedable `FaultPlan`s armed at
  named host-loop sites (`replay`, `append`, `read-sync`,
  `serve-batch`); one-branch free when disarmed.
- `fault.health`  — per-replica HEALTHY -> SUSPECT -> QUARANTINED ->
  REPAIRING -> HEALTHY state machine plus the digest-vote divergence
  probe that NAMES a corrupted replica.
- `fault.repair`  — repair-by-replay from a healthy donor snapshot
  (the `grow_fleet` donor-copy invariant, applied in place) and the
  `ReplicaLifecycleManager` wiring serve failover to automatic repair.

    from node_replication_torch.fault import (
        FaultPlan, FaultSpec, HealthTracker, ReplicaLifecycleManager,
    )

    plan = FaultPlan([FaultSpec(site="serve-batch", action="raise",
                                rid=1, after=20)])
    mgr = ReplicaLifecycleManager(nr, frontend)   # auto-wires failover
    with plan.armed():
        ...serve traffic; replica 1 dies, is repaired, rejoins...
"""

from node_replication_torch.fault.health import (
    HEALTHY,
    QUARANTINED,
    REPAIRING,
    SUSPECT,
    HealthTracker,
    IllegalTransition,
    divergence_vote,
    state_digest,
)
from node_replication_torch.fault.inject import (
    ACTIONS,
    MAX_STALL_S,
    SITES,
    FaultError,
    FaultPlan,
    FaultSpec,
    corrupt_states,
    fault_hook,
)
from node_replication_torch.fault.repair import (
    ReplicaLifecycleManager,
    repair_replica,
)

__all__ = [
    "ACTIONS",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "HEALTHY",
    "HealthTracker",
    "IllegalTransition",
    "MAX_STALL_S",
    "QUARANTINED",
    "REPAIRING",
    "ReplicaLifecycleManager",
    "SITES",
    "SUSPECT",
    "corrupt_states",
    "divergence_vote",
    "fault_hook",
    "repair_replica",
    "state_digest",
]
