"""Repair-by-replay and the replica lifecycle manager.

The port's copy of `node_replication_tpu/fault/repair.py`, unchanged
but for the cursor readback (`int(nr.log.tail)` on a tensor).

The repair half of `fault/`: a quarantined replica is rebuilt from a
healthy donor's snapshot plus log replay — the same two invariants the
repo already proves elsewhere, now composed at runtime:

- **donor-copy invariant** (`NodeReplicated.grow_fleet`): a replica's
  state is the fold of `[0, ltails[r])` from deterministic init, so a
  bit-copy of a healthy donor's state at exactly `ltails[donor]` is a
  consistent snapshot, and inheriting the donor's cursor keeps
  `head = min(healthy ltails)` untouched.
- **recovery-by-replay** (`core/checkpoint.py:recover_states`):
  deterministic `Dispatch` transitions make replaying
  `[donor_ltail, tail)` bit-identical to never having faulted.

`repair_replica` runs the whole sequence against a live wrapper:
clone from the most caught-up healthy donor (`clone_replica_from`),
unfence, and catch up through the same exec loop every replica uses
(`sync(rid)`). Linearizability holds THROUGH the repair because the
log is the source of truth — the repaired replica replays exactly the
entries everyone else already applied, in the same order.

`ReplicaLifecycleManager` closes the loop with the serve frontend:
a dead worker reports through `ServeFrontend.on_replica_failed`; the
manager suspects -> quarantines (fencing the replica out of GC) ->
repairs on a dedicated medic thread -> readmits by restarting the
replica's worker (`restart_replica`). `probe()` runs the divergence
vote for silent corruption the exception path cannot see.
"""

from __future__ import annotations

import logging
import threading

from node_replication_torch.analysis.locks import make_lock

from node_replication_torch.fault.health import (
    HEALTHY,
    QUARANTINED,
    REPAIRING,
    HealthTracker,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

logger = logging.getLogger("node_replication_torch")


def repair_replica(nr, rid: int, donor: int | None = None) -> dict:
    """Rebuild fenced replica `rid` from a healthy donor and readmit it.

    Requires `rid` to be fenced (`nr.fence_replica(rid)`) — repair of a
    live replica would race its own replay. Returns a report dict
    (`rid`, `donor`, `donor_ltail`, `replayed`, `duration_s`); also
    counted in `fault.repair` / observed in `fault.repair_s` and
    emitted as a `fault-repair` trace event.
    """
    t0 = get_clock().now()
    donor, donor_ltail = nr.clone_replica_from(rid, donor=donor)
    nr.unfence_replica(rid)
    nr.sync(rid)
    tail = int(nr.log.tail) if hasattr(nr.log, "tail") else 0
    dur = get_clock().now() - t0
    reg = get_registry()
    reg.counter("fault.repair").inc()
    reg.histogram("fault.repair_s").observe(dur)
    get_tracer().emit(
        "fault-repair", rid=rid, donor=donor, donor_ltail=donor_ltail,
        replayed=tail - donor_ltail, duration_s=dur,
    )
    return {
        "rid": rid,
        "donor": donor,
        "donor_ltail": donor_ltail,
        "replayed": tail - donor_ltail,
        "duration_s": dur,
    }


class ReplicaLifecycleManager:
    """Ties wrapper + frontend + health tracker into one repair loop.

    Wiring: construction installs `self._on_worker_failure` as the
    frontend's `on_replica_failed` callback (when a frontend is given).
    A failed worker then drives, asynchronously on a medic thread:

        report_worker_exception (-> SUSPECT)
        quarantine + `nr.fence_replica`   (GC unblocked, replica frozen)
        REPAIRING + `repair_replica`      (donor clone + replay)
        HEALTHY + `frontend.restart_replica` (rejoins admission)

    `probe()` covers the silent-corruption path: a divergence vote
    that names a minority replica quarantines and repairs it through
    the same pipeline, no worker death required. `wait_idle` joins the
    medic threads (test/bench barrier); `repairs` records every
    completed repair's report for latency accounting
    (`bench.py --chaos`).
    """

    def __init__(self, nr, frontend=None, health: HealthTracker | None = None):
        self.nr = nr
        self.frontend = frontend
        self.health = health or HealthTracker(nr.n_replicas)
        self.repairs: list[dict] = []
        self._lock = make_lock("ReplicaLifecycleManager._lock")
        self._medics: list[threading.Thread] = []
        if frontend is not None:
            frontend.on_replica_failed = self._on_worker_failure

    # ------------------------------------------------------------ pipeline

    def _on_worker_failure(self, rid: int, exc: BaseException) -> None:
        """Frontend callback: a worker died serving `rid`. Runs on the
        dying worker thread — only marks and hands off; the repair
        itself runs on a medic thread so the worker can exit."""
        self.health.report_worker_exception(rid, exc)
        t = threading.Thread(
            target=self._quarantine_and_repair, args=(rid,),
            name=f"fault-medic-r{rid}", daemon=True,
        )
        with self._lock:
            self._medics.append(t)
        t.start()

    def _quarantine_and_repair(self, rid: int) -> None:
        try:
            st = self.health.state(rid)
            if st != QUARANTINED:
                # `quarantine` walks HEALTHY through SUSPECT first, so
                # this is legal even when the tracker's strike
                # threshold (> 1) left the replica HEALTHY after the
                # report that killed its worker
                self.health.quarantine(rid)
            self.nr.fence_replica(rid)
            self.health.transition(rid, REPAIRING)
            report = repair_replica(self.nr, rid)
            self.health.transition(rid, HEALTHY)
            with self._lock:
                self.repairs.append(report)
            if self.frontend is not None:
                self.frontend.restart_replica(rid)
        except Exception as exc:
            logger.exception("repair of replica %d failed", rid)
            # back to quarantine for another attempt; the strike is
            # recorded so the health view shows the failed repair
            if self.health.state(rid) == REPAIRING:
                self.health.transition(rid, QUARANTINED)
            self.health.report_worker_exception(rid, exc)

    # ------------------------------------------------------------ entries

    def quarantine_and_repair(self, rid: int) -> None:
        """Synchronously quarantine + repair `rid` (test/ops entry;
        the async path is the frontend callback)."""
        self._quarantine_and_repair(rid)

    def probe(self) -> list[int]:
        """One divergence vote over the wrapper's states; every named
        minority replica is quarantined and repaired synchronously.
        Returns the rids the vote named."""
        minority = self.health.probe(self.nr.states)
        for rid in minority:
            self._quarantine_and_repair(rid)
        return minority

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Join outstanding medic threads. False on timeout.

        Medics are REAL threads, so the budget is accounted in real
        time by bounded join slices (a `Thread.join` is the rule's
        real-thread-barrier exemption) — an injected-clock deadline
        here would never fire under `SimClock`, turning a hung medic
        into an unbounded wait. Each slice charges at most its own
        length, so `timeout` bounds the total wall wait to within one
        slice."""
        remaining = None if timeout is None else float(timeout)
        while True:
            with self._lock:
                medics = [t for t in self._medics if t.is_alive()]
                self._medics = medics
            if not medics:
                return True
            if remaining is None:
                medics[0].join()
                continue
            if remaining <= 0:
                return False
            piece = min(remaining, 0.1)
            medics[0].join(piece)
            remaining -= piece
