"""Per-replica health state machine + divergence probe.

The port's copy of `node_replication_tpu/fault/health.py`. The digests
read each replica's slice of a dict of tensors through `.cpu().numpy()`
and walk the leaves in sorted-key order (`utils/tree.py:tree_leaves`,
the order `jax.tree.leaves` uses), so a digest equals the reference's
for the same state.

The detection half of the replica lifecycle (`fault/`): each replica
walks

    HEALTHY -> SUSPECT -> QUARANTINED -> REPAIRING -> HEALTHY

driven by three evidence streams —

- **worker exceptions** (`report_worker_exception`): a serve worker or
  combiner round that threw; one strike suspects by default because an
  exception out of a batch round is never routine.
- **stall counts** (`report_stall`): watchdog-visible no-progress
  rounds attributed to a replica (`NodeReplicated._watchdog` names the
  most dormant replica); `stall_threshold` strikes suspect it.
- **divergence votes** (`divergence_vote`): a periodic digest election
  over the `[R, ...]` state pytree. Every replica's slice is hashed;
  replicas whose digest differs from the majority digest are the
  minority — with deterministic replay from common init, a minority
  digest can only mean corruption, so the vote NAMES the broken
  replica(s) instead of merely observing `states_equal() == False`.

A SUSPECT replica either clears probation (`clear_suspect`, back to
HEALTHY) or is quarantined. QUARANTINED replicas are fenced out of the
log's `head = min(ltails)` GC reduction by the wrapper
(`NodeReplicated.fence_replica`, `core/log.py` fenced mask) so one dead
replica cannot stall log GC for the fleet. Repair
(`fault/repair.py`) walks QUARANTINED -> REPAIRING -> HEALTHY; a failed
repair drops back to QUARANTINED for another attempt.

Every transition is recorded in the tracker's timeline, emitted as a
`fault-transition` trace event, and counted (`fault.quarantine` on
entry to QUARANTINED) — `obs/report.py`'s fault section renders the
per-replica timeline from exactly these events.
"""

from __future__ import annotations

import hashlib

from node_replication_torch.analysis.locks import make_lock
from collections import Counter

import numpy as np

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer
from node_replication_torch.utils.tree import tree_leaves

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
REPAIRING = "repairing"

STATES = (HEALTHY, SUSPECT, QUARANTINED, REPAIRING)

# Legal edges of the lifecycle machine. SUSPECT -> HEALTHY is probation
# clearing; REPAIRING -> QUARANTINED is a failed repair going back for
# another attempt.
_LEGAL = frozenset({
    (HEALTHY, SUSPECT),
    (SUSPECT, HEALTHY),
    (SUSPECT, QUARANTINED),
    (QUARANTINED, REPAIRING),
    (REPAIRING, HEALTHY),
    (REPAIRING, QUARANTINED),
})


class IllegalTransition(RuntimeError):
    """A transition outside the lifecycle machine's legal edge set."""

    def __init__(self, rid: int, frm: str, to: str):
        super().__init__(
            f"replica {rid}: illegal health transition {frm} -> {to}"
        )
        self.rid = rid
        self.frm = frm
        self.to = to


def state_digest(states, rid: int) -> str:
    """Stable content digest of replica `rid`'s slice of an `[R, ...]`
    state tree (host readback; probe-cadence cost, not hot-path)."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in tree_leaves(states):
        h.update(np.ascontiguousarray(leaf[rid].cpu().numpy()).tobytes())
    return h.hexdigest()


def divergence_vote(states) -> list[int]:
    """Digest election naming the minority replica(s).

    Returns the rids whose state digest differs from the STRICT
    majority digest ([] when the fleet is unanimous). Without a strict
    majority (> R/2 identical digests) the vote cannot tell corrupt
    from healthy — in a 2-replica fleet a 1-1 split would name an
    arbitrary bloc, and repairing from the "winner" could clone the
    corruption fleet-wide — so a quorumless split returns [] and the
    caller must fall back to out-of-band evidence (worker exceptions,
    a `recover()` from checkpoint).
    """
    leaves = tree_leaves(states)
    if not leaves:
        return []
    R = int(leaves[0].shape[0])
    digests = [state_digest(states, r) for r in range(R)]
    counts = Counter(digests)
    if len(counts) == 1:
        return []
    majority, n_major = counts.most_common(1)[0]
    if n_major * 2 <= R:
        return []  # no quorum: the vote cannot name a culprit
    return [r for r, d in enumerate(digests) if d != majority]


class HealthTracker:
    """Health states + strike counters for one fleet of `n` replicas.

    Thread-safe: serve workers, the watchdog, and the repair medic all
    report concurrently. Transition legality is enforced — an illegal
    edge raises `IllegalTransition` rather than silently teleporting a
    replica's state.
    """

    def __init__(self, n_replicas: int, exc_threshold: int = 1,
                 stall_threshold: int = 3):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if exc_threshold < 1 or stall_threshold < 1:
            raise ValueError("thresholds must be >= 1")
        # nrcheck: lock-order HealthTracker._lock -> Tracer._lock — state transitions emit trace events under the lock
        self._lock = make_lock("HealthTracker._lock")
        self._states = [HEALTHY] * n_replicas
        self._exc_counts = [0] * n_replicas
        self._stall_counts = [0] * n_replicas
        self.exc_threshold = exc_threshold
        self.stall_threshold = stall_threshold
        #: every transition, in order: (clock_ts, rid, from, to) —
        #: stamped with the injected clock (`utils/clock.py`;
        #: real-monotonic by default, virtual under simulation)
        self.timeline: list[tuple[float, int, str, str]] = []
        reg = get_registry()
        self._m_quarantine = reg.counter("fault.quarantine")

    # ------------------------------------------------------------- queries

    @property
    def n_replicas(self) -> int:
        return len(self._states)

    def state(self, rid: int) -> str:
        with self._lock:
            return self._states[rid]

    def states(self) -> list[str]:
        with self._lock:
            return list(self._states)

    def healthy_rids(self) -> list[int]:
        with self._lock:
            return [r for r, s in enumerate(self._states)
                    if s == HEALTHY]

    def snapshot(self) -> dict:
        """JSON-safe view: states, strike counters, timeline length."""
        with self._lock:
            return {
                "states": list(self._states),
                "exc_counts": list(self._exc_counts),
                "stall_counts": list(self._stall_counts),
                "transitions": len(self.timeline),
            }

    # ---------------------------------------------------------- transitions

    def _transition_locked(self, rid: int, to: str) -> None:
        frm = self._states[rid]
        if (frm, to) not in _LEGAL:
            raise IllegalTransition(rid, frm, to)
        self._states[rid] = to
        # injected clock, not time.monotonic(): under `SimClock`
        # (`sim/`) lifecycle timelines — and obs/report.py's fault
        # section built from them — carry meaningful virtual stamps
        self.timeline.append((get_clock().now(), rid, frm, to))
        if to == QUARANTINED:
            self._m_quarantine.inc()
        get_tracer().emit("fault-transition", rid=rid, frm=frm, to=to)

    def transition(self, rid: int, to: str) -> None:
        """One legal edge (raises `IllegalTransition` otherwise)."""
        with self._lock:
            self._transition_locked(rid, to)

    def grow(self, k: int = 1) -> None:
        """Track `k` new replicas (the `grow_fleet` twin); newcomers
        start HEALTHY."""
        with self._lock:
            self._states.extend([HEALTHY] * k)
            self._exc_counts.extend([0] * k)
            self._stall_counts.extend([0] * k)

    # ------------------------------------------------------------- evidence

    def report_worker_exception(self, rid: int, exc=None) -> str:
        """A worker/combiner exception attributed to `rid`; suspects the
        replica once `exc_threshold` strikes accumulate. Returns the
        post-report state."""
        del exc  # classification hook: today every exception is a strike
        with self._lock:
            self._exc_counts[rid] += 1
            if (self._states[rid] == HEALTHY
                    and self._exc_counts[rid] >= self.exc_threshold):
                self._transition_locked(rid, SUSPECT)
            return self._states[rid]

    def report_stall(self, rid: int) -> str:
        """A watchdog no-progress round attributed to `rid` (the most
        dormant replica); suspects after `stall_threshold` strikes."""
        with self._lock:
            self._stall_counts[rid] += 1
            if (self._states[rid] == HEALTHY
                    and self._stall_counts[rid] >= self.stall_threshold):
                self._transition_locked(rid, SUSPECT)
            return self._states[rid]

    def clear_suspect(self, rid: int) -> None:
        """Probation cleared: SUSPECT back to HEALTHY, strikes reset."""
        with self._lock:
            self._transition_locked(rid, HEALTHY)
            self._exc_counts[rid] = 0
            self._stall_counts[rid] = 0

    def quarantine(self, rid: int) -> None:
        """Drive `rid` to QUARANTINED (through SUSPECT when needed —
        a divergence vote quarantines a HEALTHY replica directly)."""
        with self._lock:
            if self._states[rid] == HEALTHY:
                self._transition_locked(rid, SUSPECT)
            self._transition_locked(rid, QUARANTINED)

    def probe(self, states) -> list[int]:
        """Run one divergence vote over the fleet's state pytree and
        quarantine every named minority replica not already in the
        repair pipeline. Returns the rids the vote named."""
        minority = divergence_vote(states)
        for rid in minority:
            with self._lock:
                if self._states[rid] in (HEALTHY, SUSPECT):
                    if self._states[rid] == HEALTHY:
                        self._transition_locked(rid, SUSPECT)
                    self._transition_locked(rid, QUARANTINED)
        return minority
