"""The port's `fault/` lifecycle (`node_replication_torch/fault/`)
against the reference's: twins of `tests/test_fault.py`'s health state
machine, repair bit-identity and serve failover cases on `device="cpu"`
fleets, and the health digests of the port equal to the reference's for
the same states (so a divergence vote names the same replica in both).
"""

import threading
import time

import numpy as np
import pytest
import torch

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.fault import corrupt_states as j_corrupt_states
from node_replication_tpu.fault import divergence_vote as j_divergence_vote
from node_replication_tpu.fault import state_digest as j_state_digest
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg

from node_replication_torch.core.replica import (
    NodeReplicated,
    ReplicaFencedError,
)
from node_replication_torch.fault import (
    HEALTHY,
    QUARANTINED,
    REPAIRING,
    SUSPECT,
    FaultError,
    FaultPlan,
    FaultSpec,
    HealthTracker,
    IllegalTransition,
    ReplicaLifecycleManager,
    corrupt_states,
    divergence_vote,
    repair_replica,
    state_digest,
)
from node_replication_torch.models import (
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.serve import (
    FrontendClosed,
    ReplicaFailed,
    RetryPolicy,
    ServeConfig,
    ServeFrontend,
    call_with_retry,
)
from node_replication_torch.utils.clock import SimClock, installed
from node_replication_torch.utils.tree import tree_leaves


def small_nr(dispatch=None, **kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("log_entries", 512)
    kw.setdefault("gc_slack", 32)
    kw.setdefault("exec_window", 64)
    return NodeReplicated(dispatch or make_seqreg(4), device="cpu", **kw)


class TestHealthStateMachine:
    def test_full_lifecycle_walk(self):
        h = HealthTracker(2)
        assert h.state(0) == HEALTHY
        assert h.report_worker_exception(0) == SUSPECT
        h.transition(0, QUARANTINED)
        h.transition(0, REPAIRING)
        h.transition(0, HEALTHY)
        assert h.state(0) == HEALTHY
        assert h.state(1) == HEALTHY  # untouched
        walked = [(rid, frm, to) for _, rid, frm, to in h.timeline]
        assert walked == [
            (0, HEALTHY, SUSPECT), (0, SUSPECT, QUARANTINED),
            (0, QUARANTINED, REPAIRING), (0, REPAIRING, HEALTHY),
        ]

    def test_timeline_stamps_use_injected_clock(self):
        # the lifecycle timeline carries the injected clock's stamps
        with installed(SimClock(start=100.0)) as clock:
            h = HealthTracker(1)
            h.report_worker_exception(0)
            clock.advance(0.5)
            h.quarantine(0)
        stamps = [ts for ts, *_ in h.timeline]
        assert stamps == [100.0, 100.5]

    def test_illegal_transitions_raise(self):
        h = HealthTracker(1)
        with pytest.raises(IllegalTransition):
            h.transition(0, REPAIRING)  # healthy -> repairing
        h.report_worker_exception(0)
        with pytest.raises(IllegalTransition):
            h.transition(0, REPAIRING)  # suspect -> repairing

    def test_failed_repair_goes_back_to_quarantine(self):
        h = HealthTracker(1)
        h.quarantine(0)
        h.transition(0, REPAIRING)
        h.transition(0, QUARANTINED)  # legal: repair failed
        assert h.state(0) == QUARANTINED

    def test_stall_threshold(self):
        h = HealthTracker(1, stall_threshold=3)
        assert h.report_stall(0) == HEALTHY
        assert h.report_stall(0) == HEALTHY
        assert h.report_stall(0) == SUSPECT

    def test_probation_clears_strikes(self):
        h = HealthTracker(1, exc_threshold=2)
        h.report_worker_exception(0)
        h.report_worker_exception(0)
        assert h.state(0) == SUSPECT
        h.clear_suspect(0)
        assert h.state(0) == HEALTHY
        # strikes were reset: one new strike does not re-suspect
        assert h.report_worker_exception(0) == HEALTHY

    def test_healthy_rids_and_grow(self):
        h = HealthTracker(3)
        h.quarantine(1)
        assert h.healthy_rids() == [0, 2]
        h.grow(2)
        assert h.healthy_rids() == [0, 2, 3, 4]

    def test_divergence_vote_names_minority(self):
        nr = small_nr(make_seqreg(4), n_replicas=3)
        nr.execute_mut_batch([(SR_SET, i % 4, i + 1)
                              for i in range(12)], rid=0)
        nr.sync()
        assert divergence_vote(nr.states) == []
        nr.states = corrupt_states(nr.states, 1)
        assert divergence_vote(nr.states) == [1]

    def test_vote_without_quorum_names_nobody(self):
        # a 1-1 split in a 2-replica fleet has no strict majority: the
        # vote must NOT name anyone — acting on an arbitrary bloc
        # could quarantine the healthy replica and clone the corrupt
        # donor fleet-wide
        nr = small_nr(make_seqreg(4), n_replicas=2)
        nr.execute_mut_batch([(SR_SET, 0, 1)], rid=0)
        nr.sync()
        nr.states = corrupt_states(nr.states, 0)
        assert divergence_vote(nr.states) == []
        h = HealthTracker(2)
        assert h.probe(nr.states) == []
        assert h.states() == [HEALTHY, HEALTHY]

    def test_probe_quarantines_minority(self):
        nr = small_nr(make_seqreg(4), n_replicas=3)
        nr.sync()
        nr.states = corrupt_states(nr.states, 2)
        h = HealthTracker(3)
        assert h.probe(nr.states) == [2]
        assert h.state(2) == QUARANTINED
        # a second probe does not re-quarantine (already in pipeline)
        assert h.probe(nr.states) == [2]
        assert h.states().count(QUARANTINED) == 1



class TestRepairBitIdentity:
    def test_repaired_state_matches_never_faulted_fleet(self):
        # fleet A suffers a corruption + quarantine + repair mid-way
        # through an op stream; fleet B runs the same stream untouched.
        # Deterministic replay makes their final states bit-identical.
        def ops(base):
            return [(SR_SET, i % 4, base + i + 1) for i in range(40)]

        a = small_nr(make_seqreg(4), n_replicas=3)
        b = small_nr(make_seqreg(4), n_replicas=3)
        a.execute_mut_batch(ops(0), rid=0)
        b.execute_mut_batch(ops(0), rid=0)
        a.sync()
        b.sync()

        a.states = corrupt_states(a.states, 1)
        assert divergence_vote(a.states) == [1]
        a.fence_replica(1)
        a.execute_mut_batch(ops(100), rid=0)  # traffic during repair
        b.execute_mut_batch(ops(100), rid=0)
        report = repair_replica(a, 1)
        assert report["rid"] == 1 and report["donor"] != 1
        a.sync()
        b.sync()
        assert a.replicas_equal() and b.replicas_equal()
        assert divergence_vote(a.states) == []
        for la, lb in zip(tree_leaves(a.states), tree_leaves(b.states)):
            assert torch.equal(la, lb)

    def test_repair_after_ring_wrap(self):
        # the fenced cursor falls behind the GC head and the ring
        # wraps over its entries; repair must still be exact because
        # it replays from the DONOR's cursor, not the corpse's
        nr = small_nr(make_seqreg(2), log_entries=128, gc_slack=16)
        nr.execute_mut_batch([(SR_SET, 0, i + 1)
                              for i in range(10)], rid=0)
        nr.sync()
        nr.fence_replica(1)
        expect = 10
        for _ in range(4):
            nr.execute_mut_batch(
                [(SR_SET, 0, expect + j + 1) for j in range(60)],
                rid=0,
            )
            expect += 60
        assert int(nr.log.tail) > 128  # wrapped
        repair_replica(nr, 1)
        nr.sync()
        assert nr.replicas_equal()
        reader = nr.register(1)
        assert nr.execute((SR_GET, 0), reader) == expect

    def test_manager_probe_repairs_silent_corruption(self):
        nr = small_nr(make_seqreg(4), n_replicas=3)
        nr.execute_mut_batch([(SR_SET, i % 4, i + 1)
                              for i in range(12)], rid=0)
        nr.sync()
        mgr = ReplicaLifecycleManager(nr)
        assert mgr.probe() == []  # healthy fleet: vote is unanimous
        nr.states = corrupt_states(nr.states, 2)
        assert mgr.probe() == [2]
        assert mgr.health.state(2) == HEALTHY  # repaired
        assert len(mgr.repairs) == 1
        nr.sync()
        assert nr.replicas_equal()



class TestServeFailover:
    CLIENTS = 8
    PER_CLIENT = 60

    def test_kill_under_load_no_loss_no_dup_no_hang(self):
        """The acceptance story: 8 clients, a kill mid-run, and every
        client gets either a correct response or a retryable
        `ReplicaFailed`; with retry enabled nothing is lost and the
        seqreg oracle proves nothing duplicated."""
        nr = small_nr(make_seqreg(self.CLIENTS), n_replicas=2,
                      log_entries=2048, gc_slack=128,
                      exec_window=128)
        fe = ServeFrontend(nr, ServeConfig(
            queue_depth=128, batch_max_ops=16, batch_linger_s=0.0,
            failover=True,
        ))
        mgr = ReplicaLifecycleManager(nr, fe)
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=10)])
        errors: list = []

        def client(c):
            rid = c % 2
            pol = RetryPolicy(max_attempts=16, base_backoff_s=0.001,
                              max_backoff_s=0.1)
            for i in range(self.PER_CLIENT):
                try:
                    resp = call_with_retry(
                        fe, (SR_SET, c, i + 1), rid=rid, policy=pol,
                        timeout=120.0,
                    )
                except ReplicaFailed as e:
                    # acceptable ONLY if typed retryable (policy
                    # exhausted); an unretryable one means a possible
                    # duplicate and fails the test
                    if not e.retryable:
                        errors.append((c, i, "unretryable", str(e)))
                    else:
                        errors.append((c, i, "exhausted", str(e)))
                    return
                except Exception as e:  # no hangs, no untyped errors
                    errors.append((c, i, type(e).__name__, str(e)))
                    return
                if resp != i:
                    errors.append((c, i, "sequence", resp))
                    return

        with plan.armed():
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(self.CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads), "hung client"
        assert not errors, errors[:5]
        assert plan.fired, "kill never fired"
        assert mgr.wait_idle(60)
        assert mgr.health.state(1) == HEALTHY
        assert len(mgr.repairs) == 1
        # the repaired replica serves again on its own queue
        assert fe.healthy_rids() == [0, 1]
        assert fe.call((SR_SET, 0, self.PER_CLIENT + 1), rid=1,
                       timeout=60.0) == self.PER_CLIENT
        st = fe.stats()
        assert st["completed"] == self.CLIENTS * self.PER_CLIENT + 1
        fe.close()
        nr.sync()
        assert nr.replicas_equal()

    def test_submit_to_failed_replica_is_typed_retryable(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                           failover=True))
        mgr = ReplicaLifecycleManager(nr, fe)
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        with plan.armed():
            fut = fe.submit((SR_SET, 0, 1), rid=1)
            with pytest.raises(ReplicaFailed) as ei:
                fut.result(30.0)
            assert ei.value.retryable  # pre-append kill: exactly-once
            # mid-quarantine submits are typed + retryable, never hangs
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    fe.submit((SR_SET, 0, 2), rid=1)
                    break  # restarted already
                except ReplicaFailed as e:
                    assert e.retryable
                    time.sleep(0.01)
        assert mgr.wait_idle(60)
        assert fe.call((SR_SET, 1, 1), rid=1, timeout=30.0) == 0
        fe.close()

    def test_queued_requests_rehomed_to_healthy_replica(self):
        # a paused frontend stacks a backlog on the victim; the first
        # batch takes some, the kill re-homes the remainder onto the
        # healthy replica — every future still resolves correctly
        # (fresh slots: order across replicas is immaterial)
        nr = small_nr(make_seqreg(16), n_replicas=2)
        fe = ServeFrontend(
            nr,
            ServeConfig(queue_depth=32, batch_max_ops=4,
                        batch_linger_s=0.0, failover=True),
            auto_start=False,
        )
        mgr = ReplicaLifecycleManager(nr, fe)
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        futs = [fe.submit((SR_SET, s, 7), rid=1) for s in range(12)]
        with plan.armed():
            fe.start()
            outcomes = []
            for s, fut in enumerate(futs):
                try:
                    outcomes.append(("ok", fut.result(60.0)))
                except ReplicaFailed as e:
                    assert e.retryable
                    outcomes.append(("failed", None))
        assert mgr.wait_idle(60)
        oks = [o for o in outcomes if o[0] == "ok"]
        # the first batch (up to batch_max_ops) died; the re-homed
        # remainder completed with the correct previous value 0
        assert len(oks) >= 12 - 4
        assert all(v == 0 for _, v in oks)
        assert fe.stats()["rehomed"] >= 8
        fe.close()

    def test_maybe_executed_is_not_auto_retried(self):
        class OneShotFrontend:
            def __init__(self):
                self.calls = 0

            def call(self, op, rid=0, deadline_s=None, timeout=None):
                self.calls += 1
                raise ReplicaFailed(rid, RuntimeError("mid-replay"),
                                    maybe_executed=True)

            def healthy_rids(self):
                return [0, 1]

        fe = OneShotFrontend()
        with pytest.raises(ReplicaFailed) as ei:
            call_with_retry(fe, (SR_SET, 0, 1),
                            policy=RetryPolicy(max_attempts=5))
        assert fe.calls == 1  # refused: retry could duplicate the op
        assert not ei.value.retryable

    def test_retry_reroutes_to_healthy_rid(self):
        class FailThenServe:
            def __init__(self):
                self.rids_seen = []

            def call(self, op, rid=0, deadline_s=None, timeout=None):
                self.rids_seen.append(rid)
                if rid == 1:
                    raise ReplicaFailed(1, maybe_executed=False)
                return 42

            def healthy_rids(self):
                return [0]

        fe = FailThenServe()
        out = call_with_retry(
            fe, (SR_SET, 0, 1), rid=1,
            policy=RetryPolicy(max_attempts=4, base_backoff_s=0.0001,
                               max_backoff_s=0.001),
        )
        assert out == 42
        assert fe.rids_seen == [1, 0]

    def test_repair_runs_even_below_suspect_threshold(self):
        # a tracker with exc_threshold > 1 leaves the replica HEALTHY
        # after the single report that killed its worker; the medic
        # must still quarantine (through SUSPECT) and repair — not die
        # on an illegal HEALTHY -> QUARANTINED edge
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                           failover=True))
        mgr = ReplicaLifecycleManager(
            nr, fe, health=HealthTracker(2, exc_threshold=3)
        )
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        with plan.armed():
            fut = fe.submit((SR_SET, 0, 1), rid=1)
            with pytest.raises(ReplicaFailed):
                fut.result(30.0)
        assert mgr.wait_idle(60)
        assert len(mgr.repairs) == 1
        assert mgr.health.state(1) == HEALTHY
        assert fe.call((SR_SET, 0, 1), rid=1, timeout=30.0) == 0
        fe.close()

    def test_closed_frontend_wins_over_failed_replica(self):
        # FrontendClosed is permanent; after close() a still-failed
        # rid must not feed retry loops a retryable ReplicaFailed
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                           failover=True))
        # no lifecycle manager: the replica stays failed
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        with plan.armed():
            fut = fe.submit((SR_SET, 0, 1), rid=1)
            with pytest.raises(ReplicaFailed):
                fut.result(30.0)
        with pytest.raises(ReplicaFailed):
            fe.submit((SR_SET, 0, 2), rid=1)  # open + failed: typed
        fe.close()
        with pytest.raises(FrontendClosed):
            fe.submit((SR_SET, 0, 3), rid=1)  # closed: permanent

    def test_rehome_does_not_double_count_accepted(self):
        nr = small_nr(make_seqreg(8), n_replicas=2)
        fe = ServeFrontend(
            nr,
            ServeConfig(queue_depth=32, batch_max_ops=4,
                        batch_linger_s=0.0, failover=True),
            auto_start=False,
        )
        mgr = ReplicaLifecycleManager(nr, fe)
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        futs = [fe.submit((SR_SET, s, 7), rid=1) for s in range(8)]
        assert fe.stats()["accepted"] == 8
        with plan.armed():
            fe.start()
            for fut in futs:
                try:
                    fut.result(60.0)
                except ReplicaFailed:
                    pass
        assert mgr.wait_idle(60)
        fe.drain(30.0)
        st = fe.stats()
        # re-homing moved requests, it did not re-admit them: the 8
        # original admissions stay 8 (retired-queue folding included)
        assert st["accepted"] == 8, st
        assert st["rehomed"] >= 4
        fe.close()

    def test_restart_requires_failed_replica(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, ServeConfig(failover=True))
        with pytest.raises(ValueError):
            fe.restart_replica(0)
        fe.close()

    def test_failover_off_keeps_worker_alive(self):
        # the pre-fault contract: without failover a failed batch
        # rejects its own futures and the SAME worker keeps serving
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0))
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=0, after=0)])
        with plan.armed():
            fut = fe.submit((SR_SET, 0, 1), rid=0)
            with pytest.raises(FaultError):
                fut.result(30.0)
        assert fe.healthy_rids() == [0, 1]
        assert fe.call((SR_SET, 0, 1), rid=0, timeout=30.0) == 0
        fe.close()


class TestFencedGrow:
    def test_grow_fleet_never_clones_fenced_donor(self):
        nr = small_nr(make_seqreg(2), n_replicas=2)
        nr.execute_mut_batch([(SR_SET, 0, i + 1)
                              for i in range(8)], rid=0)
        nr.sync()
        nr.states = corrupt_states(nr.states, 1)
        nr.fence_replica(1)
        with pytest.raises(ReplicaFencedError):
            nr.grow_fleet(1, donor=1)
        new = nr.grow_fleet(1)  # auto-donor must pick replica 0
        repair_replica(nr, 1)
        nr.sync()
        assert nr.replicas_equal()
        assert nr.n_replicas == 3 and new == [2]



@pytest.mark.parametrize("model", ["seqreg", "hashmap"])
def test_digests_and_votes_equal_the_reference(model):
    """The same seeded stream into a reference fleet and a port fleet:
    every replica's digest is the reference's, before and after the
    same replica is corrupted in both, and the votes name it alike."""
    rng = np.random.default_rng(11)
    kw = dict(n_replicas=3, log_entries=256, gc_slack=32, exec_window=64)
    if model == "seqreg":
        jn, tn = JNR(j_make_seqreg(8), **kw), small_nr(make_seqreg(8), **kw)
        ops = [(1, int(rng.integers(-8, 16)), int(rng.integers(1 << 30)))
               for _ in range(90)]
    else:
        jn = JNR(j_make_hashmap(16), **kw)
        tn = small_nr(make_hashmap(16), **kw)
        ops = [(int(rng.integers(1, 3)), int(rng.integers(-16, 32)),
                int(rng.integers(1 << 30))) for _ in range(90)]
    for i in range(0, len(ops), 30):
        assert (jn.execute_mut_batch(ops[i:i + 30], rid=i % 3)
                == tn.execute_mut_batch(ops[i:i + 30], rid=i % 3))
    jn.sync()
    tn.sync()
    for r in range(3):
        assert j_state_digest(jn.states, r) == state_digest(tn.states, r)
    assert divergence_vote(tn.states) == j_divergence_vote(jn.states) == []
    jn.states = j_corrupt_states(jn.states, 2)
    tn.states = corrupt_states(tn.states, 2)
    for r in range(3):
        assert j_state_digest(jn.states, r) == state_digest(tn.states, r)
    assert divergence_vote(tn.states) == j_divergence_vote(jn.states) == [2]
