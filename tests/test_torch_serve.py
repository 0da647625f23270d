"""The port's serve layer (`node_replication_torch/serve/`) against the
reference's (`node_replication_tpu/serve/`).

Twins of `tests/test_serve.py`'s future, admission, deadline, drain,
retry, read-path, config, elasticity and pipelined (NodeReplicated)
cases, run on the port over `device="cpu"` fleets, and a differential:
one closed-loop client drives the same seeded op stream through a
reference frontend and a port frontend; responses, reads, ring planes,
the int64 cursors and every replica's state must be bit-identical.
"""

import threading
import time
from collections import deque

import numpy as np
import pytest

from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.models import make_seqreg as j_make_seqreg
from node_replication_tpu.serve import ServeConfig as JServeConfig
from node_replication_tpu.serve import ServeFrontend as JServeFrontend

from node_replication_torch import interop
from node_replication_torch.core.log import ring_slice
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.fault.inject import FaultPlan, FaultSpec
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_seqreg,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.serve import (
    DeadlineExceeded,
    FrontendClosed,
    Overloaded,
    ReplicaFailed,
    RetryPolicy,
    ServeConfig,
    ServeFrontend,
    call_with_retry,
)
from node_replication_torch.serve.future import ServeFuture
from node_replication_torch.utils.clock import SimClock, installed


def small_nr(dispatch=None, **kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("log_entries", 512)
    kw.setdefault("gc_slack", 32)
    kw.setdefault("exec_window", 64)
    return NodeReplicated(dispatch or make_hashmap(64), device="cpu", **kw)


def fast_cfg(**kw):
    kw.setdefault("batch_linger_s", 0.0)
    return ServeConfig(**kw)


class TestServeFuture:
    def test_resolve_and_done(self):
        f = ServeFuture(rid=0)
        assert not f.done()
        assert f._resolve(42)
        assert f.done() and f.result(timeout=1.0) == 42
        assert f.exception(timeout=1.0) is None
        assert f.latency_s is not None and f.latency_s >= 0

    def test_single_resolution_wins(self):
        f = ServeFuture(rid=0)
        assert f._resolve(1)
        assert not f._reject(RuntimeError("late"))
        assert f.result(timeout=1.0) == 1

    def test_reject_raises_typed(self):
        f = ServeFuture(rid=3)
        f._reject(Overloaded(3, 8))
        with pytest.raises(Overloaded):
            f.result(timeout=1.0)
        assert isinstance(f.exception(timeout=1.0), Overloaded)

    def test_result_timeout(self):
        f = ServeFuture(rid=0)
        with pytest.raises(TimeoutError):
            f.result(timeout=0.01)

    def test_callbacks_before_and_after(self):
        f = ServeFuture(rid=0)
        seen = []
        f.add_done_callback(lambda fut: seen.append(("pre", fut.result(0))))
        f._resolve(5)
        f.add_done_callback(
            lambda fut: seen.append(("post", fut.result(0))))
        assert seen == [("pre", 5), ("post", 5)]

    def test_callback_exception_swallowed(self):
        f = ServeFuture(rid=0)

        def bad(fut):
            raise RuntimeError("handler bug")

        f.add_done_callback(bad)
        assert f._resolve(1)  # must not raise
        assert f.result(timeout=1.0) == 1


class TestAdmissionControl:
    def test_overload_typed_and_counted(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(queue_depth=4), auto_start=False)
        futs = [fe.submit((SR_SET, 0, i + 1)) for i in range(4)]
        with pytest.raises(Overloaded) as ei:
            fe.submit((SR_SET, 0, 99))
        assert ei.value.rid == 0 and ei.value.depth == 4
        st = fe.stats()
        assert st["shed"] == 1 and st["accepted"] == 4
        fe.start()
        assert [f.result(10.0) for f in futs] == [0, 1, 2, 3]
        assert fe.stats()["completed"] == 4
        fe.close()

    def test_unknown_rid_raises(self):
        fe = ServeFrontend(small_nr(), fast_cfg())
        with pytest.raises(ValueError):
            fe.submit((HM_PUT, 0, 0), rid=7)
        with pytest.raises(ValueError):
            fe.read((HM_GET, 0), rid=7)
        fe.close()

    def test_backpressure_bounds_memory(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(queue_depth=8), auto_start=False)
        shed = 0
        for i in range(1000):
            try:
                fe.submit((SR_SET, 0, i + 1))
            except Overloaded:
                shed += 1
        st = fe.stats()
        assert shed == 992
        assert st["queued"] == 8 and st["shed"] == 992
        fe.start()
        fe.close()  # drains the 8 accepted
        assert fe.stats()["completed"] == 8


class TestDeadlines:
    def test_expired_request_dropped_before_append(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(), auto_start=False)
        fut = fe.submit((SR_SET, 0, 77), deadline_s=0.005)
        time.sleep(0.05)
        fe.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(10.0)
        fe.drain(timeout=30.0)
        assert fe.read((SR_GET, 0)) == 0  # the op had no effect
        assert fe.stats()["deadline_missed"] == 1
        assert fe.call((SR_SET, 0, 1), timeout=10.0) == 0
        fe.close()

    def test_default_deadline_from_config(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(default_deadline_s=0.005),
                           auto_start=False)
        fut = fe.submit((SR_SET, 1, 5))
        time.sleep(0.05)
        fe.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(10.0)
        fe.close()
        assert int(nr.log.tail) == 0


class TestDrainClose:
    def test_close_drains_queued_ops(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg())
        futs = [fe.submit((SR_SET, 0, i + 1), rid=0) for i in range(50)]
        fe.close()  # drain=True: flush everything first
        assert [f.result(0.0) for f in futs] == list(range(50))
        assert fe.stats()["completed"] == 50

    def test_close_without_drain_rejects_backlog(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(), auto_start=False)
        futs = [fe.submit((SR_SET, 0, i + 1)) for i in range(5)]
        fe.close(drain=False)
        for f in futs:
            with pytest.raises(FrontendClosed):
                f.result(1.0)
        assert int(nr.log.tail) == 0  # the ops never executed

    def test_submit_after_close_raises(self):
        fe = ServeFrontend(small_nr(), fast_cfg())
        fe.close()
        with pytest.raises(FrontendClosed):
            fe.submit((HM_PUT, 0, 0))
        fe.close()  # idempotent

    def test_context_manager_drains(self):
        nr = small_nr(make_seqreg(2))
        with ServeFrontend(nr, fast_cfg()) as fe:
            futs = [fe.submit((SR_SET, 1, i + 1)) for i in range(20)]
        assert [f.result(0.0) for f in futs] == list(range(20))

    def test_drain_is_a_flush_not_a_shutdown(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg())
        fe.submit((SR_SET, 0, 1))
        assert fe.drain(timeout=30.0)
        assert fe.stats()["queued"] == 0
        assert fe.call((SR_SET, 0, 2), timeout=10.0) == 1
        fe.close()


class TestRetry:
    class FlakyFrontend:
        def __init__(self, fail_times):
            self.fail_times = fail_times
            self.calls = 0

        def call(self, op, rid=0, deadline_s=None, timeout=None):
            self.calls += 1
            if self.calls <= self.fail_times:
                raise Overloaded(rid, 8)
            return 42

    def test_retries_overloaded_then_succeeds(self):
        fe = self.FlakyFrontend(fail_times=2)
        sheds = []
        policy = RetryPolicy(max_attempts=5, base_backoff_s=0.0001,
                             max_backoff_s=0.001)
        out = call_with_retry(fe, (HM_PUT, 0, 0), policy=policy,
                              on_shed=lambda a, d: sheds.append(a))
        assert out == 42 and fe.calls == 3
        assert sheds == [0, 1]

    def test_policy_exhaustion_reraises(self):
        fe = self.FlakyFrontend(fail_times=99)
        policy = RetryPolicy(max_attempts=3, base_backoff_s=0.0001,
                             max_backoff_s=0.001)
        sheds = []
        with pytest.raises(Overloaded):
            call_with_retry(fe, (HM_PUT, 0, 0), policy=policy,
                            on_shed=lambda a, d: sheds.append(a))
        assert fe.calls == 3
        assert sheds == [0, 1, 2]

    @pytest.mark.parametrize("kw", [dict(max_attempts=0),
                                    dict(total_deadline_s=0.0),
                                    dict(total_deadline_s=-1.0)])
    def test_policy_validation(self, kw):
        with pytest.raises(ValueError):
            RetryPolicy(**kw)

    def test_backoff_caps(self):
        import random

        policy = RetryPolicy(base_backoff_s=0.01, max_backoff_s=0.04)
        rng = random.Random(7)
        for attempt in range(10):
            assert 0.0 <= policy.backoff_s(attempt, rng) <= 0.04

    def test_total_deadline_budget_bounds_attempts(self):
        fe = self.FlakyFrontend(fail_times=99)
        policy = RetryPolicy(max_attempts=50, base_backoff_s=0.5,
                             max_backoff_s=2.0, total_deadline_s=3.0)
        with installed(SimClock()) as clock:
            with pytest.raises(Overloaded):
                call_with_retry(fe, (HM_PUT, 0, 0), policy=policy)
            assert clock.now() <= 3.0 + 1e-9
        assert fe.calls < 50

    def test_no_backoff_outlives_the_budget(self):
        fe = self.FlakyFrontend(fail_times=99)
        delays = []
        policy = RetryPolicy(max_attempts=50, base_backoff_s=1.0,
                             max_backoff_s=10.0, total_deadline_s=2.0)
        with installed(SimClock()) as clock:
            with pytest.raises(Overloaded):
                call_with_retry(fe, (HM_PUT, 0, 0), policy=policy,
                                on_shed=lambda a, d: delays.append(d))
            now = clock.now()
        assert delays and all(d <= 2.0 for d in delays)
        assert now <= 2.0 + 1e-9

    def test_budget_exhausted_before_sleep_reraises(self):
        fe = self.FlakyFrontend(fail_times=99)
        policy = RetryPolicy(max_attempts=5, base_backoff_s=1e9,
                             max_backoff_s=1e9, total_deadline_s=0.5)
        with installed(SimClock()) as clock:
            with pytest.raises(Overloaded):
                call_with_retry(fe, (HM_PUT, 0, 0), policy=policy)
            assert clock.now() == 0.0  # gave up without sleeping
        assert fe.calls >= 1

    def test_no_budget_keeps_legacy_behavior(self):
        fe = self.FlakyFrontend(fail_times=2)
        policy = RetryPolicy(max_attempts=5, base_backoff_s=0.0001,
                             max_backoff_s=0.001)
        assert policy.total_deadline_s is None
        assert call_with_retry(fe, (HM_PUT, 0, 0), policy=policy) == 42


class TestReadPath:
    def test_read_your_writes_and_no_queue_traffic(self):
        nr = small_nr()
        fe = ServeFrontend(nr, fast_cfg())
        assert fe.call((HM_PUT, 3, 30), rid=0, timeout=10.0) == 0
        before = fe.stats()["accepted"]
        assert fe.read((HM_GET, 3), rid=0) == 30
        assert fe.read((HM_GET, 3), rid=1) == 30
        assert fe.stats()["accepted"] == before
        fe.close()


class TestConfigValidation:
    @pytest.mark.parametrize("kw", [dict(queue_depth=0),
                                    dict(batch_max_ops=0),
                                    dict(batch_linger_s=-1.0),
                                    dict(pipeline_depth=2),
                                    dict(pipeline_depth=-1),
                                    dict(durability="sometimes")])
    def test_bad_config_raises(self, kw):
        with pytest.raises(ValueError):
            ServeConfig(**kw)

    def test_frontend_requires_batch_entry_point(self):
        with pytest.raises(TypeError):
            ServeFrontend(object())

    @pytest.mark.parametrize("kw,module", [
        (dict(obs_port=0), "obs/export.py"),
        (dict(profile_hz=10.0), "obs/profile.py"),
    ])
    def test_unported_obs_options_raise(self, kw, module):
        # each obs knob builds its module's object (the exporter as
        # the primary under the configured node id, a running
        # profiler), and close() stops it
        fe = ServeFrontend(small_nr(), ServeConfig(obs_node_id="n7", **kw),
                           auto_start=False)
        built = fe.exporter if module == "obs/export.py" else fe.profiler
        other = fe.profiler if module == "obs/export.py" else fe.exporter
        assert other is None
        assert type(built).__module__ == \
            "node_replication_torch." + module[:-3].replace("/", ".")
        if fe.exporter is not None:
            assert (built.node_id, built.role) == ("n7", "primary")
            assert built.accept_thread.is_alive()
        else:
            assert built.running
        fe.close()
        assert not (built.accept_thread.is_alive()
                    if fe.exporter is not None else built.running)

    def test_durability_needs_a_wal(self):
        with pytest.raises(ValueError, match="WAL"):
            ServeFrontend(small_nr(), ServeConfig(durability="batch"))


def _seq_clients(fe, n_clients, per_client, window, grow_at=None):
    """Pipelined sequence-numbered clients: client c owns register c
    and writes 1..per_client; every fetch-and-set must return the
    previous value. Client 0 grows the fleet once mid-traffic."""
    errors, grown = [], threading.Event()

    def client(c):
        rid = c % 2
        outstanding = deque()

        def harvest(down_to):
            while len(outstanding) > down_to:
                i, fut = outstanding.popleft()
                resp = fut.result(timeout=120.0)
                if resp != i:
                    errors.append((c, i, resp))
                    raise AssertionError("sequence broken")

        try:
            for i in range(per_client):
                outstanding.append((i, fe.submit((SR_SET, c, i + 1),
                                                 rid=rid)))
                harvest(window - 1)
                if c == 0 and i == grow_at:
                    fe.grow(1)
                    grown.set()
            harvest(0)
        except AssertionError:
            pass
        except BaseException as e:  # pragma: no cover
            errors.append((c, type(e).__name__, str(e)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return errors, grown


class TestElasticityUnderLoad:
    """grow_fleet while serve traffic is in flight: the 8-thread, 10k-op
    sequence-numbered check at both pipeline depths."""

    CLIENTS = 8
    PER_CLIENT = 1250

    @pytest.mark.parametrize("depth", [0, 1])
    def test_grow_mid_traffic_loses_nothing(self, depth):
        nr = small_nr(make_seqreg(self.CLIENTS), n_replicas=2,
                      log_entries=4096, gc_slack=256, exec_window=256)
        fe = ServeFrontend(nr, fast_cfg(queue_depth=512, batch_max_ops=64,
                                        pipeline_depth=depth))
        errors, grown = _seq_clients(fe, self.CLIENTS, self.PER_CLIENT,
                                     window=32,
                                     grow_at=self.PER_CLIENT // 2)
        assert not errors, errors[:5]
        assert grown.is_set() and nr.n_replicas == 3
        for c in range(self.CLIENTS):
            resp = fe.call((SR_SET, c, self.PER_CLIENT + 2), rid=2,
                           timeout=60.0)
            assert resp == self.PER_CLIENT, (c, resp)
        st = fe.stats()
        assert st["completed"] == st["accepted"]
        assert st["deadline_missed"] == 0
        fe.close()
        nr.sync()
        assert nr.replicas_equal()
        reader = nr.register(2)
        for c in range(self.CLIENTS):
            assert nr.execute((SR_GET, c), reader) == self.PER_CLIENT + 2


class TestPipelinedServing:
    def test_pipelined_sequence_exact(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1, batch_max_ops=8))
        futs = [fe.submit((SR_SET, 0, i + 1), rid=0) for i in range(200)]
        assert [f.result(60.0) for f in futs] == list(range(200))
        st = fe.stats()
        assert st["completed"] == 200 and st["in_service"] == 0
        fe.close()
        nr.sync()
        assert nr.replicas_equal()

    def test_depth0_and_depth1_logs_bit_identical(self):
        outs, slices = [], []
        for depth in (0, 1):
            nr = small_nr(make_seqreg(4))
            fe = ServeFrontend(nr, fast_cfg(pipeline_depth=depth,
                                            batch_max_ops=4))
            futs = [fe.submit((SR_SET, i % 4, i + 1), rid=0)
                    for i in range(64)]
            outs.append([f.result(60.0) for f in futs])
            fe.close()
            nr.sync()
            slices.append(ring_slice(nr.spec, nr.log, 0, int(nr.log.tail)))
        assert outs[0] == outs[1]
        (o0, a0), (o1, a1) = slices
        assert np.array_equal(o0, o1) and np.array_equal(a0, a1)

    def test_close_drain_waits_for_inflight_round(self):
        nr = small_nr(make_seqreg(2))
        fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1, batch_max_ops=4))
        futs = [fe.submit((SR_SET, 1, i + 1), rid=1) for i in range(40)]
        fe.close()
        assert [f.result(0.0) for f in futs] == list(range(40))

    def test_worker_death_with_round_in_flight(self):
        nr = small_nr(make_seqreg(2), n_replicas=1)
        fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1, batch_max_ops=2,
                                        failover=True), auto_start=False)
        futs = [fe.submit((SR_SET, 0, i + 1), rid=0) for i in range(4)]
        plan = FaultPlan([FaultSpec(site="serve-complete", action="raise")])
        with plan.armed():
            fe.start()
            excs = [f.exception(30.0) for f in futs]
        assert all(isinstance(e, ReplicaFailed) for e in excs)
        assert [e.maybe_executed for e in excs[:2]] == [True, True]
        assert [e.maybe_executed for e in excs[2:]] == [False, False]
        fe.close()

    def test_pre_append_kill_retryable_in_assembly_stage(self):
        nr = small_nr(make_seqreg(2), n_replicas=1)
        fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1, failover=True),
                           auto_start=False)
        fut = fe.submit((SR_SET, 0, 1), rid=0)
        plan = FaultPlan([FaultSpec(site="serve-batch", action="raise")])
        with plan.armed():
            fe.start()
            exc = fut.exception(30.0)
        assert isinstance(exc, ReplicaFailed)
        assert exc.maybe_executed is False
        assert int(nr.log.tail) == 0
        fe.close()

    def test_deadline_late_success_counted_and_delivered(self):
        reg = get_registry()
        was = reg.enabled
        reg.enable()
        try:
            base = reg.counter("serve.deadline_late_success").value
            nr = small_nr(make_seqreg(2))
            fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1),
                               auto_start=False)
            fut = fe.submit((SR_SET, 0, 7), rid=0, deadline_s=0.05)
            plan = FaultPlan([FaultSpec(site="serve-complete",
                                        action="stall", stall_s=0.5)])
            with plan.armed():
                fe.start()
                assert fut.result(30.0) == 0  # delivered, not dropped
            assert (reg.counter("serve.deadline_late_success").value
                    - base) == 1
            assert fe.stats()["deadline_missed"] == 0
            fe.close()
        finally:
            if not was:
                reg.disable()

    def test_simclock_pipelined_handoff(self):
        # the two-stage handoff under virtual time: every wait in the
        # channel and queue goes through the injectable clock, so a
        # SimClock(auto_advance) run completes without real sleeps
        with installed(SimClock(auto_advance=True)):
            nr = small_nr(make_seqreg(2))
            fe = ServeFrontend(nr, fast_cfg(pipeline_depth=1,
                                            batch_max_ops=4))
            futs = [fe.submit((SR_SET, 0, i + 1), rid=0) for i in range(24)]
            assert [f.result(60.0) for f in futs] == list(range(24))
            fe.close()

    def test_grow_mid_traffic_pipelined(self):
        nr = small_nr(make_seqreg(4), n_replicas=2, log_entries=4096,
                      gc_slack=256, exec_window=256)
        fe = ServeFrontend(nr, fast_cfg(queue_depth=256, batch_max_ops=16,
                                        pipeline_depth=1))
        errors, grown = _seq_clients(fe, 4, 200, window=1, grow_at=100)
        assert not errors, errors[:3]
        assert grown.is_set() and nr.n_replicas == 3
        assert fe.call((SR_SET, 0, 202), rid=2, timeout=30.0) == 200
        fe.close()
        nr.sync()
        assert nr.replicas_equal()


# ------------------------------------------------------ the differential


def _stream(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        rid = int(rng.integers(2))
        if u < 0.55:
            out.append(("w", (1, int(rng.integers(-n_keys, 2 * n_keys)),
                              int(rng.integers(1 << 20))), rid))
        elif u < 0.8:
            out.append(("w", (2, int(rng.integers(n_keys))), rid))
        else:
            out.append(("r", (1, int(rng.integers(n_keys))), rid))
    return out


@pytest.mark.parametrize("model,depth", [("seqreg", 0), ("seqreg", 1),
                                         ("hashmap", 0), ("hashmap", 1)])
def test_single_client_differential_bit_identical(model, depth):
    """One closed-loop client, the same seeded stream through both
    frontends: each submit is one combiner round, so both fleets see
    the same rounds; the hashmap fleets force the fused tier (the
    reference's K1 in interpret mode, the port's plain K1). The ring
    (512 slots) wraps."""
    n_keys, n = 24, 640
    kw = dict(n_replicas=2, log_entries=512, gc_slack=32, exec_window=64)
    if model == "seqreg":
        jn = JNR(j_make_seqreg(n_keys), **kw)
        tn = NodeReplicated(make_seqreg(n_keys), device="cpu", **kw)
        stream = [(k, (1,) + op[1:2] + (op[-1],) if k == "w" else op, r)
                  for k, op, r in _stream(7, n, n_keys)]
    else:
        jn = JNR(j_make_hashmap(n_keys), engine="pallas", **kw)
        tn = NodeReplicated(make_hashmap(n_keys), engine="pallas",
                            device="cpu", **kw)
        stream = _stream(8, n, n_keys)
    jf = JServeFrontend(jn, JServeConfig(batch_linger_s=0.0,
                                         pipeline_depth=depth))
    tf = ServeFrontend(tn, ServeConfig(batch_linger_s=0.0,
                                       pipeline_depth=depth))
    try:
        for kind, op, rid in stream:
            if kind == "w":
                a = jf.submit(op, rid=rid).result(timeout=60.0)
                b = tf.submit(op, rid=rid).result(timeout=60.0)
            else:
                a, b = jf.read(op, rid=rid), tf.read(op, rid=rid)
            assert a == b, (kind, op, rid, a, b)
    finally:
        jf.close()
        tf.close()
    assert int(tn.log.tail) == sum(k == "w" for k, _, _ in stream) > 512
    got = interop.log_to_numpy(tn.log)
    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        want = np.asarray(getattr(jn.log, f))
        assert want.dtype == got[f].dtype and want.shape == got[f].shape
        assert np.array_equal(want, got[f]), f
    for f, leaf in tn.states.items():
        assert np.array_equal(np.asarray(jn.states[f]), leaf.numpy()), f
    if model == "hashmap":
        assert tn.stats()["fused_rounds"] == jn.stats()["fused_rounds"] > 0
