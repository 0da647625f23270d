"""The port's observability layer (`node_replication_torch/obs/`):
twins of `tests/test_obs.py` (all but its two harness classes, which
wait for the port's `harness/`) on `device="cpu"` fleets — the metrics
registry, the flight recorder and its `events_since` cursor, the
trace-report CLI, the idle-round short-circuit, snapshot schemas,
retired per-rid gauges and sampled per-record tracing.

The cost contract: with tracing and metrics disabled, the hot-path
instrumentation pays at most one branch and allocates no event
records — enforced by poisoning the clock and JSON encoder on the
disabled path.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.log import (
    LogSpec,
    log_append,
    log_catchup_all,
    log_init,
)
from node_replication_torch.core.replica import (
    NodeReplicated,
    replicate_state,
)
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    get_registry,
)
from node_replication_torch.obs.recorder import Tracer, get_tracer, span
from node_replication_torch.ops.encoding import encode_ops


@pytest.fixture
def reg():
    """A private enabled registry (keeps the global one untouched)."""
    r = MetricsRegistry(enabled=True)
    yield r


@pytest.fixture
def global_metrics():
    """Enable the global registry for wrapper tests; restore after."""
    r = get_registry()
    was = r.enabled
    r.enable()
    yield r
    r.enabled = was


class TestMetricsRegistry:
    def test_counter_gauge_basics(self, reg):
        c = reg.counter("c")
        c.inc()
        c.inc(4)
        assert c.value == 5
        g = reg.gauge("g")
        g.set(2.5)
        assert g.value == 2.5
        assert reg.counter("c") is c  # get-or-create returns the handle

    def test_kind_conflict_raises(self, reg):
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")

    def test_disabled_is_inert(self):
        r = MetricsRegistry(enabled=False)
        c = r.counter("c")
        h = r.histogram("h")
        g = r.gauge("g")
        c.inc(100)
        h.observe(1.0)
        g.set(9)
        assert c.value == 0 and h.count == 0 and g.value == 0.0

    def test_reset_keeps_handles(self, reg):
        c = reg.counter("c")
        c.inc(7)
        reg.reset()
        assert c.value == 0
        c.inc()
        assert c.value == 1

    def test_snapshot_skips_untouched(self, reg):
        reg.counter("touched").inc()
        reg.counter("untouched")
        snap = reg.snapshot()
        assert snap == {"touched": 1}

    def test_threaded_counter_increments(self, reg):
        c = reg.counter("c")
        N, T = 5000, 8

        def work():
            for _ in range(N):
                c.inc()

        threads = [threading.Thread(target=work) for _ in range(T)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == N * T


class TestHistogramPercentiles:
    def test_known_distribution(self, reg):
        h = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0))
        for _ in range(50):
            h.observe(0.5)
        for _ in range(50):
            h.observe(3.0)
        assert h.count == 100
        assert h.sum == pytest.approx(175.0)
        # p50 lands at the first bucket's upper edge; p95 interpolates
        # inside (2, 4] and clamps to the observed max
        assert h.percentile(0.50) == pytest.approx(1.0)
        assert h.percentile(0.95) == pytest.approx(3.0)
        assert h.percentile(1.0) == pytest.approx(3.0)
        assert h.percentile(0.0) == pytest.approx(0.5)  # clamps to min

    def test_overflow_bucket(self, reg):
        h = reg.histogram("h", buckets=(1.0,))
        h.observe(100.0)
        h.observe(200.0)
        assert h.percentile(0.99) <= 200.0
        assert h.percentile(0.99) >= 100.0

    def test_empty(self, reg):
        h = reg.histogram("h")
        assert h.percentile(0.5) == 0.0
        assert h._snapshot() == {"count": 0, "sum": 0.0}

    def test_bad_buckets_raise(self, reg):
        with pytest.raises(ValueError, match="ascend"):
            Histogram("bad", reg, buckets=(2.0, 1.0))
        with pytest.raises(ValueError, match="outside"):
            reg.histogram("h").percentile(1.5)


class TestFlightRecorder:
    def test_ring_buffer_keeps_last_n(self):
        t = Tracer()
        t.enable(None, ring=3)
        for i in range(7):
            t.emit("e", i=i)
        assert [e["i"] for e in t.events()] == [4, 5, 6]
        t.disable()

    def test_monotonic_timestamps(self):
        t = Tracer()
        t.enable(None)
        for i in range(5):
            t.emit("e", i=i)
        monos = [e["mono"] for e in t.events()]
        assert monos == sorted(monos)
        assert all("ts" in e for e in t.events())
        t.disable()

    def test_enable_disable_race_is_safe(self):
        t = Tracer()
        stop = threading.Event()
        errors = []

        def emitter():
            while not stop.is_set():
                try:
                    t.emit("e", x=1)
                except Exception as ex:  # pragma: no cover
                    errors.append(ex)

        threads = [threading.Thread(target=emitter) for _ in range(4)]
        for th in threads:
            th.start()
        for _ in range(300):
            t.enable(None)
            t.disable()
        stop.set()
        for th in threads:
            th.join()
        assert not errors
        assert t.events() == []

    def test_fence_accurate_span_mode(self, monkeypatch):
        calls = []
        monkeypatch.setattr(
            "node_replication_torch.utils.fence.fence",
            lambda *trees: calls.append(trees),
        )
        t = get_tracer()
        t.enable(None)
        monkeypatch.setattr(t, "fence_spans", True)
        try:
            with span("fenced-section", tag=1) as sp:
                sp.fence("log", "states")
            with span("unfenced-section"):
                pass
        finally:
            t.fence_spans = False
            events = t.events()
            t.disable()
        assert calls == [("log", "states")]
        fe = next(e for e in events if e["event"] == "fenced-section")
        assert fe["fenced"] is True and fe["tag"] == 1
        ue = next(e for e in events if e["event"] == "unfenced-section")
        assert ue["fenced"] is False  # no fence target registered

    def test_span_add_fields(self):
        t = get_tracer()
        t.enable(None)
        try:
            with span("s", a=1) as sp:
                sp.add(b=2)
            e = t.events()[-1]
        finally:
            t.disable()
        assert e["a"] == 1 and e["b"] == 2 and "duration_s" in e


class TestDisabledPathAllocatesNothing:
    """The acceptance-criterion cost contract: disabled tracer/registry
    hot paths never read the clock, never touch the JSON encoder, and
    never build an event record."""

    def test_no_clock_no_record(self, monkeypatch):
        if os.environ.get("NR_TPU_TRACE"):
            pytest.skip("tracer force-enabled via NR_TPU_TRACE")
        t = get_tracer()
        assert not t.enabled
        r = get_registry()
        was = r.enabled
        r.disable()
        c = r.counter("test.noalloc.c")
        h = r.histogram("test.noalloc.h")
        import node_replication_torch.obs.recorder as rec

        def boom(*a, **k):  # pragma: no cover - must never run
            raise AssertionError("disabled path did observable work")

        monkeypatch.setattr(rec.time, "time", boom)
        monkeypatch.setattr(rec.time, "monotonic", boom)
        monkeypatch.setattr(rec.time, "perf_counter", boom)
        monkeypatch.setattr(rec.json, "dumps", boom)
        try:
            t.emit("nope", x=1)
            with span("nope", y=2) as sp:
                sp.add(z=3)
                sp.fence(object())
            c.inc(10)
            h.observe(1.0)
        finally:
            r.enabled = was
        assert t.events() == []
        assert c.value == 0 and h.count == 0


class TestIdleRoundShortCircuit:
    def test_nr_idle_rounds_skip_device(self, global_metrics):
        nr = NodeReplicated(
            make_hashmap(16), device="cpu", n_replicas=2, log_entries=512, gc_slack=16
        )
        tok = nr.register(0)
        assert nr.execute_mut((HM_PUT, 1, 7), tok) == 0
        nr.sync()
        before = nr.stats()

        def boom(*a, **k):  # pragma: no cover - must never run
            raise AssertionError("device exec dispatched on idle round")

        nr._exec_call = boom
        nr.flush()  # empty combine "help" round
        nr.flush()
        assert nr.execute((HM_GET, 1), tok) == 7  # read-sync poll
        after = nr.stats()
        assert after["idle_rounds"] >= before["idle_rounds"] + 2
        assert after["exec_rounds"] == before["exec_rounds"]

    def test_cnr_idle_rounds_skip_device(self, monkeypatch):
        c = MultiLogReplicated(
            make_hashmap(16), lambda o, a: a[0], nlogs=2, device="cpu", n_replicas=1,
            log_entries=1 << 10, gc_slack=32,
        )
        tok = c.register(0)
        c.execute_mut((HM_PUT, 1, 5), tok)
        c.sync()
        before = c.stats()

        def boom(*a, **k):  # pragma: no cover - must never run
            raise AssertionError("device exec dispatched on idle round")

        monkeypatch.setattr(
            "node_replication_torch.core.cnr._exec_one_log", boom)
        c.combine(0, 0)  # nothing staged on log 0
        c.combine(0, 1)
        after = c.stats()
        assert after["idle_rounds"] >= before["idle_rounds"] + 2
        assert after["exec_rounds"] == before["exec_rounds"]

    def test_union_plan_eager_idle_skip(self, global_metrics):
        d = make_hashmap(16)  # provides window_plan/window_merge
        spec = LogSpec(capacity=256, n_replicas=2, gc_slack=8)
        log = log_init(spec, device="cpu")
        states = replicate_state(d.init_state("cpu"), 2)
        opc, args, n = encode_ops([(HM_PUT, k, k) for k in range(4)], 3,
                                  device="cpu")
        log = log_append(spec, log, opc, args, n)
        log, states, _ = log_catchup_all(spec, d, log, states, 8)
        assert int(np.asarray(log.ltails).min()) == int(log.tail)

        skip = global_metrics.counter("log.engine.idle_skip")
        v0 = skip.value
        log2, states2, resps = log_catchup_all(spec, d, log, states, 8)
        # the idle call returned the inputs untouched and paid no plan
        assert log2 is log and states2 is states
        assert resps.shape == (2, 8)
        assert not np.asarray(resps).any()
        assert skip.value == v0 + 1


class TestSnapshotSchemas:
    def test_nr_stats_and_snapshot(self, global_metrics):
        nr = NodeReplicated(
            make_hashmap(32), device="cpu", n_replicas=2, log_entries=512, gc_slack=16
        )
        tok = nr.register(0)
        for i in range(5):
            nr.execute_mut((HM_PUT, i, i), tok)
        s = nr.stats()
        # legacy keys stay stable for existing consumers
        for k in ("appended", "head", "ctail", "min_ltail",
                  "exec_rounds"):
            assert k in s, k
        assert s["idle_rounds"] >= 0
        assert s["engine"] in ("combined", "scan")
        snap = nr.snapshot()
        json.dumps(snap)  # JSON-safe throughout
        # the reference's keys, plus the fleet's device
        assert set(snap) == {"log", "replicas", "exec", "mesh",
                             "metrics", "device"}
        assert snap["mesh"] is None  # un-meshed wrapper
        assert snap["log"]["tail"] == 5
        assert 0.0 <= snap["log"]["occupancy"] <= 1.0
        assert snap["replicas"]["n"] == 2
        assert snap["replicas"]["lag"] == [0, 0]
        assert snap["replicas"]["threads"] == [1, 0]
        assert snap["exec"]["engine"] == nr.engine
        assert snap["exec"]["rounds"] == s["exec_rounds"]
        assert "nr.combine.batch_size" in snap["metrics"]

    def test_cnr_stats_and_snapshot(self, global_metrics):
        c = MultiLogReplicated(
            make_hashmap(64), lambda o, a: a[0], nlogs=4, device="cpu", n_replicas=1,
            log_entries=1 << 10, gc_slack=32,
        )
        tok = c.register(0)
        for k in range(16):
            c.execute_mut((HM_PUT, k, k), tok)
        s = c.stats()
        assert s["tails"] == [4, 4, 4, 4]  # legacy key stable
        assert s["log_selected"] == [4, 4, 4, 4]
        assert s["combine_rounds"] == [4, 4, 4, 4]
        snap = c.snapshot()
        json.dumps(snap)
        assert snap["nlogs"] == 4
        assert len(snap["logs"]) == 4
        assert snap["selection_imbalance"] == pytest.approx(1.0)
        for lg in snap["logs"]:
            assert lg["tail"] == 4 and lg["max_lag"] == 0
        assert snap["exec"]["rounds"] == s["exec_rounds"]


class TestReportCLI:
    def _record_trace(self, path):
        t = get_tracer()
        t.enable(str(path))
        try:
            nr = NodeReplicated(
                make_hashmap(16), device="cpu", n_replicas=2, log_entries=512,
                gc_slack=16,
            )
            tok = nr.register(0)
            for i in range(5):
                nr.execute_mut((HM_PUT, i, i), tok)
            t.emit("throughput", second=0, ops=100)
            t.emit("throughput", second=1, ops=200)
            t.emit("watchdog", where="sync", rounds=64, dormant=1,
                   ltail=0, tail=5)
        finally:
            t.disable()

    def test_roundtrip_text(self, tmp_path, capsys):
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        self._record_trace(path)
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "event counts" in out
        assert "append" in out and "combine-replay" in out
        assert "p50" in out and "p95" in out and "p99" in out
        assert "throughput timeline" in out
        assert "300 ops over 2 sampled second(s)" in out
        assert "stall report" in out
        assert "sync: 1 warning(s), up to 64 fruitless rounds" in out

    def test_roundtrip_json(self, tmp_path, capsys):
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        self._record_trace(path)
        assert report.main([str(path), "--json"]) == 0
        data = json.loads(capsys.readouterr().out)
        assert data["event_counts"]["append"] == 5
        assert data["spans"]["append"]["count"] == 5
        assert data["spans"]["append"]["p99_s"] >= data["spans"][
            "append"]["p50_s"]
        assert data["throughput"]["source"] == "throughput"
        assert data["throughput"]["timeline"] == {"0": 100, "1": 200}
        assert data["stalls"][0]["where"] == "sync"
        assert data["stalls"][0]["dormant"] == [1]

    def test_sharding_section(self, tmp_path, capsys):
        # a sharded fleet's trace renders the Sharding section: map
        # adoptions with the re-homed slices, refusals by typed error
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        t = get_tracer()
        t.enable(str(path))
        try:
            t.emit("serve-reroute", reason="promotion",
                   map_version=2, from_version=1, shards=[0])
            t.emit("shard-refused", shard=1, error="WrongShard",
                   detail="stale HELLO v1")
            t.emit("shard-refused", shard=1, error="WrongShard",
                   detail="stale HELLO v1")
        finally:
            t.disable()
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "== sharding ==" in out
        assert ("map adoptions: 1 (final version 2)   "
                "refused submits: 2") in out
        assert "[promotion]: v1 -> v2, re-homed: s0" in out
        assert "refusals by error: WrongShard=2" in out
        assert "refusals by shard: s1=2" in out

    def test_sharding_section_json(self, tmp_path, capsys):
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        t = get_tracer()
        t.enable(str(path))
        try:
            t.emit("serve-reroute", reason="adopt", map_version=3,
                   from_version=2, shards=[0, 2])
        finally:
            t.disable()
        assert report.main([str(path), "--json"]) == 0
        data = json.loads(capsys.readouterr().out)
        shd = data["sharding"]
        assert shd["map_adoptions"] == 1
        assert shd["final_map_version"] == 3
        assert shd["adoptions"][0]["shards"] == [0, 2]
        assert shd["refused"] == 0

    def test_mesh_section(self, tmp_path, capsys):
        # a mesh-sharded fleet's trace renders the Mesh section:
        # placement, rounds by collective tier, sync bytes, ring passes
        from node_replication_torch.obs import report
        from node_replication_torch.core.log import log_append
        from node_replication_torch.models import SR_SET, make_seqreg
        from node_replication_torch.parallel import replica_mesh

        path = tmp_path / "trace.jsonl"
        t = get_tracer()
        t.enable(str(path))
        try:
            nr = NodeReplicated(
                make_seqreg(4), device="cpu", n_replicas=8, log_entries=1 << 12,
                gc_slack=64, exec_window=32,
                mesh=replica_mesh(8, devices=["cpu"] * 8),
            )
            tok = nr.register(0)
            for i in range(8):
                nr.execute_mut((SR_SET, i % 4, i), tok)
            # a uniform backlog to drive the ring tier
            opc = torch.full((200,), SR_SET, dtype=torch.int32)
            args = torch.zeros((200, 3), dtype=torch.int32)
            nr.log = log_append(nr.spec, nr.log, opc, args, 200)
            nr.sync()
        finally:
            t.disable()
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "== mesh ==" in out
        assert "NodeReplicated: 8 replica(s) over 8 device(s)" in out
        assert "rounds by tier: shmap=" in out
        assert "cross-device sync:" in out
        assert "ring catch-up:" in out
        assert report.main([str(path), "--json"]) == 0
        data = json.loads(capsys.readouterr().out)
        assert data["mesh"]["placements"][0]["tier"] == "shmap"
        assert data["mesh"]["rounds_by_tier"]["shmap"] > 0
        assert data["mesh"]["sync_bytes"] > 0
        assert data["mesh"]["ring_execs"] > 0

    def test_timeline_derived_from_appends(self, tmp_path, capsys):
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        t = get_tracer()
        t.enable(str(path))
        try:
            nr = NodeReplicated(
                make_hashmap(16), device="cpu", n_replicas=1, log_entries=512,
                gc_slack=16,
            )
            tok = nr.register(0)
            for i in range(4):
                nr.execute_mut((HM_PUT, i, i), tok)
        finally:
            t.disable()
        assert report.main([str(path), "--json"]) == 0
        data = json.loads(capsys.readouterr().out)
        assert data["throughput"]["source"] == "append"
        assert sum(data["throughput"]["timeline"].values()) == 4

    def test_timeline_with_legacy_ts_only_events(self, tmp_path,
                                                 capsys):
        # a trace file appended to across the tracer upgrade holds
        # ts-only events next to mono-stamped ones; each kind must be
        # bucketed against its OWN epoch, not a mixed baseline
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        path.write_text(
            '{"ts": 1754000000.0, "event": "throughput", "ops": 50}\n'
            '{"ts": 1754000001.0, "mono": 5.0, "event": "throughput",'
            ' "ops": 100, "second": -1}\n'
        )
        assert report.main([str(path), "--json"]) == 0
        data = json.loads(capsys.readouterr().out)
        tl = data["throughput"]["timeline"]
        assert sum(tl.values()) == 150
        assert all(int(sec) <= 2 for sec in tl)  # no cross-epoch offset

    def test_malformed_lines_skipped(self, tmp_path, capsys):
        from node_replication_torch.obs import report

        path = tmp_path / "trace.jsonl"
        path.write_text(
            '{"ts": 1.0, "mono": 1.0, "event": "ok"}\n'
            "not json\n"
            '{"ts": 2.0, "mono": 2.0, "event": "ok"}\n'
        )
        assert report.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "2 events" in out


class TestInstrumentedCorrectness:
    """Tracing + metrics + fence-span mode enabled must not change any
    result (the CI traced shard proves this at suite scale; this is the
    in-repo guard)."""

    def test_full_observability_on(self, global_metrics, monkeypatch):
        t = get_tracer()
        t.enable(None)
        monkeypatch.setattr(t, "fence_spans", True)
        try:
            nr = NodeReplicated(
                make_hashmap(32), device="cpu", n_replicas=2, log_entries=512,
                gc_slack=16,
            )
            tok = nr.register(0)
            for i in range(10):
                assert nr.execute_mut((HM_PUT, i, i * 3), tok) == 0
            for i in range(10):
                assert nr.execute((HM_GET, i), tok) == i * 3
            nr.sync()
            assert nr.replicas_equal()
            spans = [e for e in t.events() if "duration_s" in e]
            assert any(e["event"] == "exec-round" and e["fenced"]
                       for e in spans)
        finally:
            t.fence_spans = False
            t.disable()


class TestRegistryRemove:
    def test_remove_drops_from_snapshot(self, reg):
        reg.gauge("serve.queue_depth.r0").set(5)
        reg.counter("keep").inc()
        assert "serve.queue_depth.r0" in reg.snapshot()
        assert reg.remove("serve.queue_depth.r0") is True
        assert "serve.queue_depth.r0" not in reg.snapshot()
        assert "serve.queue_depth.r0" not in reg.names()
        assert reg.remove("serve.queue_depth.r0") is False  # gone
        assert "keep" in reg.snapshot()

    def test_removed_name_reregisters_fresh(self, reg):
        g = reg.gauge("g")
        g.set(7)
        reg.remove("g")
        g2 = reg.gauge("g")
        assert g2 is not g and g2.value == 0.0
        # the stale cached handle keeps working but is detached
        g.set(9)
        assert reg.snapshot().get("g") is None or \
            reg.snapshot()["g"] == 0.0


class TestRetiredReplicaGauges:
    """The per-rid gauge leak: a replica retired
    by failover leaves the registry; restart re-registers it; close
    retires every served replica's gauge."""

    def _frontend(self, global_metrics):
        from node_replication_torch.models import make_seqreg
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        nr = NodeReplicated(make_seqreg(4), device="cpu", n_replicas=2,
                            log_entries=512, gc_slack=32,
                            exec_window=64)
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                           failover=True))
        return fe

    def test_failover_retires_gauge_restart_reregisters(
            self, global_metrics):
        from node_replication_torch.fault import FaultPlan, FaultSpec
        from node_replication_torch.models import SR_SET
        from node_replication_torch.serve import ReplicaFailed

        fe = self._frontend(global_metrics)
        names = get_registry().names()
        assert "serve.queue_depth.r0" in names
        assert "serve.queue_depth.r1" in names
        plan = FaultPlan([FaultSpec(site="serve-batch",
                                    action="raise", rid=1, after=0)])
        with plan.armed():
            fut = fe.submit((SR_SET, 0, 1), rid=1)
            with pytest.raises(ReplicaFailed):
                fut.result(30.0)
        # the dying worker retires the gauge with the replica
        deadline = 30.0
        import time as _time
        t_end = _time.monotonic() + deadline
        while ("serve.queue_depth.r1" in get_registry().names()
               and _time.monotonic() < t_end):
            _time.sleep(0.01)
        assert "serve.queue_depth.r1" not in get_registry().names()
        assert "serve.queue_depth.r0" in get_registry().names()
        fe.restart_replica(1)
        assert "serve.queue_depth.r1" in get_registry().names()
        assert fe.call((SR_SET, 0, 1), rid=1, timeout=30.0) == 0
        fe.close()

    def test_close_retires_every_served_gauge(self, global_metrics):
        fe = self._frontend(global_metrics)
        assert "serve.queue_depth.r0" in get_registry().names()
        fe.close()
        names = get_registry().names()
        assert "serve.queue_depth.r0" not in names
        assert "serve.queue_depth.r1" not in names


class TestRecorderConcurrency:
    """Ring mode under concurrent writers: 8
    threads, no torn/interleaved lines, ring keeps the newest N."""

    def test_ring_mode_8_threads_keeps_newest_n(self):
        t = Tracer()
        t.enable(None, ring=64)
        n_threads, per = 8, 100

        def writer(k):
            for i in range(per):
                t.emit("w", thread=k, i=i, payload="x" * 20)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        evs = t.events()
        assert len(evs) == 64  # the newest N, bound held
        seq, _ = t.events_since(0)
        assert seq == n_threads * per  # nothing lost from the count
        # intact events: every record kept all its fields
        for e in evs:
            assert e["event"] == "w"
            assert set(("ts", "mono", "thread", "i",
                        "payload")) <= set(e)
        # newest-N: each thread's surviving events are its LAST ones,
        # in emit order (no interleaving within a thread)
        for k in range(n_threads):
            mine = [e["i"] for e in evs if e["thread"] == k]
            assert mine == sorted(mine)
            if mine:
                assert mine[-1] == per - 1 or len(mine) < per
        t.disable()

    def test_file_mode_8_threads_no_torn_lines(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        t = Tracer()
        t.enable(str(path))
        n_threads, per = 8, 200

        def writer(k):
            for i in range(per):
                t.emit("w", thread=k, i=i, payload="y" * 40)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t.disable()
        lines = path.read_text().splitlines()
        assert len(lines) == n_threads * per
        per_thread = {k: [] for k in range(n_threads)}
        for ln in lines:
            e = json.loads(ln)  # raises on any torn/interleaved line
            per_thread[e["thread"]].append(e["i"])
        for k in range(n_threads):
            assert per_thread[k] == list(range(per))

    def test_events_since_cursor(self):
        t = Tracer()
        t.enable(None, ring=4)
        for i in range(3):
            t.emit("e", i=i)
        seq, evs = t.events_since(0)
        assert seq == 3 and [e["i"] for e in evs] == [0, 1, 2]
        for i in range(3, 9):
            t.emit("e", i=i)
        seq2, evs2 = t.events_since(seq)
        # 6 new events but the ring holds 4: the evicted two are gone
        # (flight-recorder semantics), the rest arrive in order
        assert seq2 == 9 and [e["i"] for e in evs2] == [5, 6, 7, 8]
        seq3, evs3 = t.events_since(seq2)
        assert seq3 == 9 and evs3 == []
        t.disable()


class TestSampledTracing:
    """NR_TPU_TRACE_SAMPLE: sampling is a pure function of
    pos, so a sampled record keeps EVERY hop and an unsampled one
    keeps none — never a partial chain."""

    def test_pos_sampled_pure_and_modular(self):
        from node_replication_torch.obs.recorder import (
            _parse_sample,
            pos_sampled,
            set_trace_sample,
            trace_sample_n,
        )

        assert _parse_sample("1/8") == 8
        assert _parse_sample("8") == 8
        assert _parse_sample(None) == 1
        assert _parse_sample("garbage") == 1
        assert _parse_sample("0") == 1
        set_trace_sample(4)
        try:
            assert trace_sample_n() == 4
            assert [p for p in range(12) if pos_sampled(p)] == \
                [0, 4, 8]
        finally:
            set_trace_sample(1)
        assert all(pos_sampled(p) for p in range(5))  # default: all

    def test_ship_apply_chains_whole_or_absent(self, tmp_path):
        # a real WAL -> shipper -> feed -> follower chain under
        # sample=1/2: every sampled record appears at BOTH hops,
        # every unsampled one at neither
        from node_replication_torch.durable import WriteAheadLog
        from node_replication_torch.models import SR_SET, make_seqreg
        from node_replication_torch.obs.recorder import set_trace_sample
        from node_replication_torch.repl import (
            DirectoryFeed,
            Follower,
            ReplicationShipper,
        )

        dispatch = make_seqreg(4)
        nr = NodeReplicated(dispatch, device="cpu", n_replicas=1, log_entries=512,
                            gc_slack=32, exec_window=64)
        wal = WriteAheadLog(str(tmp_path / "wal"), policy="batch")
        nr.attach_wal(wal)
        feed = DirectoryFeed(str(tmp_path / "feed"),
                             arg_width=dispatch.arg_width)
        t = get_tracer()
        t.enable(None, ring=4096)
        set_trace_sample(2)
        try:
            tok = nr.register(0)
            for i in range(1, 9):  # 8 single-op records: pos 0..7
                nr.execute_mut((SR_SET, i % 4, i), tok)
            nr.wal_sync()
            shipper = ReplicationShipper(wal, feed)
            shipper.barrier(8)
            f = Follower(dispatch, feed, str(tmp_path / "follower"),
                         nr_kwargs=dict(device="cpu", n_replicas=1,
                                        log_entries=512,
                                        gc_slack=32,
                                        exec_window=64))
            assert f.wait_applied(8, timeout=30.0)
            evs = t.events()
            ships = {e["pos"] for e in evs
                     if e["event"] == "repl-ship"}
            applies = {e["pos"] for e in evs
                       if e["event"] == "repl-apply"}
            assert ships == {0, 2, 4, 6}
            assert applies == ships  # whole chain or nothing
            f.close()
            shipper.stop()
        finally:
            set_trace_sample(1)
            t.disable()
            nr.detach_wal().close()
