"""The port's host-path profiling plane (`obs/profile.py`): twins of
`tests/test_profile.py` on `device="cpu"` fleets — role/stage
attribution, bounded memory and the folded round-trip, the remote
capture protocol over a live exporter socket, the
`ServeFrontend.threads()` name contract (held against the reference's
frontend), the duty-cycle gauge across a fail->restart cycle, the
dashboard's host column and the report's Host budget section. Beside
them: a thread blocked in the round's device read-back
(`core/replica.py:_readback`) samples as `readback`, and the
`device-trace` command's torch.profiler capture (forced on the CPU)
writes a chrome trace and refuses a second capture while it runs.
"""

import json
import os
import queue
import threading
import time
import types

import pytest
import torch

from node_replication_torch.obs.metrics import MetricsRegistry, get_registry
from node_replication_torch.obs.profile import (
    KNOWN_ROLES,
    OVERFLOW_FRAME,
    SamplingProfiler,
    _classify,
    folded_from_snapshot,
    host_budget,
    parse_folded,
    role_of,
)

_PKG_FILE = "/x/node_replication_torch/core/replica.py"


# --------------------------------------------------------------------------
# controlled worker threads: one busy spinner, one idle waiter
# --------------------------------------------------------------------------


class _Workers:
    """Deterministic sampling targets: a busy-spinning thread and a
    condition-waiting thread under disciplined names."""

    def __init__(self, busy_name="serve-worker-r7",
                 wait_name="repl-shipper"):
        self.stop_evt = threading.Event()
        self.busy = threading.Thread(
            target=self._spin, name=busy_name, daemon=True)
        self.waiter = threading.Thread(
            target=self.stop_evt.wait, name=wait_name, daemon=True)
        self.busy.start()
        self.waiter.start()

    def _spin(self):
        x = 0
        while not self.stop_evt.is_set():
            x += 1

    def close(self):
        self.stop_evt.set()
        self.busy.join(5.0)
        self.waiter.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# role + stage attribution (pure)
# --------------------------------------------------------------------------


class TestRoleOf:
    @pytest.mark.parametrize("name,role", [
        ("serve-worker-r0", "serve-worker"),
        ("serve-asm-r3", "serve-assembly"),
        ("serve-cpl-r3", "serve-completion"),
        ("serve-client-12", "serve-client"),
        ("repl-shipper", "repl-shipper"),
        ("repl-relay-f1", "repl-relay"),
        ("repl-apply-f1", "repl-apply"),
        ("repl-feed-server-p", "repl-feed"),
        ("repl-promotion-watch", "repl-promote"),
        ("fault-medic-r2", "fault-medic"),
        ("obs-export-primary-1", "obs-export"),
        ("obs-device-trace-n1", "obs-export"),
        ("obs-fleet-collector", "obs-collect"),
        ("obs-profiler", "obs-profiler"),
        ("MainThread", "main"),
        ("Thread-7", "other"),
        ("", "other"),
    ])
    def test_contract(self, name, role):
        assert role_of(name) == role
        assert role in KNOWN_ROLES or role == "other"


class TestClassify:
    def test_wait_leaf_is_lock_wait(self):
        assert _classify([("/lib/threading.py", "wait"),
                          (_PKG_FILE, "execute_mut_batch")]) \
            == "lock-wait"

    def test_thread_join_leaf_is_lock_wait(self):
        assert _classify([
            ("/lib/threading.py", "_wait_for_tstate_lock"),
            ("/lib/threading.py", "join"),
        ]) == "lock-wait"

    def test_in_package_stage_funcs(self):
        assert _classify([(_PKG_FILE, "_begin_round")]) == "append"
        assert _classify([("/j/numpy.py", "dot"),
                          (_PKG_FILE, "execute_mut_batch")]) == "append"
        assert _classify([(_PKG_FILE, "take_batch")]) == "encode"
        assert _classify([(_PKG_FILE, "offer")]) == "admission"
        assert _classify([(_PKG_FILE, "_finish_delivery")]) \
            == "future-resolve"
        assert _classify([(_PKG_FILE, "_fsync")]) == "fsync"

    @pytest.mark.parametrize("func", ["synchronize", "__array__"])
    def test_foreign_readback_matches_anywhere(self, func):
        # torch.cuda.synchronize / Event.synchronize / Tensor.__array__
        assert _classify([("/t/torch/cuda/__init__.py", func),
                          ("/t/x.py", "f")]) == "readback"

    def test_foreign_names_do_not_match_stage_table(self):
        # a torch-internal frame named like a stage func must NOT
        # attribute (only in-package frames match `_STAGE_FUNCS`)
        assert _classify([("/t/torch/_tensor.py", "append"),
                          ("/t/torch/_tensor.py", "bind")]) == "other"

    def test_leafmost_in_package_match_wins(self):
        assert _classify([
            (_PKG_FILE, "_finish_delivery"),
            (_PKG_FILE, "execute_mut_batch"),
        ]) == "future-resolve"


class TestReadbackStage:
    def test_thread_blocked_in_the_round_readback_is_readback(self):
        # `.cpu()` blocks in C with no Python frame of its own; the
        # round's read-back helper is the frame the sampler sees. A
        # stand-in tensor whose `cpu` is a C-level blocking call (a
        # SimpleQueue get) holds a worker inside `_readback`
        from node_replication_torch.core.replica import _readback

        q = queue.SimpleQueue()
        pending = types.SimpleNamespace(cpu=q.get)
        got = []
        t = threading.Thread(target=lambda: got.append(_readback(pending)),
                             name="serve-worker-r3", daemon=True)
        t.start()
        try:
            p = SamplingProfiler(hz=50, registry=MetricsRegistry(
                enabled=True))
            t_end = time.monotonic() + 5.0
            mine = []
            while not mine and time.monotonic() < t_end:
                p.sample_once()
                mine = [s for s in p.snapshot()["stacks"]
                        if s["role"] == "serve-worker"
                        and s["frames"][-1] == "replica.py:_readback"]
            assert mine and all(s["stage"] == "readback" for s in mine)
            assert not any(s["wait"] for s in mine)
        finally:
            q.put(torch.arange(3))
            t.join(5.0)
        assert not t.is_alive() and got[0].tolist() == [0, 1, 2]


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------


class TestSamplingProfiler:
    def test_sample_once_buckets_roles_and_busyness(self):
        with _Workers() as _w:
            p = SamplingProfiler(hz=50, registry=MetricsRegistry(
                enabled=True))
            for _ in range(20):
                p.sample_once()
                time.sleep(0.002)
            snap = p.snapshot()
        roles = snap["roles"]
        assert roles["serve-worker"]["samples"] >= 20
        assert roles["repl-shipper"]["samples"] >= 20
        # the spinner is busy, the waiter blocked in Event.wait
        assert roles["serve-worker"]["busy"] >= 19
        assert roles["repl-shipper"]["busy"] == 0
        assert "serve-worker-r7" in roles["serve-worker"]["threads"]
        waits = [s for s in snap["stacks"]
                 if s["role"] == "repl-shipper"]
        assert waits and all(s["stage"] == "lock-wait" for s in waits)

    def test_sampler_thread_lifecycle_and_duty_gauge(self):
        reg = MetricsRegistry(enabled=True)
        with _Workers():
            p = SamplingProfiler(hz=200, registry=reg)
            p.start()
            assert p.running
            assert p.thread is not None \
                and p.thread.name == "obs-profiler"
            time.sleep(0.5)
            p.stop()
        assert not p.running and p.thread is None
        snap = p.snapshot()
        assert snap["ticks"] > 10
        assert snap["thread_samples"] > snap["ticks"]
        assert 0.0 <= snap["duty_cycle"] <= 1.0
        assert 0.0 < snap["busy_frac"] <= 1.0
        ms = reg.snapshot()
        assert 0.0 <= ms["obs.profiler.duty_cycle"] <= 1.0
        assert 0.0 < ms["obs.host.busy_frac"] <= 1.0
        # restartable: counts accumulate across segments
        p.start()
        time.sleep(0.1)
        p.stop()
        assert p.snapshot()["ticks"] >= snap["ticks"]
        p.reset()
        assert p.snapshot()["thread_samples"] == 0

    def test_bounded_memory_overflow_bucket(self):
        # counts only the roles of the threads it owns: other threads
        # of the process (a test runner's workers) may take the one
        # slot or overflow into buckets of their own roles
        with _Workers():
            p = SamplingProfiler(hz=50, max_stacks=1)
            for _ in range(10):
                p.sample_once()
        snap = p.snapshot()
        assert snap["overflow_drops"] > 0
        mine = [s for s in snap["stacks"]
                if s["role"] in ("serve-worker", "repl-shipper")]
        real = [s for s in mine if s["frames"] != [OVERFLOW_FRAME]]
        over = [s["role"] for s in mine if s["frames"] == [OVERFLOW_FRAME]]
        assert len(real) <= 1  # the one slot
        assert over and len(over) == len(set(over))  # one bucket a role
        assert len(real) + len(over) <= 2 + (not real)

    def test_folded_round_trip(self):
        with _Workers():
            p = SamplingProfiler(hz=50)
            for _ in range(5):
                p.sample_once()
        folded = p.folded()
        rows = parse_folded(folded)
        assert rows
        total = sum(n for _, n in rows)
        assert total == p.snapshot()["thread_samples"]
        # first element of every folded stack is the role
        for frames, _n in rows:
            assert role_of("") == "other"  # sanity on the helper
            assert frames[0] in KNOWN_ROLES or frames[0] == "other"
        assert folded_from_snapshot(p.snapshot()) == folded

    def test_host_budget_shape(self):
        with _Workers():
            p = SamplingProfiler(hz=50)
            for _ in range(10):
                p.sample_once()
        b = host_budget(p.snapshot())
        assert b["thread_samples"] == p.snapshot()["thread_samples"]
        assert abs(sum(s["frac"] for s in b["stages"].values())
                   - 1.0) < 1e-9
        # the waiter guarantees a lock-wait stage
        assert b["stages"]["lock-wait"]["samples"] > 0
        assert 0.0 <= b["attributed_frac"] <= 1.0

    def test_emit_summary_event(self):
        from node_replication_torch.obs.recorder import Tracer

        tr = Tracer()
        tr.enable(path=None, ring=16)
        with _Workers():
            p = SamplingProfiler(hz=50)
            for _ in range(5):
                p.sample_once()
            p.emit_summary(tracer=tr, workload="unit")
        _total, events = tr.events_since(0)
        summaries = [e for e in events
                     if e.get("event") == "profile-summary"]
        assert len(summaries) == 1
        e = summaries[0]
        assert e["workload"] == "unit"
        assert e["thread_samples"] > 0
        assert "lock-wait" in e["stages"]
        assert "repl-shipper" in e["roles"]


# --------------------------------------------------------------------------
# remote capture over the exporter socket (acceptance: live round-trip)
# --------------------------------------------------------------------------


class TestRemoteCapture:
    def test_socket_round_trip_and_role_contract(self):
        from node_replication_torch.obs import export

        exp = export.MetricsExporter(node_id="prof-node",
                                     role="primary", port=0)
        host, port = exp.address
        try:
            with _Workers():
                doc = export.profile_start(host, port, hz=199.0)
                assert doc["ok"] and doc["running"]
                assert doc["hz"] == 199.0 and doc["node_id"] \
                    == "prof-node"
                # idempotent start answers already=True
                assert export.profile_start(host, port)["already"]
                time.sleep(0.4)
                doc = export.profile_fetch(host, port, stop=True)
            assert doc["node_id"] == "prof-node"
            snap = doc["profile"]
            assert snap["thread_samples"] > 0
            assert not snap["running"]  # stop=True halted the sampler
            roles = snap["roles"]
            assert roles["serve-worker"]["samples"] > 0
            assert roles["repl-shipper"]["samples"] > 0
            # per-role buckets match the thread-name contract
            assert "serve-worker-r7" \
                in roles["serve-worker"]["threads"]
            assert "repl-shipper" in roles["repl-shipper"]["threads"]
            rows = parse_folded(doc["folded"])
            assert rows and sum(n for _, n in rows) \
                == snap["thread_samples"]
            assert doc["budget"]["thread_samples"] \
                == snap["thread_samples"]
            assert export.profile_stop(host, port)["ok"]
        finally:
            exp.close()

    def test_fetch_without_profiler_is_typed_error(self):
        from node_replication_torch.obs import export

        exp = export.MetricsExporter(node_id="bare", role="node",
                                     port=0)
        host, port = exp.address
        try:
            with pytest.raises(RuntimeError, match="no profiler"):
                export.profile_fetch(host, port)
        finally:
            exp.close()

    def test_device_trace_guarded_off_cuda(self, tmp_path, monkeypatch):
        from node_replication_torch.obs import export

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        exp = export.MetricsExporter(node_id="dt", role="node", port=0)
        host, port = exp.address
        try:
            doc = export.device_trace(host, port, str(tmp_path))
            assert doc["ok"] is False and doc["backend"] == "cpu"
            assert "skipped" in doc  # no card: capture refused
            assert not list(tmp_path.iterdir())
        finally:
            exp.close()

    def test_forced_capture_writes_a_chrome_trace(self, tmp_path,
                                                  monkeypatch):
        # the torch.profiler capture (CPU activity alone, forced) runs
        # in its own thread; one per process: a second request during
        # it is refused; the trace file appears whole at the end
        from node_replication_torch.obs import export
        from node_replication_torch.obs.recorder import Tracer

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tr = Tracer()
        tr.enable(None, ring=64)
        exp = export.MetricsExporter(node_id="dt", role="node", port=0,
                                     tracer=tr)
        host, port = exp.address
        try:
            doc = export.device_trace(host, port, str(tmp_path),
                                      duration_s=0.3, force=True)
            assert doc["ok"] and doc["backend"] == "cpu"
            busy = export.device_trace(host, port, str(tmp_path),
                                       duration_s=0.3, force=True)
            assert busy == {"ok": False, "skipped": "capture in progress"}
            t_end = time.monotonic() + 60
            while not os.path.exists(doc["path"]):
                assert time.monotonic() < t_end
                torch.ones(8).sum()
                time.sleep(0.02)
            with open(doc["path"]) as fh:
                trace = json.load(fh)
            assert "traceEvents" in trace
            ends = [e for e in tr.events()
                    if e["event"] == "obs-device-trace"]
            assert [e["ok"] for e in ends] == [True]
            assert ends[0]["path"] == doc["path"]
        finally:
            exp.close()
            tr.disable()

    def test_one_capture_per_process_under_racing_requests(
            self, tmp_path, monkeypatch):
        # two exporters of one process, 16 threads asking at once with
        # a short switch interval: torch.profiler is one per process,
        # so exactly one request starts a capture
        import sys

        from node_replication_torch.obs import export

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        exps = [export.MetricsExporter(node_id=f"race{i}", role="node",
                                       port=0) for i in range(2)]
        gate = threading.Barrier(16)
        answers = []

        def ask(i):
            gate.wait(10.0)
            answers.append(exps[i % 2].device_trace(
                str(tmp_path), duration_s=0.3, force=True))

        was = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=ask, args=(i,),
                                        name=f"obs-test-race-{i}")
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
        finally:
            sys.setswitchinterval(was)
        try:
            assert not any(t.is_alive() for t in threads)
            ok = [a for a in answers if a["ok"]]
            assert len(answers) == 16 and len(ok) == 1
            assert all(a == {"ok": False, "skipped": "capture in progress"}
                       for a in answers if not a["ok"])
            t_end = time.monotonic() + 60
            while not os.path.exists(ok[0]["path"]):  # let it finish
                assert time.monotonic() < t_end
                time.sleep(0.02)
        finally:
            for e in exps:
                e.close()

    def test_exporter_close_stops_owned_profiler(self):
        from node_replication_torch.obs import export

        exp = export.MetricsExporter(node_id="own", role="node",
                                     port=0)
        host, port = exp.address
        export.profile_start(host, port)
        prof = exp._profiler
        assert prof is not None and prof.running
        exp.close()
        assert not prof.running

    def test_fleet_collector_profile_sweep(self):
        from node_replication_torch.obs import export
        from node_replication_torch.obs.collect import FleetCollector

        e1 = export.MetricsExporter(node_id="n1", role="primary",
                                    port=0)
        e2 = export.MetricsExporter(node_id="n2", role="follower",
                                    port=0)
        coll = FleetCollector(
            ["%s:%d" % e1.address, e2], interval_s=0.1)
        try:
            with _Workers():
                started = coll.start_profiles(hz=199.0)
                assert set(started) == {"n1", "n2"}
                assert all(d.get("ok") for d in started.values())
                time.sleep(0.3)
                profs = coll.fetch_profiles(stop=True)
            assert set(profs) == {"n1", "n2"}
            for doc in profs.values():
                assert doc["profile"]["thread_samples"] > 0
                assert parse_folded(doc["folded"])
        finally:
            coll.close()
            e1.close()
            e2.close()


# --------------------------------------------------------------------------
# frontend wiring: threads() contract + config + close
# --------------------------------------------------------------------------


def _make_frontend(**cfg_kw):
    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import make_seqreg
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    nr = NodeReplicated(make_seqreg(4), n_replicas=2, log_entries=512,
                        gc_slack=32, exec_window=64, device="cpu")
    return ServeFrontend(nr, ServeConfig(batch_linger_s=0.0, **cfg_kw))


def _make_reference_frontend(**cfg_kw):
    from node_replication_tpu import NodeReplicated
    from node_replication_tpu.models import make_seqreg
    from node_replication_tpu.serve import ServeConfig, ServeFrontend

    nr = NodeReplicated(make_seqreg(4), n_replicas=2, log_entries=512,
                        gc_slack=32, exec_window=64)
    return ServeFrontend(nr, ServeConfig(batch_linger_s=0.0, **cfg_kw))


class TestServeThreads:
    def test_threads_unique_and_role_mapped(self):
        fe = _make_frontend(pipeline_depth=1, obs_port=0,
                            profile_hz=97.0)
        try:
            ths = fe.threads()
            all_names = [n for names in ths.values() for n in names]
            # every subsystem worker-thread name is unique...
            assert len(all_names) == len(set(all_names))
            # ...and maps to a known profiler role (nothing in other)
            assert set(ths) <= KNOWN_ROLES
            assert "other" not in ths
            assert len(ths["serve-assembly"]) == 2
            assert len(ths["serve-completion"]) == 2
            assert ths["obs-profiler"] == ["obs-profiler"]
            assert len(ths["obs-export"]) == 1
        finally:
            fe.close()
        assert fe.profiler is not None and not fe.profiler.running

    def test_threads_match_the_reference(self):
        # the same config gives the same threads under the same names,
        # and both packages map every one to the same role
        from node_replication_tpu.obs.profile import role_of as ref_role_of

        cfg = dict(pipeline_depth=1, obs_port=0, obs_node_id="twin",
                   profile_hz=97.0)
        fe, ref = _make_frontend(**cfg), _make_reference_frontend(**cfg)
        try:
            ths = fe.threads()
            assert ths == ref.threads()
            names = [n for ns in ths.values() for n in ns]
            assert {n: role_of(n) for n in names} == \
                {n: ref_role_of(n) for n in names}
        finally:
            fe.close()
            ref.close()

    def test_no_profiler_without_hz(self):
        fe = _make_frontend()
        try:
            assert fe.profiler is None  # disabled = does not exist
            ths = fe.threads()
            assert "obs-profiler" not in ths
            assert len(ths["serve-worker"]) == 2
        finally:
            fe.close()

    def test_profile_hz_validation(self):
        from node_replication_torch.serve import ServeConfig

        with pytest.raises(ValueError, match="profile_hz"):
            ServeConfig(profile_hz=0)
        with pytest.raises(ValueError, match="profile_hz"):
            ServeConfig(profile_hz=-5.0)


class TestDutyGaugeSurvivesRestart:
    """`Tracer.events_since` and
    `MetricsRegistry.remove` under concurrent sampling — the
    profiler's gauges must survive a `_fail_replica` ->
    `restart_replica` retire/re-register cycle (which removes and
    re-creates per-rid gauges around it) without a stale-handle
    leak."""

    def test_fail_restart_cycle_keeps_profiler_gauges_live(self):
        from node_replication_torch.fault import FaultPlan, FaultSpec
        from node_replication_torch.models import SR_SET
        from node_replication_torch.serve import ReplicaFailed

        reg = get_registry()
        was = reg.enabled
        reg.enable()
        fe = _make_frontend(failover=True, profile_hz=211.0)
        try:
            plan = FaultPlan([FaultSpec(site="serve-batch",
                                        action="raise", rid=1,
                                        after=0)])
            with plan.armed():
                fut = fe.submit((SR_SET, 0, 1), rid=1)
                with pytest.raises(ReplicaFailed):
                    fut.result(30.0)
            t_end = time.monotonic() + 30.0
            while ("serve.queue_depth.r1" in reg.names()
                   and time.monotonic() < t_end):
                time.sleep(0.01)
            assert "serve.queue_depth.r1" not in reg.names()
            fe.restart_replica(1)
            assert fe.call((SR_SET, 0, 1), rid=1, timeout=30.0) == 0
            # the profiler kept publishing across the whole cycle:
            # its gauges are still registered AND still move
            names = reg.names()
            assert "obs.profiler.duty_cycle" in names
            assert "obs.host.busy_frac" in names
            g = reg.gauge("obs.profiler.duty_cycle")
            time.sleep(1.2)  # > one publish window
            snap = reg.snapshot()
            assert snap.get("obs.profiler.duty_cycle") is not None
            assert reg.gauge("obs.profiler.duty_cycle") is g
            assert fe.profiler.snapshot()["ticks"] > 0
        finally:
            fe.close()
            reg.enabled = was

    def test_events_since_with_concurrent_remove(self):
        """`Tracer.events_since` keeps a consistent (total, tail)
        while another thread hammers `MetricsRegistry.remove` and
        re-register — the exporter scrape path during a failover."""
        from node_replication_torch.obs.recorder import Tracer

        tr = Tracer()
        tr.enable(path=None, ring=256)
        reg = MetricsRegistry(enabled=True)
        stop = threading.Event()
        errs = []

        def churn():
            try:
                while not stop.is_set():
                    g = reg.gauge("serve.queue_depth.r1")
                    g.set(1.0)
                    reg.remove("serve.queue_depth.r1", g)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        t = threading.Thread(target=churn, name="obs-test-churn")
        t.start()
        try:
            seq = 0
            for i in range(200):
                tr.emit("profile-summary", i=i)
                total, tail = tr.events_since(seq)
                for e in tail:
                    assert e["event"] == "profile-summary"
                seq = total
                reg.snapshot()
            total, _ = tr.events_since(0)
            assert total == 200
        finally:
            stop.set()
            t.join(5.0)
        assert not errs


# --------------------------------------------------------------------------
# dashboard host column + report section
# --------------------------------------------------------------------------


class TestTopHostColumn:
    def test_host_busy_column_rendered(self):
        from node_replication_torch.obs.top import node_row, render_frame

        latest = {
            "p1": {"node_id": "p1", "role": "primary",
                   "metrics": {"obs.host.busy_frac": 0.37},
                   "stats": {}, "t": 1.0},
            "f1": {"node_id": "f1", "role": "follower",
                   "metrics": {}, "stats": {}, "t": 1.0},
        }
        row = node_row(latest["p1"])
        assert row["host"] == "37.0%"
        assert node_row(latest["f1"])["host"] == "-"
        frame = render_frame(latest, now_s=1.5)
        header = frame.splitlines()[1]
        assert "host" in header
        assert "37.0%" in frame

    def test_garbage_metric_value_renders_dash(self):
        from node_replication_torch.obs.top import node_row

        row = node_row({"node_id": "x", "role": "primary",
                        "metrics": {"obs.host.busy_frac": "nope"},
                        "stats": {}})
        assert row["host"] == "-"


class TestReportHostBudget:
    def _events(self):
        return [
            {"event": "profile-summary", "hz": 97.0, "wall_s": 2.0,
             "ticks": 190, "thread_samples": 800, "duty_cycle": 0.02,
             "busy_frac": 0.4, "unique_stacks": 12,
             "overflow_drops": 0,
             "roles": {"serve-worker": 500, "serve-client": 300},
             "stages": {"lock-wait": 500, "append": 200,
                        "encode": 60, "other": 40},
             "attributed_frac": 0.95},
            {"event": "profile-summary", "hz": 97.0, "wall_s": 1.0,
             "ticks": 95, "thread_samples": 200, "duty_cycle": 0.01,
             "busy_frac": 0.8, "unique_stacks": 4,
             "overflow_drops": 2,
             "roles": {"repl-apply": 200},
             "stages": {"append": 150, "fsync": 50},
             "attributed_frac": 1.0},
            {"event": "append", "n": 4, "duration_s": 0.01,
             "mono": 1.0},
        ]

    def test_analyze_aggregates_summaries(self):
        from node_replication_torch.obs.report import analyze

        hb = analyze(self._events())["host_budget"]
        assert hb["profiles"] == 2
        assert hb["thread_samples"] == 1000
        assert hb["stages"]["lock-wait"]["samples"] == 500
        assert hb["stages"]["append"]["samples"] == 350
        assert hb["stages"]["append"]["span_total_s"] \
            == pytest.approx(0.01)
        assert hb["attributed_frac"] == pytest.approx(0.96)
        assert hb["busy_frac"] == pytest.approx(0.48)
        assert hb["overflow_drops"] == 2
        assert hb["roles"]["serve-worker"] == 500
        assert hb["roles"]["repl-apply"] == 200

    def test_render_section(self):
        import io

        from node_replication_torch.obs.report import analyze, render

        out = io.StringIO()
        render(analyze(self._events()), out=out)
        text = out.getvalue()
        assert "== host budget ==" in text
        assert "lock-wait" in text
        assert "attributed to named stages: 96.0%" in text
        assert "host_budget" in text.splitlines()[1]  # presence line

    def test_no_summaries_no_section(self):
        import io

        from node_replication_torch.obs.report import analyze, render

        report = analyze([{"event": "append", "n": 1, "mono": 0.5}])
        assert report["host_budget"] is None
        out = io.StringIO()
        render(report, out=out)
        assert "== host budget ==" not in out.getvalue()
