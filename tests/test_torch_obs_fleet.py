"""The port's fleet observability plane (`obs/export.py`,
`obs/collect.py`, `obs/report.py`, `obs/top.py`): twins of
`tests/test_obs_fleet.py`, then differentials against the reference
in one process — each package's exporter scraped by the other's
client, frames and Prometheus text byte-identical, `report.analyze`
JSON and `render` text identical on the reference's event fixtures and
on a fleet trace from a real CPU run of the port's served and
replicated flagship, and one `FleetCollector` over exporters of both
packages.
"""

import json
import socket
import threading

import pytest

from node_replication_torch.obs import report
from node_replication_torch.obs.collect import FleetCollector
from node_replication_torch.obs.export import (
    ExportError,
    MetricsExporter,
    recv_frame,
    scrape,
    send_frame,
    to_prometheus,
)
from node_replication_torch.obs.metrics import MetricsRegistry, get_registry
from node_replication_torch.obs.recorder import (
    Tracer,
    get_tracer,
    set_trace_sample,
)
from node_replication_torch.obs.top import node_row, render_frame


@pytest.fixture
def reg():
    r = MetricsRegistry(enabled=True)
    return r


@pytest.fixture
def tracer():
    t = Tracer()
    t.enable(None, ring=512)
    yield t
    t.disable()


def make_exporter(reg, tracer, **kw):
    return MetricsExporter(registry=reg, tracer=tracer, port=0,
                           **kw)


class TestExporter:
    def test_scrape_roundtrip(self, reg, tracer):
        reg.counter("a.count").inc(3)
        reg.gauge("b.gauge").set(1.5)
        reg.histogram("c.hist").observe(0.01)
        tracer.emit("append", pos0=0, n=4)
        with make_exporter(reg, tracer, node_id="n1",
                           role="primary") as exp:
            exp.add_stats("serve", lambda: {"completed": 7})
            doc = scrape(*exp.address)
        assert doc["node_id"] == "n1" and doc["role"] == "primary"
        assert doc["metrics"]["a.count"] == 3
        assert doc["metrics"]["b.gauge"] == 1.5
        assert doc["metrics"]["c.hist"]["count"] == 1
        assert doc["stats"]["serve"]["completed"] == 7
        # the exporter's own announce event rides along with `append`
        assert [e["event"] for e in doc["events"]] == [
            "append", "obs-export-serve"]
        assert doc["seq"] == 2 and "now_ts" in doc

    def test_incremental_cursor(self, reg, tracer):
        with make_exporter(reg, tracer) as exp:
            tracer.emit("e1")
            d1 = scrape(*exp.address)
            assert [e["event"] for e in d1["events"]] == [
                "obs-export-serve", "e1"]
            tracer.emit("e2")
            d2 = scrape(*exp.address, since=d1["seq"])
            assert [e["event"] for e in d2["events"]] == ["e2"]
            # same cursor again: nothing new
            d3 = scrape(*exp.address, since=d2["seq"])
            assert d3["events"] == []

    def test_sick_stats_provider_isolated(self, reg, tracer):
        def boom():
            raise RuntimeError("sick subsystem")

        with make_exporter(reg, tracer) as exp:
            exp.add_stats("bad", boom)
            exp.add_stats("good", lambda: {"x": 1})
            doc = scrape(*exp.address)
        assert doc["stats"]["good"] == {"x": 1}
        assert "RuntimeError" in doc["stats"]["bad"]["error"]

    def test_prometheus_exposition(self, reg, tracer):
        reg.counter("serve.completed").inc(9)
        reg.gauge("repl.apply_lag_pos").set(2.0)
        reg.histogram("serve.batch.duration_s").observe(0.004)
        with make_exporter(reg, tracer, node_id="nX",
                           role="relay") as exp:
            text = to_prometheus(scrape(*exp.address))
        assert ('nr_tpu_serve_completed{node="nX",role="relay"} 9'
                in text)
        assert "# TYPE nr_tpu_repl_apply_lag_pos gauge" in text
        assert "nr_tpu_serve_batch_duration_s_count" in text
        assert 'quantile="0.95"' in text

    def test_bad_frame_is_transport_error_not_crash(self, reg,
                                                    tracer):
        with make_exporter(reg, tracer) as exp:
            sock = socket.create_connection(exp.address, timeout=2.0)
            sock.sendall(b"\xff" * 8 + b"garbage")
            sock.close()
            # the server survives a torn/garbage client: next scrape
            # still answers
            doc = scrape(*exp.address)
            assert "node_id" in doc

    def test_unknown_command_answers_typed_error(self, reg, tracer):
        with make_exporter(reg, tracer) as exp:
            sock = socket.create_connection(exp.address, timeout=2.0)
            try:
                send_frame(sock, json.dumps({"cmd": "nope"}).encode())
                rsp = json.loads(recv_frame(sock).decode())
            finally:
                sock.close()
            assert "error" in rsp
            with pytest.raises(RuntimeError):
                # the client helper surfaces it as a typed failure
                raise RuntimeError(rsp["error"])

    def test_closed_exporter_refuses(self, reg, tracer):
        exp = make_exporter(reg, tracer)
        addr = exp.address
        exp.close()
        with pytest.raises(ExportError):
            scrape(*addr, timeout_s=0.5)


class TestCollector:
    def test_socket_and_inprocess_targets(self, reg, tracer,
                                          tmp_path):
        reg.counter("x.ops").inc(4)
        out = tmp_path / "fleet.jsonl"
        with make_exporter(reg, tracer, node_id="socknode",
                           role="primary") as exp:
            reg2 = MetricsRegistry(enabled=True)
            t2 = Tracer()
            t2.enable(None, ring=64)
            exp2 = MetricsExporter(registry=reg2, tracer=t2, port=0,
                                   node_id="inproc", role="follower")
            coll = FleetCollector(
                [f"{exp.address[0]}:{exp.address[1]}", exp2],
                out_path=str(out),
            )
            try:
                assert coll.collect_once() == 2
                assert coll.nodes() == ["inproc", "socknode"]
                assert coll.series("socknode", "x.ops") == [
                    (coll.series("socknode", "x.ops")[0][0], 4)
                ]
                latest = coll.latest()
                assert latest["socknode"]["role"] == "primary"
            finally:
                coll.close()
                exp2.close()
                t2.disable()
        lines = [json.loads(ln) for ln in
                 out.read_text().splitlines()]
        assert sum(1 for ln in lines
                   if ln["event"] == "fleet-scrape") == 2

    def test_unreachable_target_counts_not_crashes(self, tmp_path):
        out = tmp_path / "fleet.jsonl"
        coll = FleetCollector(["127.0.0.1:1"], out_path=str(out),
                              timeout_s=0.2)
        try:
            assert coll.collect_once() == 0
            assert coll.stats()["errors"]
        finally:
            coll.close()
        lines = [json.loads(ln) for ln in
                 out.read_text().splitlines()]
        assert any(ln["event"] == "fleet-scrape-error"
                   for ln in lines)

    def test_pid_dedup_and_reattribution(self, reg, tracer,
                                         tmp_path):
        # two exporters in ONE process share the tracer: the merge
        # must keep each event once, and an event naming a known node
        # (a relay's relay-forward) re-attributes to that node
        out = tmp_path / "fleet.jsonl"
        a = make_exporter(reg, tracer, node_id="primary",
                          role="primary")
        b = make_exporter(reg, tracer, node_id="relay7",
                          role="relay")
        coll = FleetCollector([a, b], out_path=str(out))
        try:
            coll.collect_once()  # learn both identities
            tracer.emit("repl-ship", pos=8, n=1)
            tracer.emit("relay-forward", pos=8, n=1, name="relay7")
            coll.collect_once()
        finally:
            coll.close()
            a.close()
            b.close()
        lines = [json.loads(ln) for ln in
                 out.read_text().splitlines()]
        ships = [ln for ln in lines if ln["event"] == "repl-ship"]
        fwds = [ln for ln in lines
                if ln["event"] == "relay-forward"]
        assert len(ships) == 1 and len(fwds) == 1  # pid-deduped
        assert ships[0]["node_id"] == "primary"
        assert fwds[0]["node_id"] == "relay7"  # re-attributed
        assert fwds[0]["role"] == "relay"
        assert "t_fleet" in ships[0]

    def test_pre_scrape_events_reattribute_to_known_exporters(
            self, reg, tracer, tmp_path):
        # in-process exporters declare their identity at construction,
        # so even events emitted BEFORE the collector's first cycle
        # re-attribute to the right co-resident node
        out = tmp_path / "fleet.jsonl"
        a = make_exporter(reg, tracer, node_id="primary",
                          role="primary")
        b = make_exporter(reg, tracer, node_id="relay9",
                          role="relay")
        tracer.emit("relay-forward", pos=4, n=1, name="relay9")
        coll = FleetCollector([a, b], out_path=str(out))
        try:
            coll.collect_once()  # FIRST cycle already sees relay9
        finally:
            coll.close()
            a.close()
            b.close()
        fwds = [json.loads(ln) for ln in out.read_text().splitlines()
                if json.loads(ln)["event"] == "relay-forward"]
        assert len(fwds) == 1 and fwds[0]["node_id"] == "relay9"

    def test_owner_death_reelects_pid_owner(self, reg, tracer):
        # the pid's event-merge owner dies; a surviving co-resident
        # exporter must take over event merging on its next cycle
        a = make_exporter(reg, tracer, node_id="owner",
                          role="primary")
        b = make_exporter(reg, tracer, node_id="survivor",
                          role="relay")
        coll = FleetCollector(
            [f"{a.address[0]}:{a.address[1]}", b],
        )
        try:
            coll.collect_once()  # a owns the pid
            a.close()
            tracer.emit("repl-ship", pos=0, n=1)
            coll.collect_once()  # a errors -> ownership released
            n_before = coll.stats()["merged_events"]
            tracer.emit("repl-ship", pos=4, n=1)
            coll.collect_once()  # b merges now
            assert coll.stats()["merged_events"] > n_before
        finally:
            coll.close()
            b.close()

    def test_add_target_mid_run(self, reg, tracer):
        coll = FleetCollector([])
        try:
            assert coll.collect_once() == 0
            with make_exporter(reg, tracer, node_id="late") as exp:
                coll.add_target(exp)
                assert coll.collect_once() == 1
                assert coll.nodes() == ["late"]
        finally:
            coll.close()


def _merged(events):
    """Stamp a synthetic event list the way the collector would."""
    return [dict(e) for e in events]


class TestFleetReportJoin:
    def _chain_events(self):
        # the canonical 3-process chain for pos 64: primary submit/
        # append/sync/ship/ack, relay forward, leaf apply
        return [
            {"event": "fleet-scrape", "node_id": "primary",
             "role": "primary", "ts": 100.0, "t": 0.1,
             "metrics": {"repl.ship_lag_pos": 0.0},
             "stats": {"serve": {"completed": 10, "queued": 0,
                                 "shed": 0}}},
            {"event": "fleet-scrape", "node_id": "relay0",
             "role": "relay", "ts": 100.0, "t": 0.1, "metrics": {},
             "stats": {"relay": {"cursor": 65}}},
            {"event": "fleet-scrape", "node_id": "leaf0",
             "role": "follower", "ts": 100.0, "t": 0.1,
             "metrics": {"repl.apply_lag_pos": 1.0},
             "stats": {"follower": {"applied": 65}}},
            {"event": "serve-batch", "node_id": "primary", "pos": 64,
             "n": 1, "ts": 100.010, "t_fleet": 100.010,
             "duration_s": 0.004, "queue_delay_s": 0.001},
            {"event": "append", "node_id": "primary", "pos0": 64,
             "n": 1, "ts": 100.007, "t_fleet": 100.007,
             "duration_s": 0.001},
            {"event": "wal-sync", "node_id": "primary",
             "synced_to": 65, "ts": 100.008, "t_fleet": 100.008,
             "duration_s": 0.0005},
            {"event": "repl-ship", "node_id": "primary", "pos": 64,
             "n": 1, "ts": 100.009, "t_fleet": 100.009},
            {"event": "relay-forward", "node_id": "relay0",
             "name": "relay0", "pos": 64, "n": 1, "ts": 100.011,
             "t_fleet": 100.012},
            {"event": "repl-apply", "node_id": "leaf0",
             "name": "leaf0", "pos": 64, "n": 1, "ts": 100.013,
             "t_fleet": 100.015},
        ]

    def test_three_process_chain_joins(self):
        fleet = report.analyze(self._chain_events())["fleet"]
        assert {n["node_id"] for n in fleet["nodes"]} == {
            "primary", "relay0", "leaf0"}
        roles = {n["node_id"]: n["role"] for n in fleet["nodes"]}
        assert roles["relay0"] == "relay"
        assert fleet["records"] == 1
        assert fleet["complete_records"] == 1
        assert fleet["complete_multiprocess_records"] == 1
        tl = fleet["timelines"][0]
        assert tl["pos"] == 64 and tl["processes"] == 3
        hops = [(h["hop"], h["node"]) for h in tl["hops"]]
        assert hops == [
            ("submit", "primary"), ("append", "primary"),
            ("wal-sync", "primary"), ("ship", "primary"),
            ("relay-forward", "relay0"), ("apply", "leaf0"),
            ("ack", "primary"),
        ]
        # the submit stamp reconstructs from ack - delay - duration
        assert tl["hops"][0]["t"] == 0.0
        edges = fleet["edges"]
        assert "submit->ack" in edges
        assert edges["submit->ack"]["count"] == 1
        assert abs(edges["submit->ack"]["p50_s"] - 0.005) < 1e-9
        assert edges["relay-forward->apply"]["p50_s"] > 0

    def test_follower_reappend_filtered_to_origin(self):
        # followers replay through the same combiner protocol and
        # re-emit append/wal-sync — the chain keeps only the origin's
        events = self._chain_events() + [
            {"event": "append", "node_id": "leaf0", "pos0": 64,
             "n": 1, "ts": 100.014, "t_fleet": 100.016,
             "duration_s": 0.001},
            {"event": "wal-sync", "node_id": "leaf0",
             "synced_to": 70, "ts": 100.017, "t_fleet": 100.019,
             "duration_s": 0.0005},
        ]
        fleet = report.analyze(events)["fleet"]
        tl = fleet["timelines"][0]
        appends = [h for h in tl["hops"] if h["hop"] == "append"]
        syncs = [h for h in tl["hops"] if h["hop"] == "wal-sync"]
        assert [h["node"] for h in appends] == ["primary"]
        assert [h["node"] for h in syncs] == ["primary"]
        # no negative edges sneak in through the replayed append
        for label, e in fleet["edges"].items():
            assert e["p50_s"] >= 0, (label, e)

    def test_multi_node_same_hop_uses_first_occurrence(self):
        # two relays forward, two leaves apply: edges pair FIRST
        # occurrences, never across parallel nodes
        events = self._chain_events() + [
            {"event": "relay-forward", "node_id": "relay1",
             "name": "relay1", "pos": 64, "n": 1, "ts": 100.020,
             "t_fleet": 100.020},
            {"event": "repl-apply", "node_id": "leaf1",
             "name": "leaf1", "pos": 64, "n": 1, "ts": 100.025,
             "t_fleet": 100.025},
        ]
        fleet = report.analyze(events)["fleet"]
        tl = fleet["timelines"][0]
        assert tl["processes"] == 5
        for label, e in fleet["edges"].items():
            assert e["p50_s"] >= 0, (label, e)
        assert fleet["edges"]["relay-forward->apply"]["count"] == 1

    def test_earliest_occurrence_not_node_sort_order(self):
        # a relay whose name sorts BEFORE the fast relay but forwards
        # LATER must not become the edge anchor (earliest by time,
        # not by (rank, node) list order)
        events = self._chain_events() + [
            {"event": "relay-forward", "node_id": "a-relay",
             "name": "a-relay", "pos": 64, "n": 1, "ts": 100.030,
             "t_fleet": 100.030},
        ]
        fleet = report.analyze(events)["fleet"]
        for label, e in fleet["edges"].items():
            assert e["p50_s"] >= 0, (label, e)
        # relay-forward anchors at relay0's 100.012, so apply at
        # 100.015 gives +3ms, not 100.030 -> -15ms
        assert fleet["edges"]["relay-forward->apply"][
            "p50_s"] == pytest.approx(0.003, abs=1e-6)

    def test_no_node_tags_no_fleet_section(self):
        rep = report.analyze([
            {"event": "append", "pos0": 0, "n": 1, "ts": 1.0,
             "mono": 1.0, "duration_s": 0.001},
        ])
        assert rep["fleet"] is None

    def test_renders_and_json_roundtrips(self, capsys):
        import io

        rep = report.analyze(self._chain_events())
        buf = io.StringIO()
        report.render(rep, out=buf)
        out = buf.getvalue()
        assert "== fleet ==" in out
        assert "record @pos 64 (3 process(es), complete)" in out
        assert "per-edge latency:" in out
        json.dumps(rep)  # JSON-serializable end to end

    def test_partial_merge_scrapes_only(self):
        # a collector that merged summaries but no hop events still
        # renders (explicit no-joinable-hops note, no crash)
        import io

        events = [e for e in self._chain_events()
                  if e["event"] == "fleet-scrape"]
        rep = report.analyze(events)
        assert rep["fleet"]["records"] == 0
        buf = io.StringIO()
        report.render(rep, out=buf)
        assert "no joinable per-record hops" in buf.getvalue()


class TestReportRobustness:
    """Every section renders cleanly — no crash, explicit no-data —
    on traces missing (or only partially holding) its events."""

    def _render(self, events):
        import io

        rep = report.analyze(events)
        buf = io.StringIO()
        report.render(rep, out=buf)
        json.dumps(rep)
        return rep, buf.getvalue()

    def test_empty_trace(self):
        rep, out = self._render([])
        assert "trace: 0 events" in out
        assert "[no data:" in out and "fleet" in out

    def test_sections_line_lists_absences(self):
        _rep, out = self._render(
            [{"event": "serve-batch", "rid": 0, "n": 1, "ts": 1.0,
              "mono": 1.0, "queue_depth": 0, "duration_s": 0.001}]
        )
        assert "sections: serve" in out
        assert "[no data:" in out

    def test_serve_shed_without_batches(self):
        rep, out = self._render(
            [{"event": "serve-shed", "rid": 0, "depth": 4,
              "prio": "NORMAL", "ts": 1.0, "mono": 1.0}]
        )
        assert rep["serve"]["shed"] == 1
        assert rep["serve"]["max_batch"] == 0
        assert "== serve ==" in out

    def test_promotion_without_rto(self):
        rep, _ = self._render(
            [{"event": "repl-promote", "name": "f1", "epoch": 2,
              "applied": 10, "duration_s": 0.1, "ts": 1.0,
              "mono": 1.0}]
        )
        p = rep["replication"]["promotions"][0]
        assert p["rto_s"] == pytest.approx(0.1)
        assert p["detect_s"] == 0.0

    def test_fault_rehome_only(self):
        rep, out = self._render(
            [{"event": "serve-rehome", "rid": 1, "n": 3, "ts": 1.0,
              "mono": 1.0}]
        )
        assert rep["fault"]["rehomed"] == 3
        assert rep["fault"]["repair_p50_s"] == 0.0
        assert "== fault ==" in out

    def test_kernel_calibration_only(self):
        rep, out = self._render(
            [{"event": "fused-calibration", "winner": "chain",
              "window": 64, "fused_s": 0.2, "chain_s": 0.1,
              "ts": 1.0, "mono": 1.0}]
        )
        assert rep["kernels"]["calibrations"][0]["winner"] == "chain"
        assert "== kernels ==" in out

    def test_durability_open_only(self):
        rep, out = self._render(
            [{"event": "wal-open", "tail": 0, "ts": 1.0,
              "mono": 1.0}]
        )
        assert rep["durability"]["fsyncs"] == 0
        assert "== durability ==" in out


class TestDashboard:
    def test_node_row_and_frame(self):
        latest = {
            "primary": {
                "node_id": "primary", "role": "primary", "t": 1.0,
                "metrics": {
                    "repl.ship_lag_pos": 5.0,
                    "serve.request.latency_s": {"count": 9,
                                                "p99": 0.0021},
                },
                "stats": {"serve": {
                    "completed": 100, "accepted": 110, "shed": 10,
                    "deadline_missed": 0, "queued": 2,
                    "overload": {"limits": {"0": 32, "1": 64},
                                 "brownout": True,
                                 "backpressure": 0},
                }},
            },
            "leaf0": {
                "node_id": "leaf0", "role": "follower", "t": 0.0,
                "metrics": {"repl.apply_lag_pos": 7.0},
                "stats": {"follower": {"applied": 93}},
            },
        }
        row = node_row(latest["primary"])
        assert row["limit"] == "32"
        assert row["ship-lag"] == "5"
        assert row["burn"] == "9.1%"
        assert row["p99"] == "2.1ms"
        assert "BROWNOUT" in row["state"]
        frame = render_frame(latest, now_s=10.0, stale_after_s=5.0)
        lines = frame.splitlines()
        assert lines[0] == "fleet: 2 node(s)"
        # tree order + indent: primary row above the follower's
        p_line = next(ln for ln in lines if "primary" in ln)
        f_line = next(ln for ln in lines if "leaf0" in ln)
        assert lines.index(p_line) < lines.index(f_line)
        assert f_line.startswith("    ")
        assert "STALE" in f_line  # last scrape 10s ago > 5s
        assert "93" in f_line

    def test_empty_frame(self):
        frame = render_frame({})
        assert "no nodes answered" in frame


# --------------------------------------------------------------------------
# differentials against the reference (one process, both packages)
# --------------------------------------------------------------------------

from node_replication_tpu.obs import export as j_export  # noqa: E402
from node_replication_tpu.obs import report as j_report  # noqa: E402
from node_replication_tpu.obs.collect import (  # noqa: E402
    FleetCollector as JFleetCollector,
)
from node_replication_tpu.obs.metrics import (  # noqa: E402
    MetricsRegistry as JMetricsRegistry,
)
from node_replication_tpu.obs.recorder import Tracer as JTracer  # noqa: E402

from node_replication_torch.obs import export  # noqa: E402


def _wire_bytes(send, payload: bytes) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, payload)
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


def _fill(reg, tracer):
    reg.counter("serve.completed").inc(9)
    reg.gauge("repl.apply_lag_pos").set(2.0)
    h = reg.histogram("serve.batch.duration_s")
    for v in (0.001, 0.004, 0.02):
        h.observe(v)
    tracer.emit("repl-ship", pos=8, n=1)


@pytest.fixture
def j_reg():
    return JMetricsRegistry(enabled=True)


@pytest.fixture
def j_tracer():
    t = JTracer()
    t.enable(None, ring=512)
    yield t
    t.disable()


class TestWireAgainstReference:
    @pytest.mark.parametrize("payload", [b"", b"{}", b"x" * 70000,
                                         json.dumps({"cmd": "scrape",
                                                     "since": 3}).encode()])
    def test_frames_byte_identical(self, payload):
        assert _wire_bytes(send_frame, payload) == \
            _wire_bytes(j_export.send_frame, payload)
        a, b = socket.socketpair()
        try:
            j_export.send_frame(a, payload)
            assert recv_frame(b) == payload
            send_frame(a, payload)
            assert j_export.recv_frame(b) == payload
        finally:
            a.close()
            b.close()

    def test_each_scrapes_the_other(self, reg, tracer, j_reg, j_tracer):
        _fill(reg, tracer)
        _fill(j_reg, j_tracer)
        with make_exporter(reg, tracer, node_id="torch-n",
                           role="relay") as exp, \
                j_export.MetricsExporter(registry=j_reg, tracer=j_tracer,
                                         port=0, node_id="jax-n",
                                         role="relay") as jexp:
            exp.add_stats("serve", lambda: {"completed": 9})
            jexp.add_stats("serve", lambda: {"completed": 9})
            by_ref = j_export.scrape(*exp.address)
            by_port = scrape(*jexp.address)
            mine = scrape(*exp.address)
        assert by_ref["node_id"] == "torch-n"
        assert by_port["node_id"] == "jax-n"
        assert set(by_ref) == set(by_port) == set(mine)
        for k in ("role", "metrics", "stats", "seq"):
            assert by_ref[k] == by_port[k], k
        assert [e["event"] for e in by_ref["events"]] == \
            [e["event"] for e in by_port["events"]]

    def test_prometheus_text_byte_identical(self, reg, tracer):
        _fill(reg, tracer)
        reg.counter("nr.exec.engine.pallas_fused").inc(3)
        reg.gauge("weird-name/x").set(0.5)
        with make_exporter(reg, tracer, node_id='n"1\\', role="primary") \
                as exp:
            doc = scrape(*exp.address)
        text = to_prometheus(doc)
        assert text == j_export.to_prometheus(doc)
        assert 'quantile="0.99"' in text and "nr_tpu_weird_name_x" in text

    def test_one_collector_over_both_packages(self, reg, tracer, j_reg,
                                              j_tracer, tmp_path):
        reg.counter("x.ops").inc(4)
        j_reg.counter("x.ops").inc(5)
        exp = make_exporter(reg, tracer, node_id="torch-node",
                            role="primary")
        jexp = j_export.MetricsExporter(registry=j_reg, tracer=j_tracer,
                                        port=0, node_id="jax-node",
                                        role="follower")
        colls = {name: cls(["%s:%d" % exp.address, "%s:%d" % jexp.address],
                           out_path=str(tmp_path / f"{name}.jsonl"))
                 for name, cls in (("port", FleetCollector),
                                   ("ref", JFleetCollector))}
        try:
            for coll in colls.values():  # learn both identities
                assert coll.collect_once() == 2
            # one pid: the first target merges its process's events, and
            # an event naming the reference's node re-attributes to it
            tracer.emit("repl-ship", pos=4, n=1)
            tracer.emit("repl-apply", pos=4, n=1, name="jax-node")
            for coll in colls.values():
                assert coll.collect_once() == 2
                assert coll.nodes() == ["jax-node", "torch-node"]
                assert [v for _, v in coll.series("torch-node",
                                                  "x.ops")] == [4, 4]
                assert [v for _, v in coll.series("jax-node",
                                                  "x.ops")] == [5, 5]
        finally:
            for coll in colls.values():
                coll.close()
            exp.close()
            jexp.close()
        outs = {name: [json.loads(ln) for ln in
                       (tmp_path / f"{name}.jsonl").read_text().splitlines()]
                for name in colls}
        # the same lines, fields, events and attribution (the clock
        # stamps differ)
        shape = [[(ln["event"], ln["node_id"], ln.get("role"), ln.get("pos"),
                   sorted(ln)) for ln in outs[k]] for k in ("port", "ref")]
        assert shape[0] == shape[1]
        assert ("repl-apply", "jax-node", "follower", 4) in \
            [s[:4] for s in shape[0]]
        assert ("repl-ship", "torch-node", "primary", 4) in \
            [s[:4] for s in shape[0]]


def _same_report(events):
    """analyze() JSON and render() text of both packages on one event
    list."""
    import io

    rep, jrep = report.analyze(events), j_report.analyze(events)
    assert json.dumps(rep, sort_keys=True) == \
        json.dumps(jrep, sort_keys=True)
    out, jout = io.StringIO(), io.StringIO()
    report.render(rep, out=out)
    j_report.render(jrep, out=jout)
    assert out.getvalue() == jout.getvalue()
    return rep, out.getvalue()


_FIXTURES = {
    "chain": TestFleetReportJoin()._chain_events,
    "empty": lambda: [],
    "robustness": lambda: [
        {"event": "serve-shed", "rid": 0, "depth": 4, "prio": "NORMAL",
         "ts": 1.0, "mono": 1.0},
        {"event": "repl-promote", "name": "f1", "epoch": 2, "applied": 10,
         "duration_s": 0.1, "ts": 1.0, "mono": 1.0},
        {"event": "serve-rehome", "rid": 1, "n": 3, "ts": 1.0, "mono": 1.0},
        {"event": "fused-calibration", "winner": "chain", "window": 64,
         "fused_s": 0.2, "chain_s": 0.1, "ts": 1.0, "mono": 1.0},
        {"event": "wal-open", "tail": 0, "ts": 1.0, "mono": 1.0}],
    "host-budget": lambda: [
        {"event": "profile-summary", "hz": 97.0, "wall_s": 2.0,
         "ticks": 190, "thread_samples": 800, "duty_cycle": 0.02,
         "busy_frac": 0.4, "unique_stacks": 12, "overflow_drops": 0,
         "roles": {"serve-worker": 500, "serve-client": 300},
         "stages": {"lock-wait": 500, "append": 200, "encode": 60,
                    "other": 40},
         "attributed_frac": 0.95},
        {"event": "append", "n": 4, "duration_s": 0.01, "mono": 1.0}],
}


class TestReportAgainstReference:
    @pytest.mark.parametrize("name", sorted(_FIXTURES))
    def test_fixtures_identical(self, name):
        _same_report(_FIXTURES[name]())

    def test_served_replicated_fleet_trace_identical(self, tmp_path):
        # a real CPU run of the port's served flagship shape (fused
        # tier, durable acks, ship-before-ack) and a follower, both
        # exporting; the collector's fleet.jsonl reads the same in
        # both packages' reports
        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.durable import WriteAheadLog
        from node_replication_torch.models import HM_PUT, make_hashmap
        from node_replication_torch.repl import (
            DirectoryFeed,
            Follower,
            ReplicationShipper,
        )
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        kw = dict(n_replicas=2, log_entries=512, gc_slack=32,
                  engine="pallas", device="cpu")
        t = get_tracer()
        t.enable(None, ring=4096)
        set_trace_sample(2)
        reg_g = get_registry()
        was = reg_g.enabled
        reg_g.enable()
        nr = NodeReplicated(make_hashmap(16), **kw)
        nr.attach_wal(WriteAheadLog(str(tmp_path / "wal"), policy="batch"))
        feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=3)
        shipper = ReplicationShipper(nr.wal, feed)
        fe = ServeFrontend(nr, ServeConfig(batch_linger_s=0.0,
                                           durability="batch", obs_port=0,
                                           obs_node_id="primary"))
        fe.ack_barrier = shipper.barrier
        f = Follower(make_hashmap(16), feed, str(tmp_path / "leaf"),
                     nr_kwargs=kw, name="leaf", obs_port=0)
        out = tmp_path / "fleet.jsonl"
        coll = FleetCollector([fe.exporter, f.frontend.exporter],
                              out_path=str(out))
        try:
            coll.collect_once()
            for i in range(24):
                assert fe.call((HM_PUT, i % 16, i), rid=i % 2,
                               timeout=30.0) == 0
            assert f.wait_applied(nr.log.tail.item(), timeout=30.0)
            coll.collect_once()
        finally:
            coll.close()
            f.close()
            fe.close()
            shipper.stop()
            nr.detach_wal().close()
            set_trace_sample(1)
            t.disable()
            reg_g.enabled = was
        events = report.load_events(str(out))
        assert events == j_report.load_events(str(out))
        rep, text = _same_report(events)
        fleet = rep["fleet"]
        assert {n["node_id"] for n in fleet["nodes"]} == {"primary",
                                                          "leaf"}
        assert fleet["complete_records"] >= 1 and "submit->ack" in \
            fleet["edges"]
        assert "== fleet ==" in text and "== replication ==" in text
