"""The port's tracer wiring: twins of `tests/test_trace.py` (all but
`TestHarnessMeasureEvents`, which waits for the port's `harness/`) on
`device="cpu"` fleets — watchdogs emit (and re-emit) events, the
combine path emits spans, file mode writes JSONL — and the span tree
of a combiner round: clock, parent and round of each span, the
disabled path, the round's spans and reads, and the benchmark's
mapping of idle device time onto them (`portbench/spans.py`)."""

import pytest

from node_replication_torch.core.log import WARN_ROUNDS
from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.models.vspace import make_vspace
from node_replication_torch.obs import recorder
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.trace import get_tracer, span
from portbench.spans import align, attribute_idle, clock, misfit


def _with_mem_tracer(fn):
    t = get_tracer()
    t.enable(None)  # in-memory buffer
    try:
        return fn(t)
    finally:
        t.disable()


class TestWatchdogEvents:
    def test_nr_watchdog_emits_and_reemits(self):
        def body(t):
            events = []
            nr = NodeReplicated(
                make_hashmap(16), device="cpu", n_replicas=1, log_entries=512,
                gc_slack=16,
                gc_callback=lambda log, rid: events.append((log, rid)),
            )
            rounds = 0
            # drive 3×WARN_ROUNDS spin rounds: the watchdog must fire at
            # EVERY multiple, not just the first (r1 warned once then went
            # silent forever)
            for _ in range(3 * WARN_ROUNDS):
                rounds = nr._watchdog(rounds, "test-stall")
            w = [e for e in t.events() if e["event"] == "watchdog"]
            assert len(w) == 3
            assert [e["rounds"] for e in w] == [
                WARN_ROUNDS, 2 * WARN_ROUNDS, 3 * WARN_ROUNDS
            ]
            assert all(e["where"] == "test-stall" for e in w)
            assert events == [(0, 0)] * 3  # gc_callback re-fires too

        _with_mem_tracer(body)

    def test_cnr_watchdog_emits_with_log_index(self):
        def body(t):
            c = MultiLogReplicated(
                make_hashmap(16), lambda o, a: a[0], nlogs=2,
                device="cpu", n_replicas=1, log_entries=1 << 10, gc_slack=32,
            )
            rounds = 0
            for _ in range(2 * WARN_ROUNDS):
                rounds = c._watchdog(rounds, 1, "cnr-stall")
            w = [e for e in t.events() if e["event"] == "watchdog"]
            assert len(w) == 2
            assert all(e["log"] == 1 for e in w)

        _with_mem_tracer(body)


class TestSpans:
    def test_combine_emits_append_and_replay_spans(self):
        def body(t):
            nr = NodeReplicated(
                make_hashmap(16), device="cpu", n_replicas=2, log_entries=512,
                gc_slack=16,
            )
            tok = nr.register(0)
            assert nr.execute_mut((HM_PUT, 3, 42), tok) == 0
            assert nr.execute((HM_GET, 3), tok) == 42
            names = [e["event"] for e in t.events()]
            assert "append" in names
            assert "combine-replay" in names
            ap = next(e for e in t.events() if e["event"] == "append")
            assert ap["n"] == 1 and "duration_s" in ap

        _with_mem_tracer(body)


class TestTraceFileMode:
    def test_jsonl_file_written(self, tmp_path):
        import json

        t = get_tracer()
        path = str(tmp_path / "trace.jsonl")
        t.enable(path)
        try:
            t.emit("hello", x=1)
            t.emit("world", y=2)
        finally:
            t.disable()
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        assert [r["event"] for r in recs] == ["hello", "world"]
        assert all("ts" in r for r in recs)


class TestSpanTree:
    def test_nested_spans_carry_clock_parent_and_round(self):
        def body(t):
            with span("root", round=None) as root:
                with span("a"):
                    with span("b"):
                        pass
                root.add(round=7)
                with span("c", round=9):
                    pass
            with span("solo"):
                pass
            ev = {e["event"]: e for e in t.events()}
            assert [e["event"] for e in t.events()] == [
                "b", "a", "c", "root", "solo"]
            for e in ev.values():
                assert e["t0_ns"] <= e["t1_ns"]
                assert e["duration_s"] == pytest.approx(
                    (e["t1_ns"] - e["t0_ns"]) * 1e-9)
            assert ev["root"]["parent"] is None
            assert ev["a"]["parent"] == ev["root"]["id"]
            assert ev["b"]["parent"] == ev["a"]["id"]
            assert ev["c"]["parent"] == ev["root"]["id"]
            assert [ev[n]["round"] for n in "abc"] == [7, 7, 9]
            assert ev["root"]["round"] == 7
            assert ev["solo"]["parent"] is None and "round" not in ev["solo"]
            assert ev["root"]["t0_ns"] <= ev["b"]["t0_ns"]
            assert ev["b"]["t1_ns"] <= ev["root"]["t1_ns"]

        _with_mem_tracer(body)

    def test_disabled_span_is_the_shared_null_span(self):
        t = get_tracer()
        assert not t.enabled
        sp = span("off", x=1)
        assert sp is recorder._NULL_SPAN
        assert span("other") is sp
        with sp as inner:
            assert inner is sp
            inner.add(y=2)
            inner.fence(object())
        t.enable(None)
        try:
            events = t.events()
        finally:
            t.disable()
        assert events == []

    def test_a_round_enters_a_record_while_a_profiler_records(
            self, tmp_path):
        import json

        from torch.profiler import ProfilerActivity, profile

        def body(t):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with span("probe-round", round=None) as sp:
                    with span("probe-child"):
                        pass
                    sp.add(round=3)
            with span("probe-after", round=4):
                pass
            path = tmp_path / "trace.json"
            prof.export_chrome_trace(str(path))
            names = [e.get("name") for e in
                     json.loads(path.read_text())["traceEvents"]]
            assert names.count("probe-round") == 1
            assert "probe-child" not in names and "probe-after" not in names
            assert [e["event"] for e in t.events()] == [
                "probe-child", "probe-round", "probe-after"]

        _with_mem_tracer(body)

    @pytest.mark.parametrize("model", ["hashmap", "vspace"])
    def test_a_fused_round_gives_its_span_tree(self, model):
        if model == "hashmap":
            nr = NodeReplicated(make_hashmap(64), 4, log_entries=1024,
                                engine="pallas", device="cpu")
            ops = [(HM_PUT, k, 100 + k) for k in range(16)]
        else:
            nr = NodeReplicated(make_vspace(4096, max_span=64), 4,
                                log_entries=1024, engine="pallas",
                                device="cpu")
            ops = [(1, 64 * k, 7 + k, 1 + k) for k in range(16)]
        reg = get_registry()
        was = reg.enabled
        reads = reg.counter("nr.d2h.reads")

        def body(t):
            reg.enable()
            try:
                before = reads.value
                resps = nr.execute_mut_batch(ops, 1)
                n_reads = reads.value - before
            finally:
                reg.enabled = was
            assert len(resps) == len(ops)
            spans = [e for e in t.events() if "id" in e]
            root = spans[-1]
            assert root["event"] == "mut-batch" and root["parent"] is None
            assert root["round"] == 0 and root["n"] == len(ops)
            kids = [e for e in spans if e is not root]
            names = sorted(e["event"] for e in kids)
            assert names == sorted(["encode", "fused-round", "deliver"]
                                   + ["d2h"] * 4)
            for e in kids:
                assert e["parent"] == root["id"] and e["round"] == 0
                assert root["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] \
                    <= root["t1_ns"]
            assert n_reads == sum(e["event"] == "d2h" for e in kids)

        _with_mem_tracer(body)


class TestAttributeIdle:
    #: a chrome trace: the window mark over [1000, 1100] us and device
    #: work that leaves it idle over [1010, 1030], [1040, 1080] and
    #: [1085, 1095]
    EVENTS = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1041.0,
         "dur": 2.0},
    ] + [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}
        for a, b in ((1000.0, 1010.0), (1030.0, 1040.0), (1080.0, 1085.0),
                     (1095.0, 1100.0))
    ]
    #: the host's clock read 5 ms as the mark opened, 2 us late at its
    #: close: trace us = (ns + OFFSET) / 1000
    STAMPS = (5_000_000, 5_102_000)
    OFFSET = 1_000_000 - 5_000_000

    def _span(self, name, a_us, b_us, sid, parent=None):
        return {"event": name, "id": sid, "parent": parent,
                "t0_ns": int(a_us * 1000 - self.OFFSET),
                "t1_ns": int(b_us * 1000 - self.OFFSET)}

    def test_clock_and_alignment_by_round_records(self):
        clk = clock(self.EVENTS, self.STAMPS)
        assert clk["offset_ns"] == pytest.approx(self.OFFSET)
        assert clk["residual_ns"] == pytest.approx(-2_000)
        # two rounds, each on a host clock of its own offset, and their
        # mut-batch records in the trace at [1005, 1035], [1038, 1070]
        events = self.EVENTS + [
            {"ph": "X", "cat": "cpu_op", "name": "mut-batch", "ts": a,
             "dur": b - a} for a, b in ((1005.0, 1035.0), (1038.0, 1070.0))]
        spans = [
            {"event": "d2h", "round": 0, "t0_ns": 7_002_000,
             "t1_ns": 7_004_000},
            {"event": "mut-batch", "round": 0, "t0_ns": 7_000_000,
             "t1_ns": 7_030_000},
            {"event": "d2h", "round": 7, "t0_ns": 9_002_000,
             "t1_ns": 9_006_000},
            {"event": "mut-batch", "round": 7, "t0_ns": 9_000_000,
             "t1_ns": 9_032_000},
            {"event": "mut-batch", "round": 9, "t0_ns": 9_500_000,
             "t1_ns": 9_510_000},
        ]
        got, paired, worst = align(events, spans)
        assert paired == 2 and worst == pytest.approx(0.0)
        assert [(e["event"], e["t0_ns"], e["t1_ns"]) for e in got] == [
            ("d2h", 1_007_000, 1_009_000),
            ("mut-batch", 1_005_000, 1_035_000),
            ("d2h", 1_040_000, 1_044_000),
            ("mut-batch", 1_038_000, 1_070_000)]
        # the copy at [1041, 1043] us inside round 7's d2h, then not
        assert misfit(events, got, op="aten::copy_") == [0.0]
        late = [dict(e, t0_ns=1_042_000) if e["t0_ns"] == 1_040_000
                else e for e in got]
        assert misfit(events, late, op="aten::copy_") == \
            pytest.approx([1.0])

    def test_idle_by_span_and_unspanned_share(self):
        spans = [
            self._span("mut-batch", 1005, 1035, 1),
            self._span("encode", 1012, 1028, 2, 1),
            self._span("mut-batch", 1050, 1070, 3),
            self._span("d2h", 1055, 1065, 4, 3),
        ]
        got = attribute_idle(self.EVENTS, spans, self.OFFSET)
        assert got["idle_s"] == pytest.approx(70e-6)
        assert got["by_span"] == pytest.approx(
            {"encode": 20e-6, "d2h": 40e-6, "(none)": 10e-6})
        # [1040, 1050] and [1070, 1080] of the second gap and all the
        # third lie outside every mut-batch
        assert got["unspanned_s"] == pytest.approx(30e-6)
        assert got["idle_unspanned_pct"] == pytest.approx(300 / 7)
