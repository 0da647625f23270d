"""The port's tracer wiring: twins of `tests/test_trace.py` (all but
`TestHarnessMeasureEvents`, which waits for the port's `harness/`) on
`device="cpu"` fleets — watchdogs emit (and re-emit) events, the
combine path emits spans, file mode writes JSONL."""

from node_replication_torch.core.log import WARN_ROUNDS
from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.utils.trace import get_tracer


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
