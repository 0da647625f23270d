"""The span readers and `spans.py`'s traced run on the CPU at small sizes:
the program's round spans reach `run.spans`, every round's metrics read
from them, and a run without spans (the harness's own) reads nothing.

    python -m pytest portbench -q
"""

from __future__ import annotations

import pytest

from portbench import harness, spans
from portbench.test_portbench import SEED, SMALL

ROUND_CELLS = ("hashmap-rounds", "vspace-rounds")


@pytest.mark.parametrize("cell", ROUND_CELLS)
def test_a_traced_run_with_spans_reads_each_round(cell):
    result, run = spans.traced_run(cell, SEED, 1.0, device="cpu",
                                   overrides=SMALL[cell])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    m = result["metrics"]
    rounds = spans.rounds_of(run.spans)
    assert len(rounds) == run.outcome["rounds"]
    # the log's free space and tail, the cursor check, the responses
    assert m["round_d2h_reads"]["value"] == 4.0
    for name in ("round_encode_ms", "round_d2h_wait_ms",
                 "round_deliver_ms", "round_launch_ms"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    # no device trace on the CPU: nothing to map idle time onto, and no
    # CUDA event around the copies
    assert "idle_unspanned_pct" not in m
    assert "round_copies_device_ms" not in m
    launch = sum(e["t1_ns"] - e["t0_ns"] for e in run.spans
                 if e["event"] == "fused-round")
    assert m["round_launch_ms"]["value"] == pytest.approx(
        launch / len(rounds) * 1e-6)


def test_a_run_without_spans_reads_no_span_metric():
    r = harness.run_cell("hashmap-rounds", SEED, 1.0, True, device="cpu",
                         overrides=SMALL["hashmap-rounds"])
    assert r["correct"]
    assert r["metrics"]["round_d2h_reads"]["value"] == 4.0
    run = type("R", (), {})()
    for name in spans.SPAN_METRICS:
        assert harness.load_reader(name)(run) is None


def test_self_time_leaves_out_the_children():
    root = {"event": "fused-round", "id": 1, "t0_ns": 0, "t1_ns": 100}
    kids = [{"event": "d2h", "id": 2, "parent": 1, "t0_ns": 10,
             "t1_ns": 40},
            {"event": "d2h", "id": 3, "parent": 1, "t0_ns": 50,
             "t1_ns": 60},
            {"event": "d2h", "id": 4, "parent": 2, "t0_ns": 20,
             "t1_ns": 30}]
    assert spans.self_ns(root, [root] + kids) == 60
