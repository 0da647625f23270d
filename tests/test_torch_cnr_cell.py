"""The benchmark's CNR cell (`cnr-hashmap-l8`) on the CPU at a small
size: whole runs through `portbench.harness.run_cell`, sound and with
the timed path broken; the plain reference against a loop over each
log's ops; the batch's span tree and its reads of device memory
(`core/cnr.py:MultiLogReplicated.execute_mut_batch`); and each log's
tail and cursors after a run."""

import json

import numpy as np
import pytest
import torch

from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.models import HM_PUT, HM_REMOVE, make_hashmap
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.trace import get_tracer
from portbench import control, harness, reference
from portbench.drivers import rounds
from portbench.models import cnr_hashmap
from portbench.test_portbench import _broken

CELL = "cnr-hashmap-l8"
SEEDS = [1, 2**31 + 77]
KEYS, REPLICAS, LOGS, RING = 64, 4, 8, 1024
#: the cell at a size the CPU holds: the same traffic and log count
SMALL = {"config": {"n_keys": KEYS, "n_replicas": REPLICAS,
                    "log_entries": RING},
         "traffic": {"window": 16, "warmup_rounds": 2}}


def _counters(*names):
    reg = get_registry()
    return {n: reg.counter(n).value for n in names}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_runs_correct_on_the_cpu(seed, trace):
    r = harness.run_cell(CELL, seed, 1.0, trace, device="cpu",
                         overrides=SMALL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = harness.load_bench()
    want = {m["name"] for m in harness.cell_metrics(bench, CELL, trace)}
    got = r["metrics"]
    if not trace:
        assert set(got) == want == {"replay_ops_s", "setup_s"}
        return
    # the device metrics read nothing without a card
    assert set(got) == {"round_d2h_reads", "cnr_log_rounds"} < want
    per_batch = got["cnr_log_rounds"]["value"]
    assert 1 <= per_batch <= LOGS
    assert got["round_d2h_reads"]["value"] == pytest.approx(4 * per_batch)
    # the window's counters, reset as it opened: every per-log round
    # took the fused tier
    c = _counters("cnr.combine.rounds", "cnr.exec.engine.pallas_fused",
                  "cnr.exec.engine.fused_fallback",
                  "cnr.exec.engine.fused_fallback.inflight")
    assert c["cnr.exec.engine.fused_fallback"] == 0
    assert c["cnr.exec.engine.fused_fallback.inflight"] == 0
    assert c["cnr.exec.engine.pallas_fused"] == c["cnr.combine.rounds"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_a_loop_over_each_logs_ops(seed):
    """The reference replays the stream in submission order; CNR replays
    each log's ops in order, one log after another. The `LogMapper`
    keeps a cell's ops in one log, so the two agree."""
    _, _, cfg, spec = harness.load_cell(CELL, overrides=SMALL)
    model = harness.load_model(cfg)
    planes = harness.initial_planes(model, seed, "cpu")
    ops = control.control_ops(model, spec, seed, 24)
    opc, args, write = (np.concatenate([o[i] for o in ops])
                        for i in range(3))
    logs = np.array([model.log_of(int(o), tuple(a))
                     for o, a in zip(opc, args)])
    assert set(logs.tolist()) == set(range(LOGS))
    loop = {k: v.numpy().copy() for k, v in planes.items()}
    want = np.zeros(len(opc), np.int64)
    for h in range(LOGS):
        for i in np.flatnonzero(logs == h):
            want[i] = model.step(loop, int(opc[i]), args[i], bool(write[i]))
    ref = {k: v.clone() for k, v in planes.items()}
    got = reference.replay(model, ref, torch.from_numpy(opc),
                           torch.from_numpy(args), torch.from_numpy(write),
                           chunk=40)
    assert np.array_equal(got.numpy(), want)
    for k in loop:
        assert np.array_equal(ref[k].numpy(), loop[k])


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    from node_replication_torch.ops.replay import FusedHashmapEngine

    monkeypatch.setattr(FusedHashmapEngine, "round_fn",
                        _broken(kind)(FusedHashmapEngine.round_fn))
    r = harness.run_cell(CELL, SEEDS[1], 1.0, False, device="cpu",
                         overrides=SMALL)
    assert not r["correct"], r["checks"]


def _fleet():
    model = cnr_hashmap.Model({"n_keys": KEYS, "n_replicas": REPLICAS,
                               "n_logs": LOGS, "log_entries": RING,
                               "engine": "pallas"})
    planes = {"val": torch.arange(KEYS, dtype=torch.int32),
              "pres": torch.ones(KEYS, dtype=torch.bool)}
    return model.build(planes, "cpu")


#: batches of ops by key: over every log, and over logs 1 and 3 alone
BATCHES = {
    "all-logs": [[(HM_PUT, k, 100 + k) for k in range(24)],
                 [(HM_REMOVE, k) for k in range(0, 48, 3)]],
    "two-logs": [[(HM_PUT, k, 7) for k in (1, 3, 9, 11, 17)],
                 [(HM_REMOVE, k) for k in (3, 11, 25)]],
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_a_batch_gives_its_span_tree(case):
    """One `mut-batch` a batch, its `round` the sum of the logs' tails
    before it (so no other batch has it), and under it, for each log the
    batch maps to, one `encode`, `fused-round` and `deliver` of that log
    and the round's four `d2h` reads, each counted."""
    nr = _fleet()
    reg = get_registry()
    was = reg.enabled
    t = get_tracer()
    t.enable(None)
    reg.enable()
    try:
        for ops in BATCHES[case]:
            tails = int(nr.ml.tail.sum())
            before = _counters("nr.d2h.reads", "cnr.combine.rounds")
            seq = len(t.events())
            nr.execute_mut_batch(ops, 2)
            after = _counters("nr.d2h.reads", "cnr.combine.rounds")
            spans = [e for e in t.events()[seq:] if "id" in e]
            mapped = {k % KEYS % LOGS for _, k, *_ in ops}
            root = spans[-1]
            assert root["event"] == "mut-batch" and root["parent"] is None
            assert root["round"] == tails and root["n"] == len(ops)
            kids = spans[:-1]
            # a per-log round reads its answers inside `fused-round`
            launches = {e["id"] for e in kids if e["event"] == "fused-round"}
            for e in kids:
                assert e["round"] == tails
                assert e["parent"] == root["id"] or (
                    e["event"] == "d2h" and e["parent"] in launches)
                assert root["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] \
                    <= root["t1_ns"]
            for name in ("encode", "fused-round", "deliver"):
                logs = [e["log"] for e in kids if e["event"] == name]
                assert sorted(logs) == sorted(mapped), name
            reads = after["nr.d2h.reads"] - before["nr.d2h.reads"]
            assert reads == sum(e["event"] == "d2h" for e in kids) \
                == 4 * len(mapped)
            assert len(kids) == 7 * len(mapped)
            assert after["cnr.combine.rounds"] \
                - before["cnr.combine.rounds"] == len(mapped)
        seen = [e["round"] for e in t.events()
                if e.get("event") == "mut-batch"]
        assert len(seen) == len(BATCHES[case]) == len(set(seen))
    finally:
        t.disable()
        reg.enabled = was


@pytest.mark.parametrize("nlogs", [1, 2, 8])
def test_a_fused_per_log_round_reads_the_card_four_times(nlogs):
    nr = MultiLogReplicated(make_hashmap(KEYS), lambda o, a: a[0],
                            nlogs=nlogs, n_replicas=REPLICAS,
                            log_entries=RING, engine="pallas", device="cpu")
    reg = get_registry()
    was = reg.enabled
    reg.enable()
    names = ("nr.d2h.reads", "cnr.combine.rounds",
             "cnr.exec.engine.pallas_fused", "cnr.exec.engine.fused_fallback")
    try:
        before = _counters(*names)
        for b in range(3):
            nr.execute_mut_batch([(HM_PUT, k, b) for k in range(32)], b)
        d = {n: v - before[n] for n, v in _counters(*names).items()}
    finally:
        reg.enabled = was
    assert d["cnr.combine.rounds"] == 3 * nlogs
    assert d["cnr.exec.engine.pallas_fused"] == 3 * nlogs
    assert d["cnr.exec.engine.fused_fallback"] == 0
    assert d["nr.d2h.reads"] == 4 * 3 * nlogs


@pytest.mark.parametrize("owing", [1, 2, 3])
def test_each_round_refused_for_owed_responses_is_counted(owing):
    """Replica 0 begins a batch of 130 ops on log 0, more than the
    largest fused window of a 256-slot ring (128): that round takes the
    chain and, unfinished, leaves replica 0 owed responses on log 0.
    Then `owing` other replicas each begin a batch of two ops on log 0:
    each round is refused the fused tier for the responses owed there
    and counted once in `cnr.exec.engine.fused_fallback.inflight`. Once
    every batch is finished nothing is owed, and the next rounds, on
    logs 0 and 1, are fused. The answers are a scan fleet's."""
    names = ("cnr.combine.rounds", "cnr.exec.engine.pallas_fused",
             "cnr.exec.engine.fused_fallback",
             "cnr.exec.engine.fused_fallback.inflight")

    def run(engine):
        nr = MultiLogReplicated(make_hashmap(KEYS), lambda o, a: a[0],
                                nlogs=2, n_replicas=REPLICAS,
                                log_entries=256, gc_slack=32, exec_window=16,
                                engine=engine, device="cpu")
        pend = [nr.begin_mut_batch(
            [(HM_PUT, 2 * (i % 8), i) for i in range(130)], 0)]
        assert list(nr._inflight[0]) == [0] and nr._inflight[1] == {}
        for r in range(1, owing + 1):
            pend.append(nr.begin_mut_batch(
                [(HM_PUT, 2 * r, r), (HM_REMOVE, 2 * r + 2)], r))
        owed = [sorted(o) for o in nr._inflight]
        after_begin = _counters(*names)
        out = [nr.finish_mut_batch(p) for p in pend]
        assert nr._inflight == [{}, {}]
        out.append(nr.execute_mut_batch([(HM_PUT, 4, 9), (HM_PUT, 5, 9)], 0))
        return nr, owed, after_begin, out

    reg = get_registry()
    was = reg.enabled
    reg.enable()
    try:
        before = _counters(*names)
        nr, owed, after_begin, out = run("pallas")
        end = _counters(*names)
    finally:
        reg.enabled = was
    assert owed == [list(range(owing + 1)), []]
    d = {n: after_begin[n] - before[n] for n in names}
    assert d["cnr.exec.engine.fused_fallback.inflight"] == owing
    assert d["cnr.exec.engine.fused_fallback"] == 1 + owing
    assert d["cnr.exec.engine.pallas_fused"] == 0
    assert d["cnr.combine.rounds"] == 1 + owing
    # finishing is no round; the last batch's two rounds are fused
    d = {n: end[n] - after_begin[n] for n in names}
    assert d["cnr.exec.engine.fused_fallback"] == 0
    assert d["cnr.exec.engine.pallas_fused"] == d["cnr.combine.rounds"] == 2
    scan, _, _, want = run("scan")
    assert out == want
    nr.sync()
    scan.sync()
    for f in ("values", "present"):
        assert torch.equal(nr.states[f], scan.states[f])


def test_each_log_ends_at_its_ops_and_every_cursor_at_its_tail(monkeypatch):
    """After a run, each log's tail is the number of the run's ops,
    warm-up included, whose key maps to it; after `sync()` every
    replica's cursor on every log is at that log's tail."""
    seen = {}
    state = cnr_hashmap.Model.fleet_state
    drive = rounds.run

    def fleet_state(nr):
        out = state(nr)
        seen["tail"] = nr.ml.tail.clone()
        seen["ltails"] = nr.ml.ltails.clone()
        return out

    def run(r):
        seen["outcome"] = drive(r)
        seen["model"] = r.model
        return seen["outcome"]

    monkeypatch.setattr(cnr_hashmap.Model, "fleet_state",
                        staticmethod(fleet_state))
    monkeypatch.setattr(rounds, "run", run)
    r = harness.run_cell(CELL, SEEDS[0], 0.5, False, device="cpu",
                         overrides=SMALL)
    assert r["correct"], json.dumps(r["checks"])
    model = seen["model"]
    per_log = np.zeros(LOGS, np.int64)
    for opc, args, _ in seen["outcome"]["ops"]:
        for o, a in zip(opc, args):
            per_log[model.log_of(int(o), tuple(a))] += 1
    assert seen["tail"].tolist() == per_log.tolist()
    assert (seen["ltails"] == seen["tail"][:, None]).all()
