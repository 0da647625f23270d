"""The port's simulation plane (`node_replication_torch/sim/`,
`utils/clock.py:SimClock`) against the reference's.

- Twins of `tests/test_sim.py`'s 45 tests (the injectable clock, the
  seeded scheduler, the oracles, every flavor on clean code, overload
  bursts, the canaries, the sharded, pipelined, txn and reshard cases),
  on `device="cpu"` fleets; the shrink of `reclaim-ignores-pins` stays
  slow-marked, as in the reference.
- Differential cases (integer data, tolerance 0): `generate_case` gives
  equal specs for seeds 0-299 under every filter; scheduler traces and
  the oracles' arrays are equal for the same seed and op stream; each
  oracle names the port model's state leaves with their shapes and
  dtypes; `run_case` gives equal digests and event lists in both
  packages on seeds that cover every flavor x wrapper the generator
  gives; a failing-seed artifact written by either package's `explore`
  replays in the other's `replay --spec` with the same digest; a port
  canary leaves the reference's class untouched, and the reverse; and
  with the fused tier's calibration armed (the CPU hook) the port's
  digests do not change.
"""

import json
import threading
import time

import numpy as np
import pytest

from node_replication_tpu.sim import canary as j_canary
from node_replication_tpu.sim import explore as j_explore
from node_replication_tpu.sim import replay as j_replay
from node_replication_tpu.sim.oracle import make_oracle as j_make_oracle
from node_replication_tpu.sim.properties import generate_case as j_generate
from node_replication_tpu.sim.properties import run_case as j_run_case
from node_replication_tpu.sim.scheduler import SimScheduler as JSimScheduler

from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    make_hashmap,
    make_queue,
    make_seqreg,
    make_stack,
)
from node_replication_torch.sim import canary
from node_replication_torch.sim import explore
from node_replication_torch.sim import replay
from node_replication_torch.sim.oracle import make_oracle
from node_replication_torch.sim.properties import (
    FLAVORS,
    MODEL_SIZES,
    MODELS,
    CaseSpec,
    generate_case,
    run_case,
)
from node_replication_torch.sim.scheduler import SimScheduler
from node_replication_torch.sim.shrink import shrink_case
from node_replication_torch.utils.clock import (
    RealClock,
    SimClock,
    get_clock,
    installed,
    set_clock,
)

CPU = "cpu"


def run(spec):
    return run_case(spec, device=CPU)


class TestClock:
    def test_default_is_real_clock(self):
        assert isinstance(get_clock(), RealClock)

    def test_real_clock_contract(self):
        c = RealClock()
        t0 = c.now()
        assert c.now() >= t0
        cond = threading.Condition()
        with cond:
            t1 = time.monotonic()
            assert c.wait(cond, 0.01) is False  # timeout, no notify
            assert time.monotonic() - t1 < 1.0

    def test_installed_restores(self):
        prev = get_clock()
        sim = SimClock()
        with installed(sim):
            assert get_clock() is sim
        assert get_clock() is prev

    def test_sim_sleep_auto_advances_instantly(self):
        sim = SimClock()
        t0 = time.monotonic()
        sim.sleep(3600.0)
        assert sim.now() == 3600.0
        assert time.monotonic() - t0 < 1.0

    def test_sim_sleep_blocks_until_advanced(self):
        sim = SimClock(auto_advance=False)
        woke = threading.Event()

        def sleeper():
            sim.sleep(5.0)
            woke.set()

        t = threading.Thread(target=sleeper, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not woke.is_set()
        sim.advance(5.0)
        assert woke.wait(5.0)
        t.join(5.0)

    def test_sim_timed_cond_wait_expires_on_advance(self):
        sim = SimClock(auto_advance=False)
        cond = threading.Condition()
        out = {}

        def waiter():
            with cond:
                out["r"] = sim.wait(cond, 5.0)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        for _ in range(200):
            if sim.waiters():
                break
            time.sleep(0.005)
        assert sim.waiters() == [5.0]
        sim.advance(10.0)
        t.join(5.0)
        assert not t.is_alive()
        assert out["r"] is False  # woke because virtual time expired

    def test_sim_timed_cond_wait_honors_real_notify(self):
        sim = SimClock(auto_advance=False)
        cond = threading.Condition()
        out = {}

        def waiter():
            with cond:
                out["r"] = sim.wait(cond, 5.0)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        for _ in range(200):
            if sim.waiters():
                break
            time.sleep(0.005)
        with cond:
            cond.notify_all()
        t.join(5.0)
        assert not t.is_alive()
        assert out["r"] is True  # not expired: a real notification

    def test_set_clock_returns_previous(self):
        sim = SimClock()
        prev = set_clock(sim)
        try:
            assert get_clock() is sim
        finally:
            assert set_clock(prev) is sim


class TestScheduler:
    def test_same_seed_same_schedule(self):
        def build(seed):
            s = SimScheduler(seed)
            log = []
            for name in ("a", "b", "c"):
                s.add(name, lambda n=name: log.append(n) or True,
                      weight={"a": 3.0, "b": 1.0, "c": 1.0}[name])
            s.run(50)
            return log

        assert build(7) == build(7)
        assert build(7) != build(8)

    def test_disable_removes_from_schedule(self):
        s = SimScheduler(1)
        s.add("a", lambda: True)
        s.add("b", lambda: True)
        s.disable("a")
        for _ in range(10):
            name, _ = s.step()
            assert name == "b"

    def test_idle_limit_stops(self):
        s = SimScheduler(1)
        s.add("idle", lambda: False)
        assert s.run(100, idle_limit=3) == 3


class TestOracle:
    def test_hashmap_semantics(self):
        o = make_oracle("hashmap", 8)
        assert o.apply((1, 3, 42)) == 0        # put
        assert o.read((1, 3)) == 42            # get
        assert o.apply((2, 3, 0)) == 1         # remove present
        assert o.apply((2, 3, 0)) == 0         # remove absent
        assert o.read((1, 3)) == -1
        assert o.apply((1, 11, 9)) == 0        # k % 8 == 3
        assert o.read((1, 3)) == 9

    def test_stack_overflow_and_pop_empty(self):
        o = make_oracle("stack", 2)
        assert o.apply((1, 10, 0)) == 1
        assert o.apply((1, 11, 0)) == 2
        assert o.apply((1, 12, 0)) == -1       # full
        assert o.apply((2, 0, 0)) == 11
        assert o.apply((2, 0, 0)) == 10
        assert o.apply((2, 0, 0)) == -1        # empty
        assert o.read((2, 0)) == 0             # len

    def test_queue_fifo_and_wrap(self):
        o = make_oracle("queue", 2)
        assert o.apply((1, 5, 0)) == 1
        assert o.apply((1, 6, 0)) == 2
        assert o.apply((1, 7, 0)) == -1        # full
        assert o.apply((2, 0, 0)) == 5
        assert o.apply((1, 7, 0)) == 2         # ring wraps
        assert o.read((1, 0)) == 6             # front
        assert o.read((2, 0)) == 2             # len

    def test_seqreg_fetch_and_set(self):
        o = make_oracle("seqreg", 4)
        assert o.apply((1, 2, 7)) == 0
        assert o.apply((1, 2, 9)) == 7
        assert o.read((1, 2)) == 9

    def test_copy_is_independent(self):
        o = make_oracle("hashmap", 4)
        o.apply((1, 1, 5))
        c = o.copy()
        c.apply((1, 1, 6))
        assert o.read((1, 1)) == 5 and c.read((1, 1)) == 6


def _find_spec(predicate, max_seed=80, **kw):
    for seed in range(max_seed):
        spec = generate_case(seed, **kw)
        if predicate(spec):
            return spec
    raise AssertionError("no matching spec in seed range")


class TestProperties:
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_every_flavor_holds_on_clean_code(self, flavor):
        for seed in range(2):
            spec = generate_case(seed, flavors=(flavor,))
            res = run(spec)
            assert res.ok, [v.as_dict() for v in res.violations]

    def test_cnr_multilog_runs_the_same_fault_plans(self):
        # a MultiLogReplicated case whose schedule injects write faults
        # holds every property, in the wrapper and the serve flavor
        for flavor in ("wrapper", "serve"):
            spec = _find_spec(
                lambda s: s.wrapper == "cnr"
                and any(st[0] == "wf" for st in s.steps),
                wrappers=("cnr",), flavors=(flavor,),
            )
            assert spec.wrapper == "cnr"
            res = run(spec)
            assert res.ok, [v.as_dict() for v in res.violations]

    def test_corruption_is_detected_and_repaired(self):
        spec = _find_spec(
            lambda s: any(st[0] == "corrupt" for st in s.steps),
            flavors=("wrapper",), wrappers=("nr",),
        )
        assert spec.n_replicas == 3  # quorum for the digest vote
        res = run(spec)
        # divergence-detect would fire had the vote missed it; every
        # other property would fire had the repair been wrong
        assert res.ok, [v.as_dict() for v in res.violations]

    def test_replay_is_byte_identical(self):
        spec1 = generate_case(0)
        spec2 = generate_case(0)
        assert spec1 == spec2
        r1, r2 = run(spec1), run(spec2)
        assert r1.digest == r2.digest
        assert r1.events == r2.events

    def test_spec_roundtrips_through_json(self):
        spec = generate_case(5)
        assert CaseSpec.from_dict(spec.as_dict()) == spec


class TestOverloadBursts:
    def test_generated_burst_case_clean_and_deterministic(self):
        # a generated serve/NR case with burst steps holds shed-honesty,
        # priority-inversion and resp-diff, and replays byte-identically
        spec = _find_spec(
            lambda s: any(st[0] == "burst" for st in s.steps),
            flavors=("serve",), wrappers=("nr",),
        )
        r1 = run(spec)
        assert r1.ok, [v.as_dict() for v in r1.violations]
        r2 = run(spec)
        assert r1.digest == r2.digest
        evs = [e for e in r1.events if e[1] == "burst"]
        assert evs

    def test_crafted_burst_sheds_bulk_completes_critical(self):
        # 6 BULK fill the burst frontend's depth-6 queue, then 6
        # CRITICAL arrivals evict them one by one: every CRITICAL
        # completes, every BULK rejects, the log holds exactly the
        # completed set, and no priority inversion
        burst = (
            [[2, [1, k, 100 + k]] for k in range(6)]
            + [[0, [1, k, 200 + k]] for k in range(6)]
        )
        spec = CaseSpec(
            seed=0, model="hashmap", wrapper="nr", flavor="serve",
            n_replicas=2, nlogs=1, steps=[["burst", burst], ["sync"]],
        )
        res = run(spec)
        assert res.ok, [v.as_dict() for v in res.violations]
        ev = [e for e in res.events if e[1] == "burst"][0]
        outcomes = [o[1] for o in ev[2]["outcomes"]]
        assert outcomes[:6] == ["evicted"] * 6
        assert outcomes[6:] == ["completed"] * 6
        assert ev[2]["applied"] == 6
        assert ev[2]["evicted"] == 6

    def test_non_serve_flavors_unchanged_by_burst_generation(self):
        for flavor in ("wrapper", "crash", "repl"):
            for seed in range(4):
                spec = generate_case(seed, flavors=(flavor,))
                assert not any(st[0] == "burst" for st in spec.steps)


class TestCanaries:
    def test_reclaim_ignores_pins_is_caught(self):
        # a repl schedule with a lagging shipper across a snapshot+sync
        # observes a feed gap, and the failing seed replays
        # byte-identically
        with canary.armed("reclaim-ignores-pins"):
            spec = generate_case(1, flavors=("repl",))
            res = run(spec)
            assert any(v.prop == "replication-gap"
                       for v in res.violations), (
                "canary survived", [v.as_dict()
                                    for v in res.violations])
            replay_res = run(generate_case(1, flavors=("repl",)))
            assert replay_res.digest == res.digest

    @pytest.mark.slow
    def test_reclaim_ignores_pins_shrinks(self):
        with canary.armed("reclaim-ignores-pins"):
            spec = generate_case(1, flavors=("repl",))
            rep = shrink_case(spec, max_runs=80, device=CPU)
            assert rep.shrunk_steps < rep.original_steps
            assert any(v.prop == "replication-gap"
                       for v in rep.result.violations)

    def test_ack_before_fsync_is_caught(self):
        with canary.armed("ack-before-fsync"):
            spec = generate_case(3, flavors=("crash",))
            res = run(spec)
            assert any(v.prop == "durable-ack-survival"
                       for v in res.violations)

    def test_clean_run_after_canary_disarms(self):
        spec = generate_case(3, flavors=("crash",))
        assert run(spec).ok

    def test_unknown_canary_raises(self):
        with pytest.raises(ValueError):
            canary.armed("no-such-bug")


class TestShardedFlavor:
    def test_generated_sharded_case_clean_and_deterministic(self):
        spec = _find_spec(
            lambda s: any(st[0] == "skill" for st in s.steps)
            and any(st[0] == "spromote" for st in s.steps),
            flavors=("sharded",),
        )
        assert spec.flavor == "sharded" and spec.n_shards == 2
        r1 = run(spec)
        assert r1.ok, [v.as_dict() for v in r1.violations]
        r2 = run(spec)
        assert r1.digest == r2.digest

    def test_crafted_failover_isolates_survivor(self):
        steps = [
            ["sw", [1, 0, 11]],                      # shard 0
            ["sw", [1, 1, 12]],                      # shard 1
            ["sbatch", [[1, 2, 13], [1, 3, 14], [1, 4, 15]]],
            ["swal", 0],                             # durable, UNshipped
            ["swal", 1], ["sship", 1],
            ["skill", 0],
            ["sw", [1, 2, 21]],                      # victim-keyed
            ["sw", [1, 3, 22]],                      # survivor-keyed
            ["sread", [1, 3, 0]],
            ["spromote", 0],
            ["szombie", 0],
            ["sw", [1, 2, 23]],
            ["sread", [1, 2, 0]],
        ]
        spec = CaseSpec(
            seed=0, model="hashmap", wrapper="nr", flavor="sharded",
            n_replicas=1, nlogs=1, steps=steps, n_shards=2,
        )
        res = run(spec)
        assert res.ok, [v.as_dict() for v in res.violations]
        by_step = {e[0]: e for e in res.events}
        assert by_step[2][1] == "sbatch"
        assert [r[:2] for r in by_step[2][2]["results"]] == [
            [0, "ok"], [1, "ok"], [0, "ok"]]
        assert by_step[6][1] == "skill"
        assert by_step[6][2]["durable"] == 3
        assert by_step[6][2]["acked"] == 0
        assert by_step[7][1] == "sw-err"
        assert by_step[7][2] == {"shard": 0,
                                 "err": "ShardUnavailable"}
        assert by_step[8][1] == "sw" and by_step[8][2]["shard"] == 1
        assert by_step[9][1] == "sread"
        assert by_step[10][1] == "spromote"
        assert by_step[10][2]["shard"] == 0
        assert by_step[10][2]["applied"] == 0
        assert by_step[10][2]["map_version"] == 2
        assert by_step[11][1] == "sship-fenced"
        assert by_step[12][1] == "sw" and by_step[12][2]["shard"] == 0
        assert by_step[13][1] == "sread"
        assert by_step[13][2] == {"shard": 0, "val": 23}

    def test_non_sharded_flavors_unchanged_by_sharded_generation(self):
        legacy = tuple(f for f in FLAVORS if f != "sharded")
        for seed in range(40):
            new = generate_case(seed)
            old = generate_case(seed, flavors=legacy)
            if new.flavor == "sharded":
                assert old.flavor == "serve" and old.wrapper == "nr"
            else:
                assert new == old
        sharded_kinds = {"sw", "sbatch", "sread", "swal", "sship",
                         "sapply", "skill", "spromote", "szombie"}
        for flavor in legacy:
            for seed in range(4):
                spec = generate_case(seed, flavors=(flavor,))
                assert not any(st[0] in sharded_kinds
                               for st in spec.steps)

    def test_n_shards_field_optional_in_artifacts(self):
        spec = generate_case(0)
        d = spec.as_dict()
        d.pop("n_shards")
        loaded = CaseSpec.from_dict(d)
        assert loaded.n_shards == 0
        sharded = generate_case(0, flavors=("sharded",))
        assert CaseSpec.from_dict(sharded.as_dict()) == sharded


class TestPipelineOverlapKnob:
    def test_overlap_drawn_for_serve_flavor_only(self):
        seen = {0: 0, 1: 0}
        for seed in range(120):
            spec = generate_case(seed)
            if spec.flavor == "serve":
                seen[spec.overlap] += 1
            else:
                assert spec.overlap == 0
        assert seen[0] > 0 and seen[1] > 0

    def test_pipelined_serve_case_clean_and_deterministic(self):
        spec = _find_spec(
            lambda s: s.overlap == 1, flavors=("serve",),
        )
        assert spec.overlap == 1
        r1 = run(spec)
        assert r1.ok, [v.as_dict() for v in r1.violations]
        r2 = run(spec)
        assert r1.digest == r2.digest

    def test_overlap_field_optional_in_artifacts(self):
        spec = generate_case(3)
        d = spec.as_dict()
        d.pop("overlap")
        loaded = CaseSpec.from_dict(d)
        assert loaded.overlap == 0


class TestTxnAndReshardSteps:
    def test_generated_txn_case_clean_and_deterministic(self):
        spec = _find_spec(
            lambda s: any(st[0] == "stxn" and st[2]
                          for st in s.steps),
            flavors=("sharded",),
        )
        r1 = run(spec)
        assert r1.ok, [v.as_dict() for v in r1.violations]
        kinds = {e[1] for e in r1.events}
        assert kinds & {"stxn", "stxn-recovered", "stxn-abort"}
        r2 = run(spec)
        assert r1.digest == r2.digest

    def test_generated_reshard_case_clean_and_deterministic(self):
        spec = _find_spec(
            lambda s: any(st[0] == "sreshard" for st in s.steps),
            flavors=("sharded",),
        )
        r1 = run(spec)
        assert r1.ok, [v.as_dict() for v in r1.violations]
        assert any(e[1] == "sreshard" for e in r1.events)
        r2 = run(spec)
        assert r1.digest == r2.digest

    def test_crafted_txn_across_split_topology(self):
        steps = [
            ["sw", [1, 0, 11]],
            ["sw", [1, 2, 12]],                       # moved class
            ["sw", [1, 1, 13]],
            ["stxn", [[1, 4, 21], [1, 5, 22]], 0],    # cross-shard
            ["sreshard", 0],
            ["sw", [1, 2, 31]],                       # lands on recipient
            ["stxn", [[1, 1, 41], [1, 2, 42]], 0],    # classes 1 + 2
            ["sread", [1, 2, 0]],
        ]
        spec = CaseSpec(
            seed=0, model="hashmap", wrapper="nr", flavor="sharded",
            n_replicas=1, nlogs=1, steps=steps, n_shards=2,
        )
        res = run(spec)
        assert res.ok, [v.as_dict() for v in res.violations]
        by_step = {e[0]: e for e in res.events}
        assert by_step[3][1] == "stxn"
        assert by_step[3][2]["shards"] == [0, 1]
        assert by_step[4][1] == "sreshard"
        assert by_step[4][2]["moved"] == 2
        assert by_step[4][2]["map_version"] == 2
        assert by_step[6][1] == "stxn"
        assert by_step[6][2]["shards"] == [1, 2]
        assert by_step[7][2] == {"shard": 2, "val": 42}

    def test_crafted_txn_abort_in_kill_window_is_atomic(self):
        steps = [
            ["sw", [1, 1, 11]],
            ["skill", 0],
            ["stxn", [[1, 1, 21], [1, 2, 22]], 0],
            ["sread", [1, 1, 0]],
        ]
        spec = CaseSpec(
            seed=0, model="hashmap", wrapper="nr", flavor="sharded",
            n_replicas=1, nlogs=1, steps=steps, n_shards=2,
        )
        res = run(spec)
        assert res.ok, [v.as_dict() for v in res.violations]
        by_step = {e[0]: e for e in res.events}
        assert by_step[2][1] == "stxn-abort"
        assert by_step[3][2] == {"shard": 1, "val": 11}

    def test_ack_before_decision_canary_is_caught(self):
        with canary.armed("ack-before-decision"):
            spec = _find_spec(
                lambda s: any(st[0] == "stxn" and st[2]
                              for st in s.steps),
                flavors=("sharded",),
            )
            res = run(spec)
            assert any(v.prop == "txn-atomicity"
                       for v in res.violations), (
                "canary survived",
                [v.as_dict() for v in res.violations])
            replay_res = run(spec)
            assert replay_res.digest == res.digest
        # disarmed: the same spec runs clean
        assert run(spec).ok


# ------------------------------------------------------ the differential


@pytest.mark.parametrize("flavors", [FLAVORS] + [(f,) for f in FLAVORS],
                         ids=["all"] + list(FLAVORS))
def test_generate_case_equals_the_reference(flavors):
    for seed in range(300):
        a = generate_case(seed, flavors=flavors)
        b = j_generate(seed, flavors=flavors)
        assert a.as_dict() == b.as_dict(), seed


def test_generate_case_equals_the_reference_under_wrapper_filters():
    for kw in (dict(wrappers=("cnr",)), dict(wrappers=("nr",)),
               dict(models=("stack", "queue")),
               dict(models=("seqreg",), wrappers=("nr",),
                    flavors=("serve", "sharded"))):
        for seed in range(100):
            assert (generate_case(seed, **kw).as_dict()
                    == j_generate(seed, **kw).as_dict()), (kw, seed)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_scheduler_trace_equals_the_reference(seed):
    traces = []
    for cls in (SimScheduler, JSimScheduler):
        s = cls(seed)
        hits = {"a": 0}

        def progress():
            hits["a"] += 1
            return hits["a"] % 3 != 0

        # registered out of name order: picks sort by name in both
        s.add("zeta", lambda: "z", weight=0.5)
        s.add("alpha", progress, weight=3.0)
        s.add("mid", lambda: False, weight=1.2, enabled=False)
        s.run(40)
        s.enable("mid")
        s.disable("zeta")
        s.run(60, idle_limit=4)
        traces.append(s.trace)
    assert traces[0] == traces[1]
    assert len(traces[0]) >= 41


def _op_stream(model, n, seed):
    rng = np.random.default_rng(seed)
    size = MODEL_SIZES[model]
    ops = []
    for i in range(n):
        code = 1 if model == "seqreg" else int(rng.choice((1, 1, 2)))
        ops.append((code, int(rng.integers(-2 * size, 3 * size)), i + 1))
    return ops


_MAKERS = {"hashmap": make_hashmap, "stack": make_stack,
           "queue": make_queue, "seqreg": make_seqreg}


@pytest.mark.parametrize("model", MODELS)
def test_oracle_equals_the_reference_and_names_the_model_state(model):
    size = MODEL_SIZES[model]
    o, jo = make_oracle(model, size), j_make_oracle(model, size)
    nr = NodeReplicated(_MAKERS[model](size), n_replicas=2,
                        log_entries=256, gc_slack=32, device=CPU)
    ops = _op_stream(model, 120, MODELS.index(model))
    for op in ops:
        want = jo.apply(op)
        assert o.apply(op) == want
        assert nr.execute_mut_batch([op], rid=0)[0] == want
    a, b = o.arrays(), jo.arrays()
    assert sorted(a) == sorted(b)
    state = nr.verify(lambda s: s)
    assert sorted(state) == sorted(a)
    for name in a:
        got, ref = np.asarray(a[name]), np.asarray(b[name])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref)
        assert state[name].dtype == got.dtype
        assert state[name].shape == got.shape
        assert np.array_equal(state[name], got)
    c = o.copy()
    c.apply(ops[0])
    assert o.arrays().keys() == c.arrays().keys()


def _covering_seeds():
    """One seed for each (model-free) flavor x wrapper x overlap the
    generator gives in seeds 0-199, plus a sharded case with a crash
    variant txn and one with a split."""
    want, picked = {}, []
    for seed in range(200):
        s = j_generate(seed)
        key = (s.flavor, s.wrapper, s.overlap)
        if key not in want:
            want[key] = seed
            picked.append(seed)
    for pred in (lambda s: any(st[0] == "stxn" and st[2] for st in s.steps),
                 lambda s: any(st[0] == "sreshard" for st in s.steps),
                 lambda s: any(st[0] == "corrupt" for st in s.steps)):
        for seed in range(200):
            if pred(j_generate(seed)):
                if seed not in picked:
                    picked.append(seed)
                break
    return picked


COVERING = _covering_seeds()


def test_covering_seeds_cover_every_flavor_and_wrapper():
    keys = {(j_generate(s).flavor, j_generate(s).wrapper) for s in COVERING}
    assert {f for f, _ in keys} == set(FLAVORS)
    assert {w for _, w in keys} == {"nr", "cnr"}
    assert 10 <= len(COVERING) <= 16


@pytest.mark.parametrize("seed", COVERING)
def test_run_case_equals_the_reference(seed):
    spec = generate_case(seed)
    mine, ref = run(spec), j_run_case(j_generate(seed))
    assert mine.ok and ref.ok, ([v.as_dict() for v in mine.violations],
                                [v.as_dict() for v in ref.violations])
    assert mine.events == ref.events
    assert mine.digest == ref.digest




def _fused_tier_wins(monkeypatch):
    """Arm the fused tier's calibration on the CPU (its test hook) and
    make every fused sample win it, as K1 does on the card."""
    from node_replication_torch.core import replica

    note = replica._FusedTier._note_fused_sample

    def fast(self, tier, pad, dt, fkey=()):
        note(self, tier, pad, 0.0 if tier == "pallas_fused" else dt, fkey)

    monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
    monkeypatch.setattr(replica._FusedTier, "_note_fused_sample", fast)


@pytest.fixture
def fused_wins(monkeypatch):
    _fused_tier_wins(monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("flavors,seeds", [(FLAVORS, range(150)),
                                          (("sharded",), range(40))],
                         ids=["all", "sharded"])
def test_run_case_equals_the_reference_over_a_sweep(flavors, seeds):
    # the covering seeds above, widened to a sweep (~10 minutes of the
    # reference's compiles and rounds, so slow-marked as the
    # reference's own seed sweeps are)
    for seed in seeds:
        mine = run(generate_case(seed, flavors=flavors))
        ref = j_run_case(j_generate(seed, flavors=flavors))
        assert mine.ok and ref.ok, seed
        assert mine.events == ref.events, seed
        assert mine.digest == ref.digest, seed


def test_calibrated_fused_tier_keeps_the_digest(monkeypatch):
    # the fused tier calibrates by measured time on the card, so which
    # tier a round takes varies; no event may record it. The CPU hook
    # arms the same calibration over the kernels' plain versions, once
    # as measured and once with the fused tier winning every key
    plain = {s: run(generate_case(s)).digest for s in COVERING}
    monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
    nr = NodeReplicated(make_hashmap(8), 2, log_entries=256, gc_slack=32,
                        device=CPU)
    assert nr._fused_mode == "auto"
    for s in COVERING:
        res = run(generate_case(s))
        assert res.ok and res.digest == plain[s], s
    _fused_tier_wins(monkeypatch)
    for s in COVERING:
        res = run(generate_case(s))
        assert res.ok and res.digest == plain[s], s


@pytest.mark.parametrize("seed", [19, 200])
def test_replay_fault_strikes_the_fused_tier_as_the_chain(seed, fused_wins,
                                                          monkeypatch):
    # seed 19 (CNR) and 200 (NR) inject a `replay`-site raise into a
    # hashmap write; the card's calibrated fused tier must hit the site
    # as the chain does, or the digest depends on which tier won
    from node_replication_torch.ops import replay as ops_replay

    spec = generate_case(seed)
    assert any(st[0] == "wf" and st[2:4] == ["replay", "raise"]
               for st in spec.steps)
    with monkeypatch.context() as m:
        # the reference reads the same hook: its fused tier skips the
        # replay site, so it runs unarmed here
        m.delenv("NR_TPU_FUSED_CAL")
        ref = j_run_case(j_generate(seed))
    plain = ops_replay.hashmap_fused_round_plain
    calls = []
    monkeypatch.setattr(ops_replay, "hashmap_fused_round_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    res = run(spec)
    assert calls  # the fused tier ran rounds of this case
    assert res.ok and res.events == ref.events
    assert res.digest == ref.digest


def test_sharded_sub_batches_round_alike_under_a_slow_submitter(
        monkeypatch):
    # an `sbatch` step stages each shard's ops through its frontend
    # one `submit` at a time, and a `stxn` commit each participant's;
    # a worker that wakes between two of them splits the sub-batch
    # over two rounds, so the follower's `sapply` record counts (and
    # the digest) followed thread timing. Sleeping after every submit
    # makes that certain unless the staging holds the worker
    import time as _time

    from node_replication_torch.serve.frontend import ServeFrontend

    spec = _find_spec(lambda s: any(st[0] == "sreshard" for st in s.steps),
                      flavors=("sharded",))
    ref = j_run_case(j_generate(spec.seed, flavors=("sharded",)))
    submit = ServeFrontend.submit

    def slow(self, *a, **k):
        fut = submit(self, *a, **k)
        _time.sleep(0.01)
        return fut

    monkeypatch.setattr(ServeFrontend, "submit", slow)
    res = run(spec)
    assert res.ok and res.events == ref.events
    assert res.digest == ref.digest


def _explore_artifact(main, name, out, device_args):
    rc = main(["--canary", name, "--seeds", "40", "--no-shrink",
               "--out", str(out), *device_args])
    assert rc == 0
    (path,) = sorted(out.glob("failing-seed-*.json"))
    return path, json.loads(path.read_text())


def _replay_digest(main, path, capsys, device_args):
    capsys.readouterr()
    rc = main(["--spec", str(path), "--json", *device_args])
    assert rc == 1  # the canary's violation, replayed
    return json.loads(capsys.readouterr().out)["digest"]


@pytest.mark.parametrize("name", ["ack-before-fsync", "ack-before-decision"])
def test_artifacts_replay_across_the_packages(name, tmp_path, capsys):
    with canary.armed(name):
        path, art = _explore_artifact(explore.main, name, tmp_path / "port",
                                      ["--device", CPU])
    assert art["canary"] == name and art["replay_identical"]
    with j_canary.armed(name):
        assert _replay_digest(j_replay.main, path, capsys, []) \
            == art["digest"]
        jpath, jart = _explore_artifact(j_explore.main, name,
                                        tmp_path / "ref", [])
    assert jart["spec"] == art["spec"] and jart["digest"] == art["digest"]
    with canary.armed(name):
        assert _replay_digest(replay.main, jpath, capsys,
                              ["--device", CPU]) == jart["digest"]


@pytest.mark.parametrize("name", sorted(canary.CANARIES))
def test_canaries_patch_only_their_own_package(name):
    from node_replication_tpu.durable import txnlog as j_txnlog
    from node_replication_tpu.durable import wal as j_wal

    from node_replication_torch.durable import txnlog, wal

    def methods(w, t):
        return (w.WriteAheadLog._pin_floor_locked, w.WriteAheadLog.sync,
                t.DecisionLog.publish)

    port0, ref0 = methods(wal, txnlog), methods(j_wal, j_txnlog)
    with canary.armed(name):
        assert methods(j_wal, j_txnlog) == ref0
        assert sum(a is not b for a, b in
                   zip(methods(wal, txnlog), port0)) == 1
    with j_canary.armed(name):
        assert methods(wal, txnlog) == port0
        assert sum(a is not b for a, b in
                   zip(methods(j_wal, j_txnlog), ref0)) == 1
    assert methods(wal, txnlog) == port0
    assert methods(j_wal, j_txnlog) == ref0
    assert canary.CANARY_FLAVOR == j_canary.CANARY_FLAVOR


@pytest.mark.parametrize("name", sorted(canary.CANARIES))
def test_canary_is_caught_replayed_and_shrunk(name, capsys):
    # the CI sim-smoke loop on the port: caught, replayed
    # byte-identically, and shrunk by ddmin
    assert explore.main(["--canary", name, "--seeds", "60",
                         "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "harness verified" in out and "IDENTICAL" in out


def test_explore_sweep_is_clean_and_writes_no_artifact(tmp_path, capsys):
    rc = explore.main(["--seeds", "24", "--out", str(tmp_path / "a"),
                       "--device", CPU, "--progress", "0"])
    assert rc == 0
    assert not (tmp_path / "a").exists()
    out = capsys.readouterr().out
    assert "swept 24 seed(s)" in out and "0 failing" in out
