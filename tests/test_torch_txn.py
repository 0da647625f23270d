"""The port's 2PC plane and online resharding (`node_replication_torch/
shard/txn.py`, `shard/reshard.py`, `durable/txnlog.py`) against the
reference's.

- Twins of `tests/test_txn.py`'s 26 tests (the intent journal and the
  decision log, participant fencing, locks, idempotent verbs and
  recovery by decision lookup, the coordinator's atomicity and
  decision-before-ack, a live split with zero lost acks and its merge),
  on the CPU through `nr_kwargs=dict(device="cpu")`, with the
  reference's sizes.
- Differential cases (integer data, tolerance 0): intent journals,
  decision files and the coordinator epoch file are byte-identical
  across the packages and each package reads the other's; one seeded
  stream of transactions (cross-shard commits, single-shard degrades, a
  conflict abort) through both packages' `ShardGroup` gives equal
  results, errors, decision directories, journals and fleets; and a
  group of either package that died mid-commit is recovered in place by
  the other, which resolves the intent without applying it twice.
"""

import os
import struct
import threading
import time

import numpy as np
import pytest

from node_replication_tpu.durable import DecisionLog as JDecisionLog
from node_replication_tpu.durable import TxnIntentLog as JTxnIntentLog
from node_replication_tpu.fault.inject import FaultPlan as JFaultPlan
from node_replication_tpu.fault.inject import FaultSpec as JFaultSpec
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.shard import ShardGroup as JShardGroup

from node_replication_torch import interop
from node_replication_torch.durable import (
    DecisionLog,
    TxnIntentLog,
    TxnLogCorruptError,
)
from node_replication_torch.fault.inject import FaultPlan, FaultSpec
from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
from node_replication_torch.serve import (
    RetryPolicy,
    ServeError,
    TxnAborted,
    TxnConflict,
    call_with_retry,
)
from node_replication_torch.serve.errors import WrongShard
from node_replication_torch.shard import (
    ReshardError,
    ReshardPlan,
    ShardGroup,
    ShardMap,
)

NR_KW = dict(n_replicas=1, log_entries=1 << 10, gc_slack=32, device="cpu")
J_NR_KW = {k: v for k, v in NR_KW.items() if k != "device"}


def _group(tmp_path, n=2, **kw):
    kw.setdefault("nr_kwargs", NR_KW)
    kw.setdefault("concurrent_router", False)
    return ShardGroup(n, make_hashmap(256), str(tmp_path), **kw)


def _read(g, k):
    s = g.map.shard_of(k)
    return int(g.primaries[s].live_frontend.read((HM_GET, k)))


# ==========================================================================
# the durable layer: intent journal + decision log
# ==========================================================================


class TestTxnIntentLog:
    def test_journal_and_reopen_rebuilds_unresolved(self, tmp_path):
        p = str(tmp_path / "txn-intents.log")
        log = TxnIntentLog(p)
        log.journal_intent("t1", 1, [(HM_PUT, 2, 9)])
        log.journal_intent("t2", 1, [(HM_PUT, 4, 9)])
        log.journal_resolved("t2", "abort")
        log.close()
        log2 = TxnIntentLog(p)
        unres = log2.unresolved()
        assert list(unres) == ["t1"]
        assert unres["t1"]["ops"] == [(HM_PUT, 2, 9)]
        assert log2.outcome("t2") == "abort"
        log2.close()

    def test_torn_tail_truncates_silently(self, tmp_path):
        p = str(tmp_path / "txn-intents.log")
        log = TxnIntentLog(p)
        log.journal_intent("t1", 1, [(HM_PUT, 2, 9)])
        log.close()
        good = os.path.getsize(p)
        with open(p, "ab") as f:
            f.write(struct.pack("<II", 4096, 0) + b"par")  # torn record
        log2 = TxnIntentLog(p)
        assert list(log2.unresolved()) == ["t1"]
        log2.close()
        assert os.path.getsize(p) == good  # debris truncated away

    def test_complete_bad_crc_is_typed_corruption(self, tmp_path):
        p = str(tmp_path / "txn-intents.log")
        log = TxnIntentLog(p)
        log.journal_intent("t1", 1, [(HM_PUT, 2, 9)])
        log.close()
        payload = b'{"kind": "garbage"}'
        with open(p, "ab") as f:  # complete frame, wrong checksum
            f.write(struct.pack("<II", len(payload), 1234) + payload)
        with pytest.raises(TxnLogCorruptError):
            TxnIntentLog(p)

    def test_commit_begin_round_trips(self, tmp_path):
        p = str(tmp_path / "txn-intents.log")
        log = TxnIntentLog(p)
        log.journal_intent("t1", 3, [(HM_PUT, 2, 9)])
        log.journal_commit_begin("t1", 17)
        log.close()
        log2 = TxnIntentLog(p)
        assert log2.unresolved()["t1"]["commit_begin"] == 17
        log2.close()


class TestDecisionLog:
    def test_publish_load_and_absence(self, tmp_path):
        d = DecisionLog(str(tmp_path))
        assert d.load("nope") is None  # absence != corruption
        d.publish("t1", "commit", shards=(0, 2))
        rec = d.load("t1")
        assert rec["outcome"] == "commit"
        assert list(rec["shards"]) == [0, 2]
        assert d.outcome("t1") == "commit"

    def test_epoch_bumps_are_durable(self, tmp_path):
        d = DecisionLog(str(tmp_path))
        assert d.epoch() == 0
        assert d.bump_epoch() == 1
        assert DecisionLog(str(tmp_path)).epoch() == 1

    def test_corrupt_decision_is_typed(self, tmp_path):
        d = DecisionLog(str(tmp_path))
        d.publish("t1", "commit")
        path = [os.path.join(str(tmp_path), f)
                for f in os.listdir(str(tmp_path)) if "t1" in f][0]
        with open(path, "w") as f:
            f.write("{not json")
        with pytest.raises(TxnLogCorruptError):
            d.load("t1")


# ==========================================================================
# participant semantics (through a ShardGroup's wiring)
# ==========================================================================


class TestParticipant:
    def test_prepared_intent_locks_keys_not_shard(self, tmp_path):
        g = _group(tmp_path)
        try:
            g.router.txn_call(0, "prepare", "c.g1.1", 1,
                              ops=[(HM_PUT, 2, 9)])
            # the locked KEY conflicts, with zero log effect...
            with pytest.raises(TxnConflict) as ei:
                g.router.call((HM_PUT, 2, 5))
            assert ei.value.retryable and not ei.value.maybe_executed
            # ...but the shard keeps serving every other key
            assert int(g.router.call((HM_PUT, 4, 44))) >= 0
            assert _read(g, 4) == 44
        finally:
            g.close()

    def test_commit_applies_and_releases(self, tmp_path):
        g = _group(tmp_path)
        try:
            g.router.txn_call(0, "prepare", "c.g1.1", 1,
                              ops=[(HM_PUT, 2, 9)])
            g.router.txn_call(0, "commit", "c.g1.1", 1)
            assert _read(g, 2) == 9
            assert int(g.router.call((HM_PUT, 2, 10))) >= 0  # unlocked
            # idempotent re-drive: no second apply, empty results
            assert g.router.txn_call(0, "commit", "c.g1.1", 1) == []
            assert _read(g, 2) == 10
        finally:
            g.close()

    def test_abort_is_zero_effect_and_idempotent(self, tmp_path):
        g = _group(tmp_path)
        try:
            g.router.txn_call(0, "prepare", "c.g1.1", 1,
                              ops=[(HM_PUT, 2, 9)])
            g.router.txn_call(0, "abort", "c.g1.1", 1)
            assert _read(g, 2) == -1  # never applied (absent key)
            g.router.txn_call(0, "abort", "c.g1.1", 1)  # no-op
            g.router.txn_call(0, "abort", "never-prepared", 1)  # no-op
            with pytest.raises(ServeError):
                g.router.txn_call(0, "commit", "c.g1.1", 1)
        finally:
            g.close()

    def test_stale_version_fenced_at_every_verb(self, tmp_path):
        g = _group(tmp_path)
        try:
            p = g.primaries[0].txn
            with pytest.raises(WrongShard):
                p.prepare("c.g1.1", 1, [(HM_PUT, 2, 9)],
                          peer_version=g.map.version + 1)
            p.prepare("c.g1.1", 1, [(HM_PUT, 2, 9)], g.map.version)
            with pytest.raises(WrongShard):
                p.commit("c.g1.1", peer_version=g.map.version + 1)
        finally:
            g.close()

    def test_misrouted_op_in_prepare_is_wrong_shard(self, tmp_path):
        g = _group(tmp_path)
        try:
            with pytest.raises(WrongShard):
                g.router.txn_call(0, "prepare", "c.g1.1", 1,
                                  ops=[(HM_PUT, 3, 9)])  # key 3 -> s1
        finally:
            g.close()

    def test_restart_rebuilds_locks_and_presumes_abort(self, tmp_path):
        g = _group(tmp_path)
        coord = g.coordinator()
        g.router.txn_call(0, "prepare", f"x.g{coord.gen}.1", coord.gen,
                          ops=[(HM_PUT, 2, 9)])
        g.close()
        g2 = _group(tmp_path, recover=True)
        try:
            # reopened journal rebuilt the lock...
            with pytest.raises(TxnConflict):
                g2.router.call((HM_PUT, 2, 5))
            # ...a NEW coordinator generation makes the old intent
            # presumed-abortable, which releases it
            g2.coordinator()
            res = g2.resolve_in_doubt()
            assert res[0][f"x.g{coord.gen}.1"] == "abort"
            assert int(g2.router.call((HM_PUT, 2, 5))) >= 0
            assert _read(g2, 2) == 5  # the prepared 9 never applied
        finally:
            g2.close()

    def test_live_generation_stays_in_doubt(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            txn = f"{coord.name}.g{coord.gen}.7"
            g.router.txn_call(0, "prepare", txn, coord.gen,
                              ops=[(HM_PUT, 2, 9)])
            res = g.resolve_in_doubt()
            assert res[0][txn] == "in-doubt"
            with pytest.raises(TxnConflict):  # keys stay locked
                g.router.call((HM_PUT, 2, 5))
        finally:
            g.close()

    def test_crash_mid_commit_replays_exactly_once(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            txn = f"{coord.name}.g{coord.gen}.1"
            g.router.txn_call(0, "prepare", txn, coord.gen,
                              ops=[(HM_PUT, 2, 9), (HM_PUT, 4, 11)])
            g.decisions.publish(txn, "commit", shards=(0,))
            plan = FaultPlan([FaultSpec(site="txn-commit",
                                        action="raise", rid=0)])
            with plan.armed():
                with pytest.raises(Exception):
                    # applies BOTH ops, then dies before the resolved
                    # record — the canonical mid-commit crash
                    g.router.txn_call(0, "commit", txn, coord.gen)
            assert len(plan.fired) == 1
            wal = g.primaries[0].wal
            tail_after_crash = wal.tail
            # recovery finds the commit decision and the journaled
            # commit-begin fence: the WAL scan sees both ops already
            # applied and replays NOTHING
            res = g.resolve_in_doubt()
            assert res[0][txn] == "commit"
            assert wal.tail == tail_after_crash  # zero re-appends
            assert _read(g, 2) == 9 and _read(g, 4) == 11
            assert int(g.router.call((HM_PUT, 2, 10))) >= 0  # unlocked
        finally:
            g.close()

    def test_redriven_commit_verb_dedups_after_mid_commit_crash(
            self, tmp_path):
        # the OTHER recovery path: a restarted coordinator re-drives
        # the published commit through the `commit` VERB (not
        # `resolve_in_doubt`) — the journaled commit-begin fence must
        # make that re-drive dedup too, or the participant that died
        # between apply and resolved-record applies twice (found by
        # `bench.py --txn`'s mid-commit SIGKILL round)
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            txn = f"{coord.name}.g{coord.gen}.1"
            g.router.txn_call(0, "prepare", txn, coord.gen,
                              ops=[(HM_PUT, 2, 9), (HM_PUT, 4, 11)])
            g.decisions.publish(txn, "commit", shards=(0,))
            plan = FaultPlan([FaultSpec(site="txn-commit",
                                        action="raise", rid=0)])
            with plan.armed():
                with pytest.raises(Exception):
                    g.router.txn_call(0, "commit", txn, coord.gen)
            wal = g.primaries[0].wal
            tail_after_crash = wal.tail
            out = g.router.txn_call(0, "commit", txn, coord.gen)
            assert wal.tail == tail_after_crash  # zero re-appends
            assert len(out) == 2                 # results re-delivered
            assert _read(g, 2) == 9 and _read(g, 4) == 11
            # and the re-drive resolved it: a third commit is a no-op
            assert g.router.txn_call(0, "commit", txn, coord.gen) == []
        finally:
            g.close()


# ==========================================================================
# coordinator: atomicity, degrade, decision-before-ack, recovery
# ==========================================================================


class TestCoordinator:
    def test_cross_shard_txn_is_atomic(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            out = coord.execute_txn([(HM_PUT, 2, 111), (HM_PUT, 3, 222)])
            assert len(out) == 2
            assert _read(g, 2) == 111 and _read(g, 3) == 222
            # decision is durable and consultable after the fact
            assert g.decisions.outcome(
                f"{coord.name}.g{coord.gen}.1") == "commit"
        finally:
            g.close()

    def test_single_shard_degrades_to_plain_batch(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            coord.execute_txn([(HM_PUT, 2, 5), (HM_PUT, 4, 6)])
            # no decision record: this was never a 2PC transaction
            assert list(g.decisions.decisions()) == []
            assert _read(g, 2) == 5 and _read(g, 4) == 6
        finally:
            g.close()

    def test_conflict_aborts_whole_txn_with_zero_effect(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            # lock a shard-1 key under a foreign prepared txn, so the
            # coordinator's shard-1 prepare must refuse
            g.router.txn_call(1, "prepare", "other.g1.1", coord.gen,
                              ops=[(HM_PUT, 3, 1)])
            with pytest.raises(TxnAborted):
                coord.execute_txn([(HM_PUT, 2, 111), (HM_PUT, 3, 222)])
            # all-or-nothing: the shard-0 half must NOT have applied
            assert _read(g, 2) == -1 and _read(g, 3) == -1
            # and the abort decision was published as an accelerator
            assert g.decisions.outcome(
                f"{coord.name}.g{coord.gen}.1") == "abort"
            # the foreign intent keeps its lock (its txn, its keys)
            with pytest.raises(TxnConflict):
                g.router.call((HM_PUT, 3, 5))
        finally:
            g.close()

    def test_coordinator_crash_after_decision_recovers(self, tmp_path):
        g = _group(tmp_path)
        try:
            c1 = g.coordinator()
            txn = f"{c1.name}.g{c1.gen}.1"
            # simulate a coordinator that died between the durable
            # decision publish and phase 2: prepares + decision only
            g.router.txn_call(0, "prepare", txn, c1.gen,
                              ops=[(HM_PUT, 2, 9)])
            g.router.txn_call(1, "prepare", txn, c1.gen,
                              ops=[(HM_PUT, 3, 8)])
            g.decisions.publish(txn, "commit", shards=(0, 1))
            c2 = g.coordinator(name="c2")
            rep = c2.recover()
            assert rep["redriven"] >= 2 and rep["failed"] == 0
            assert _read(g, 2) == 9 and _read(g, 3) == 8
            assert g.resolve_in_doubt() == {0: {}, 1: {}}
        finally:
            g.close()

    def test_submit_txn_future_resolves_after_decision(self, tmp_path):
        g = _group(tmp_path)
        try:
            coord = g.coordinator()
            fut = coord.submit_txn([(HM_PUT, 2, 1), (HM_PUT, 3, 2)])
            assert fut.result(10.0) == [0, 0]
            assert g.decisions.outcome(
                f"{coord.name}.g{coord.gen}.1") == "commit"
        finally:
            g.close()


# ==========================================================================
# reshard: live split, quiesced merge
# ==========================================================================


class TestReshard:
    def test_split_moves_class_with_zero_lost_acks(self, tmp_path):
        g = _group(tmp_path)
        try:
            for k in range(32):
                g.router.call((HM_PUT, k, k * 10 + 1))
            stop = threading.Event()
            acked: dict[int, int] = {}
            errs: list = []

            # a generous budget: retries must absorb the whole fence
            # window (catch-up + promote + map publish), which the
            # default 8-attempt policy only just covers on a quiet box
            ride = RetryPolicy(max_attempts=512, base_backoff_s=0.001,
                               max_backoff_s=0.05)

            def writer():
                i = 0
                while not stop.is_set():
                    k = (i * 2) % 32  # donor's congruence class
                    try:
                        call_with_retry(g.router, (HM_PUT, k, 7000 + i),
                                        policy=ride, deadline_s=30.0)
                        acked[k] = 7000 + i
                    except Exception as e:  # pragma: no cover
                        errs.append(e)
                        return
                    i += 1
                    time.sleep(0.001)

            th = threading.Thread(target=writer, name="test-reshard-w")
            th.start()
            time.sleep(0.1)
            plan = ReshardPlan(g, donor=0)
            rep = plan.split()
            time.sleep(0.1)
            stop.set()
            th.join(timeout=10)
            assert not errs
            assert g.map.n_shards == 4
            assert rep.new_version == rep.old_version + 1
            # the published map converged too
            assert ShardMap.load(str(tmp_path)).version == rep.new_version

            def rd(k):
                s = g.map.shard_of(k)
                if s == 2:  # the moved class rides the recipient
                    return int(plan._recipient.frontend.read((HM_GET, k)))
                fe = g.primaries[s % 2].live_frontend
                return int(fe.read((HM_GET, k)))

            # ZERO lost acks across the cutover...
            assert all(rd(k) == v for k, v in acked.items())
            # ...and the untouched class is untouched
            assert all(rd(k) == k * 10 + 1 for k in range(1, 32, 2))
            # new writes route to the recipient
            call_with_retry(g.router, (HM_PUT, 2, 4242))
            assert rd(2) == 4242
            # bounded fence window, not state-sized (split's own
            # catch-up/drain timeouts are 10s; anything under that
            # proves the fence is bounded by config, not by history)
            assert rep.fence_s < 10.0
        finally:
            g.close()

    def test_split_then_merge_round_trips(self, tmp_path):
        g = _group(tmp_path)
        try:
            for k in range(16):
                g.router.call((HM_PUT, k, 100 + k))
            plan = ReshardPlan(g, donor=0)
            plan.split()
            call_with_retry(g.router, (HM_PUT, 2, 999))  # recipient write
            rep = plan.merge()
            assert g.map.n_shards == 2
            assert rep.drained_records > 0
            # folded values visible at the survivor, including the
            # post-split write
            assert _read(g, 2) == 999
            assert all(_read(g, k) == 100 + k for k in range(16)
                       if k != 2)
        finally:
            g.close()

    def test_txn_spans_refined_topology(self, tmp_path):
        g = _group(tmp_path)
        try:
            ReshardPlan(g, donor=0).split()
            coord = g.coordinator()
            # classes 1 and 2 of 4: one alias shard, one recipient
            coord.execute_txn([(HM_PUT, 5, 1), (HM_PUT, 6, 2)])
            fe1 = g.primaries[1].live_frontend
            assert int(fe1.read((HM_GET, 5))) == 1
        finally:
            g.close()

    def test_split_refuses_inflight_txn_and_dead_donor(self, tmp_path):
        g = _group(tmp_path)
        try:
            g.router.txn_call(0, "prepare", "c.g1.1", 1,
                              ops=[(HM_PUT, 2, 9)])
            with pytest.raises(ReshardError):
                ReshardPlan(g, donor=0).split()
            g.router.txn_call(0, "abort", "c.g1.1", 1)
            g.kill_primary(0)
            with pytest.raises(ReshardError):
                ReshardPlan(g, donor=0).split()
        finally:
            g.close()

    def test_plan_is_single_use(self, tmp_path):
        g = _group(tmp_path)
        try:
            plan = ReshardPlan(g, donor=0)
            with pytest.raises(ReshardError):
                plan.merge()  # nothing split yet
            plan.split()
            with pytest.raises(ReshardError):
                plan.split()
        finally:
            g.close()


# =========================================== against the reference


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            with open(p, "rb") as fh:
                out[name] = fh.read()
    return out


def _journal(log):
    log.journal_intent("c.g1.1", 1, [(HM_PUT, 2, 9), (HM_PUT, -4, 1 << 30)])
    log.journal_intent("c.g1.2", 1, [(2, 6)])
    log.journal_commit_begin("c.g1.1", 17)
    log.journal_resolved("c.g1.2", "abort")
    log.journal_intent("x_y-z.g2.3", 2, [(HM_PUT, 8, -1)])
    log.journal_resolved("c.g1.1", "commit")
    log.journal_intent("c.g2.9", 2, [(HM_PUT, 10, 3), (2, 12)])
    log.journal_commit_begin("c.g2.9", 40)


def _journal_view(log):
    return ({t: (i["gen"], [tuple(op) for op in i["ops"]],
                 i["commit_begin"]) for t, i in log.unresolved().items()},
            {t: log.outcome(t) for t in ("c.g1.1", "c.g1.2", "c.g2.9")})


def test_intent_journals_byte_identical(tmp_path):
    """The same appends through both packages' `TxnIntentLog`: equal
    bytes; each package reopens the other's journal to the same
    unresolved intents and outcomes, and truncates a torn tail of the
    other's file to the same length."""
    jp, tp = str(tmp_path / "j" / "txn-intents.log"), \
        str(tmp_path / "t" / "txn-intents.log")
    jl, tl = JTxnIntentLog(jp), TxnIntentLog(tp)
    _journal(jl)
    _journal(tl)
    jl.close()
    tl.close()
    with open(jp, "rb") as f:
        a = f.read()
    with open(tp, "rb") as f:
        b = f.read()
    assert a == b and len(b) > 0
    want = _journal_view(TxnIntentLog(tp))
    assert _journal_view(TxnIntentLog(jp)) == want
    assert _journal_view(JTxnIntentLog(tp)) == want
    assert want[0]["c.g2.9"] == (2, [(HM_PUT, 10, 3), (2, 12)], 40)
    for p in (jp, tp):
        with open(p, "ab") as f:
            f.write(struct.pack("<II", 4096, 0) + b"torn")
    reader = {jp: TxnIntentLog, tp: JTxnIntentLog}
    for p, R in reader.items():
        log = R(p)
        assert log.truncated_bytes == 12
        log.close()
        assert os.path.getsize(p) == len(a)


def test_decision_files_byte_identical(tmp_path):
    """Decisions and epoch bumps through both packages' `DecisionLog`:
    every file in the two directories equal byte for byte; each package
    reads the other's decisions and epoch."""
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    logs = (JDecisionLog(jd), DecisionLog(td))
    for d in logs:
        assert d.bump_epoch() == 1
        d.publish("coord.g1.1", "commit", shards=(0, 2))
        d.publish("coord.g1.2", "abort", shards=[1, 0])
        d.publish("c2.g1.1", "commit")
        assert d.bump_epoch() == 2
    a, b = _files(jd), _files(td)
    assert sorted(b) == ["coord-epoch.json", "dec-c2.g1.1.json",
                         "dec-coord.g1.1.json", "dec-coord.g1.2.json"]
    assert a == b
    for reader, d in ((DecisionLog, jd), (JDecisionLog, td)):
        log = reader(d)
        assert log.epoch() == 2
        assert [dict(x) for x in log.decisions()] == \
            [dict(x) for x in logs[0].decisions()]
        assert log.outcome("coord.g1.2") == "abort"


def _txns(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.choice(np.arange(0, 40), int(rng.integers(1, 4)),
                          replace=False)
        out.append([(HM_PUT, int(k), int(rng.integers(1, 1 << 30)))
                    for k in keys])
    return out


def _fleet(nr):
    nr.sync()
    lg = nr.log
    if hasattr(lg.tail, "numpy"):
        cur = interop.log_to_numpy(lg)
        st = {f: leaf.numpy() for f, leaf in nr.states.items()}
    else:
        cur = {f: np.asarray(getattr(lg, f)) for f in
               ("opcodes", "args", "head", "tail", "ctail", "ltails")}
        st = {f: np.asarray(nr.states[f]) for f in nr.states}
    return cur, st


def _run_txns(pkg, d, txns):
    G = ShardGroup if pkg == "port" else JShardGroup
    kw = NR_KW if pkg == "port" else J_NR_KW
    disp = make_hashmap(256) if pkg == "port" else j_make_hashmap(256)
    g = G(2, disp, d, nr_kwargs=kw, concurrent_router=False,
          with_followers=False)
    outs = []
    try:
        coord = g.coordinator()
        for i, ops in enumerate(txns):
            if i == 5:
                # a foreign prepared intent on shard 1 (key 1): the next
                # cross-shard txn touching it aborts, then it aborts
                g.router.txn_call(1, "prepare", "other.g1.1", coord.gen,
                                  ops=[(HM_PUT, 1, 77)])
                ops = ops + [(HM_PUT, 1, 5), (HM_PUT, 0, 6)]
            try:
                outs.append(("ok", coord.execute_txn(ops)))
            except Exception as e:
                outs.append((type(e).__name__, getattr(e, "txn", None)))
            if i == 5:
                g.router.txn_call(1, "abort", "other.g1.1", coord.gen)
        fleets = [_fleet(p.live_frontend.nr) for p in g.primaries]
        journals = [open(os.path.join(d, f"s{s}", "txn",
                                      "txn-intents.log"), "rb").read()
                    for s in range(2)]
        return outs, fleets, journals, _files(g.decisions_dir)
    finally:
        g.close()


def test_txn_stream_matches_reference(tmp_path):
    """One seeded stream of 12 transactions of 1-3 PUTs (cross-shard
    commits, single-shard degrades, and one that meets a foreign
    prepared intent and aborts with zero effect) through both packages'
    two-shard group: equal results and errors, byte-identical decision
    directories and per-shard intent journals, equal fleets."""
    txns = _txns(8, 12)
    jo, jf, jj, jd = _run_txns("ref", str(tmp_path / "ref"), txns)
    to, tf, tj, td = _run_txns("port", str(tmp_path / "port"), txns)
    assert jo == to
    assert [o for o in to if o[0] != "ok"] == [("TxnAborted", "coord.g1.3")]
    assert jd == td and len(td) > 5
    assert jj == tj and all(tj)
    for (jc, js), (tc, ts) in zip(jf, tf):
        for f in jc:
            assert jc[f].dtype == tc[f].dtype and \
                np.array_equal(jc[f], tc[f]), f
        for f in js:
            assert np.array_equal(js[f], ts[f]), f


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_mid_commit_crash_recovers_across_packages(writer, tmp_path):
    """A group of one package prepares a transaction on shard 0,
    publishes its commit decision, applies both ops and dies before
    the resolved record; the other package reopens the same directory
    with `recover=True` (its WAL, journal and map), finds the key
    locked, resolves the intent by decision lookup without appending
    anything, and serves the committed values."""
    d = str(tmp_path / "g")
    W = JShardGroup if writer == "ref" else ShardGroup
    Rd = ShardGroup if writer == "ref" else JShardGroup
    wkw = J_NR_KW if writer == "ref" else NR_KW
    rkw = NR_KW if writer == "ref" else J_NR_KW
    wd = j_make_hashmap(256) if writer == "ref" else make_hashmap(256)
    rd = make_hashmap(256) if writer == "ref" else j_make_hashmap(256)
    Plan, Spec = (JFaultPlan, JFaultSpec) if writer == "ref" \
        else (FaultPlan, FaultSpec)
    g = W(2, wd, d, nr_kwargs=wkw, concurrent_router=False,
          with_followers=False)
    coord = g.coordinator()
    txn = f"{coord.name}.g{coord.gen}.1"
    g.router.call((HM_PUT, 6, 60))
    g.router.txn_call(0, "prepare", txn, coord.gen,
                      ops=[(HM_PUT, 2, 9), (HM_PUT, 4, 11)])
    g.decisions.publish(txn, "commit", shards=(0,))
    plan = Plan([Spec(site="txn-commit", action="raise", rid=0)])
    with plan.armed():
        with pytest.raises(Exception):
            g.router.txn_call(0, "commit", txn, coord.gen)
    assert len(plan.fired) == 1
    tail = g.primaries[0].wal.tail
    g.close()
    g2 = Rd(2, rd, d, nr_kwargs=rkw, concurrent_router=False,
            with_followers=False, recover=True)
    try:
        assert g2.map.version == 1
        assert g2.primaries[0].wal.tail == tail == 3
        with pytest.raises(Exception) as ei:
            g2.router.call((HM_PUT, 2, 5))
        assert type(ei.value).__name__ == "TxnConflict"
        res = g2.resolve_in_doubt()
        assert res[0][txn] == "commit"
        assert g2.primaries[0].wal.tail == tail
        fe = g2.primaries[0].live_frontend
        assert [int(fe.read((HM_GET, k))) for k in (2, 4, 6)] == [9, 11, 60]
        assert int(g2.router.call((HM_PUT, 2, 10))) >= 0
        assert int(fe.read((HM_GET, 2))) == 10
    finally:
        g2.close()
