"""Differential tests of the port's `NodeReplicated`
(`node_replication_torch/core/replica.py`) against the reference
wrapper: one op stream through both, for each of `engine='combined'`,
`'scan'` and `'pallas'` (the reference's fused tier in interpret mode,
the port's through the plain version of its kernel). The stream has
per-op writes, enqueue/flush batches, `execute_mut_batch`, split
rounds (finished and aborted), cross-replica and stale reads, and a
fence -> clone -> unfence repair in the middle, over a ring that wraps
twice. Responses, `ring_slice`, states and the `stats()` fields must be
identical."""

import numpy as np
import pytest
import torch

from node_replication_tpu.core.log import ring_slice as j_ring_slice
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.models import make_hashmap as j_make_hashmap

from node_replication_torch import interop
from node_replication_torch.core.log import ring_slice as t_ring_slice
from node_replication_torch.core.replica import (
    NodeReplicated as TNR,
    ReplicaFencedError,
)
from node_replication_torch.models import make_hashmap as t_make_hashmap
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops.replay import FUSED_KERNEL

K, R = 29, 3
KW = dict(n_replicas=R, log_entries=512, gc_slack=64)


def _ops(rng, n):
    out = []
    for _ in range(n):
        if rng.random() < 0.65:
            out.append((1, int(rng.integers(-K, 2 * K)),
                        int(rng.integers(1000))))
        else:
            out.append((2, int(rng.integers(K))))
    return out


def _twins(engine):
    return (JNR(j_make_hashmap(K), engine=engine, **KW),
            TNR(t_make_hashmap(K), engine=engine, device="cpu", **KW))


def _same_state(jn, tn, what=""):
    got = interop.states_to_numpy(tn.states)
    for f in ("values", "present"):
        a, b = np.asarray(jn.states[f]), got[f]
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)


def _same_log(jn, tn, what=""):
    js, ts = jn.stats(), tn.stats()
    assert js == ts, (what, js, ts)
    tail = js["appended"]
    lo = max(0, tail - jn.spec.capacity)
    jo, ja = j_ring_slice(jn.spec, jn.log, lo, tail)
    to, ta = t_ring_slice(tn.spec, tn.log, lo, tail)
    assert np.array_equal(jo, to) and np.array_equal(ja, ta), what
    assert np.array_equal(np.asarray(jn.log.ltails),
                          tn.log.ltails.numpy()), what


@pytest.mark.parametrize("engine", ["combined", "scan", "pallas"])
def test_op_stream_bit_identical(engine):
    rng = np.random.default_rng({"combined": 1, "scan": 2,
                                 "pallas": 3}[engine])
    jn, tn = _twins(engine)
    jt = [jn.register(r) for r in range(R)]
    tt = [tn.register(r) for r in range(R)]

    def both(fn_name, *args, rid=None):
        j_args = [jt[rid] if a is _TOKEN else a for a in args]
        t_args = [tt[rid] if a is _TOKEN else a for a in args]
        a = getattr(jn, fn_name)(*j_args)
        b = getattr(tn, fn_name)(*t_args)
        assert a == b, (fn_name, args, a, b)
        return a

    # per-op writes and cross-replica reads
    for i in range(6):
        op = _ops(rng, 1)[0]
        both("execute_mut", op, _TOKEN, rid=i % R)
        both("execute", (1, op[1]), _TOKEN, rid=(i + 1) % R)
    # explicit flat-combining batches
    for r in range(R):
        for op in _ops(rng, 4):
            both("enqueue_mut", op, _TOKEN, rid=r)
    both("flush")
    for r in range(R):
        both("responses", _TOKEN, rid=r)
    _same_log(jn, tn, "after flush")
    # caller-assembled batches and the split round
    both("execute_mut_batch", _ops(rng, 40), 1)
    ops = _ops(rng, 20)
    jp, tp = jn.begin_mut_batch(ops, 2), tn.begin_mut_batch(ops, 2)
    assert jn.finish_mut_batch(jp) == tn.finish_mut_batch(tp)
    ops = _ops(rng, 12)
    jp, tp = jn.begin_mut_batch(ops, 0), tn.begin_mut_batch(ops, 0)
    with pytest.raises(RuntimeError):
        tn.begin_mut_batch(ops, 0)  # at most one split round per replica
    jn.abort_mut_batch(jp)
    tn.abort_mut_batch(tp)
    both("execute_mut_batch", _ops(rng, 30), 0)
    _same_log(jn, tn, "after split rounds")
    # reads: synced, stale, bounded
    for k in range(0, K, 4):
        both("execute", (1, k), _TOKEN, rid=k % R)
        both("execute_stale", (1, k), _TOKEN, rid=(k + 1) % R)
        both("execute_stale_bounded", (1, k), _TOKEN, 0, rid=(k + 2) % R)
    for r in range(R):
        both("read_lag", r)
        both("ltail", r)
    # quarantine replica 2 mid-stream, write past it, repair it
    both("fence_replica", 2)
    with pytest.raises(ReplicaFencedError):
        tn.execute((1, 0), tt[2])
    for _ in range(3):
        both("execute_mut_batch", _ops(rng, 60), 0)
        both("execute", (1, int(rng.integers(K))), _TOKEN, rid=1)
    _same_log(jn, tn, "fenced")
    _same_state(jn, tn, "fenced")
    assert both("clone_replica_from", 2) == (0, jn.ltail(0))
    both("unfence_replica", 2)
    both("sync")
    _same_state(jn, tn, "repaired")
    assert tn.replicas_equal()
    # enough traffic to wrap the 512-slot ring twice
    while int(tn.log.tail) <= 2 * 512 + 100:
        both("execute_mut_batch", _ops(rng, 100), int(rng.integers(R)))
        both("execute", (1, int(rng.integers(K))), _TOKEN,
             rid=int(rng.integers(R)))
    both("sync")
    _same_log(jn, tn, "end")
    _same_state(jn, tn, "end")
    assert jn.verify(lambda s: s["values"].tolist()) == \
        tn.verify(lambda s: s["values"].tolist())
    if engine == "pallas":
        assert tn.stats()["fused_rounds"] > 0
        assert tn.last_round_tier == "pallas_fused"
        assert FUSED_KERNEL.launches == 0  # CPU: the plain version ran


class _Token:
    pass


_TOKEN = _Token()


def test_auto_calibration_commits_a_verdict(monkeypatch):
    # the CPU-test hook arms winner selection (on a CUDA device it arms
    # by itself); both tiers run real rounds, so results never differ
    monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
    reg = get_registry()
    reg.enable()
    try:
        nr = TNR(t_make_hashmap(K), engine="auto", device="cpu", **KW)
        ref = TNR(t_make_hashmap(K), engine="scan", device="cpu", **KW)
        assert nr.stats()["fused_tier"] == "calibrating"
        rng = np.random.default_rng(4)
        for _ in range(8):
            ops = _ops(rng, 16)
            assert nr.execute_mut_batch(ops, 0) == \
                ref.execute_mut_batch(ops, 0)
        assert nr.stats()["fused_tier"] in ("auto:pallas_fused",
                                            "auto:chain")
        nr.sync()
        ref.sync()
        for f in ("values", "present"):
            assert torch.equal(nr.states[f], ref.states[f])
    finally:
        reg.disable()


def test_pallas_engine_validation():
    with pytest.raises(ValueError):
        TNR(t_make_hashmap(K), engine="pallas", debug=True, device="cpu",
            **KW)
    with pytest.raises(ValueError):
        TNR(t_make_hashmap(K), engine="bogus", device="cpu", **KW)


def test_fault_plane_matches_reference():
    # the port's copy of the fault plane: same chaos schedules from the
    # same seeds, and the same raise/corrupt faults at the round's hook
    # sites leave both wrappers in bit-identical (corrupted) states
    from node_replication_tpu.fault import inject as jinj

    from node_replication_torch.fault import inject as tinj

    for seed in range(5):
        assert (tinj.FaultPlan.chaos(seed, n_replicas=R).schedule()
                == jinj.FaultPlan.chaos(seed, n_replicas=R).schedule())
    rng = np.random.default_rng(9)
    jn, tn = _twins("combined")
    jt, tt = jn.register(0), tn.register(0)

    def specs(m):
        return [m.FaultSpec("append", "raise", rid=0),
                m.FaultSpec("replay", "corrupt", rid=1, after=1)]

    jplan, tplan = jinj.FaultPlan(specs(jinj)), tinj.FaultPlan(specs(tinj))
    with jplan.armed(), tplan.armed():
        with pytest.raises(jinj.FaultError):
            jn.execute_mut((1, 3, 4), jt)
        with pytest.raises(tinj.FaultError):
            tn.execute_mut((1, 3, 4), tt)
        for _ in range(3):
            ops = _ops(rng, 10)
            assert jn.execute_mut_batch(ops, 0) == \
                tn.execute_mut_batch(ops, 0)
    assert jplan.fired == tplan.fired
    assert [f["action"] for f in tplan.fired] == ["raise", "corrupt"]
    _same_state(jn, tn, "corrupted")
    assert not tn.replicas_equal()


@pytest.mark.parametrize("fence", [None, 0, 2])
def test_exec_round_equals_reference_static_window(fence):
    # the port's scan round replays only up to the largest lag of a
    # live replica (`_round_window`), where the reference scans the
    # whole static exec_window every round: hold each round's progress,
    # ring, cursors, states and delivered responses against the
    # reference, with live lags of up to four windows and a fenced
    # replica left behind
    from node_replication_torch.utils.trace import get_tracer

    W = 8
    kw = {**KW, "exec_window": W}
    jn = JNR(j_make_hashmap(K), engine="scan", **kw)
    tn = TNR(t_make_hashmap(K), engine="scan", device="cpu", **kw)
    rng = np.random.default_rng(50 + (3 if fence is None else fence))
    ops = _ops(rng, 30)
    assert jn.execute_mut_batch(ops, 0) == tn.execute_mut_batch(ops, 0)
    if fence is not None:
        jn.fence_replica(fence)
        tn.fence_replica(fence)
    live = [r for r in range(R) if r != fence]
    pending = []
    for r, n in zip(live, (3 * W - 1, W + 3)):
        ops = _ops(rng, n)
        pending.append((jn.begin_mut_batch(ops, r),
                        tn.begin_mut_batch(ops, r)))
    _same_log(jn, tn, "begun")
    tracer = get_tracer()
    tracer.enable(None)
    try:
        rounds = 0
        while True:
            progressed = jn._exec_round()
            assert tn._exec_round() == progressed, rounds
            _same_log(jn, tn, f"round {rounds}")
            _same_state(jn, tn, f"round {rounds}")
            if not progressed:
                break
            rounds += 1
        windows = [e["window"] for e in tracer.events()
                   if e["event"] == "exec-round"]
    finally:
        tracer.disable()
    assert rounds >= 4
    assert windows[0] == W and min(windows) < W
    for jp, tp in pending:
        assert jn.finish_mut_batch(jp) == tn.finish_mut_batch(tp)
    _same_log(jn, tn, "finished")
    _same_state(jn, tn, "finished")
