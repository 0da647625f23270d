"""Differential tests of the port's `MultiLogReplicated`
(`node_replication_torch/core/cnr.py`) against the reference: twins of
`tests/test_cnr.py`, of `tests/test_pallas_fused.py::TestCNRFused` (the
fused per-log tier, K1 through its plain version on the CPU) and of
`tests/test_serve.py`'s `MultiLogReplicated` cases, plus the per-op,
batch and split-round paths driven with one numpy-seeded stream
through both packages: responses, rings, int64 cursors, states and
counters must be bit-identical."""

import random

import numpy as np
import pytest
import torch

import node_replication_torch.models as tmods
import node_replication_tpu.models as jm
from node_replication_torch.core.cnr import MultiLogReplicated
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    OA_GET,
    OA_PUT,
    OA_REMOVE,
    SR_GET,
    SR_SET,
    make_hashmap,
    make_oahashmap,
    make_seqreg,
    make_sortedset,
    sortedset_log_mapper,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops import replay
from node_replication_torch.serve import ServeConfig, ServeFrontend
from node_replication_tpu.core.cnr import MultiLogReplicated as JMulti
from node_replication_tpu.core.replica import NodeReplicated as JNode
from node_replication_tpu.serve import ServeConfig as JServeConfig
from node_replication_tpu.serve import ServeFrontend as JServeFrontend

CPU = "cpu"


def _key_mapper(opcode, args):
    return args[0]


def cnr(d, **kw):
    kw.setdefault("device", CPU)
    return MultiLogReplicated(d, _key_mapper, **kw)


def _same(j, t):
    """Rings, cursors and states of a reference and a port CNR fleet."""
    for f in j.ml._fields:
        a, b = np.asarray(getattr(j.ml, f)), getattr(t.ml, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in j.states:
        a, b = np.asarray(j.states[f]), t.states[f].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def twins(make, mapper=_key_mapper, **kw):
    """The same fleet in both packages: `make(models)` builds the
    dispatch from the reference's or the port's models module."""
    return (JMulti(make(jm), mapper, **kw),
            MultiLogReplicated(make(tmods), mapper, device=CPU, **kw))


def both(j, t, run):
    """`run(fleet)` on the reference and on the port: equal results,
    rings, cursors and states; returns the port's result."""
    a, b = run(j), run(t)
    assert a == b
    _same(j, t)
    return b


class TestMultiLogReplicated:
    def test_basic_write_read_across_replicas(self):
        def run(c):
            t0, t1 = c.register(0), c.register(1)
            return [c.execute_mut((1, 5, 55), t0), c.execute((1, 5), t1),
                    c.execute_mut((2, 5), t1), c.execute((1, 5), t0)]

        assert both(*twins(lambda m: m.make_hashmap(64), nlogs=4,
                           n_replicas=2, log_entries=1 << 10, gc_slack=32),
                    run) == [0, 55, 1, -1]

    def test_execute_mut_preserves_enqueue_mut_backlog(self):
        def run(c):
            t = c.register(0)
            c.enqueue_mut((1, 0, 100), t)
            c.enqueue_mut((1, 1, 101), t)
            out = [c.execute_mut((2, 0), t), c.responses(t)]
            c.flush()
            return out + [c.responses(t), c.execute((1, 1), t)]

        assert both(*twins(lambda m: m.make_hashmap(64), nlogs=4,
                           n_replicas=1, log_entries=1 << 10, gc_slack=32),
                    run) == [1, [0], [0], 101]

    def test_ops_partition_over_logs(self):
        def run(c):
            t = c.register(0)
            for k in range(16):
                c.execute_mut((1, k, k), t)
            return c.stats()

        st = both(*twins(lambda m: m.make_hashmap(64), nlogs=4,
                         n_replicas=1, log_entries=1 << 10, gc_slack=32),
                  run)
        assert st["tails"] == [4, 4, 4, 4]

    def test_differential_vs_single_log(self):
        # the CNR fleets of both packages and the port's single-log
        # fleet answer every op alike
        rng = random.Random(9)
        kw = dict(n_replicas=2, log_entries=1 << 10, gc_slack=32)
        j, c = twins(lambda m: m.make_hashmap(32), nlogs=4, **kw)
        nr = NodeReplicated(make_hashmap(32), device=CPU, **kw)
        jt = [j.register(r) for r in range(2)]
        ct = [c.register(r) for r in range(2)]
        nt = [nr.register(r) for r in range(2)]
        for _ in range(120):
            r, k = rng.randrange(2), rng.randrange(32)
            op = ((1, k, rng.randrange(1000)) if rng.random() < 0.6
                  else (2, k))
            got = c.execute_mut(op, ct[r])
            assert got == j.execute_mut(op, jt[r])
            assert got == nr.execute_mut(op, nt[r])
        for f in (c, j, nr):
            f.sync()
        _same(j, c)
        assert c.replicas_equal() and nr.replicas_equal()
        a, b = c.verify(lambda s: s), nr.verify(lambda s: s)
        np.testing.assert_array_equal(a["values"], b["values"])
        np.testing.assert_array_equal(a["present"], b["present"])

    def test_sortedset_with_its_mapper(self):
        def run(c):
            t = c.register(0)
            out = [c.execute_mut((1, k), t) for k in (3, 7, 11)]
            out.append(c.execute((2, 0, 16), c.register(1)))
            c.sync()
            return out + [c.replicas_equal()]

        assert both(*twins(lambda m: m.make_sortedset(128),
                           sortedset_log_mapper, nlogs=2, n_replicas=2,
                           log_entries=1 << 10, gc_slack=32),
                    run) == [1, 1, 1, 3, True]

    def test_gc_callback_fires_on_starved_log(self):
        events = {"j": [], "t": []}
        kw = dict(nlogs=2, n_replicas=1, log_entries=1 << 10, gc_slack=32,
                  exec_window=4)
        j = JMulti(jm.make_hashmap(16), _key_mapper, **kw,
                   gc_callback=lambda log, rid: events["j"].append(
                       (log, rid)))
        t = cnr(make_hashmap(16), **kw,
                gc_callback=lambda log, rid: events["t"].append((log, rid)))
        j._watchdog(63, 1, "test")
        t._watchdog(63, 1, "test")
        assert events["j"] == events["t"] == [(1, 0)]

    def test_mesh_and_bad_engine_refused(self):
        # a mesh that is not a ('replica', 'log') Mesh, as the
        # reference refuses it
        for mk, cls, kw in ((make_hashmap, MultiLogReplicated,
                             {"device": CPU}),
                            (jm.make_hashmap, JMulti, {})):
            with pytest.raises(ValueError, match="'replica', 'log'"):
                cls(mk(16), _key_mapper, nlogs=2, mesh=object(), **kw)
        for mk, cls, kw in ((make_hashmap, MultiLogReplicated,
                             {"device": CPU}),
                            (jm.make_hashmap, JMulti, {})):
            with pytest.raises(ValueError, match="unknown engine"):
                cls(mk(16), _key_mapper, nlogs=2, engine="combined", **kw)
        with pytest.raises(ValueError, match="fused_factory"):
            cnr(make_seqreg(4), nlogs=2, engine="pallas")


class TestOaHashmap:
    """`tests/test_cnr.py::TestOaHashmap`, reference and port side by
    side."""

    def _twins(self, n, probe, R):
        kw = dict(n_replicas=R, log_entries=1 << 10, gc_slack=32)
        j, t = JNode(jm.make_oahashmap(n, probe=probe), **kw), \
            NodeReplicated(make_oahashmap(n, probe=probe), device=CPU, **kw)
        return j, t, j.register(0), t.register(0)

    def test_shadow_model_with_collisions(self):
        j, t, jt, tt = self._twins(32, 8, 2)
        shadow = {}
        rng = random.Random(4)
        for _ in range(150):
            k = rng.randrange(-50, 50)
            p = rng.random()
            if p < 0.5:
                op = (OA_PUT, k, rng.randrange(1000))
                resp = t.execute_mut(op, tt)
                assert resp == j.execute_mut(op, jt)
                if resp == 0:
                    shadow[k] = op[2]
                else:
                    assert resp == -2
            elif p < 0.75:
                resp = t.execute_mut((OA_REMOVE, k), tt)
                assert resp == j.execute_mut((OA_REMOVE, k), jt)
                assert resp == (1 if k in shadow else 0)
                shadow.pop(k, None)
            else:
                assert t.execute((OA_GET, k), tt) == shadow.get(k, -1)
        t.sync()
        assert t.replicas_equal()

    def test_update_in_place_prefers_match_over_tombstone(self):
        j, t, jt, tt = self._twins(16, 16, 1)
        for op in ((OA_PUT, 1, 10), (OA_PUT, 2, 20), (OA_REMOVE, 2, 0),
                   (OA_PUT, 1, 11)):
            assert t.execute_mut(op, tt) == j.execute_mut(op, jt)
        assert t.execute((OA_GET, 1), tt) == 11
        t.verify(lambda s: ((s["flag"] == 1) & (s["keys"] == 1)).sum() == 1
                 or (_ for _ in ()).throw(AssertionError("two slots")))

    def test_window_full_drops_deterministically(self):
        j, t, jt, tt = self._twins(64, 2, 2)
        resps = [t.execute_mut((OA_PUT, k, k), tt) for k in range(64)]
        assert resps == [j.execute_mut((OA_PUT, k, k), jt)
                         for k in range(64)]
        assert -2 in resps
        t.sync()
        assert t.replicas_equal()


def _ops(rng, n, K):
    return [(int(rng.choice([1, 1, 2])), int(rng.integers(-K, 2 * K)),
             int(rng.integers(0, 1 << 20))) for _ in range(n)]


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_op_stream_bit_identical(engine):
    # per-op writes and reads, staged writes with flush, serial batches
    # and split rounds (with an abort) from rotating replicas through
    # both packages; on the fused tier every per-log sub-batch is one K1
    # round (its plain version here), the reference's in interpret mode
    K, L, R = 23, 3, 3
    kw = dict(nlogs=L, n_replicas=R, log_entries=256, gc_slack=32,
              exec_window=8, engine=engine)
    j = JMulti(jm.make_hashmap(K), _key_mapper, **kw)
    t = cnr(make_hashmap(K), **kw)
    jt = [j.register(r) for r in range(R)]
    tt = [t.register(r) for r in range(R)]
    rng = np.random.default_rng(5)
    before = replay.FUSED_KERNEL.launches
    for i in range(14):
        r = int(rng.integers(R))
        kind = i % 5
        if kind == 0:
            ops = _ops(rng, int(rng.integers(1, 40)), K)
            assert t.execute_mut_batch(ops, r) == \
                j.execute_mut_batch(ops, r)
        elif kind == 1:
            ops = _ops(rng, int(rng.integers(1, 12)), K)
            pt, pj = t.begin_mut_batch(ops, r), j.begin_mut_batch(ops, r)
            assert t.finish_mut_batch(pt) == j.finish_mut_batch(pj)
        elif kind == 2:
            for op in _ops(rng, 3, K):
                t.enqueue_mut(op, tt[r])
                j.enqueue_mut(op, jt[r])
            t.flush(r)
            j.flush(r)
            assert t.responses(tt[r]) == j.responses(jt[r])
        elif kind == 3:
            for op in _ops(rng, 4, K):
                assert t.execute_mut(op, tt[r]) == j.execute_mut(op, jt[r])
                rop = (1, op[1])
                assert t.execute(rop, tt[(r + 1) % R]) == \
                    j.execute(rop, jt[(r + 1) % R])
        else:
            ops = _ops(rng, 6, K)
            t.abort_mut_batch(t.begin_mut_batch(ops, r))
            j.abort_mut_batch(j.begin_mut_batch(ops, r))
        _same(j, t)
    st, sj = t.stats(), j.stats()
    assert st == sj
    if engine == "pallas":
        assert st["fused_tier"] == "forced" and st["exec_rounds"] == 0
        assert replay.FUSED_KERNEL.launches == before  # the CPU twin
    t.sync()
    j.sync()
    _same(j, t)
    assert t.snapshot()["logs"] == j.snapshot()["logs"]


class TestCNRFused:
    def test_per_log_sub_batches_bit_identical(self):
        # `tests/test_pallas_fused.py::TestCNRFused`
        reg = get_registry()
        was = reg.enabled
        reg.enable()
        try:
            ctr = reg.counter("cnr.exec.engine.pallas_fused")
            before = ctr.value
            kw = dict(nlogs=3, n_replicas=2, log_entries=512, gc_slack=64)
            c_f = cnr(make_hashmap(23), engine="pallas", **kw)
            c_s = cnr(make_hashmap(23), engine="scan", **kw)
            rng = np.random.RandomState(3)
            ops = [(1 if rng.rand() < 0.7 else 2, int(rng.randint(23)),
                    int(rng.randint(1000))) for _ in range(34)]
            assert c_f.execute_mut_batch(ops[:24], rid=0) == \
                c_s.execute_mut_batch(ops[:24], rid=0)
            t_f, t_s = c_f.register(1), c_s.register(1)
            for op in ops[24:]:
                assert c_f.execute_mut(op, t_f) == c_s.execute_mut(op, t_s)
            c_f.sync()
            c_s.sync()
            for f in ("values", "present"):
                assert torch.equal(c_f.states[f], c_s.states[f])
            for f in c_f.ml._fields:
                assert torch.equal(getattr(c_f.ml, f), getattr(c_s.ml, f))
            st = c_f.stats()
            assert st["fused_tier"] == "forced"
            assert st["fused_rounds"] == sum(st["combine_rounds"]) > 0
            assert st["exec_rounds"] == 0
            assert ctr.value == before + st["fused_rounds"]
            for k in (1, 5, 22):
                assert c_f.execute((1, k), t_f) == c_s.execute((1, k), t_s)
            assert c_f.round_tier(1) == "pallas_fused"
        finally:
            if not was:
                reg.disable()

    def test_fused_round_leaves_the_other_logs_rows(self):
        # a per-log fused round writes its own ring row back in place:
        # every other log's ring and cursors are untouched
        c = cnr(make_hashmap(16), nlogs=4, n_replicas=2, log_entries=256,
                gc_slack=32, engine="pallas")
        c.execute_mut_batch([(1, k, 100 + k) for k in range(16)], rid=0)
        snap = {f: getattr(c.ml, f).clone() for f in c.ml._fields}
        c.execute_mut_batch([(1, 5, 7), (2, 9, 0)], rid=1)  # log 1 only
        for f in c.ml._fields:
            now = getattr(c.ml, f)
            for l in (0, 2, 3):
                assert torch.equal(now[l], snap[f][l]), (f, l)
        assert c.ml.tail.tolist() == [4, 6, 4, 4]
        assert c.execute((1, 5), c.register(0)) == 7


# ------------------------------------------------------------ serving


def seqreg_twins(n_replicas=2):
    return twins(lambda m: m.make_seqreg(4), nlogs=2, n_replicas=n_replicas,
                 log_entries=128, gc_slack=8, exec_window=16)


def fast_cfg(**kw):
    kw.setdefault("batch_linger_s", 0.0)
    return ServeConfig(**kw)


def _set_stream(n):
    ops, expect, counts = [], [], [0, 0, 0, 0]
    for i in range(n):
        slot = i % 4
        ops.append((SR_SET, slot, counts[slot] + 1))
        expect.append(counts[slot])
        counts[slot] += 1
    return ops, expect


class TestServeOverCnr:
    """`tests/test_serve.py`'s `MultiLogReplicated` cases, each through
    the reference and the port."""

    def test_cnr_batch_submission_order_across_logs(self):
        ops, expect = _set_stream(40)

        def run(c):
            out = c.execute_mut_batch(ops, rid=0)
            c.sync()
            return out, c.replicas_equal()

        assert both(*seqreg_twins(), run) == (expect, True)

    def test_cnr_empty_and_bad_rid(self):
        for c in seqreg_twins(n_replicas=1):
            assert c.execute_mut_batch([], rid=0) == []
            with pytest.raises(ValueError):
                c.execute_mut_batch([(SR_SET, 0, 1)], rid=3)

    def test_cnr_failed_batch_does_not_wedge_replica(self, monkeypatch):
        j, t = seqreg_twins(n_replicas=1)
        state = {"fail": 0}
        for cls in (JMulti, MultiLogReplicated):
            def flaky(self_ml, log_idx, orig=cls._exec_round):
                if state["fail"]:
                    state["fail"] -= 1
                    raise RuntimeError("injected replay failure")
                return orig(self_ml, log_idx)

            monkeypatch.setattr(cls, "_exec_round", flaky)

        def run(c):
            state["fail"] = 1
            with pytest.raises(RuntimeError):
                c.execute_mut_batch([(SR_SET, 0, 1), (SR_SET, 1, 1)], rid=0)
            # the failed batch's first log pass appended; its replay and
            # the second log's pass did not run: slot 0 holds 1, slot 1
            # nothing
            return c.execute_mut_batch([(SR_SET, 0, 2), (SR_SET, 1, 2)],
                                       rid=0)

        assert both(j, t, run) == [1, 0]

    def test_cnr_begin_finish_scatter(self):
        ops, expect = _set_stream(16)

        def run(c):
            pending = c.begin_mut_batch(ops, rid=0)
            with pytest.raises(RuntimeError):
                c.begin_mut_batch([(SR_SET, 0, 99)], rid=0)
            with pytest.raises(RuntimeError):
                c.execute_mut_batch([(SR_SET, 0, 99)], rid=0)
            out = c.finish_mut_batch(pending)
            with pytest.raises(RuntimeError):
                c.finish_mut_batch(pending)
            c.sync()
            return out, c.replicas_equal()

        assert both(*seqreg_twins(), run) == (expect, True)

    @pytest.mark.parametrize("depth", [0, 1])
    def test_frontend_over_cnr(self, depth):
        n = 16 if depth == 0 else 32
        j, t = seqreg_twins()

        def run(c):
            front, cfg = ((JServeFrontend, JServeConfig)
                          if isinstance(c, JMulti)
                          else (ServeFrontend, ServeConfig))
            with front(c, cfg(batch_linger_s=0.0, pipeline_depth=depth,
                              batch_max_ops=4)) as fe:
                futs = [fe.submit((SR_SET, i % 4, i // 4 + 1), rid=i % 2)
                        for i in range(n)]
                out = [f.result(30.0) for f in futs]
                out.append(fe.read((SR_GET, 2), rid=1))
            assert fe.nr is c
            return out

        assert both(j, t, run) == [i // 4 for i in range(n)] + [n // 4]

    def test_frontend_over_fused_cnr_hashmap(self):
        # the served hashmap fleet on the fused tier: every per-log
        # sub-batch one K1 round (the reference's in interpret mode, the
        # port's plain version), answers and stats equal to the
        # reference's, and states equal to a port scan twin's
        def run(c):
            front, cfg = ((JServeFrontend, JServeConfig)
                          if isinstance(c, JMulti)
                          else (ServeFrontend, ServeConfig))
            with front(c, cfg(batch_linger_s=0.0, batch_max_ops=8)) as fe:
                got = [fe.submit((1 + (i % 3 == 2), i % 40, i),
                                 rid=i % 2).result(30.0)
                       for i in range(60)]
                got += [fe.read((1, k), rid=k % 2) for k in range(40)]
            st = c.stats()
            c.sync()
            return got, st

        kw = dict(nlogs=4, n_replicas=2, log_entries=256, gc_slack=32)
        j, t = twins(lambda m: m.make_hashmap(40), engine="pallas", **kw)
        got, st = both(j, t, run)
        assert st["exec_rounds"] == 0
        assert st["fused_rounds"] == sum(st["combine_rounds"]) > 0
        s = cnr(make_hashmap(40), engine="scan", **kw)
        sgot, sst = run(s)
        assert sgot == got and sst["exec_rounds"] > 0
        for f in ("values", "present"):
            assert torch.equal(s.states[f], t.states[f])


def _serve_stream(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        rid = int(rng.integers(2))
        if u < 0.55:
            out.append(("w", (1, int(rng.integers(-n_keys, 2 * n_keys)),
                              int(rng.integers(1 << 20))), rid))
        elif u < 0.8:
            out.append(("w", (2, int(rng.integers(n_keys))), rid))
        else:
            out.append(("r", (1, int(rng.integers(n_keys))), rid))
    return out


@pytest.mark.parametrize("model,engine,depth,n", [
    ("seqreg", "scan", 0, 300), ("seqreg", "scan", 1, 300),
    ("hashmap", "scan", 0, 300), ("hashmap", "pallas", 0, 720),
    ("hashmap", "pallas", 1, 300)])
def test_serve_differential_over_cnr(model, engine, depth, n):
    """One closed-loop client, the same seeded stream through the
    reference's frontend over its `MultiLogReplicated` and the port's
    over the port's: each submit is one per-log combiner round, so both
    fleets see the same rounds (on the fused tier the reference's K1 in
    interpret mode, the port's plain K1). With `n` = 720 every per-log
    ring (256 slots, the least the fused tier takes) wraps."""
    n_keys = 24
    kw = dict(nlogs=2, n_replicas=2, log_entries=256, gc_slack=16,
              exec_window=16, engine=engine)
    j, t = twins(lambda m: getattr(m, "make_" + model)(n_keys), **kw)
    stream = _serve_stream(11, n, n_keys)
    if model == "seqreg":
        stream = [(k, (1,) + op[1:2] + (op[-1],) if k == "w" else op, r)
                  for k, op, r in stream]
    jf = JServeFrontend(j, JServeConfig(batch_linger_s=0.0,
                                        pipeline_depth=depth))
    tf = ServeFrontend(t, ServeConfig(batch_linger_s=0.0,
                                      pipeline_depth=depth))
    try:
        for kind, op, rid in stream:
            if kind == "w":
                a = jf.submit(op, rid=rid).result(timeout=60.0)
                b = tf.submit(op, rid=rid).result(timeout=60.0)
            else:
                a, b = jf.read(op, rid=rid), tf.read(op, rid=rid)
            assert a == b, (kind, op, rid, a, b)
    finally:
        jf.close()
        tf.close()
    _same(j, t)
    assert (t.ml.tail.min().item() > 256) == (n == 720)
    st = t.stats()
    assert st == j.stats()
    assert (st["fused_rounds"] > 0) == (engine == "pallas")
