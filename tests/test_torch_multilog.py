"""Differential tests of the port's stacked multi-log
(`node_replication_torch/core/multilog.py`) against the reference:
twins of `tests/test_multilog.py`, plus every replay engine of
`multilog_exec_all` (sequential fold, partitioned scan, combined,
combined lock-step) and `make_multilog_step` driven with the same
numpy-seeded op streams through both packages. Rings, int64 cursors,
states and responses must be bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_torch.core.multilog import (
    MultiLogSpec,
    is_log_synced_for_reads,
    make_multilog_step,
    multilog_append,
    multilog_exec_all,
    multilog_init,
    multilog_space,
    partition_ops,
)
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.models import (
    HM_GET,
    HM_PUT,
    make_hashmap,
    make_partitioned_hashmap,
)
from node_replication_torch.utils.checks import CheckError
from node_replication_tpu.core import multilog as jml
from node_replication_tpu.core.replica import replicate_state as j_replicate

import node_replication_tpu.models as jm
import node_replication_torch.models as tm

CPU = "cpu"


def spec4(nlogs=2, R=2, cap=64, slack=8, mod=None):
    return (mod.MultiLogSpec if mod else MultiLogSpec)(
        nlogs=nlogs, capacity=cap, n_replicas=R, arg_width=3,
        gc_slack=slack)


def key_mapper(opcode, args):
    return args[0]


def _eq(a, b, what=""):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _same_ml(jml_state, tml_state):
    for f in jml_state._fields:
        _eq(getattr(jml_state, f), getattr(tml_state, f), f)


def _same_tree(js, ts):
    assert set(js) == set(ts)
    for f in js:
        _eq(js[f], ts[f], f)


class TestPartition:
    def test_partition_by_key(self):
        ops = [(HM_PUT, (0, 10)), (HM_PUT, (1, 11)), (HM_PUT, (2, 12)),
               (HM_PUT, (3, 13))]
        opc, args, counts, placements = partition_ops(
            key_mapper, 2, ops, 3, device=CPU)
        assert counts.tolist() == [2, 2] and counts.dtype == torch.int64
        assert placements == [(0, 0), (1, 0), (0, 1), (1, 1)]
        assert args[0, :, 0].tolist() == [0, 2]
        assert args[1, :, 0].tolist() == [1, 3]
        want = jml.partition_ops(key_mapper, 2, ops, 3)
        for a, b in zip(want[:3], (opc, args, counts)):
            _eq(a, b)


class TestMultiLog:
    def test_append_exec_converges_all_replicas(self):
        spec = spec4()
        d = make_hashmap(16)
        ml = multilog_init(spec, CPU)
        states = replicate_state(d.init_state(CPU), spec.n_replicas)
        ops = [(HM_PUT, (k, 100 + k)) for k in range(8)]
        opc, args, counts, _ = partition_ops(key_mapper, 2, ops, 3,
                                             device=CPU)
        ml = multilog_append(spec, ml, opc, args, counts)
        assert ml.tail.tolist() == [4, 4]
        ml, states, resps = multilog_exec_all(spec, d, ml, states, 4)
        assert (ml.ltails == 4).all() and (ml.head == 4).all()
        v = states["values"]
        assert (v == v[0:1]).all()
        assert v[0, :8].tolist() == [100 + k for k in range(8)]

    def test_per_log_sync_tracking(self):
        spec = spec4()
        d = make_hashmap(16)
        ml = multilog_init(spec, CPU)
        states = replicate_state(d.init_state(CPU), spec.n_replicas)
        ops = [(HM_PUT, (0, 1)), (HM_PUT, (2, 2))]  # both -> log 0
        opc, args, counts, _ = partition_ops(key_mapper, 2, ops, 3,
                                             pad_to=2, device=CPU)
        ml = multilog_append(spec, ml, opc, args, counts)
        assert int(ml.tail[0]) == 2 and int(ml.tail[1]) == 0
        ml, states, _ = multilog_exec_all(spec, d, ml, states, 2)
        assert is_log_synced_for_reads(ml, 0, 0, ml.ctail[0])
        assert is_log_synced_for_reads(ml, 1, 0, ml.ctail[1])
        assert int(ml.ctail[1]) == 0

    def test_space_per_log(self):
        spec = spec4(cap=64, slack=8)
        ml = multilog_init(spec, CPU)
        sp = multilog_space(spec, ml)
        assert sp.tolist() == [56, 56] and sp.dtype == torch.int64


def _stream(rng, nlogs, n, K, opcs, hot=False):
    """`n` ops per log with the congruence invariant, keys of one log
    colliding when `hot`."""
    ops = []
    for l in range(nlogs):
        for _ in range(n):
            k = l + nlogs * int(rng.integers(0, 2 if hot else K // nlogs))
            ops.append((int(rng.choice(opcs)),
                        (k, int(rng.integers(0, 1000)))))
    return ops


@pytest.mark.parametrize("engine", ["sequential", "partitioned_scan",
                                    "combined", "lockstep"])
def test_exec_all_engines_bit_identical(engine):
    # one op stream through both packages' multilog_exec_all, engine by
    # engine: rings, int64 cursors, states and every response; the
    # replicas start on divergent cursors except under lock-step
    nlogs, R, K, B = 4, 3, 32, 5
    jspec, tspec = spec4(nlogs, R, 128, 8, jml), spec4(nlogs, R, 128, 8)
    part = engine != "sequential"
    jpm = jm.make_partitioned_hashmap(K, nlogs) if part else None
    tpm = tm.make_partitioned_hashmap(K, nlogs) if part else None
    combined = {"partitioned_scan": False, "combined": True,
                "lockstep": True}.get(engine)
    lockstep = engine == "lockstep"
    jd, td = jm.make_hashmap(K), tm.make_hashmap(K)
    j = (jml.multilog_init(jspec), j_replicate(jd.init_state(), R))
    t = (multilog_init(tspec, CPU), replicate_state(td.init_state(CPU), R))
    rng = np.random.default_rng(3)
    jexec = jax.jit(
        lambda m, s, w: jml.multilog_exec_all(
            jspec, jd, m, s, w, partitioned=jpm, combined=combined,
            lockstep=lockstep),
        static_argnums=(2,))
    for step in range(5):
        ops = _stream(rng, nlogs, B, K, [HM_PUT, HM_PUT, 2, 0, 7],
                      hot=step % 2 == 1)
        opc, args, counts, _ = jml.partition_ops(key_mapper, nlogs, ops, 3,
                                                 pad_to=B)
        if not lockstep and step == 2:
            counts = counts.at[1].set(2)  # a short bucket
        tml = multilog_append(tspec, t[0], torch.from_numpy(np.array(opc)),
                              torch.from_numpy(np.array(args)),
                              torch.from_numpy(np.array(counts)))
        jm_ = jml.multilog_append(jspec, j[0], opc, args, counts)
        _same_ml(jm_, tml)
        # off lock-step, replay a window shorter than the appended span
        # so that cursors lag and windows start mid-span
        w = B if lockstep else (3 if step % 2 else 2 * B)
        jm_, jst, jr = jexec(jm_, j[1], w)
        tml, tst, tr = multilog_exec_all(
            tspec, td, tml, t[1], w, partitioned=tpm, combined=combined,
            lockstep=lockstep)
        _eq(jr, tr, "resps")
        _same_ml(jm_, tml)
        _same_tree(jst, tst)
        j, t = (jm_, jst), (tml, tst)


@pytest.mark.parametrize("partitioned", [False, True])
def test_step_bit_identical_and_matches_shadow(partitioned):
    # `TestMultiLogStep::test_step_matches_shadow`, with and without a
    # partitioned model, through both packages' make_multilog_step
    nlogs, R, K = 4, 3, 32
    jspec, tspec = spec4(nlogs, R, 64, 8, jml), spec4(nlogs, R, 64, 8)
    jpm = jm.make_partitioned_hashmap(K, nlogs) if partitioned else None
    tpm = tm.make_partitioned_hashmap(K, nlogs) if partitioned else None
    jd, td = jm.make_hashmap(K), tm.make_hashmap(K)
    jstep = jml.make_multilog_step(jd, jspec, 4, 2, partitioned=jpm,
                                   donate=False)
    tstep = make_multilog_step(td, tspec, 4, 2, partitioned=tpm)
    j = [jml.multilog_init(jspec), j_replicate(jd.init_state(), R)]
    t = [multilog_init(tspec, CPU), replicate_state(td.init_state(CPU), R)]
    rng = np.random.default_rng(7)
    shadow = {}
    for _ in range(4):
        ops = _stream(rng, nlogs, 4, K, [HM_PUT, HM_PUT, 2])
        opc, args, counts, _ = jml.partition_ops(key_mapper, nlogs, ops, 3,
                                                 pad_to=4)
        rk = rng.integers(0, K, (R, 2)).astype(np.int32)
        rd_opc = np.full((R, 2), HM_GET, np.int32)
        rd_args = np.zeros((R, 2, 3), np.int32)
        rd_args[:, :, 0] = rk
        j[0], j[1], jwr, jrd = jstep(j[0], j[1], opc, args, counts,
                                     jnp.asarray(rd_opc),
                                     jnp.asarray(rd_args))
        t[0], t[1], twr, trd = tstep(
            t[0], t[1], *(torch.from_numpy(np.array(x))
                          for x in (opc, args, counts)),
            torch.from_numpy(rd_opc), torch.from_numpy(rd_args))
        _eq(jwr, twr, "wr")
        _eq(jrd, trd, "rd")
        _same_ml(j[0], t[0])
        _same_tree(j[1], t[1])
        for opcode, (k, v) in ops:
            if opcode == HM_PUT:
                shadow[k] = v
            else:
                shadow.pop(k, None)
        for r in range(R):
            for c in range(2):
                assert int(trd[r, c]) == shadow.get(int(rk[r, c]), -1)
    v = t[1]["values"]
    assert (v == v[0:1]).all()


class TestLockstepDebugCheck:
    def test_debug_step_runs_clean_in_lockstep(self):
        pm = make_partitioned_hashmap(32, 2)
        spec = spec4(nlogs=2, R=2, cap=64, slack=8)
        step = make_multilog_step(pm.full, spec, writes_per_log=2,
                                  reads_per_replica=1, partitioned=pm,
                                  debug=True)
        ml = multilog_init(spec, CPU)
        states = replicate_state(pm.full.init_state(CPU), 2)
        ops = [(HM_PUT, (0, 7)), (HM_PUT, (1, 8)), (HM_PUT, (2, 9)),
               (HM_PUT, (3, 1))]
        opc, args, counts, _ = partition_ops(key_mapper, 2, ops, 3,
                                             pad_to=2, device=CPU)
        rd_opc = torch.full((2, 1), HM_GET, dtype=torch.int32)
        rd_args = torch.zeros((2, 1, 3), dtype=torch.int32)
        ml, states, _, rd = step(ml, states, opc, args, counts, rd_opc,
                                 rd_args)
        assert int(rd[0, 0]) == 7

    def test_divergent_ltails_raise_under_checks(self):
        from node_replication_torch.utils.checks import debug_checks

        pm = make_partitioned_hashmap(32, 2)
        spec = spec4(nlogs=2, R=2, cap=64, slack=8)
        ml = multilog_init(spec, CPU)
        states = replicate_state(pm.full.init_state(CPU), 2)
        ops = [(HM_PUT, (0, 7)), (HM_PUT, (1, 8))]
        opc, args, counts, _ = partition_ops(key_mapper, 2, ops, 3,
                                             pad_to=1, device=CPU)
        ml = multilog_append(spec, ml, opc, args, counts)
        lt = ml.ltails.clone()
        lt[0, 1] = 1
        ml = ml._replace(ltails=lt)
        # disarmed, the precondition is not read (ltails[0] is imposed)
        multilog_exec_all(spec, pm.full, ml, states, 1, partitioned=pm,
                          combined=True, lockstep=True)
        with debug_checks(True):
            with pytest.raises(CheckError, match="lockstep"):
                multilog_exec_all(spec, pm.full, ml, states, 1,
                                  partitioned=pm, combined=True,
                                  lockstep=True)


def test_step_rejects_batch_past_capacity_and_counts_engines():
    from node_replication_torch.obs.metrics import get_registry

    spec = spec4(nlogs=2, R=2, cap=64, slack=8)
    with pytest.raises(ValueError, match="appendable capacity"):
        make_multilog_step(make_hashmap(8), spec, 57, 1)
    reg = get_registry()
    was = reg.enabled
    reg.enable()
    try:
        c = reg.counter("multilog.engine.combined_lockstep")
        before = c.value
        pm = make_partitioned_hashmap(32, 2)
        step = make_multilog_step(pm.full, spec, 2, 1, partitioned=pm)
        ml = multilog_init(spec, CPU)
        states = replicate_state(pm.full.init_state(CPU), 2)
        z = torch.zeros((2, 2), dtype=torch.int32)
        step(ml, states, z, torch.zeros((2, 2, 3), dtype=torch.int32),
             torch.zeros((2,), dtype=torch.int64),
             torch.zeros((2, 1), dtype=torch.int32),
             torch.zeros((2, 1, 3), dtype=torch.int32))
        assert c.value == before + 1
    finally:
        if not was:
            reg.disable()
