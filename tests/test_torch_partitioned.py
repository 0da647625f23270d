"""Differential tests of the port's state-partitioned models
(`node_replication_torch/models/partitioned.py`): twins of
`tests/test_partitioned.py`. The congruence split/merge, and replay
through `split -> per-log replay with sub -> merge` bit-identical to the
sequential per-log fold with the full model, for every bundled
`PartitionedModel`, in the port and against the reference's partitioned
replay on the same numpy-seeded streams. The reference's `MultiLogRunner`
cases belong to the harness, which this package has not ported yet
(ROADMAP.md queue 1 item 10); their property (the partitioned runner
equals the fold runner) is held here through `make_multilog_step`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import node_replication_tpu.models as jm
import node_replication_torch.models as tm
from node_replication_torch.core.multilog import (
    MultiLogSpec,
    make_multilog_step,
    multilog_append,
    multilog_exec_all,
    multilog_init,
    partition_ops,
)
from node_replication_torch.core.replica import replicate_state, states_equal
from node_replication_torch.models import (
    FS_TRUNCATE,
    FS_WRITE,
    HM_GET,
    HM_PUT,
    HM_REMOVE,
    SS_INSERT,
    SS_REMOVE,
    make_hashmap,
    make_partitioned_hashmap,
    make_partitioned_sortedset,
)
from node_replication_tpu.core import multilog as jml
from node_replication_tpu.core.replica import replicate_state as j_replicate

CPU = "cpu"


def key_mapper(opcode, args):
    return args[0]


def _mspec(nlogs, R=2, cap=128, slack=8, mod=None):
    return (mod.MultiLogSpec if mod else MultiLogSpec)(
        nlogs=nlogs, capacity=cap, n_replicas=R, arg_width=3,
        gc_slack=slack)


def _eq(a, b, what=""):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


class TestSplitMerge:
    def test_roundtrip_hashmap(self):
        pm = make_partitioned_hashmap(32, 4)
        st = {"values": torch.arange(32, dtype=torch.int32),
              "present": torch.zeros(32, dtype=torch.bool)}
        back = pm.merge(pm.split(st))
        assert back["values"].tolist() == list(range(32))
        # a fleet's leading replica axis: lead=1
        fleet = replicate_state(st, 3)
        sp = pm.split(fleet, lead=1)
        assert tuple(sp["values"].shape) == (3, 4, 8)
        assert torch.equal(pm.merge(sp, lead=1)["values"], fleet["values"])

    def test_split_owns_congruence_classes(self):
        pm = make_partitioned_hashmap(16, 4)
        st = {"values": torch.arange(16, dtype=torch.int32),
              "present": torch.ones(16, dtype=torch.bool)}
        v = pm.split(st)["values"]
        for l in range(4):
            assert v[l].tolist() == [l, l + 4, l + 8, l + 12]
        jv = jm.make_partitioned_hashmap(16, 4).split(
            {k: x.numpy() for k, x in st.items()})["values"]
        _eq(jv, v)

    def test_indivisible_rejected(self):
        with pytest.raises(ValueError):
            make_partitioned_hashmap(30, 4)
        with pytest.raises(ValueError):
            make_partitioned_sortedset(33, 2)
        with pytest.raises(ValueError):
            tm.make_partitioned_memfs(6, 4, 4)

    def test_nlogs_mismatch_rejected(self):
        pm = make_partitioned_hashmap(32, 2)
        spec = _mspec(4)
        ml = multilog_init(spec, CPU)
        states = replicate_state(make_hashmap(32).init_state(CPU), 2)
        with pytest.raises(ValueError):
            multilog_exec_all(spec, pm.full, ml, states, 4, partitioned=pm)


def _ops_hashmap(rng, nlogs, n, K):
    return [(int(rng.choice([HM_PUT, HM_PUT, HM_REMOVE])),
             (l + nlogs * int(rng.integers(0, K // nlogs)),
              int(rng.integers(0, 1000))))
            for l in range(nlogs) for _ in range(n)]


def _ops_sortedset(rng, nlogs, n, K):
    return [(int(rng.choice([SS_INSERT, SS_INSERT, SS_REMOVE])),
             (l + nlogs * int(rng.integers(0, K // nlogs)), 0))
            for l in range(nlogs) for _ in range(n)]


def _ops_memfs(rng, nlogs, n, F, B=4):
    return [(int(rng.choice([FS_WRITE, FS_WRITE, FS_WRITE, FS_TRUNCATE,
                             3])),
             (l + nlogs * int(rng.integers(0, F // nlogs)),
              int(rng.integers(-1, B + 1)), int(rng.integers(0, 100))))
            for l in range(nlogs) for _ in range(n)]


MODELS = {
    "hashmap": (lambda m, n, L: (m.make_hashmap(n),
                                 m.make_partitioned_hashmap(n, L)),
                _ops_hashmap, 64, 3),
    "sortedset": (lambda m, n, L: (m.make_sortedset(n),
                                   m.make_partitioned_sortedset(n, L)),
                  _ops_sortedset, 32, 2),
    "memfs": (lambda m, n, L: (m.make_memfs(n, 4),
                               m.make_partitioned_memfs(n, 4, L)),
              _ops_memfs, 8, 2),
}


@pytest.mark.parametrize("nlogs", [2, 4])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fold_equivalence_bit_identical(model, nlogs):
    # `TestFoldEquivalence`: the sequential fold with `full` and the
    # partitioned replay (scan, combined, and lock-step: each log's
    # window planned once and merged into its replicas) agree in the
    # port, and the port's partitioned replay equals the reference's on
    # every round
    make, gen, n, R = MODELS[model]
    d, pm = make(tm, n, nlogs)
    jd, jpm = make(jm, n, nlogs)
    spec, jspec = _mspec(nlogs, R=R), _mspec(nlogs, R=R, mod=jml)
    rng = np.random.default_rng(11)
    tl = {m: (multilog_init(spec, CPU), replicate_state(d.init_state(CPU), R))
          for m in ("fold", "scan", "combined", "lockstep")}
    jl = (jml.multilog_init(jspec), j_replicate(jd.init_state(), R))
    jstep = jax.jit(lambda m, s, o, a, c: jml.multilog_exec_all(
        jspec, jd, jml.multilog_append(jspec, m, o, a, c), s, 4,
        partitioned=jpm, combined=False))
    for _ in range(3):
        ops = gen(rng, nlogs, 4, n)
        opc, args, counts, _ = partition_ops(key_mapper, nlogs, ops, 3,
                                             pad_to=4, device=CPU)
        out = {}
        for m, (ml, st) in tl.items():
            ml = multilog_append(spec, ml, opc, args, counts)
            ml, st, r = multilog_exec_all(
                spec, d, ml, st, 4,
                partitioned=None if m == "fold" else pm,
                combined=m in ("combined", "lockstep"),
                lockstep=m == "lockstep")
            tl[m] = (ml, st)
            out[m] = r
        jml_, jst, jr = jstep(*jl, opc.numpy(), args.numpy(),
                              counts.numpy())
        jl = (jml_, jst)
        for m in out:
            _eq(jr, out[m], m)
    for m, (ml, st) in tl.items():
        for f in st:
            _eq(jl[1][f], st[f], f"{m} {f}")
        for f in ml._fields:
            _eq(getattr(jl[0], f), getattr(ml, f), f"{m} {f}")


def test_partitioned_step_matches_shadow_and_fold_step():
    # `TestPartitionedStep` plus the runner twin: the partitioned step,
    # the fold step and a dict agree step by step, and converge
    nlogs, K, R = 4, 32, 3
    spec = _mspec(nlogs, R=R, cap=64)
    pm = make_partitioned_hashmap(K, nlogs)
    steps = {"part": make_multilog_step(pm.full, spec, 4, 2, partitioned=pm),
             "fold": make_multilog_step(make_hashmap(K), spec, 4, 2)}
    live = {m: [multilog_init(spec, CPU),
                replicate_state(pm.full.init_state(CPU), R)] for m in steps}
    rng = np.random.default_rng(7)
    shadow = {}
    for _ in range(3):
        ops = _ops_hashmap(rng, nlogs, 4, K)
        opc, args, counts, _ = partition_ops(key_mapper, nlogs, ops, 3,
                                             pad_to=4, device=CPU)
        rk = rng.integers(0, K, (R, 2)).astype(np.int32)
        rd_opc = torch.full((R, 2), HM_GET, dtype=torch.int32)
        rd_args = torch.zeros((R, 2, 3), dtype=torch.int32)
        rd_args[:, :, 0] = torch.from_numpy(rk)
        rds = {}
        for m, step in steps.items():
            live[m][0], live[m][1], _, rds[m] = step(
                live[m][0], live[m][1], opc, args, counts, rd_opc, rd_args)
        assert torch.equal(rds["part"], rds["fold"])
        for opcode, (k, v) in ops:
            if opcode == HM_PUT:
                shadow[k] = v
            else:
                shadow.pop(k, None)
        for r in range(R):
            for j in range(2):
                assert int(rds["part"][r, j]) == shadow.get(int(rk[r, j]),
                                                            -1)
    assert states_equal(live["part"][1])
    for f in ("values", "present"):
        assert torch.equal(live["part"][1][f], live["fold"][1][f])


def test_sub_dispatch_divides_arg0_like_the_reference():
    # `_div_arg0`: floored division (negative keys too) on the per-op
    # transitions and the combined window; the port's plan is divided
    # too (the lock-step multilog replay plans a partition's window)
    pm = make_partitioned_hashmap(12, 3)
    jpm = jm.make_partitioned_hashmap(12, 3)
    assert pm.sub.name == jpm.sub.name == "hashmap12sub3"
    assert pm.name == jpm.name
    rng = np.random.default_rng(5)
    opc = rng.choice([0, 1, 2], 16).astype(np.int32)
    args = np.stack([rng.integers(-12, 24, 16), rng.integers(0, 9, 16),
                     np.zeros(16)], 1).astype(np.int32)
    st = {"values": rng.integers(0, 9, 4).astype(np.int32),
          "present": rng.random(4) < 0.5}
    js, jr = jpm.sub.window_apply({k: jnp.asarray(v) for k, v in st.items()},
                                  jnp.asarray(opc), jnp.asarray(args))
    ts, tr = pm.sub.window_apply({k: torch.from_numpy(v)
                                  for k, v in st.items()},
                                 torch.from_numpy(opc),
                                 torch.from_numpy(args))
    _eq(jr, tr)
    for f in js:
        _eq(js[f], ts[f], f)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    ps, pr = pm.sub.window_merge(tst, pm.sub.window_plan(
        tst, torch.from_numpy(opc), torch.from_numpy(args)))
    _eq(jr, pr)
    for f in js:
        _eq(js[f], ps[f], f)
