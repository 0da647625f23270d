"""Differential tests of the port's stack, queue, sorted set, memfs and
synthetic models through `NodeReplicated` against the reference: twins
of `tests/test_models.py` (synthetic, memfs, sorted set, queue) and
`tests/test_stack_integration.py` (the verify-stack linearizability
smoke test). Each case drives one numpy-seeded op stream through a
reference fleet and a port fleet and requires every response, the log
and every replica's state to be bit-identical, besides the reference
test's own assertions."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import node_replication_tpu.models as jm
import node_replication_torch.models as tm
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.models import (
    FS_READ,
    FS_READ_LOGGED,
    FS_SIZE,
    FS_TRUNCATE,
    FS_WRITE,
    Q_DEQ,
    Q_ENQ,
    Q_FRONT,
    Q_LEN,
    SS_CONTAINS,
    SS_INSERT,
    SS_RANGE_COUNT,
    SS_RANK,
    SS_REMOVE,
    SYN_READ,
    SYN_WRITE,
    memfs_log_mapper,
    sortedset_log_mapper,
)
from node_replication_torch.ops.encoding import Dispatch
from node_replication_tpu import NodeReplicated as JNodeReplicated
from node_replication_tpu.ops.encoding import Dispatch as JDispatch

CPU = "cpu"


class Twins:
    """A reference fleet and a port fleet driven in lock-step: every
    call goes to both and must answer the same."""

    def __init__(self, jd, td, **kw):
        self.j = JNodeReplicated(jd, **kw)
        self.t = NodeReplicated(td, device=CPU, **kw)
        self.tok = {}

    def _toks(self, rid):
        if rid not in self.tok:
            self.tok[rid] = (self.j.register(rid), self.t.register(rid))
        return self.tok[rid]

    def mut(self, op, rid=0):
        jt, tt = self._toks(rid)
        a, b = self.j.execute_mut(op, jt), self.t.execute_mut(op, tt)
        assert a == b, (op, a, b)
        return b

    def enq(self, op, rid=0):
        jt, tt = self._toks(rid)
        self.j.enqueue_mut(op, jt)
        self.t.enqueue_mut(op, tt)

    def flush(self, rid=None):
        self.j.flush(rid)
        self.t.flush(rid)

    def read(self, op, rid=0):
        jt, tt = self._toks(rid)
        a, b = self.j.execute(op, jt), self.t.execute(op, tt)
        assert a == b, (op, a, b)
        return b

    def finish(self):
        self.j.sync()
        self.t.sync()
        assert self.t.replicas_equal() and self.j.replicas_equal()
        for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
            a, b = np.asarray(getattr(self.j.log, f)), \
                getattr(self.t.log, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for f in self.j.states:
            a, b = np.asarray(self.j.states[f]), self.t.states[f].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        return self.t


class TestSynthetic:
    def test_deterministic_replay_converges(self):
        kw = dict(n=512, cold_reads=4, cold_writes=2, hot_reads=2,
                  hot_writes=1, hot_set=32)
        tw = Twins(jm.make_synthetic(**kw), tm.make_synthetic(**kw),
                   n_replicas=2, log_entries=256, gc_slack=16,
                   exec_window=16)
        for i in range(20):
            tw.enq((SYN_WRITE, i * 17 + 3), rid=i % 2)
        tw.flush()
        t = tw.finish()
        assert t.states["lines"].any()

    def test_read_matches_write_checksum_footprint(self):
        kw = dict(n=64, cold_reads=2, cold_writes=1, hot_reads=1,
                  hot_writes=1, hot_set=8)
        tw = Twins(jm.make_synthetic(**kw), tm.make_synthetic(**kw),
                   n_replicas=1, log_entries=256, gc_slack=16)
        assert tw.read((SYN_READ, 5)) == 0
        tw.mut((SYN_WRITE, 5))
        assert tw.read((SYN_READ, 5)) != 0
        tw.finish()

    def test_zero_cost_knobs(self):
        kw = dict(n=64, cold_reads=1, cold_writes=1, hot_reads=0,
                  hot_writes=0, hot_set=8)
        tw = Twins(jm.make_synthetic(**kw), tm.make_synthetic(**kw),
                   n_replicas=1, log_entries=256, gc_slack=16)
        tw.mut((SYN_WRITE, 1))
        tw.read((SYN_READ, 1))
        tw.finish()

    def test_checksums_wrap_like_the_reference(self):
        # seeds near the int32 limits and lines pushed past 2^31 by
        # repeated writes: the int64 checksum wraps to int32 in the
        # response and in the update, as the reference's does under x64
        kw = dict(n=8, cold_reads=6, cold_writes=5, hot_reads=2,
                  hot_writes=2, hot_set=3)
        tw = Twins(jm.make_synthetic(**kw), tm.make_synthetic(**kw),
                   n_replicas=2, log_entries=256, gc_slack=16)
        rng = np.random.default_rng(0)
        lim = np.iinfo(np.int32)
        for i in range(40):
            seed = int(rng.choice([lim.max, lim.min, lim.max - 7,
                                   int(rng.integers(lim.min, lim.max))]))
            tw.mut((SYN_WRITE, seed), rid=i % 2)
            tw.read((SYN_READ, seed), rid=(i + 1) % 2)
        t = tw.finish()
        assert int(t.states["lines"].abs().max()) > 1 << 30


class TestMemFS:
    def test_write_read_truncate(self):
        tw = Twins(jm.make_memfs(4, 8), tm.make_memfs(4, 8), n_replicas=2,
                   log_entries=256, gc_slack=16)
        assert tw.mut((FS_WRITE, 1, 3, 42)) == 4
        assert tw.read((FS_READ, 1, 3)) == 42
        assert tw.read((FS_SIZE, 1)) == 4
        assert tw.mut((FS_READ_LOGGED, 1, 3)) == 42
        assert tw.read((FS_SIZE, 1)) == 4
        assert tw.mut((FS_TRUNCATE, 1)) == 4
        assert tw.read((FS_READ, 1, 3)) == 0
        assert tw.read((FS_SIZE, 1)) == 0
        assert tw.mut((FS_WRITE, 9, 0, 1)) == -1
        tw.finish()

    def test_log_mapper_partitions_by_file(self):
        assert memfs_log_mapper(FS_WRITE, (3, 0, 1)) == 3
        assert memfs_log_mapper(FS_WRITE, (3, 7, 9)) == 3


class TestSortedSet:
    def test_ordered_queries(self):
        tw = Twins(jm.make_sortedset(64), tm.make_sortedset(64),
                   n_replicas=1, log_entries=256, gc_slack=16)
        for k in (5, 10, 20, 40):
            assert tw.mut((SS_INSERT, k)) == 1
        assert tw.mut((SS_INSERT, 10)) == 0
        assert tw.read((SS_CONTAINS, 10)) == 1
        assert tw.read((SS_RANGE_COUNT, 5, 21)) == 3
        assert tw.read((SS_RANK, 21)) == 3
        assert tw.mut((SS_REMOVE, 10)) == 1
        assert tw.mut((SS_REMOVE, 10)) == 0
        assert tw.read((SS_RANGE_COUNT, 0, 64)) == 3
        tw.finish()

    def test_log_mapper_by_key(self):
        assert sortedset_log_mapper(SS_INSERT, (17,)) == 17


class TestQueue:
    def test_fifo_semantics_vs_shadow(self):
        from collections import deque

        tw = Twins(jm.make_queue(16), tm.make_queue(16), n_replicas=2,
                   log_entries=512, gc_slack=16)
        shadow: deque = deque()
        rng = random.Random(2)
        for i in range(200):
            p = rng.random()
            if p < 0.5:
                resp = tw.mut((Q_ENQ, i))
                if len(shadow) < 16:
                    shadow.append(i)
                    assert resp == len(shadow)
                else:
                    assert resp == -1
            elif p < 0.8:
                assert tw.mut((Q_DEQ,)) == (shadow.popleft() if shadow
                                            else -1)
            elif p < 0.9:
                assert tw.read((Q_FRONT,)) == (shadow[0] if shadow else -1)
            else:
                assert tw.read((Q_LEN,)) == len(shadow)
        tw.finish()


@pytest.mark.parametrize("engine", ["scan", "combined"])
def test_stack_engines_bit_identical(engine):
    # the stack through both engines of both packages: the combined
    # engine takes the union-window plan tier (window_canonical=True)
    tw = Twins(jm.make_stack(24), tm.make_stack(24), n_replicas=3,
               log_entries=256, gc_slack=16, exec_window=16, engine=engine)
    rng = np.random.default_rng(5)
    for i in range(60):
        rid = int(rng.integers(3))
        if rng.random() < 0.55:
            tw.enq((1, int(rng.integers(1, 1 << 20))), rid=rid)
        else:
            tw.enq((2,), rid=rid)
        if rng.random() < 0.3:
            tw.flush(rid)
            tw.read((int(rng.integers(1, 3)),), rid=int(rng.integers(3)))
    tw.flush()
    tw.finish()


# ------------------------------------------------ verify-stack twins

VPUSH = 1
VPOP = 2
NTHREADS = 8


def make_verify_stack_ref(capacity: int, n_threads: int) -> JDispatch:
    """The reference test's VerifyStack (per-replica transitions)."""

    def make_state():
        return {
            "buf": jnp.zeros((capacity,), jnp.int32),
            "top": jnp.zeros((), jnp.int32),
            "last_seen": jnp.full((n_threads,), 1 << 20, jnp.int32),
            "violations": jnp.zeros((), jnp.int32),
            "pop_history": jnp.zeros((capacity,), jnp.int32),
            "pops": jnp.zeros((), jnp.int32),
        }

    def push(state, args):
        top = state["top"]
        ok = top < capacity
        idx = jnp.where(ok, top, capacity - 1)
        buf = jnp.where(ok, state["buf"].at[idx].set(args[0]), state["buf"])
        tid, count = args[0] & 0xFFFF, args[0] >> 16
        last = jnp.where(ok, state["last_seen"].at[tid].set(count + 1),
                         state["last_seen"])
        return {**state, "buf": buf, "last_seen": last,
                "top": jnp.where(ok, top + 1, top)}, jnp.int32(0)

    def pop(state, args):
        top = state["top"]
        ok = top > 0
        val = state["buf"][jnp.where(ok, top - 1, 0)]
        tid, count = val & 0xFFFF, val >> 16
        bad = ok & (count >= state["last_seen"][tid])
        last = jnp.where(ok, state["last_seen"].at[tid].set(count),
                         state["last_seen"])
        hist = jnp.where(ok, state["pop_history"].at[state["pops"]].set(val),
                         state["pop_history"])
        return {**state, "top": jnp.where(ok, top - 1, top),
                "last_seen": last,
                "violations": state["violations"] + bad.astype(jnp.int32),
                "pop_history": hist,
                "pops": state["pops"] + ok.astype(jnp.int32)}, \
            jnp.where(ok, val, jnp.int32(-1))

    return JDispatch(name="verify_stack", make_state=make_state,
                     write_ops=(push, pop), read_ops=(), arg_width=3)


def make_verify_stack(capacity: int, n_threads: int) -> Dispatch:
    """The same VerifyStack written as the port's fleet transitions:
    each op updates, in place, the lanes its mask selects."""

    def make_state(device=None):
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return {"buf": z(capacity), "top": z(),
                "last_seen": torch.full((n_threads,), 1 << 20,
                                        dtype=torch.int32, device=device),
                "violations": z(), "pop_history": z(capacity), "pops": z()}

    def push(s, args, lanes):
        rows = torch.arange(lanes.shape[0])
        top = s["top"]
        ok = lanes & (top < capacity)
        idx = torch.where(top < capacity, top, capacity - 1).long()
        s["buf"][rows, idx] = torch.where(ok, args[:, 0],
                                          s["buf"][rows, idx])
        tid = (args[:, 0] & 0xFFFF).long()
        s["last_seen"][rows, tid] = torch.where(
            ok, (args[:, 0] >> 16) + 1, s["last_seen"][rows, tid])
        top.copy_(torch.where(ok, top + 1, top))
        return torch.zeros_like(top)

    def pop(s, args, lanes):
        rows = torch.arange(lanes.shape[0])
        top = s["top"]
        ok = top > 0
        val = s["buf"][rows, torch.where(ok, top - 1, 0).long()]
        tid = (val & 0xFFFF).long()
        count = val >> 16
        hit = lanes & ok
        bad = hit & (count >= s["last_seen"][rows, tid])
        s["last_seen"][rows, tid] = torch.where(hit, count,
                                                s["last_seen"][rows, tid])
        at = s["pops"].long()
        s["pop_history"][rows, at] = torch.where(
            hit, val, s["pop_history"][rows, at])
        s["violations"].add_(bad.to(torch.int32))
        s["pops"].add_(hit.to(torch.int32))
        top.copy_(torch.where(hit, top - 1, top))
        return torch.where(ok, val, torch.full_like(val, -1))

    return Dispatch(name="verify_stack", make_state=make_state,
                    write_ops=(push, pop), read_ops=(), arg_width=3)


def _verify_twins(per_thread):
    cap = NTHREADS * per_thread + 8
    return Twins(make_verify_stack_ref(cap, NTHREADS),
                 make_verify_stack(cap, NTHREADS), n_replicas=2,
                 log_entries=1024, gc_slack=64, exec_window=128)


def test_parallel_push_sequential_pop():
    # tagged values pushed from 8 threads over 2 replicas, then popped
    # by one thread: per-thread monotonicity holds on every replica
    per_thread = 24
    tw = _verify_twins(per_thread)
    rng = random.Random(9)
    nxt = {t: 1 for t in range(NTHREADS)}
    live = list(range(NTHREADS))
    while live:
        t = rng.choice(live)
        tw.enq((VPUSH, (nxt[t] << 16) | t), rid=t % 2)
        nxt[t] += 1
        if nxt[t] > per_thread:
            live.remove(t)
        if rng.random() < 0.2:
            tw.flush(t % 2)
    tw.flush()
    for _ in range(NTHREADS * per_thread):
        assert tw.mut((VPOP,), rid=0) != -1
    t = tw.finish()
    for rid in (0, 1):
        assert int(t.states["violations"][rid]) == 0
        assert int(t.states["top"][rid]) == 0
        assert int(t.states["pops"][rid]) == NTHREADS * per_thread


def test_parallel_push_and_pop_replicas_equal():
    per_thread = 16
    tw = _verify_twins(per_thread)
    rng = random.Random(10)
    counts = [1] * NTHREADS
    for _ in range(NTHREADS * per_thread):
        t = rng.randrange(NTHREADS)
        if rng.random() < 0.6:
            tw.enq((VPUSH, (counts[t] << 16) | t), rid=t % 2)
            counts[t] += 1
        else:
            tw.enq((VPOP,), rid=t % 2)
        if rng.random() < 0.15:
            tw.flush(t % 2)
    tw.flush()
    t = tw.finish()
    assert (t.states["violations"] == 0).all()
