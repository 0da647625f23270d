"""Differential tests of the port's log (`node_replication_torch/core/
log.py`) against the reference (`node_replication_tpu/core/log.py`).

The same numpy-seeded inputs go through both packages on the CPU; every
value is an integer, so results must be bit-identical (tolerance 0).
Mid-stream logs (wrapped rings, staggered cursors) are built with the
reference and carried to the port through `interop`.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from node_replication_tpu.core import log as jlog
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.models import make_hashmap as j_make_hashmap

from node_replication_torch import interop
from node_replication_torch.core import log as tlog
from node_replication_torch.core.replica import replicate_state as t_replicate
from node_replication_torch.models import make_hashmap as t_make_hashmap

CPU = "cpu"
K = 23

# the reference's programs, jitted once per shape (eager jax recompiles
# a scan at every call)
j_append = jax.jit(jlog.log_append, static_argnums=(0,))
j_exec = jax.jit(jlog.log_exec_all, static_argnums=(0, 1, 4))
j_catchup = jax.jit(jlog.log_catchup_all, static_argnums=(0, 1, 4),
                    static_argnames=("need_resps", "on_trajectory"))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_log_equal(jl, tl, what=""):
    for f in jl._fields:
        a, b = np.asarray(getattr(jl, f)), _np(getattr(tl, f))
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f, a, b)


def assert_states_equal(js, ts, what=""):
    for f in ("values", "present"):
        a, b = np.asarray(js[f]), _np(ts[f])
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f)


def random_batch(rng, n, n_keys=K, neg=False):
    opc = rng.choice(np.array([0, 1, 1, 2, 2, 3], np.int32), n)
    lo = -n_keys if neg else 0
    args = np.stack([rng.integers(lo, 2 * n_keys, n),
                     rng.integers(1, 999, n),
                     rng.integers(0, 9, n)], axis=1).astype(np.int32)
    return opc.astype(np.int32), args


@functools.lru_cache(maxsize=None)
def _staggered(R, capacity=256, gc_slack=64, rounds=14, batch=40):
    rng = np.random.default_rng(R)
    spec = jlog.LogSpec(capacity=capacity, n_replicas=R, arg_width=3,
                        gc_slack=gc_slack)
    d = j_make_hashmap(K)
    log = jlog.log_init(spec)
    states = j_replicate(d.init_state(), R)
    for _ in range(rounds):
        opc, args = random_batch(rng, batch)
        log = j_append(spec, log, jnp.asarray(opc), jnp.asarray(args),
                       batch)
        tail = int(log.tail)
        limits = tail - rng.integers(0, batch // 2, R)
        log, states, _ = j_exec(spec, d, log, states, 2 * batch,
                                limits=jnp.asarray(limits))
    assert int(log.tail) >= 2 * spec.capacity  # wrapped twice
    return spec, d, log, states


def staggered_fleet(R, seed):
    """A reference fleet mid-stream (built once per R): the ring wraps
    at least twice and the replica cursors are staggered (replay under
    random limits). `seed` seeds the test's own further inputs."""
    return (*_staggered(R), np.random.default_rng(seed))


def to_port(spec, log, states, R):
    tspec = tlog.LogSpec(capacity=spec.capacity, n_replicas=R,
                         arg_width=spec.arg_width, gc_slack=spec.gc_slack)
    return (tspec, interop.log_from_numpy(log, CPU),
            interop.states_from_numpy(states, CPU))


@pytest.mark.parametrize("R", [1, 4, 64])
def test_log_append_wraps_bit_identical(R):
    rng = np.random.default_rng(R)
    jspec = jlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    tspec = tlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    jl, tl = jlog.log_init(jspec), tlog.log_init(tspec, CPU)
    assert_log_equal(jl, tl, "init")
    n = 64  # one batch shape: the reference compiles once per shape
    for step in range(16):  # 16 x >= 32 slots wraps the 256 ring twice
        count = int(rng.integers(32, n + 1))
        opc, args = random_batch(rng, n)
        jl = j_append(jspec, jl, jnp.asarray(opc), jnp.asarray(args),
                      count)
        # alternate the host-int and the tensor count paths
        tcount = count if step % 2 else torch.tensor(count)
        tl = tlog.log_append(tspec, tl, torch.from_numpy(opc),
                             torch.from_numpy(args), tcount)
        assert_log_equal(jl, tl, f"append {step}")
        # keep GC pace so the next append never overruns (head = tail)
        jl = jl._replace(head=jl.tail)
        tl = tl._replace(head=tl.tail.clone())
        assert int(jlog.log_space(jspec, jl)) == int(
            tlog.log_space(tspec, tl))
    assert int(jl.tail) > 2 * jspec.capacity


def test_gather_window_bit_identical():
    rng = np.random.default_rng(7)
    spec, _, log, _, _ = staggered_fleet(4, 3)
    tspec, tl, _ = to_port(spec, log, {"values": np.zeros((4, K), np.int32),
                                       "present": np.zeros((4, K), bool)}, 4)
    tail = int(log.tail)
    for _ in range(6):
        start = tail - int(rng.integers(0, 150))
        stop = start + int(rng.integers(0, 40))
        w = int(rng.integers(1, 64))
        jo, ja = jlog.gather_window(spec, log.opcodes, log.args,
                                    jnp.int64(start), jnp.int64(stop), w)
        to, ta = tlog.gather_window(tspec, tl.opcodes, tl.args, start,
                                    stop, w)
        assert np.array_equal(np.asarray(jo), _np(to))
        assert np.array_equal(np.asarray(ja), _np(ta))


@pytest.mark.parametrize("R", [1, 4, 64])
def test_exec_all_with_limits_and_fenced(R):
    spec, d, log, states, rng = staggered_fleet(R, 10 + R)
    tspec, tl, ts = to_port(spec, log, states, R)
    td = t_make_hashmap(K)
    tail = int(log.tail)
    limits = (tail - rng.integers(0, 30, R)).astype(np.int64)
    fenced = rng.random(R) < 0.3
    for kw_j, kw_t, what in (
        ({}, {}, "plain"),
        ({"limits": jnp.asarray(limits)},
         {"limits": torch.from_numpy(limits)}, "limits"),
        ({"fenced": jnp.asarray(fenced)},
         {"fenced": torch.from_numpy(fenced)}, "fenced"),
        ({"limits": jnp.asarray(limits), "fenced": jnp.asarray(fenced)},
         {"limits": torch.from_numpy(limits),
          "fenced": torch.from_numpy(fenced)}, "both"),
    ):
        jl2, js2, jr = j_exec(spec, d, log, states, 24, **kw_j)
        tl2, ts2, tr = tlog.log_exec_all(tspec, td, tl, ts, 24, **kw_t)
        assert_log_equal(jl2, tl2, what)
        assert_states_equal(js2, ts2, what)
        assert np.array_equal(np.asarray(jr), _np(tr)), what
    # the port is functional: its inputs are unchanged
    assert_log_equal(log, tl, "inputs untouched")
    assert_states_equal(states, ts, "inputs untouched")


def _scan_only(d):
    return dataclasses.replace(d, window_apply=None, window_plan=None,
                               window_merge=None, window_canonical=False)


@pytest.mark.parametrize("R", [1, 4, 64])
def test_catchup_tiers_from_staggered_cursors(R):
    spec, d, log, states, rng = staggered_fleet(R, 20 + R)
    tspec, tl, ts = to_port(spec, log, states, R)
    td = t_make_hashmap(K)
    fenced = np.zeros(R, bool)
    fenced[rng.integers(0, R)] = True
    limits = (int(log.tail) - rng.integers(0, 30, R)).astype(np.int64)
    cases = [
        # union-window plan tier (window_canonical), with and without
        # responses, fenced and not
        (d, td, {}, {}, "union"),
        (d, td, {"need_resps": False}, {"need_resps": False},
         "union no resps"),
        (d, td, {"fenced": jnp.asarray(fenced)},
         {"fenced": torch.from_numpy(fenced)}, "union fenced"),
        # per-replica window_apply tier (limits / off-trajectory)
        (d, td, {"limits": jnp.asarray(limits)},
         {"limits": torch.from_numpy(limits)}, "window_apply limits"),
        (d, td, {"on_trajectory": False, "fenced": jnp.asarray(fenced)},
         {"on_trajectory": False, "fenced": torch.from_numpy(fenced)},
         "window_apply fenced"),
        # scan tier (no combined form)
        (_scan_only(d), _scan_only(td), {"fenced": jnp.asarray(fenced)},
         {"fenced": torch.from_numpy(fenced)}, "scan fenced"),
    ]
    for dj, dt, kw_j, kw_t, what in cases:
        jl2, js2, jr = j_catchup(spec, dj, log, states, 32, **kw_j)
        tl2, ts2, tr = tlog.log_catchup_all(tspec, dt, tl, ts, 32, **kw_t)
        assert_log_equal(jl2, tl2, what)
        assert_states_equal(js2, ts2, what)
        assert np.array_equal(np.asarray(jr), _np(tr)), what
    # the wrapper's no-readback form of the union tier gives the same
    tl3, ts3, tr3 = tlog.log_catchup_all(tspec, td, tl, ts, 32,
                                         idle_check=False)
    jl3, js3, jr3 = j_catchup(spec, d, log, states, 32)
    assert_log_equal(jl3, tl3, "no idle check")
    assert np.array_equal(np.asarray(jr3), _np(tr3))


def test_union_idle_short_circuit_matches():
    spec, d, log, states, _ = staggered_fleet(4, 31)
    # catch everyone up, then a second call is idle in both packages
    log, states, _ = j_exec(spec, d, log, states, 512)
    tspec, tl, ts = to_port(spec, log, states, 4)
    jl2, js2, jr = jlog.log_catchup_all(spec, d, log, states, 16)
    tl2, ts2, tr = tlog.log_catchup_all(tspec, t_make_hashmap(K), tl, ts,
                                        16)
    assert_log_equal(jl2, tl2)
    assert np.array_equal(np.asarray(jr), _np(tr))
    assert not _np(tr).any()


def test_gc_head_fenced_laggard_and_all_fenced():
    R = 4
    spec, d, log, states, _ = staggered_fleet(R, 41)
    tspec, tl, ts = to_port(spec, log, states, R)
    new_lt = np.asarray(log.ltails) + np.array([5, 0, 9, 2])
    # a fenced laggard is masked out of the min; head never rewinds
    for fen in ([False, True, False, False], [True, True, True, True],
                [False, False, False, False]):
        jh = jlog._gc_head(log, jnp.asarray(new_lt), jnp.asarray(fen))
        th = tlog._gc_head(tl, torch.from_numpy(new_lt),
                           torch.tensor(fen))
        assert int(jh) == int(th), fen
    jh = jlog._gc_head(log, jnp.asarray(new_lt), None)
    th = tlog._gc_head(tl, torch.from_numpy(new_lt), None)
    assert int(jh) == int(th)
    jf = jlog._freeze_limits(log, None, jnp.asarray([True, False] * 2))
    tf = tlog._freeze_limits(tl, None, torch.tensor([True, False] * 2))
    assert np.array_equal(np.asarray(jf), _np(tf))
    assert int(tf[1]) == tlog._FAR


def test_ring_slice_bit_identical():
    spec, _, log, states, rng = staggered_fleet(4, 51)
    tspec, tl, _ = to_port(spec, log, states, 4)
    tail = int(log.tail)
    for start, stop in ((tail - 200, tail - 10), (tail - 256, tail),
                        (tail, tail)):
        jo, ja = jlog.ring_slice(spec, log, start, stop)
        to, ta = tlog.ring_slice(tspec, tl, start, stop)
        assert np.array_equal(jo, to) and np.array_equal(ja, ta)
    with pytest.raises(ValueError):
        tlog.ring_slice(tspec, tl, tail - 257, tail)
    with pytest.raises(ValueError):
        tlog.ring_slice(tspec, tl, tail, tail + 1)


def test_replicate_state_materializes_copies():
    d = t_make_hashmap(5)
    st = t_replicate(d.init_state(CPU), 3)
    st["values"][1, 2] = 7  # an expand view would write every replica
    assert st["values"][:, 2].tolist() == [0, 7, 0]
