"""Differential tests of the port's radix vspace against the reference:
the model (`node_replication_torch/models/vspace.py:make_vspace_radix`
against `node_replication_tpu/models/vspace.py`) and its kernel paths
(`node_replication_torch/ops/vspace.py`, `radix=True`, against
`node_replication_tpu/ops/pallas_vspace.py` run as its own tests run it:
`interpret=True`, `jit=False`). On the CPU the port's wrappers run the
kernels' plain versions, so this holds K6 (`vspace_radix_replay`) and
K7b (`vspace_radix_plan_replay`) bit-identical to the reference kernels,
tolerance 0 (every output is an integer):

- the per-op writes and reads, and the combined replay
  (`window_plan`/`window_merge`/`window_apply`) with a torn initial
  state and the pinned teardown-epoch responses
  (`tests/test_window.py::TestVSpaceWindowApply`);
- the scan and combined steps, and `NodeReplicated` on the chain
  (`tests/test_models.py::TestVSpaceRadix`);
- K6 and K7b, the K6 step and the K7b plan step
  (`tests/test_pallas_vspace.py`), the reads on the kernel layout, and
  the reference's config rules (one PML4 entry: P <= 2^27).

Windows carry all four write kinds, NOOP and unknown opcodes, vpages
past P (taken mod P), spans of n <= 0 and n > max_span, spans that cross
a PD boundary or pass P, and teardowns of unallocated regions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core import log as jlog
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.core.step import make_step as j_make_step
from node_replication_tpu.models import make_vspace_radix as j_make_radix
from node_replication_tpu.ops import pallas_vspace as jpv
from node_replication_tpu.ops.encoding import apply_read as j_apply_read
from node_replication_tpu.ops.encoding import apply_write as j_apply_write

from node_replication_torch import interop
from node_replication_torch.core import log as tlog
from node_replication_torch.core.replica import NodeReplicated as TNR
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step as t_make_step
from node_replication_torch.models import (
    VSR_IDENTIFY,
    VSR_MAP,
    VSR_MAP_DEVICE,
    VSR_RESOLVED,
    VSR_TABLES,
    VSR_UNMAP,
    VSR_UNMAP_TABLE,
)
from node_replication_torch.models import make_vspace_radix as t_make_radix
from node_replication_torch.ops import vspace as tpv
from node_replication_torch.ops.encoding import apply_read, apply_write

CPU = "cpu"
KEYS = ("pt", "pd", "pdpt", "pml4")

j_write = jax.jit(j_apply_write, static_argnums=(0,))
j_read = jax.jit(j_apply_read, static_argnums=(0,))


def window(rng, W, P, S):
    """The reference tests' mix (`tests/test_window.py:242-253`) plus
    vpages below 0, spans crossing a PD boundary and spans passing P."""
    opc = rng.choice(np.array([0, 1, 2, 3, 4, 9], np.int32), W,
                     p=[0.06, 0.3, 0.14, 0.25, 0.2, 0.05])
    args = np.stack([rng.integers(-P, 2 * P, W), rng.integers(-2, 60, W),
                     rng.integers(-1, S + 3, W)], axis=1).astype(np.int32)
    k = max(1, W // 8)
    at = rng.choice(W, 2 * k, replace=False)
    args[at[:k], 0] = 512 * rng.integers(1, max(2, P // 512), k) - 3
    args[at[k:], 0] = P - rng.integers(1, S, k)
    return opc, args


def torn_state(d, P):
    """The reference tests' torn initial state: a full walk in region 0,
    pd without pt in region 1, pt without pd in region 2."""
    st = d.init_state()
    st["pt"] = st["pt"].at[10:40].set(5).at[1100:1130].set(9)
    st["pd"] = st["pd"].at[0].set(True).at[1].set(True)
    st["pdpt"] = st["pdpt"].at[0].set(True)
    st["pml4"] = st["pml4"].at[0].set(True)
    return st


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _t(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def j_fold(d, state, opc, args):
    resps = []
    for i in range(len(opc)):
        state, r = j_write(d, state, jnp.asarray(opc[i]),
                           jnp.asarray(args[i]))
        resps.append(int(r))
    return state, resps


# --------------------------------------------------------------- model


@pytest.mark.parametrize("seed", [0, 1])
def test_write_and_read_ops_bit_identical(seed):
    # one op at a time through both packages; the port runs R = 3
    # identical replicas (its ops work on the replica axis)
    P, S, W = 1500, 20, 48
    rng = np.random.default_rng(seed)
    jd, td = j_make_radix(P, max_span=S), t_make_radix(P, max_span=S)
    opc, args = window(rng, W, P, S)
    js = torn_state(jd, P)
    ts = replicate_state(_t(js), 3)
    rd_opc = rng.choice(np.array([0, 1, 2, 3, 7], np.int32), W)
    rd_args = window(rng, W, P, S)[1]
    for i in range(W):
        js, jr = j_write(jd, js, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        rep = lambda a: torch.from_numpy(np.repeat(a[i:i + 1], 3, 0))
        tr = apply_write(td, ts, rep(opc), rep(args))
        assert tr.tolist() == [int(jr)] * 3, i
        jq = j_read(jd, js, jnp.asarray(rd_opc[i]), jnp.asarray(rd_args[i]))
        tq = apply_read(td, ts, rep(rd_opc), rep(rd_args))
        assert tq.tolist() == [int(jq)] * 3, i
    for k in KEYS:
        for r in range(3):
            _eq(js[k], ts[k][r], f"{k} replica {r}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_apply_matches_fold_from_torn_state(seed):
    # the twin of test_window.py::test_radix_matches_sequential_fold:
    # coupled pt/pd/pdpt/pml4 histories, teardown epochs, span-crossing
    # table marks
    P, S, W = 1500, 20, 96
    rng = np.random.default_rng(seed)
    jd, td = j_make_radix(P, max_span=S), t_make_radix(P, max_span=S)
    opc, args = window(rng, W, P, S)
    st0 = torn_state(jd, P)
    ref_state, ref_resps = j_fold(jd, st0, opc, args)
    jplan = jd.window_plan(st0, jnp.asarray(opc), jnp.asarray(args))
    tplan = td.window_plan(_t(st0), torch.from_numpy(opc),
                           torch.from_numpy(args))
    for f in jplan:
        assert np.array_equal(np.asarray(jplan[f]), _np(tplan[f])), f
    got, resps = td.window_apply(_t(st0), torch.from_numpy(opc),
                                 torch.from_numpy(args))
    assert resps.tolist() == ref_resps
    for k in KEYS:
        _eq(ref_state[k], got[k], k)


def test_teardown_epochs_pinned():
    # the twin of test_window.py::test_radix_teardown_epochs: two
    # teardowns of one region, the first counting initially mapped and
    # in-window pages, the second only pages mapped after the first
    P = 1100
    jd, td = j_make_radix(P, max_span=8), t_make_radix(P, max_span=8)
    st0 = jd.init_state()
    st0["pt"] = st0["pt"].at[600:606].set(3)
    st0["pd"] = st0["pd"].at[1].set(True)
    st0["pdpt"] = st0["pdpt"].at[0].set(True)
    st0["pml4"] = st0["pml4"].at[0].set(True)
    ops = [(1, 520, 9, 4), (1, 602, 9, 4), (4, 700, 0, 0), (3, 520, 4, 0),
           (1, 640, 1, 2), (4, 712, 0, 0), (4, 712, 0, 0), (2, 76, 5, 3),
           (4, 100, 0, 0)]
    opc = np.array([o[0] for o in ops], np.int32)
    args = np.array([o[1:] for o in ops], np.int32)
    ref_state, ref_resps = j_fold(jd, st0, opc, args)
    got, resps = td.window_apply(_t(st0), torch.from_numpy(opc),
                                 torch.from_numpy(args))
    assert ref_resps == resps.tolist() == [4, 0, 10, 0, 2, 2, 0, 3, 3]
    for k in KEYS:
        _eq(ref_state[k], got[k], k)
    # the kernel's plain version gives the same
    ks = tpv.pallas_vspace_state(P, 2, True, _t(st0), CPU)
    *kout, kr = tpv.make_vspace_replay(P, 2, len(ops), 8, True)(
        torch.from_numpy(opc), torch.from_numpy(args),
        *(ks[k] for k in KEYS))
    assert kr.tolist() == ref_resps
    view = tpv.model_view(dict(zip(KEYS, kout)), P, True)
    for k in KEYS:
        _eq(ref_state[k], view[k][1], k)


def test_batched_window_apply_is_per_replica_apply():
    # the per-replica window_apply tier: each replica its own state and
    # window (a leading axis), against the reference's vmap
    P, S, R, W = 1100, 8, 3, 40
    rng = np.random.default_rng(4)
    jd, td = j_make_radix(P, max_span=S), t_make_radix(P, max_span=S)
    js = j_replicate(torn_state(jd, P), R)
    js["pt"] = jnp.asarray(np.asarray(js["pt"])
                           * rng.integers(0, 2, (R, P)).astype(np.int32))
    wins = [window(rng, W, P, S) for _ in range(R)]
    opc = np.stack([w[0] for w in wins])
    args = np.stack([w[1] for w in wins])
    jst, jr = jax.vmap(jd.window_apply)(js, jnp.asarray(opc),
                                        jnp.asarray(args))
    tst, tr = td.window_apply(_t(js), torch.from_numpy(opc),
                              torch.from_numpy(args))
    for k in KEYS:
        _eq(jst[k], tst[k], k)
    _eq(jr, tr)


def test_plan_is_prefix_absorbing():
    # window_canonical=True: merging plan(state(lo), [lo, hi)) into a
    # replica already at any p in [lo, hi] lands on state(hi)
    P, S, N, snaps = 1100, 8, 40, (8, 21, 33)
    td = t_make_radix(P, max_span=S)
    assert td.window_canonical
    rng = np.random.default_rng(1)
    opc, args = window(rng, N, P, S)
    st = replicate_state(td.init_state(CPU), 1)
    snap = {}
    for i in range(N):
        if i in snaps:
            snap[i] = {k: v.clone() for k, v in st.items()}
        apply_write(td, st, torch.from_numpy(opc[i:i + 1]),
                    torch.from_numpy(args[i:i + 1]))
    lo, _, hi = snaps
    plan = td.window_plan({k: v[0] for k, v in snap[lo].items()},
                          torch.from_numpy(opc[lo:hi]),
                          torch.from_numpy(args[lo:hi]))
    for p in snaps:
        merged, _ = td.window_merge(snap[p], plan)
        for k in KEYS:
            assert torch.equal(merged[k], snap[hi][k]), (p, k)


def _step_batch(rng, R, Bw, Br, P, S, span_hi=None):
    """The reference step tests' batch (`tests/test_pallas_vspace.py:
    129-146`)."""
    wr_opc = rng.choice(np.array([0, 1, 2, 3, 4], np.int32), (R, Bw))
    wr_args = np.stack([rng.integers(0, P, (R, Bw)),
                        rng.integers(0, 60, (R, Bw)),
                        rng.integers(0, span_hi or S + 1, (R, Bw))],
                       axis=-1).astype(np.int32)
    rd_opc = rng.choice(np.array([1, 2, 3], np.int32), (R, Br))
    rd_args = np.stack([rng.integers(0, P, (R, Br)),
                        rng.integers(1, 9, (R, Br)), np.zeros((R, Br))],
                       axis=-1).astype(np.int32)
    return wr_opc, wr_args, rd_opc, rd_args


@pytest.mark.parametrize("combined", [False, True])
def test_step_combined_and_scan_match_reference(combined):
    # the twin of test_window.py::test_radix_step_combined_matches_scan:
    # a multi-step drive over a ring that wraps, both engines in both
    # packages, every response, cursor and state identical
    R, Bw, Br, P, STEPS = 3, 4, 2, 1100, 5
    kw = dict(capacity=2 * R * Bw, n_replicas=R, arg_width=3,
              gc_slack=R * Bw // 2)
    jspec, tspec = jlog.LogSpec(**kw), tlog.LogSpec(**kw)
    jd, td = j_make_radix(P, max_span=8), t_make_radix(P, max_span=8)
    jstep = j_make_step(jd, jspec, Bw, Br, combined=combined, donate=False)
    tstep = t_make_step(td, tspec, Bw, Br, combined=combined)
    sstep = t_make_step(td, tspec, Bw, Br, combined=not combined)
    rng = np.random.default_rng(7)
    jl, js = jlog.log_init(jspec), j_replicate(jd.init_state(), R)
    tl, ts = tlog.log_init(tspec, CPU), replicate_state(td.init_state(CPU), R)
    sl, ss = tlog.log_init(tspec, CPU), replicate_state(td.init_state(CPU), R)
    for s in range(STEPS):
        b = _step_batch(rng, R, Bw, Br, P, 8, span_hi=9)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
        for w, r in ((tw, tr), (sw, sr)):
            _eq(jw, w, f"wr {s}")
            _eq(jr, r, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
    for k in KEYS:
        _eq(js[k], ts[k], k)
        _eq(js[k], ss[k], k)
    assert int(jl.tail) > jspec.capacity


def _nr_pair(P, S, R, **kw):
    return (JNR(j_make_radix(P, max_span=S), n_replicas=R, **kw),
            TNR(t_make_radix(P, max_span=S), n_replicas=R, device=CPU,
                **kw))


def test_node_replicated_walk_teardown_and_empty_map():
    # the twins of test_models.py::TestVSpaceRadix's directed tests,
    # through both wrappers (the radix model has no fused tier: the
    # rounds take the chain)
    for nr in _nr_pair(2048, 8, 2, log_entries=256, gc_slack=16):
        tok = nr.register(0)
        assert nr.execute_mut((VSR_MAP, 10, 100, 4), tok) == 4
        assert nr.execute((VSR_IDENTIFY, 10), tok) == 101
        assert nr.execute((VSR_IDENTIFY, 13), tok) == 104
        assert nr.execute((VSR_IDENTIFY, 14), tok) == -1
        assert nr.execute_mut((VSR_MAP_DEVICE, 600, 7, 2), tok) == 2
        assert nr.execute((VSR_IDENTIFY, 600), tok) == 8 | (1 << 30)
        assert nr.execute((VSR_RESOLVED, 8, 8), tok) == 4
        assert nr.execute((VSR_RESOLVED, 600, 8), tok) == 2
        assert nr.execute((VSR_TABLES,), tok) == 2
        assert nr.execute_mut((VSR_MAP, 1100, 5, 0), tok) == 0
        assert nr.execute((VSR_TABLES,), tok) == 2  # no phantom table
        assert nr.execute_mut((VSR_MAP, 510, 200, 4), tok) == 4
        assert nr.execute_mut((VSR_UNMAP, 10, 2), tok) == 2
        assert nr.execute((VSR_TABLES,), tok) == 2
        assert nr.execute_mut((VSR_UNMAP_TABLE, 7), tok) == 4
        assert nr.execute((VSR_TABLES,), tok) == 1
        assert nr.execute((VSR_IDENTIFY, 511), tok) == -1
        assert nr.execute((VSR_IDENTIFY, 512), tok) == 203
        assert nr.execute_mut((VSR_MAP, 100, 900, 1), tok) == 1
        assert nr.execute((VSR_IDENTIFY, 12), tok) == -1
        nr.sync()
        assert nr.replicas_equal()


def test_node_replicated_random_ops_match_reference_and_shadow():
    # the twin of test_models.py::TestVSpaceRadix::
    # test_shadow_model_random_ops, both wrappers against a dict shadow
    N, SPAN = 1536, 8
    jn, tn = _nr_pair(N, SPAN, 2, log_entries=1 << 12, gc_slack=64)
    jt, tt = jn.register(0), tn.register(1)
    rng = np.random.default_rng(4)
    shadow = {}
    for _ in range(120):
        op = int(rng.choice([VSR_MAP, VSR_MAP_DEVICE, VSR_UNMAP,
                             VSR_UNMAP_TABLE], p=[0.4, 0.2, 0.3, 0.1]))
        v = int(rng.integers(0, N))
        if op in (VSR_MAP, VSR_MAP_DEVICE):
            f, n = int(rng.integers(0, 1 << 16)), int(rng.integers(1, 9))
            o = (op, v, f, n)
            for i in range(n):
                if v + i < N:
                    shadow[v + i] = (f + i, op == VSR_MAP_DEVICE)
        elif op == VSR_UNMAP:
            n = int(rng.integers(1, SPAN + 1))
            o = (op, v, n)
            for i in range(n):
                shadow.pop(v + i, None)
        else:
            o = (op, v)
            base = (v >> 9) << 9
            for pg in range(base, min(base + 512, N)):
                shadow.pop(pg, None)
        assert jn.execute_mut(o, jt) == tn.execute_mut(o, tt)
    for v in rng.integers(0, N, 64):
        got = tn.execute((VSR_IDENTIFY, int(v)), tt)
        assert got == jn.execute((VSR_IDENTIFY, int(v)), jt)
        want = shadow.get(int(v))
        assert got == (-1 if want is None
                       else (want[0] + 1) | (int(want[1]) << 30)), v
    for nr in (jn, tn):
        nr.sync()
    for k in KEYS:
        _eq(jn.states[k], tn.states[k], k)
    assert tn.replicas_equal()


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_replay_matches_reference_kernel(seed):
    # the twin of test_pallas_vspace.py::TestRadixKernel: K6's plain
    # version against the reference kernel, from the torn state
    P, S, W, R = 1500, 20, 64, 3
    rng = np.random.default_rng(seed)
    jd = j_make_radix(P, max_span=S)
    opc, args = window(rng, W, P, S)
    st0 = torn_state(jd, P)
    jst = jpv.pallas_vspace_state(P, R, True, st0)
    jout = jpv.make_vspace_replay(P, R, W, S, True, interpret=True)(
        jnp.asarray(opc), jnp.asarray(args), *(jst[k] for k in KEYS))
    tst = tpv.pallas_vspace_state(P, R, True, _t(st0), CPU)
    for k in KEYS:
        _eq(jst[k], tst[k], f"state {k}")
    tout = tpv.make_vspace_replay(P, R, W, S, True)(
        torch.from_numpy(opc), torch.from_numpy(args),
        *(tst[k] for k in KEYS))
    for a, b, what in zip(jout, tout, KEYS + ("resps",)):
        _eq(a, b, what)
    # and both are the model's fold
    ref_state, ref_resps = j_fold(jd, st0, opc, args)
    assert tout[4].tolist() == ref_resps
    view = tpv.model_view(dict(zip(KEYS, tout)), P, True)
    for k in KEYS:
        for r in range(R):
            _eq(ref_state[k], view[k][r], k)


@pytest.mark.parametrize("seed", [3, 4])
def test_radix_plan_replay_matches_reference_kernel(seed):
    # K7b's plain version, its delta planes starting non-zero (a step's
    # chunks carry them along), in the reference layout and the model
    # layout [1, P] the plan step passes
    P, S, W = 1500, 20, 64
    rng = np.random.default_rng(seed)
    opc, args = window(rng, W, P, S)
    jst = jpv.pallas_vspace_state(P, 1, True, torn_state(j_make_radix(
        P, max_span=S), P))
    shape = np.asarray(jst["pt"]).shape
    planes = [(rng.random(shape) < 0.1).astype(np.int32) for _ in "wc"]
    planes.append((rng.random(3) < 0.5).astype(np.int32))
    jout = jpv.make_vspace_plan_replay(P, W, S, True, interpret=True)(
        jnp.asarray(opc), jnp.asarray(args), *(jst[k] for k in KEYS),
        *map(jnp.asarray, planes))
    tst = interop.radix_from_numpy(jst, CPU, layout="kernel")
    trep = tpv.make_vspace_plan_replay(P, W, S, True)
    tout = trep(torch.from_numpy(opc), torch.from_numpy(args),
                *(tst[k] for k in KEYS), *map(torch.from_numpy, planes))
    names = KEYS + ("wins", "clr", "pdt", "resps")
    for a, b, what in zip(jout, tout, names):
        _eq(a, b, what)
    flat = lambda a: torch.from_numpy(a.reshape(1, -1)[:, :P].copy())
    mout = trep(torch.from_numpy(opc), torch.from_numpy(args),
                tst["pt"].reshape(1, -1)[:, :P].contiguous(),
                *(tst[k] for k in KEYS[1:]), flat(planes[0]),
                flat(planes[1]), torch.from_numpy(planes[2]))
    for a, b, what in zip(mout, tout, names):
        b = b.reshape(1, -1)[:, :P] if what in ("pt", "wins", "clr") else b
        assert torch.equal(a, b), what


def levels_off_state(d):
    """Mapped pages under set PD entries (regions 0, 1 and 2) with PDPT
    and PML4 unset: nothing walks until a live MAP sets them."""
    st = d.init_state()
    st["pt"] = st["pt"].at[10:40].set(5).at[600:700].set(7).at[
        1100:1130].set(9)
    st["pd"] = st["pd"].at[0].set(True).at[1].set(True).at[2].set(True)
    return st


def late_first_map_window(rng, W, P, S):
    """UNMAPs and teardowns over mapped pages and MAPs of n <= 0, then
    the window's first live MAP at entry 3W/4, then the usual mix:
    before it no page walks, after it the walk switches on."""
    head = 3 * W // 4
    opc = rng.choice(np.array([1, 2, 3, 3, 4], np.int32), head)
    args = np.stack([rng.choice(np.array([20, 30, 610, 650, 1110, 1120]),
                                head) + P * rng.integers(-1, 2, head),
                     rng.integers(1, 20, head),
                     rng.integers(-3, 1, head)], axis=1).astype(np.int32)
    tail_opc, tail_args = window(rng, W - head, P, S)
    opc = np.concatenate([opc, tail_opc])
    args = np.concatenate([args, tail_args])
    opc[head] = 1
    args[head] = (rng.integers(0, P - S), rng.integers(0, 60),
                  rng.integers(1, S + 1))
    return opc, args, head


def _check_walk_switch(opc, resps, head):
    # nothing walked before the first live MAP: unmaps and teardowns
    # count 0, maps (of n <= 0) count 0
    assert not any(resps[:head]), resps[:head]
    assert (opc[:head] == 3).any() and (opc[:head] == 4).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_replay_walk_switches_on_at_first_live_map(seed):
    # K6's plain version against the reference kernel from a start state
    # with PML4 = PDPT = 0: the walk turns on only after the window's
    # first live MAP (the kernel reads this from its first[] indices)
    P, S, W, R = 1500, 20, 64, 2
    rng = np.random.default_rng(100 + seed)
    jd = j_make_radix(P, max_span=S)
    opc, args, head = late_first_map_window(rng, W, P, S)
    st0 = levels_off_state(jd)
    jst = jpv.pallas_vspace_state(P, R, True, st0)
    jout = jpv.make_vspace_replay(P, R, W, S, True, interpret=True)(
        jnp.asarray(opc), jnp.asarray(args), *(jst[k] for k in KEYS))
    tst = tpv.pallas_vspace_state(P, R, True, _t(st0), CPU)
    tout = tpv.make_vspace_replay(P, R, W, S, True)(
        torch.from_numpy(opc), torch.from_numpy(args),
        *(tst[k] for k in KEYS))
    for a, b, what in zip(jout, tout, KEYS + ("resps",)):
        _eq(a, b, what)
    ref_state, ref_resps = j_fold(jd, st0, opc, args)
    assert tout[4].tolist() == ref_resps
    _check_walk_switch(opc, ref_resps, head)


@pytest.mark.parametrize("seed", [3, 4])
def test_radix_plan_replay_walk_switches_on_at_first_live_map(seed):
    # the same for K7b's plain version, its delta planes included
    P, S, W = 1500, 20, 64
    rng = np.random.default_rng(100 + seed)
    opc, args, head = late_first_map_window(rng, W, P, S)
    jst = jpv.pallas_vspace_state(P, 1, True, levels_off_state(
        j_make_radix(P, max_span=S)))
    shape = np.asarray(jst["pt"]).shape
    planes = [(rng.random(shape) < 0.1).astype(np.int32) for _ in "wc"]
    planes.append((rng.random(3) < 0.5).astype(np.int32))
    jout = jpv.make_vspace_plan_replay(P, W, S, True, interpret=True)(
        jnp.asarray(opc), jnp.asarray(args), *(jst[k] for k in KEYS),
        *map(jnp.asarray, planes))
    tst = interop.radix_from_numpy(jst, CPU, layout="kernel")
    tout = tpv.make_vspace_plan_replay(P, W, S, True)(
        torch.from_numpy(opc), torch.from_numpy(args),
        *(tst[k] for k in KEYS), *map(torch.from_numpy, planes))
    for a, b, what in zip(jout, tout, KEYS + ("wins", "clr", "pdt",
                                              "resps")):
        _eq(a, b, what)
    _check_walk_switch(opc, tout[7].tolist(), head)


def test_radix_step_matches_reference_step_and_scan():
    # the twin of test_pallas_vspace.py::TestPallasVspaceStep: the K6
    # step against the reference's kernel step (ring, cursors, kernel
    # state, responses) and the port's scan step (model state)
    R, Bw, Br, P, S, STEPS = 3, 4, 2, 1100, 8, 4
    kw = dict(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jspec, tspec = jlog.LogSpec(**kw), tlog.LogSpec(**kw)
    jd, td = j_make_radix(P, max_span=S), t_make_radix(P, max_span=S)
    jstep = jpv.make_pallas_vspace_step(P, jspec, Bw, Br, S, radix=True,
                                        interpret=True, jit=False)
    tstep = tpv.make_pallas_vspace_step(P, tspec, Bw, Br, S, radix=True)
    sstep = t_make_step(td, tspec, Bw, Br, combined=False)
    rng = np.random.default_rng(5)
    jl, tl, sl = (jlog.log_init(jspec), tlog.log_init(tspec, CPU),
                  tlog.log_init(tspec, CPU))
    js = jpv.pallas_vspace_state(P, R, True, jd.init_state())
    ts = tpv.pallas_vspace_state(P, R, True, device=CPU)
    ss = replicate_state(td.init_state(CPU), R)
    for s in range(STEPS):
        b = _step_batch(rng, R, Bw, Br, P, S)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
        for w, r in ((jw, jr), (sw, sr)):
            _eq(w, tw, f"wr {s}")
            _eq(r, tr, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
        for k in KEYS:
            _eq(js[k], ts[k], f"step {s} {k}")
    view = tpv.model_view(ts, P, True)
    for k in KEYS:
        assert torch.equal(view[k], ss[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_radix_plan_step_matches_reference_and_scan(seed):
    # the twin of test_pallas_vspace.py::TestPlanStep::
    # test_radix_plan_step_matches_scan_step, with the reference's plan
    # step and scan step beside the port's
    R, Bw, Br, P, S, STEPS = 3, 4, 2, 1100, 8, 4
    kw = dict(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jspec, tspec = jlog.LogSpec(**kw), tlog.LogSpec(**kw)
    jd, td = j_make_radix(P, max_span=S), t_make_radix(P, max_span=S)
    jstep = jpv.make_pallas_vspace_plan_step(P, jspec, Bw, Br, S, radix=True,
                                             dispatch=jd, interpret=True,
                                             jit=False)
    tstep = tpv.make_pallas_vspace_plan_step(P, tspec, Bw, Br, S, radix=True,
                                             dispatch=td)
    sstep = t_make_step(td, tspec, Bw, Br, combined=False)
    rng = np.random.default_rng(seed)
    jl, tl, sl = (jlog.log_init(jspec), tlog.log_init(tspec, CPU),
                  tlog.log_init(tspec, CPU))
    js = j_replicate(jd.init_state(), R)
    ts = replicate_state(td.init_state(CPU), R)
    ss = replicate_state(td.init_state(CPU), R)
    for s in range(STEPS):
        b = _step_batch(rng, R, Bw, Br, P, S)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
        for w, r in ((jw, jr), (sw, sr)):
            _eq(w, tw, f"wr {s}")
            _eq(r, tr, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
    for k in KEYS:
        _eq(js[k], ts[k], k)
        _eq(js[k], ss[k], k)


def test_reads_on_kernel_layout_match_reference():
    P, S, R, B = 1500, 20, 3, 24
    rng = np.random.default_rng(8)
    st = torn_state(j_make_radix(P, max_span=S), P)
    js = jpv.pallas_vspace_state(P, R, True, st)
    js = dict(js, pt=jnp.asarray(np.asarray(js["pt"])
                                 * rng.integers(0, 2, np.asarray(
                                     js["pt"]).shape).astype(np.int32)))
    rd_opc = rng.choice(np.array([0, 1, 2, 3, -1, 6], np.int32), (R, B))
    rd_args = window(rng, R * B, P, S)[1].reshape(R, B, 3)
    jq = jpv._vspace_reads(P, S, True)(js, jnp.asarray(rd_opc),
                                       jnp.asarray(rd_args))
    tq = tpv.vspace_reads(P, S, radix=True)(
        interop.radix_from_numpy(js, CPU, layout="kernel"),
        torch.from_numpy(rd_opc), torch.from_numpy(rd_args))
    _eq(jq, tq)


def test_config_rules_match_reference():
    # max_span > 512 is refused by both packages; past 2^27 pages the
    # reference asserts one PML4 entry, the port raises ValueError
    for fn in (lambda: jpv.make_vspace_replay(1500, 2, 8, 600, True,
                                              interpret=True),
               lambda: jpv.make_vspace_plan_replay(1500, 8, 600, True,
                                                   interpret=True)):
        with pytest.raises(ValueError):
            fn()
    big = (1 << 27) + 1
    with pytest.raises(AssertionError):
        jpv.make_vspace_replay(big, 1, 8, 8, True, interpret=True)
    for fn in (lambda: tpv.make_vspace_replay(1500, 2, 8, 600, True),
               lambda: tpv.make_vspace_plan_replay(1500, 8, 600, True),
               lambda: tpv.make_vspace_replay(big, 1, 8, 8, True),
               lambda: tpv.make_vspace_plan_replay(big, 8, 8, True),
               lambda: tpv.make_pallas_vspace_step(
                   big, tlog.LogSpec(n_replicas=1, capacity=512,
                                     gc_slack=64), 1, 1, 8, radix=True)):
        with pytest.raises(ValueError):
            fn()
    # at 2^27 pages exactly there is still one PML4 entry
    tpv.check_config(1 << 27, 8, True, "radix")
    assert tpv.levels(1 << 27) == (1 << 18, 512, 1)


def test_wrappers_route_cpu_to_plain_and_check_shapes():
    P, S = 1500, 20
    opc = torch.tensor([1, 4, 0], dtype=torch.int32)
    args = torch.tensor([[508, 41, 9], [5, 0, 0], [0, 0, 0]],
                        dtype=torch.int32)
    pt = torch.zeros((2, P), dtype=torch.int32)
    lv = [torch.zeros((n,), dtype=torch.int32) for n in tpv.levels(P)]
    counts = [k.launches for k in tpv.KERNELS]
    out = tpv.vspace_radix_replay(opc, args, pt, *lv, P, S)
    assert out[4].tolist() == [9, 4, 0]  # 4 of the 9 were walked again
    assert out[1].tolist() == [0, 1, 0] and out[2].tolist() == [1]
    assert out[0][:, 508:517].tolist() == [[0] * 4 + [46, 47, 48, 49, 50]] * 2
    planes = (torch.zeros_like(pt[:1]), torch.zeros_like(pt[:1]),
              torch.zeros_like(lv[0]))
    pout = tpv.vspace_radix_plan_replay(opc, args, pt[:1], *lv, *planes,
                                        P, S)
    assert pout[4][0].nonzero().flatten().tolist() == list(range(512, 517))
    assert pout[5][0].nonzero().flatten().tolist() == list(range(512))
    assert pout[6].tolist() == [1, 1, 0]
    assert int(pt.abs().sum()) == 0  # out of place
    assert counts == [k.launches for k in tpv.KERNELS]
    with pytest.raises(ValueError):  # wrong level width is refused
        tpv.vspace_radix_replay(opc, args, pt, lv[0][:2], *lv[1:], P, S)
    with pytest.raises(ValueError):  # wrong dtype is refused
        tpv.vspace_radix_replay(opc, args, pt.long(), *lv, P, S)


def test_interop_round_trips_both_layouts():
    P, R = 1500, 2
    jd = j_make_radix(P, max_span=8)
    model = j_replicate(torn_state(jd, P), R)
    tm = interop.radix_from_numpy(model, CPU)
    assert tm["pd"].dtype == torch.bool and tm["pt"].shape == (R, P)
    back = interop.radix_to_numpy(tm)
    for k in KEYS:
        assert np.array_equal(back[k], np.asarray(model[k]))
    kern = jpv.pallas_vspace_state(P, R, True, torn_state(jd, P))
    tk = interop.radix_from_numpy(kern, CPU, layout="kernel")
    assert tk["pd"].dtype == torch.int32 and tk["pt"].dim() == 3
    view = tpv.model_view(tk, P, True)
    jview = jpv.model_view(kern, P, True)
    for k in KEYS:
        _eq(jview[k], view[k], k)
    with pytest.raises(ValueError):
        interop.radix_from_numpy(model, CPU, layout="kernel")
