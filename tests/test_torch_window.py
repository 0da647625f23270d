"""Differential tests of the port's hashmap model
(`node_replication_torch/models/hashmap.py`) against the reference:
the combined replay `window_plan`/`window_merge`/`window_apply`, the
per-op write/read transitions, and the prefix-absorbing property the
union-window catch-up tier relies on
(`tests/test_window.py::test_plan_is_prefix_absorbing`). Bit-identical
(every value is an integer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.ops.encoding import apply_read as j_apply_read
from node_replication_tpu.ops.encoding import apply_write as j_apply_write

from node_replication_torch.core.replica import replicate_state
from node_replication_torch.models import make_hashmap as t_make_hashmap
from node_replication_torch.ops.encoding import apply_read, apply_write

CPU = "cpu"


def _window(rng, W, K):
    # PUT/REMOVE plus NOOP and unknown opcodes; keys past K and
    # negative, so the floored modulo is exercised
    opc = rng.choice(np.array([0, 1, 1, 2, 2, 3, -1], np.int32), W)
    args = np.stack([rng.integers(-2 * K, 2 * K, W),
                     rng.integers(1, 999, W),
                     rng.integers(0, 9, W)], axis=1).astype(np.int32)
    return opc, args


def _state(rng, K):
    return {"values": rng.integers(-5, 99, K).astype(np.int32),
            "present": rng.random(K) < 0.5}


def _eq(a, b, what=""):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("K,W", [(5, 1), (5, 8), (64, 64), (29, 37)])
def test_plan_merge_apply_bit_identical(K, W):
    rng = np.random.default_rng(K * 100 + W)
    jd, td = j_make_hashmap(K), t_make_hashmap(K)
    for _ in range(3):
        st = _state(rng, K)
        opc, args = _window(rng, W, K)
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
        jplan = jd.window_plan(jst, jnp.asarray(opc), jnp.asarray(args))
        tplan = td.window_plan(tst, torch.from_numpy(opc),
                               torch.from_numpy(args))
        for f in ("touched", "value", "present", "resps"):
            _eq(jplan[f], tplan[f], f)
        jm, jr = jd.window_merge(jst, jplan)
        tm, tr = td.window_merge(tst, tplan)
        _eq(jm["values"], tm["values"])
        _eq(jm["present"], tm["present"])
        _eq(jr, tr)
        ja, jar = jd.window_apply(jst, jnp.asarray(opc), jnp.asarray(args))
        ta, tar = td.window_apply(tst, torch.from_numpy(opc),
                                  torch.from_numpy(args))
        _eq(ja["values"], ta["values"])
        _eq(ja["present"], ta["present"])
        _eq(jar, tar)


def test_batched_window_apply_is_per_replica_apply():
    # the port's per-replica window_apply tier runs R plans at once over
    # a leading batch axis: each row must equal its own reference apply
    K, W, R = 17, 24, 5
    rng = np.random.default_rng(3)
    jd, td = j_make_hashmap(K), t_make_hashmap(K)
    sts = [_state(rng, K) for _ in range(R)]
    wins = [_window(rng, W, K) for _ in range(R)]
    tst = {f: torch.from_numpy(np.stack([s[f] for s in sts]))
           for f in ("values", "present")}
    topc = torch.from_numpy(np.stack([w[0] for w in wins]))
    targs = torch.from_numpy(np.stack([w[1] for w in wins]))
    tout, tresps = td.window_apply(tst, topc, targs)
    for r in range(R):
        jout, jresps = jd.window_apply(
            {f: jnp.asarray(v) for f, v in sts[r].items()},
            jnp.asarray(wins[r][0]), jnp.asarray(wins[r][1]))
        _eq(jout["values"], tout["values"][r])
        _eq(jout["present"], tout["present"][r])
        _eq(jresps, tresps[r])


def test_write_and_read_ops_bit_identical():
    # the table-indexed branch selection (apply_write/apply_read) against
    # the reference's lax.switch, op by op, one replica per lane
    K, R, N = 11, 6, 40
    rng = np.random.default_rng(5)
    jd, td = j_make_hashmap(K), t_make_hashmap(K)
    jw = jax.jit(jax.vmap(lambda s, o, a: j_apply_write(jd, s, o, a)))
    jrd = jax.jit(jax.vmap(lambda s, o, a: j_apply_read(jd, s, o, a)))
    st = {"values": rng.integers(0, 50, (R, K)).astype(np.int32),
          "present": rng.random((R, K)) < 0.5}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    for _ in range(N):
        opc, args = _window(rng, R, K)
        jst, jr = jw(jst, jnp.asarray(opc), jnp.asarray(args))
        tr = apply_write(td, tst, torch.from_numpy(opc),
                         torch.from_numpy(args))
        _eq(jr, tr)
        ropc = rng.choice(np.array([0, 1, 2, -3], np.int32), R)
        _eq(jrd(jst, jnp.asarray(ropc), jnp.asarray(args)),
            apply_read(td, tst, torch.from_numpy(ropc),
                       torch.from_numpy(args)))
    _eq(jst["values"], tst["values"])
    _eq(jst["present"], tst["present"])


@pytest.mark.parametrize("N,snaps", [(64, (16, 25, 48)), (40, (0, 7, 40))])
def test_plan_is_prefix_absorbing(N, snaps):
    # merging plan(state(m), [m, end)) into a replica ALREADY at any p in
    # [m, end] must land exactly on state(end)
    K = 30
    d = t_make_hashmap(K)
    rng = np.random.default_rng(1)
    opcodes = torch.from_numpy(rng.integers(0, 3, N).astype(np.int32))
    args = torch.from_numpy(np.stack(
        [rng.integers(0, 30, N), rng.integers(1, 60, N),
         rng.integers(0, 9, N)], axis=1).astype(np.int32))
    lo, _mid, hi = snaps
    fleet = replicate_state(d.init_state(CPU), 1)
    snap = {}
    for i in range(N):
        if i in snaps:
            snap[i] = {k: v.clone() for k, v in fleet.items()}
        apply_write(d, fleet, opcodes[i:i + 1], args[i:i + 1])
    snap[N] = fleet
    plan = d.window_plan({k: v[0] for k, v in snap[lo].items()},
                         opcodes[lo:hi], args[lo:hi])
    for p in snaps:
        merged, _ = d.window_merge(snap[p], plan)
        for f in ("values", "present"):
            assert torch.equal(merged[f], snap[hi][f]), (p, f)


# ------------------------------------------- windowkit and the models
# stack, queue, sortedset, memfs (`tests/test_window.py`'s
# TestStack/Queue/SortedSet/MemfsWindowApply and TestCombinedCatchup's
# prefix-absorbing cases), each against the reference bit for bit


def _jnp_tree(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _torch_tree(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


@pytest.mark.parametrize("W", [1, 2, 3, 7, 8, 64, 100])
def test_associative_scan_matches_jax(W):
    # the clamped-walk composition on random int32 triples that reach
    # the int32 limits, and a three-leaf segmented form: same bits as
    # jax.lax.associative_scan, bracketing included
    from node_replication_torch.ops.windowkit import associative_scan

    def compose(mod):
        def c(f, g):
            af, lf, hf = f
            ag, lg, hg = g
            return (af + ag,
                    mod.minimum(mod.maximum(lf + ag, lg), hg),
                    mod.minimum(mod.maximum(hf + ag, lg), hg))
        return c

    rng = np.random.default_rng(W)
    lim = np.iinfo(np.int32)
    for batch in ((), (3,)):
        xs = [rng.integers(lim.min, lim.max, batch + (W,), dtype=np.int64,
                           endpoint=True).astype(np.int32)
              for _ in range(3)]
        xs[0][..., :2] = lim.max  # wraps on the first combine
        got = associative_scan(compose(torch),
                               tuple(torch.from_numpy(x) for x in xs))
        want = jax.jit(lambda *e: jax.lax.associative_scan(
            compose(jnp), e, axis=-1))(*(jnp.asarray(x) for x in xs))
        for a, b in zip(want, got):
            _eq(a, b)


def test_windowkit_helpers_match_reference():
    from node_replication_torch.ops import windowkit as tw
    from node_replication_tpu.ops import windowkit as jw

    walk = jax.jit(jw.clamped_walk, static_argnums=(1, 2))
    resolve = jax.jit(jw.slot_resolve, static_argnums=(4,))
    table = jax.jit(jw.last_update_table, static_argnums=(2,))
    rng = np.random.default_rng(4)
    for W, n in ((1, 3), (17, 5), (64, 9)):
        delta = rng.integers(-1, 2, W).astype(np.int32)
        x0 = int(rng.integers(0, n + 1))
        for a, b in zip(walk(jnp.asarray(delta), 0, n, x0),
                        tw.clamped_walk(torch.from_numpy(delta), 0, n,
                                        x0)):
            _eq(a, b)
        kind = rng.integers(0, 3, W)
        upd = np.where(kind == 1, rng.integers(0, n, W), n).astype(np.int32)
        qry = np.where(kind == 2, rng.integers(0, n, W), n).astype(np.int32)
        val = rng.integers(-99, 99, W).astype(np.int32)
        init = rng.integers(-99, 99, n).astype(np.int32)
        want = resolve(jnp.asarray(upd), jnp.asarray(val),
                               jnp.asarray(qry), jnp.asarray(init), n)
        got = tw.slot_resolve(torch.from_numpy(upd), torch.from_numpy(val),
                              torch.from_numpy(qry),
                              torch.from_numpy(init), n)
        live = kind == 2
        assert np.array_equal(np.asarray(want)[live], got.numpy()[live])
        for a, b in zip(table(jnp.asarray(upd),
                                             jnp.asarray(val), n),
                        tw.last_update_table(torch.from_numpy(upd),
                                             torch.from_numpy(val), n)):
            _eq(a, b)


def _stack_case(mod, C):
    def state(rng):
        return {"buf": rng.integers(0, 99, C).astype(np.int32),
                "top": np.int32(rng.integers(0, C + 1))}
    return mod.make_stack(C), state, np.array([0, 1, 1, 2, 2, 9], np.int32)


def _queue_case(mod, C):
    def state(rng):
        h = int(rng.integers(-20, 20))
        return {"buf": rng.integers(0, 99, C).astype(np.int32),
                "head": np.int32(h),
                "tail": np.int32(h + rng.integers(0, C + 1))}
    return mod.make_queue(C), state, np.array([0, 1, 1, 2, 2, 9], np.int32)


def _sortedset_case(mod, K):
    def state(rng):
        return {"present": rng.random(K) < 0.5}
    return mod.make_sortedset(K), state, np.array([0, 1, 1, 2, 2, 9],
                                                  np.int32)


def _memfs_case(mod, F, B=4):
    def state(rng):
        return {"data": rng.integers(0, 99, (F, B)).astype(np.int32),
                "size": rng.integers(0, B + 1, F).astype(np.int32)}
    return (mod.make_memfs(F, B), state,
            np.array([0, 1, 1, 1, 2, 3, 3, 9], np.int32))


CASES = {"stack": (_stack_case, 7), "queue": (_queue_case, 3),
         "sortedset": (_sortedset_case, 13), "memfs": (_memfs_case, 5)}


def _case_window(rng, opcs, W, n):
    opc = rng.choice(opcs, W).astype(np.int32)
    # out-of-range and negative args pin the clip/-1/floored-mod edges
    args = np.stack([rng.integers(-n - 2, 2 * n + 2, W),
                     rng.integers(-1, 6, W),
                     rng.integers(1, 100, W)], axis=1).astype(np.int32)
    return opc, args


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_model_plan_apply_and_fold_bit_identical(name, seed):
    # plan, merge and apply against the reference's; the port's
    # per-op fleet transitions folded in order against the reference's
    # apply_write fold; and a leading batch axis equal to per-row applies
    import node_replication_tpu.models as jm
    import node_replication_torch.models as tm

    mk, n = CASES[name]
    (jd, gen, opcs), (td, _, _) = mk(jm, n), mk(tm, n)
    rng = np.random.default_rng(seed)
    W, R = 48, 3
    st = gen(rng)
    opc, args = _case_window(rng, opcs, W, n)
    jst, tst = _jnp_tree(st), _torch_tree(st)
    j_plan, j_apply = jax.jit(jd.window_plan), jax.jit(jd.window_apply)
    jplan = j_plan(jst, jnp.asarray(opc), jnp.asarray(args))
    tplan = td.window_plan(tst, torch.from_numpy(opc),
                           torch.from_numpy(args))
    assert set(jplan) == set(tplan)
    for f in jplan:
        _eq(jplan[f], tplan[f], f)
    jout, jr = j_apply(jst, jnp.asarray(opc), jnp.asarray(args))
    tout, tr = td.window_apply(tst, torch.from_numpy(opc),
                               torch.from_numpy(args))
    for f in jout:
        _eq(jout[f], tout[f], f)
    _eq(jr, tr)
    step = jax.jit(lambda s, o, a: j_apply_write(jd, s, o, a))
    fleet = replicate_state(tst, R)
    for i in range(W):
        jst, r = step(jst, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        got = apply_write(td, fleet, torch.full((R,), int(opc[i]),
                                                dtype=torch.int32),
                          torch.from_numpy(np.repeat(args[i:i + 1], R, 0)))
        assert (got == int(r)).all() and int(r) == int(tr[i]), i
    for f in jst:
        _eq(jst[f], fleet[f][R - 1], f)
        _eq(jout[f], fleet[f][0], f)
    sts = [gen(rng) for _ in range(R)]
    wins = [_case_window(rng, opcs, W, n) for _ in range(R)]
    bst = {f: torch.from_numpy(np.stack([s[f] for s in sts])) for f in st}
    bout, bresps = td.window_apply(
        bst, torch.from_numpy(np.stack([w[0] for w in wins])),
        torch.from_numpy(np.stack([w[1] for w in wins])))
    for r in range(R):
        jo, jrs = j_apply(_jnp_tree(sts[r]), jnp.asarray(wins[r][0]),
                          jnp.asarray(wins[r][1]))
        for f in jo:
            _eq(jo[f], bout[f][r], f)
        _eq(jrs, bresps[r])


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_reads_bit_identical(name):
    import node_replication_tpu.models as jm
    import node_replication_torch.models as tm

    mk, n = CASES[name]
    (jd, gen, _), (td, _, _) = mk(jm, n), mk(tm, n)
    rng = np.random.default_rng(8)
    R = 6
    sts = [gen(rng) for _ in range(R)]
    jst = {f: jnp.asarray(np.stack([s[f] for s in sts])) for f in sts[0]}
    tst = {f: torch.from_numpy(np.stack([s[f] for s in sts]))
           for f in sts[0]}
    jrd = jax.jit(jax.vmap(lambda s, o, a: j_apply_read(jd, s, o, a)))
    for _ in range(6):
        opc = rng.integers(-1, 5, R).astype(np.int32)
        args = np.stack([rng.integers(-n - 2, 2 * n + 2, R),
                         rng.integers(-n, 2 * n, R),
                         rng.integers(0, 9, R)], axis=1).astype(np.int32)
        _eq(jrd(jst, jnp.asarray(opc), jnp.asarray(args)),
            apply_read(td, tst, torch.from_numpy(opc),
                       torch.from_numpy(args)))


def test_stack_pop_sees_in_window_push_not_initial():
    from node_replication_torch.models import make_stack

    d = make_stack(4)
    st0 = {"buf": torch.tensor([99, 0, 0, 0], dtype=torch.int32),
           "top": torch.tensor(1, dtype=torch.int32)}
    ops = [(2, 0), (2, 0), (1, 7), (1, 8), (2, 0), (1, 9), (2, 0), (2, 0)]
    opcodes = torch.tensor([o[0] for o in ops], dtype=torch.int32)
    args = torch.zeros((len(ops), 3), dtype=torch.int32)
    args[:, 0] = torch.tensor([o[1] for o in ops], dtype=torch.int32)
    state, resps = d.window_apply(st0, opcodes, args)
    assert resps.tolist() == [99, -1, 1, 2, 8, 2, 9, 7]
    assert int(state["top"]) == 0


def test_memfs_truncate_then_write_then_logged_read():
    from node_replication_torch.models import make_memfs

    d = make_memfs(2, 4)
    st0 = {"data": torch.zeros((2, 4), dtype=torch.int32),
           "size": torch.zeros((2,), dtype=torch.int32)}
    st0["data"][0, 0] = 7
    st0["size"][0] = 1
    ops = [(3, 0, 0, 0), (2, 0, 0, 0), (3, 0, 0, 0), (1, 0, 2, 55),
           (3, 0, 2, 0), (3, 0, 0, 0)]
    opcodes = torch.tensor([o[0] for o in ops], dtype=torch.int32)
    args = torch.tensor([list(o[1:]) for o in ops], dtype=torch.int32)
    state, resps = d.window_apply(st0, opcodes, args)
    assert resps.tolist() == [7, 1, 0, 3, 55, 0]
    assert int(state["size"][0]) == 3
    assert int(state["data"][0, 0]) == 0 and int(state["data"][0, 2]) == 55


def test_queue_ring_wrap_with_offset_cursors():
    # cursors far from zero on a capacity-3 ring churned through many
    # generations, against the reference's fold
    import node_replication_tpu.models as jm
    import node_replication_torch.models as tm

    jd, td = jm.make_queue(3), tm.make_queue(3)
    st = {"buf": np.array([5, 6, 7], np.int32), "head": np.int32(4),
          "tail": np.int32(6)}
    rng = np.random.default_rng(9)
    W = 96
    opc = rng.choice([1, 2], size=W).astype(np.int32)
    args = np.zeros((W, 3), np.int32)
    args[:, 0] = rng.integers(1, 100, W)
    jst = _jnp_tree(st)
    step = jax.jit(lambda s, o, a: j_apply_write(jd, s, o, a))
    want = []
    for i in range(W):
        jst, r = step(jst, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        want.append(int(r))
    got, resps = td.window_apply(_torch_tree(st), torch.from_numpy(opc),
                                 torch.from_numpy(args))
    assert resps.tolist() == want
    for f in jst:
        _eq(jst[f], got[f], f)


@pytest.mark.parametrize("name", ["stack", "queue", "sortedset", "memfs"])
def test_new_model_plans_are_prefix_absorbing(name):
    # window_canonical=True: merging plan(state(m), [m, end)) into a
    # replica already at any p in [m, end] lands on state(end)
    import node_replication_torch.models as tm

    mk, n = CASES[name]
    d, gen, opcs = mk(tm, n)
    assert d.window_canonical
    rng = np.random.default_rng(2)
    N, snaps = 40, (0, 9, 23, 40)
    opc, args = _case_window(rng, opcs, N, n)
    opc, args = torch.from_numpy(opc), torch.from_numpy(args)
    fleet = replicate_state(_torch_tree(gen(rng)), 1)
    snap = {}
    for i in range(N):
        if i in snaps:
            snap[i] = {k: v.clone() for k, v in fleet.items()}
        apply_write(d, fleet, opc[i:i + 1], args[i:i + 1])
    snap[N] = fleet
    plan = d.window_plan({k: v[0] for k, v in snap[0].items()}, opc, args)
    for p in snaps:
        merged, _ = d.window_merge(snap[p], plan)
        for f in merged:
            assert torch.equal(merged[f], snap[N][f]), (p, f)


@pytest.mark.parametrize("name", ["stack", "queue"])
def test_step_combined_matches_scan_and_reference(name):
    # `tests/test_window.py::TestStackWindowApply::test_step_combined_
    # matches_scan`: the port's combined and scan steps against each
    # other and against the reference's combined step
    import node_replication_tpu.models as jm
    import node_replication_torch.models as tm
    from node_replication_torch.core.log import LogSpec as TSpec
    from node_replication_torch.core.log import log_init as t_log_init
    from node_replication_torch.core.step import make_step as t_make_step
    from node_replication_tpu import LogSpec as JSpec
    from node_replication_tpu import log_init as j_log_init
    from node_replication_tpu import make_step as j_make_step
    from node_replication_tpu.core.replica import (
        replicate_state as j_replicate,
    )

    R, Bw, Br, C, STEPS = 3, 4, 2, 9, 5
    mk = {"stack": "make_stack", "queue": "make_queue"}[name]
    jd, td = getattr(jm, mk)(C), getattr(tm, mk)(C)
    kw = dict(capacity=2 * R * Bw, n_replicas=R, arg_width=3,
              gc_slack=R * Bw // 2)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    j_step = j_make_step(jd, jspec, Bw, Br, jit=True, donate=False,
                         combined=True)
    steps = {c: t_make_step(td, tspec, Bw, Br, combined=c)
             for c in (True, False)}
    jlog, jst = j_log_init(jspec), j_replicate(jd.init_state(), R)
    tl = {c: (t_log_init(tspec, CPU), replicate_state(td.init_state(CPU), R))
          for c in steps}
    rng = np.random.default_rng(2)
    for _ in range(STEPS):
        wr_opc = rng.choice([0, 1, 2], size=(R, Bw)).astype(np.int32)
        wr_args = rng.integers(1, 50, size=(R, Bw, 3)).astype(np.int32)
        rd_opc = rng.choice([1, 2], size=(R, Br)).astype(np.int32)
        rd_args = np.zeros((R, Br, 3), np.int32)
        jlog, jst, jwr, jrd = j_step(jlog, jst, jnp.asarray(wr_opc),
                                     jnp.asarray(wr_args),
                                     jnp.asarray(rd_opc),
                                     jnp.asarray(rd_args))
        for c, step in steps.items():
            log, st = tl[c]
            log, st, wr, rd = step(log, st, torch.from_numpy(wr_opc),
                                   torch.from_numpy(wr_args),
                                   torch.from_numpy(rd_opc),
                                   torch.from_numpy(rd_args))
            tl[c] = (log, st)
            _eq(jwr, wr)
            _eq(jrd, rd)
    for c in steps:
        for f in jst:
            _eq(jst[f], tl[c][1][f], f)
