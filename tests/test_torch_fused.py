"""Differential tests of the port's fused combiner round
(`node_replication_torch/ops/replay.py:FusedHashmapEngine`, its kernel
run through the plain version on the CPU) against the reference engine
built with `interpret=True`, in the shape of
`tests/test_pallas_fused.py::TestFusedRoundBitIdentity`: 30 rounds, two
ring wraps, a fence/repair cycle. Ring planes, cursors, states and the
`round_fn` responses must be bit-identical. Then `round_fn` (K1 over
the model's `[R, K]` states, `hashmap_fused_round_model`) at edge
shapes against the reference engine's round and against the planes'
plain round (`hashmap_fused_round_plain`, over `[Kp, R]` planes) with
the transposes around it, and that plain round against the reference
engine's round over the planes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core.log import LogSpec as JSpec
from node_replication_tpu.core.log import log_init as j_log_init
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.ops.encoding import encode_ops as j_encode

from node_replication_torch import interop
from node_replication_torch.core.log import LogSpec as TSpec
from node_replication_torch.core.log import log_append, log_exec_all
from node_replication_torch.core.log import log_init as t_log_init
from node_replication_torch.core.replica import replicate_state as t_replicate
from node_replication_torch.models import make_hashmap as t_make_hashmap
from node_replication_torch.ops.encoding import encode_ops as t_encode
from node_replication_torch.ops.replay import (
    FUSED_KERNEL,
    hashmap_fused_round_model,
    hashmap_fused_round_plain,
)
from node_replication_torch.ops.ring import (
    fused_cursor_lattice,
    fused_window_ok,
    window_rows,
)

CPU = "cpu"


def _mixed_ops(rng, n, n_keys):
    ops = []
    for _ in range(n):
        if rng.random() < 0.7:
            ops.append((1, int(rng.integers(-n_keys, 2 * n_keys)),
                        int(rng.integers(1000))))
        else:
            ops.append((2, int(rng.integers(n_keys))))
    return ops


def _eq(a, b, what=""):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _log_eq(jl, tl, what=""):
    for f in jl._fields:
        _eq(getattr(jl, f), getattr(tl, f), f"{what} {f}")


def _reseat(log, rid, donor):
    lt = log.ltails.clone()
    lt[rid] = lt[donor]
    return log._replace(ltails=lt)


def test_eligibility_rule_is_the_reference_rule():
    for w in (1, 5, 127, 128, 129, 512):
        worst = (127 + w + 127) // 128
        assert window_rows(w) >= worst
    assert fused_window_ok(512, 64) and fused_window_ok(512, 256)
    assert not fused_window_ok(512, 512)
    assert not fused_window_ok(96, 8)


def test_rounds_including_wrap_and_fence_match_reference():
    K, R = 13, 4
    jspec = JSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    tspec = TSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    jeng = j_make_hashmap(K).fused_factory(jspec, interpret=True)
    td = t_make_hashmap(K)
    teng = td.fused_factory(tspec, device=CPU)
    assert teng.supports(16) and teng.launches(16) == 1
    assert not teng.supports(256)  # the reference's rule: no room
    rng = np.random.default_rng(0)
    jl, tl, sl = j_log_init(jspec), t_log_init(tspec, CPU), \
        t_log_init(tspec, CPU)
    js = j_replicate(j_make_hashmap(K).init_state(), R)
    ts = t_replicate(td.init_state(CPU), R)
    ss = t_replicate(td.init_state(CPU), R)
    fenced = None
    # 30 rounds of 18..24 ops (padded to 32) wrap the 256-slot ring
    # twice; fencing toggles mid-run
    for rnd in range(30):
        n = int(rng.integers(18, 25))
        ops = _mixed_ops(rng, n, K)
        jo, ja, _ = j_encode(ops, 3, pad_to=32)
        to, ta, _ = t_encode(ops, 3, pad_to=32, device=CPU)
        if rnd == 12:
            fenced = np.zeros(R, bool)
            fenced[2] = True
        if rnd == 20:
            # repair: reseat replica 2 from donor 0, then unfence
            fenced = None
            js = jax.tree.map(lambda x: x.at[2].set(x[0]), js)
            jl = jl._replace(ltails=jl.ltails.at[2].set(jl.ltails[0]))
            for st in (ts, ss):
                for f in st:
                    st[f][2] = st[f][0]
            tl, sl = _reseat(tl, 2, 0), _reseat(sl, 2, 0)
        jl, js, jr = jeng.round(jl, js, jo, ja, n, fenced=fenced)
        tl, ts, tr = teng.round(tl, ts, to, ta, n, fenced=fenced)
        _log_eq(jl, tl, f"round {rnd}")
        _eq(js["values"], ts["values"], f"values {rnd}")
        _eq(js["present"], ts["present"], f"present {rnd}")
        _eq(jr, tr, f"resps {rnd}")
        # and the port's own append+scan chain agrees with its fused tier
        f = None if fenced is None else torch.from_numpy(fenced)
        sl = log_append(tspec, sl, to, ta, n)
        while True:
            lts = sl.ltails.numpy()
            live = lts if fenced is None else lts[~fenced]
            if int(live.min()) >= int(sl.tail):
                break
            sl, ss, sr = log_exec_all(tspec, td, sl, ss, 32, fenced=f)
        live = np.ones(R, bool) if fenced is None else ~fenced
        assert np.array_equal(sr.numpy()[live, :n], tr.numpy()[live, :n])
        for fld in ("opcodes", "args", "tail", "ctail", "head", "ltails"):
            assert torch.equal(getattr(sl, fld), getattr(tl, fld)), fld
        assert torch.equal(ss["values"], ts["values"])
    assert int(tl.tail) > 2 * tspec.capacity


def test_raw_round_kernel_layout_matches_reference():
    K, R = 11, 8
    jspec = JSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    tspec = TSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    jeng = j_make_hashmap(K).fused_factory(jspec, interpret=True)
    rng = np.random.default_rng(5)
    ops = _mixed_ops(rng, 8, K)
    jo, ja, _ = j_encode(ops, 3, pad_to=8)
    to, ta, _ = t_encode(ops, 3, pad_to=8, device=CPU)
    kp = _kp(K)
    vals = rng.integers(0, 50, (kp, R)).astype(np.int32)
    pres = (rng.random((kp, R)) < 0.5).astype(np.int32)
    # start mid-stream: a ring past one wrap holding old entries, all
    # cursors at the tail; the port takes the reference's log and planes
    # through `interop` and hands its results back the same way
    jl = j_log_init(jspec)._replace(
        opcodes=jnp.asarray(rng.integers(0, 3, 256).astype(np.int32)),
        tail=jnp.int64(300), ctail=jnp.int64(300), head=jnp.int64(300),
        ltails=jnp.full((R,), 300, jnp.int64))
    tl = interop.log_from_numpy(jl, CPU)
    fen = np.zeros(R, bool)
    fen[[1, 6]] = True
    for fenced in (None, fen):
        jraw = jeng.raw_round(8, fenced is not None)
        extra_j = () if fenced is None else (jnp.asarray(fenced),)
        jout = jraw(jl, jnp.asarray(vals), jnp.asarray(pres), jo, ja, 7,
                    *extra_j)
        planes = interop.planes_from_numpy({"values": vals,
                                            "present": pres}, CPU)
        tout = _planes_round(tspec, tl, planes["values"], planes["present"],
                             to, ta, 7, K, fenced)
        got = interop.log_to_numpy(tout[0])
        for f in jl._fields:
            a = np.asarray(getattr(jout[0], f))
            assert a.dtype == got[f].dtype and np.array_equal(a, got[f]), f
        got = interop.planes_to_numpy({"values": tout[1],
                                       "present": tout[2]})
        _eq(jout[1], torch.from_numpy(got["values"]), "values")
        _eq(jout[2], torch.from_numpy(got["present"]), "present")
        _eq(jout[3], tout[3], "resps")


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    K, R = 5, 2
    spec = TSpec(capacity=256, n_replicas=R, gc_slack=64)
    log = t_log_init(spec, CPU)
    to, ta, _ = t_encode([(1, 3, 9), (2, 3)], 3, pad_to=2, device=CPU)
    vals = torch.zeros((R, K), dtype=torch.int32)
    pres = torch.zeros((R, K), dtype=torch.bool)
    before = FUSED_KERNEL.launches
    out = hashmap_fused_round_model(spec, log.tail, 2, to, ta, log.opcodes,
                                    log.args, vals, pres, K)
    assert FUSED_KERNEL.launches == before  # the plain version ran
    assert out[0][:2].tolist() == [1, 2] and out[4].tolist() == [[0, 1],
                                                                 [0, 1]]
    with pytest.raises(ValueError):  # wrong dtype is refused
        hashmap_fused_round_model(spec, log.tail, 2, to, ta, log.opcodes,
                                  log.args, vals.long(), pres, K)


def _kp(K: int) -> int:
    """Key rows of the planes: K rounded up to 8."""
    return -(-K // 8) * 8


def _planes_round(spec, log, vals_t, pres_t, opcodes, args, count, K,
                  fenced=None):
    """The planes' plain round as a whole round: `(log, vals_t, pres_t,
    resps[W, R])`, the ring appended and the cursors joined."""
    fen = (None if fenced is None
           else torch.as_tensor(fenced).to(torch.int32))
    ring_opc, ring_args, vals_t, pres_t, resps = hashmap_fused_round_plain(
        spec, log.tail, count, opcodes, args, log.opcodes, log.args, vals_t,
        pres_t, K, fen)
    log = fused_cursor_lattice(
        log._replace(opcodes=ring_opc, args=ring_args), count, fenced)
    return log, vals_t, pres_t, resps


def _mid_stream_log(spec, rng, tail=300):
    """A reference log whose ring is past one wrap and holds old
    entries, every cursor at the tail."""
    L, R = spec.capacity, spec.n_replicas
    return j_log_init(spec)._replace(
        opcodes=jnp.asarray(rng.integers(0, 3, L).astype(np.int32)),
        args=jnp.asarray(
            rng.integers(-9, 9, (L, spec.arg_width)).astype(np.int32)),
        tail=jnp.int64(tail), ctail=jnp.int64(tail), head=jnp.int64(tail),
        ltails=jnp.full((R,), tail, jnp.int64))


# (K, R, W, count, fenced replicas): K not a multiple of 8 (the planes'
# padding rows), R % 4 != 0, two fenced replicas, windows of 1 and 8
# with NOOP padding past `count` (down to an empty round); every window
# has keys below 0 and at or above K, and inert opcodes
MODEL_CASES = {
    "kp_pad": (13, 4, 8, 8, ()),
    "r_odd": (16, 5, 8, 8, ()),
    "fenced": (13, 6, 8, 7, (1, 4)),
    "fenced_r_odd": (9, 7, 8, 8, (0, 6)),
    "w1": (11, 3, 1, 1, ()),
    "w1_fenced": (11, 3, 1, 1, (0, 2)),
    "w8_padded": (24, 4, 8, 3, ()),
    "empty": (13, 5, 8, 0, (1, 3)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_layout_round_equals_raw_round_transposed(case):
    K, R, W, count, fen_rows = MODEL_CASES[case]
    spec = TSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    jspec = JSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    eng = t_make_hashmap(K).fused_factory(spec, device=CPU)
    jeng = j_make_hashmap(K).fused_factory(jspec, interpret=True)
    rng = np.random.default_rng(list(MODEL_CASES).index(case))
    opc = np.zeros(W, np.int32)
    args = np.zeros((W, 3), np.int32)
    opc[:count] = rng.choice(np.array([1, 1, 2, 2, 7], np.int32), count)
    args[:count, 0] = rng.integers(-2 * K, 3 * K, count)
    args[:count, 1] = rng.integers(-1000, 1000, count)
    if count >= 2:
        args[0, 0], args[1, 0] = -K - 3, K + 2
    opc_t, args_t = torch.from_numpy(opc), torch.from_numpy(args)
    values = rng.integers(-50, 50, (R, K)).astype(np.int32)
    present = rng.random((R, K)) < 0.5
    jl = _mid_stream_log(jspec, rng)
    log = interop.log_from_numpy(jl, CPU)
    fenced = None
    if fen_rows:
        fenced = np.zeros(R, bool)
        fenced[list(fen_rows)] = True
    extra = () if fenced is None else (torch.from_numpy(fenced),)
    before = FUSED_KERNEL.launches
    lm, sm, rm = eng.round_fn(W, fenced is not None)(
        log, {"values": torch.from_numpy(values),
              "present": torch.from_numpy(present)},
        opc_t, args_t, count, *extra)
    # the plain version ran: no launch counted
    assert FUSED_KERNEL.launches == before
    # the reference engine's round over the same model-layout states
    jl, js, jr = jeng.round(
        jl, {"values": jnp.asarray(values), "present": jnp.asarray(present)},
        jnp.asarray(opc), jnp.asarray(args), count, fenced=fenced)
    _log_eq(jl, lm, case)
    _eq(js["values"], sm["values"], "values")
    _eq(js["present"], sm["present"], "present")
    _eq(jr, rm, "resps")
    vt = torch.zeros((_kp(K), R), dtype=torch.int32)
    vt[:K] = torch.from_numpy(values).T
    pt = torch.zeros_like(vt)
    pt[:K] = torch.from_numpy(present).T
    lr, vt, pt, rr = _planes_round(spec, log, vt, pt, opc_t, args_t, count,
                                   K, fenced)
    for f in lr._fields:
        a, b = getattr(lm, f), getattr(lr, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert sm["values"].dtype == torch.int32
    assert sm["present"].dtype == torch.bool
    assert torch.equal(sm["values"], vt[:K].T)
    assert torch.equal(sm["present"], (pt[:K] > 0).T)
    want = rr.T.clone()
    if fenced is not None:
        want[torch.from_numpy(fenced)] = 0
        # a fenced replica keeps its input and answers 0
        assert np.array_equal(sm["values"].numpy()[fenced], values[fenced])
        assert np.array_equal(sm["present"].numpy()[fenced],
                              present[fenced])
    assert rm.dtype == torch.int32 and torch.equal(rm, want)
    assert not rm[:, count:].any()  # NOOP padding answers 0
    if fenced is None and count:
        assert int(lm.tail) == 300 + count and torch.equal(
            lm.ltails, lm.tail.expand(R))


def test_model_wrapper_checks_the_states_and_round_fn_takes_views():
    K, R, W = 10, 4, 8
    spec = TSpec(capacity=256, n_replicas=R, arg_width=3, gc_slack=64)
    log = t_log_init(spec, CPU)
    to, ta, _ = t_encode([(1, 3, 9), (2, 3), (1, -4, 5)], 3, pad_to=W,
                         device=CPU)
    vals = torch.arange(R * K, dtype=torch.int32).reshape(R, K)
    pres = (vals % 3) == 0
    ring = (log.tail, 3, to, ta, log.opcodes, log.args)
    out = hashmap_fused_round_model(spec, *ring, vals, pres, K)
    assert out[4].shape == (R, W) and out[4][:, 1].tolist() == [1] * R
    assert out[2][:, 3].tolist() == [0] * R and out[2][:, 6].tolist() \
        == [5] * R
    for bad in ((vals, pres.int()), (vals.long(), pres),
                (vals.T.contiguous(), pres.T.contiguous()),
                (vals.T.contiguous().T, pres)):
        with pytest.raises(ValueError):
            hashmap_fused_round_model(spec, *ring, *bad, K)
    with pytest.raises(ValueError):  # n_keys other than the states'
        hashmap_fused_round_model(spec, *ring, vals, pres, K + 1)
    # round_fn hands K1 contiguous states, whatever view it was given
    eng = t_make_hashmap(K).fused_factory(spec, device=CPU)
    views = {"values": vals.T.contiguous().T,
             "present": pres.T.contiguous().T}
    assert not views["values"].is_contiguous()
    _, st, resps = eng.round_fn(W)(log, views, to, ta, 3)
    assert torch.equal(st["values"], out[2])
    assert torch.equal(st["present"], out[3])
    assert torch.equal(resps, out[4])
