"""Differential tests of the port's fused combiner round
(`node_replication_torch/ops/replay.py:FusedHashmapEngine`, its kernel
run through the plain version on the CPU) against the reference engine
built with `interpret=True`, in the shape of
`tests/test_pallas_fused.py::TestFusedRoundBitIdentity`: 30 rounds, two
ring wraps, a fence/repair cycle. Ring planes, cursors, states and the
`round_fn` responses must be bit-identical."""

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
    hashmap_fused_round,
)
from node_replication_torch.ops.ring import fused_window_ok, window_rows

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
    teng = t_make_hashmap(K).fused_factory(tspec, device=CPU)
    rng = np.random.default_rng(5)
    ops = _mixed_ops(rng, 8, K)
    jo, ja, _ = j_encode(ops, 3, pad_to=8)
    to, ta, _ = t_encode(ops, 3, pad_to=8, device=CPU)
    kp = teng.kp
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
        traw = teng.raw_round(8, fenced is not None)
        extra_j = () if fenced is None else (jnp.asarray(fenced),)
        extra_t = () if fenced is None else (torch.from_numpy(fenced),)
        jout = jraw(jl, jnp.asarray(vals), jnp.asarray(pres), jo, ja, 7,
                    *extra_j)
        planes = interop.planes_from_numpy({"values": vals,
                                            "present": pres}, CPU)
        tout = traw(tl, planes["values"], planes["present"], to, ta, 7,
                    *extra_t)
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
    vals = torch.zeros((8, R), dtype=torch.int32)
    before = FUSED_KERNEL.launches
    out = hashmap_fused_round(spec, log.tail, 2, to, ta, log.opcodes,
                              log.args, vals, vals.clone(), K)
    assert FUSED_KERNEL.launches == before  # the plain version ran
    assert out[0][:2].tolist() == [1, 2] and out[4].tolist() == [[0, 0],
                                                                 [1, 1]]
    with pytest.raises(ValueError):  # wrong dtype is refused
        hashmap_fused_round(spec, log.tail, 2, to, ta, log.opcodes,
                            log.args, vals.long(), vals, K)
