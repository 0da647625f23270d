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
