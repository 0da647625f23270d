"""Differential tests of the port's flat vspace model
(`node_replication_torch/models/vspace.py`) against the reference
(`node_replication_tpu/models/vspace.py`): the per-op write and read
transitions, the combined replay `window_plan`/`window_merge`/
`window_apply` (`tests/test_window.py::TestVSpaceWindowApply`), its
prefix-absorbing property (the vspace case of
`test_plan_is_prefix_absorbing`), and the model driven unchanged by
the port's step and catch-up engines. Windows carry negative vpages,
spans with n <= 0 and n > max_span, NOOP and unknown opcodes, pframe 0
and vpages near 2^31 (int32 wrap). Bit-identical, tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core import log as jlog
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.core.step import make_step as j_make_step
from node_replication_tpu.models import make_vspace as j_make_vspace
from node_replication_tpu.ops.encoding import apply_read as j_apply_read
from node_replication_tpu.ops.encoding import apply_write as j_apply_write

from node_replication_torch import interop
from node_replication_torch.core import log as tlog
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step as t_make_step
from node_replication_torch.models import make_vspace as t_make_vspace
from node_replication_torch.ops.encoding import apply_read, apply_write

CPU = "cpu"
CONFIGS = [(300, 5), (512, 8), (600, 8)]

j_write = jax.jit(j_apply_write, static_argnums=(0,))
j_read = jax.jit(j_apply_read, static_argnums=(0,))
j_exec = jax.jit(jlog.log_exec_all, static_argnums=(0, 1, 4))
j_catchup = jax.jit(jlog.log_catchup_all, static_argnums=(0, 1, 4),
                    static_argnames=("on_trajectory",))


def window(rng, W, P, S, near_wrap=True):
    """An adversarial window: MAP/UNMAP with NOOP and unknown opcodes,
    vpages in [-P, 2P) plus a few near 2^31, pframes from 0, spans from
    -1 to past max_span (overlapping spans are the common case)."""
    opc = rng.choice(np.array([0, 1, 2, 9, -3], np.int32), W,
                     p=[0.1, 0.45, 0.3, 0.1, 0.05])
    args = np.stack([rng.integers(-P, 2 * P, W), rng.integers(0, 60, W),
                     rng.integers(-1, S + 3, W)], axis=1).astype(np.int32)
    if near_wrap:
        k = max(1, W // 16)
        at = rng.choice(W, k, replace=False)
        args[at, 0] = (2 ** 31 - 1 - rng.integers(0, S, k)).astype(np.int32)
        args[at[: k // 2 + 1], 1] = 2 ** 31 - 2  # pframe + lane wraps too
    return opc, args


def frames0(rng, P):
    f = rng.integers(1, 90, P).astype(np.int32)
    f[rng.random(P) < 0.6] = 0  # unmapped
    return f


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("P,S", CONFIGS)
def test_write_and_read_ops_bit_identical(P, S):
    # the sequential fold, one op at a time, through both packages; the
    # port runs R = 3 identical replicas (its ops work on the replica
    # axis), the reference one
    rng = np.random.default_rng(P + S)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    opc, args = window(rng, 48, P, S)
    f0 = frames0(rng, P)
    js = {"frames": jnp.asarray(f0)}
    ts = replicate_state({"frames": torch.from_numpy(f0)}, 3)
    rd_opc = rng.choice(np.array([0, 1, 2, 5], np.int32), 48)
    rd_args = window(rng, 48, P, S)[1]
    rd_args[:, 1] = rng.integers(-1, S + 3, 48)
    for i in range(len(opc)):
        js, jr = j_write(jd, js, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        tr = apply_write(td, ts, torch.full((3,), int(opc[i]),
                                            dtype=torch.int32),
                         torch.from_numpy(np.repeat(args[i:i + 1], 3, 0)))
        assert tr.tolist() == [int(jr)] * 3, i
        jq = j_read(jd, js, jnp.asarray(rd_opc[i]), jnp.asarray(rd_args[i]))
        tq = apply_read(td, ts, torch.full((3,), int(rd_opc[i]),
                                           dtype=torch.int32),
                        torch.from_numpy(np.repeat(rd_args[i:i + 1], 3, 0)))
        assert tq.tolist() == [int(jq)] * 3, i
    for r in range(3):
        _eq(js["frames"], ts["frames"][r], f"replica {r}")


def test_lanes_mask_leaves_other_replicas_untouched():
    P, S = 300, 5
    td = t_make_vspace(P, max_span=S)
    st = replicate_state(td.init_state(CPU), 3)
    opc = torch.tensor([1, 0, 2], dtype=torch.int32)
    args = torch.tensor([[290, 9, 5], [290, 9, 5], [0, 4, 0]],
                        dtype=torch.int32)
    st["frames"][2, :4] = 3
    resp = apply_write(td, st, opc, args)
    assert resp.tolist() == [5, 0, 4]
    assert st["frames"][0, 290:295].tolist() == [9, 10, 11, 12, 13]
    assert int(st["frames"][1].abs().sum()) == 0
    assert st["frames"][2, :4].tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("P,S", CONFIGS)
@pytest.mark.parametrize("W", [1, 64])
def test_plan_merge_apply_bit_identical(P, S, W):
    rng = np.random.default_rng(7 * P + W)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    for _ in range(2):
        f0 = frames0(rng, P)
        opc, args = window(rng, W, P, S)
        jst, tst = {"frames": jnp.asarray(f0)}, {"frames":
                                                 torch.from_numpy(f0)}
        jplan = jd.window_plan(jst, jnp.asarray(opc), jnp.asarray(args))
        tplan = td.window_plan(tst, torch.from_numpy(opc),
                               torch.from_numpy(args))
        for f in ("touched", "value", "resps"):
            _eq(jplan[f], tplan[f], f)
        js, jr = jd.window_apply(jst, jnp.asarray(opc), jnp.asarray(args))
        ts, tr = td.window_apply(tst, torch.from_numpy(opc),
                                 torch.from_numpy(args))
        _eq(js["frames"], ts["frames"], "frames")
        _eq(jr, tr, "resps")


def test_batched_window_apply_is_per_replica_apply():
    # the per-replica window_apply tier: a leading replica axis on the
    # state and the window, each replica its own state and window
    P, S, R, W = 300, 5, 3, 40
    rng = np.random.default_rng(4)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    f = np.stack([frames0(rng, P) for _ in range(R)])
    wins = [window(rng, W, P, S) for _ in range(R)]
    opc = np.stack([w[0] for w in wins])
    args = np.stack([w[1] for w in wins])
    ts, tr = td.window_apply({"frames": torch.from_numpy(f)},
                             torch.from_numpy(opc), torch.from_numpy(args))
    jvm = jax.vmap(jd.window_apply)
    js, jr = jvm({"frames": jnp.asarray(f)}, jnp.asarray(opc),
                 jnp.asarray(args))
    _eq(js["frames"], ts["frames"])
    _eq(jr, tr)


@pytest.mark.parametrize("N,snaps", [(20, (5, 9, 15)), (40, (8, 21, 33))])
def test_plan_is_prefix_absorbing(N, snaps):
    # merging plan(state(lo), [lo, hi)) into a replica already at any p
    # in [lo, hi] lands exactly on state(hi): the union-window catch-up
    # contract (the reference's vspace case, `make_vspace(600, 8)`)
    P, S = 600, 8
    td = t_make_vspace(P, max_span=S)
    rng = np.random.default_rng(1)
    opc = rng.integers(0, 3, N).astype(np.int32)
    args = np.stack([rng.integers(0, 40, N), rng.integers(1, 60, N),
                     rng.integers(0, 9, N)], axis=1).astype(np.int32)
    lo, _, hi = snaps
    st = replicate_state(td.init_state(CPU), 1)
    snap = {}
    for i in range(N):
        if i in snaps:
            snap[i] = {"frames": st["frames"].clone()}
        apply_write(td, st, torch.from_numpy(opc[i:i + 1]),
                    torch.from_numpy(args[i:i + 1]))
    snap[N] = st
    plan = td.window_plan({"frames": snap[lo]["frames"][0]},
                          torch.from_numpy(opc[lo:hi]),
                          torch.from_numpy(args[lo:hi]))
    for p in snaps:
        merged, _ = td.window_merge(snap[p], plan)
        assert torch.equal(merged["frames"], snap[hi]["frames"]), p


def test_degenerate_span_takes_the_scan_engine():
    # max_span > n_pages: no combined form, in both packages
    jd, td = j_make_vspace(4, max_span=9), t_make_vspace(4, max_span=9)
    assert jd.window_plan is None and td.window_plan is None
    assert jd.window_canonical == td.window_canonical is False
    assert td.fused_factory is not None


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("R", [1, 3, 4])
def test_make_step_bit_identical(R, combined):
    # the port's core/step.py takes the vspace model unchanged: scan and
    # combined (plan once, merge per replica) over a ring that wraps
    P, S, Bw, Br = 512, 8, 4, 2
    jspec = jlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    tspec = tlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    jstep = j_make_step(jd, jspec, Bw, Br, combined=combined, donate=False)
    tstep = t_make_step(td, tspec, Bw, Br, combined=combined)
    jl, tl = jlog.log_init(jspec), tlog.log_init(tspec, CPU)
    js = j_replicate(jd.init_state(), R)
    ts = replicate_state(td.init_state(CPU), R)
    rng = np.random.default_rng(R + 10 * combined)
    steps = 2 * 256 // (R * Bw) + 2
    for s in range(steps):
        opc, args = window(rng, R * Bw, P, S, near_wrap=(s % 2 == 0))
        rd_opc = rng.choice(np.array([0, 1, 2], np.int32), (R, Br))
        rd_args = window(rng, R * Br, P, S)[1].reshape(R, Br, 3)
        b = (opc.reshape(R, Bw), args.reshape(R, Bw, 3), rd_opc, rd_args)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        _eq(jw, tw, f"wr {s}")
        _eq(jr, tr, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
    _eq(js["frames"], ts["frames"])
    assert int(jl.tail) > 2 * 256


def test_catchup_tiers_from_staggered_cursors():
    # union-plan, per-replica window_apply and scan catch-up of a fleet
    # whose cursors were left staggered by limited replays
    P, S, R = 300, 5, 4
    jspec = jlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    rng = np.random.default_rng(12)
    log, states = jlog.log_init(jspec), j_replicate(jd.init_state(), R)
    for _ in range(8):
        opc, args = window(rng, 40, P, S)
        log = jlog.log_append(jspec, log, jnp.asarray(opc),
                              jnp.asarray(args), 40)
        limits = int(log.tail) - rng.integers(0, 20, R)
        log, states, _ = j_exec(jspec, jd, log, states, 80,
                                limits=jnp.asarray(limits))
    assert int(log.tail) > 256
    tspec = tlog.LogSpec(capacity=256, n_replicas=R, gc_slack=64)
    tl = interop.log_from_numpy(log, CPU)
    ts = interop.vspace_from_numpy(states, CPU)
    fenced = np.zeros(R, bool)
    fenced[2] = True
    limits = (int(log.tail) - rng.integers(0, 12, R)).astype(np.int64)
    for kw in ({}, {"fenced": fenced}, {"limits": limits},
               {"on_trajectory": False}):
        kj = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        kt = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        jl2, js2, jr = j_catchup(jspec, jd, log, states, 32, **kj)
        tl2, ts2, tr = tlog.log_catchup_all(tspec, td, tl, ts, 32, **kt)
        for f in jl2._fields:
            _eq(getattr(jl2, f), getattr(tl2, f), f"{kw} {f}")
        _eq(js2["frames"], ts2["frames"], kw)
        _eq(jr, tr, kw)
    back = interop.vspace_to_numpy(ts)
    assert np.array_equal(back["frames"], np.asarray(states["frames"]))
