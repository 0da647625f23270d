"""Differential tests of the port's lock-step batch step against the
reference: `core/step.make_step` (scan and combined) and the replay
kernel's step `ops/replay.make_pallas_step` — here on the CPU, so the
kernel wrapper runs its plain version — against the reference's
`ops/pallas_replay.make_pallas_step(interpret=True, jit=False)`, the
way the reference's own tests run it. Bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core.log import LogSpec as JSpec
from node_replication_tpu.core.log import log_init as j_log_init
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.core.step import make_step as j_make_step
from node_replication_tpu.models import make_hashmap as j_make_hashmap
from node_replication_tpu.ops.pallas_replay import (
    make_hashmap_replay as j_make_hashmap_replay,
)
from node_replication_tpu.ops.pallas_replay import (
    make_pallas_step as j_make_pallas_step,
)
from node_replication_tpu.ops.pallas_replay import (
    pallas_hashmap_state as j_pallas_state,
)

from node_replication_torch.core.log import LogSpec as TSpec
from node_replication_torch.core.log import log_init as t_log_init
from node_replication_torch.core.replica import replicate_state as t_replicate
from node_replication_torch.core.step import LockstepError
from node_replication_torch.core.step import make_step as t_make_step
from node_replication_torch.models import make_hashmap as t_make_hashmap
from node_replication_torch.ops.replay import (
    make_hashmap_replay as t_make_hashmap_replay,
)
from node_replication_torch.ops.replay import (
    make_pallas_step as t_make_pallas_step,
)
from node_replication_torch.ops.replay import (
    pallas_hashmap_state as t_pallas_state,
)

CPU = "cpu"


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _log_eq(jl, tl, what=""):
    for f in jl._fields:
        _eq(getattr(jl, f), getattr(tl, f), f"{what} {f}")


def _batches(rng, R, Bw, Br, K, neg=False):
    lo = -K if neg else 0
    wr_opc = rng.choice(np.array([1, 2], np.int32), (R, Bw))
    wr_args = np.zeros((R, Bw, 3), np.int32)
    wr_args[..., 0] = rng.integers(lo, K, (R, Bw))
    wr_args[..., 1] = rng.integers(1, 999, (R, Bw))
    rd_opc = rng.choice(np.array([0, 1], np.int32), (R, Br))
    rd_args = np.zeros((R, Br, 3), np.int32)
    rd_args[..., 0] = rng.integers(lo, K, (R, Br))
    return wr_opc, wr_args, rd_opc, rd_args


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("R", [1, 4, 64])
def test_make_step_bit_identical(R, combined):
    K, Bw, Br = 37, 2, 2
    # rings of 256 slots wrap at least twice over the steps
    steps = 2 * 256 // (R * Bw) + 2
    jspec = JSpec(capacity=256, n_replicas=R, gc_slack=64)
    tspec = TSpec(capacity=256, n_replicas=R, gc_slack=64)
    jd, td = j_make_hashmap(K), t_make_hashmap(K)
    jstep = j_make_step(jd, jspec, Bw, Br, combined=combined, donate=False)
    tstep = t_make_step(td, tspec, Bw, Br, combined=combined)
    jl, tl = j_log_init(jspec), t_log_init(tspec, CPU)
    js = j_replicate(jd.init_state(), R)
    ts = t_replicate(td.init_state(CPU), R)
    rng = np.random.default_rng(R + 10 * combined)
    for s in range(steps):
        b = _batches(rng, R, Bw, Br, K, neg=(s % 3 == 0))
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        _eq(jw, tw, f"wr {s}")
        _eq(jr, tr, f"rd {s}")
        _log_eq(jl, tl, f"step {s}")
    _eq(js["values"], ts["values"])
    _eq(js["present"], ts["present"])
    assert int(jl.tail) > 2 * 256


def test_pallas_step_plain_matches_reference_interpret():
    R, Bw, Br, K = 4, 4, 2, 200
    jspec = JSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    tspec = TSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jstep = j_make_pallas_step(K, jspec, Bw, Br, tile_r=2, interpret=True,
                               jit=False)
    tstep = t_make_pallas_step(K, tspec, Bw, Br)
    jl, tl = j_log_init(jspec), t_log_init(tspec, CPU)
    js, ts = j_pallas_state(K, R), t_pallas_state(K, R, CPU)
    rng = np.random.default_rng(0)
    for s in range(3):
        b = _batches(rng, R, Bw, Br, K, neg=(s == 1))
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        _eq(jw, tw, f"wr {s}")
        _eq(jr, tr, f"rd {s}")
        _log_eq(jl, tl, f"step {s}")
        _eq(js["values"], ts["values"])
        _eq(js["present"], ts["present"])


def test_pallas_step_agrees_with_combined_step():
    # the kernel layout [Kp, R] against the model layout [R, K]: the two
    # step paths chip_smoke.py holds against each other on the card
    R, K = 8, 13
    spec = TSpec(capacity=256, n_replicas=R, gc_slack=64)
    d = t_make_hashmap(K)
    pstep = t_make_pallas_step(K, spec, 1, 1)
    cstep = t_make_step(d, spec, 1, 1, combined=True)
    pl_, cl = t_log_init(spec, CPU), t_log_init(spec, CPU)
    ps, cs = t_pallas_state(K, R, CPU), t_replicate(d.init_state(CPU), R)
    rng = np.random.default_rng(9)
    for s in range(40):  # 40 x 8 slots wraps the ring
        b = [torch.from_numpy(x) for x in _batches(rng, R, 1, 1, K)]
        pl_, ps, pw, pr = pstep(pl_, ps, *b)
        cl, cs, cw, cr = cstep(cl, cs, *b)
        assert torch.equal(pw, cw) and torch.equal(pr, cr), s
    for f in pl_._fields:
        assert torch.equal(getattr(pl_, f), getattr(cl, f)), f
    assert torch.equal(ps["values"][:K].T, cs["values"])
    assert torch.equal(ps["present"][:K].T > 0, cs["present"])


def test_negative_keys_replay_matches_reference():
    R, W, K = 2, 4, 16
    jrep = j_make_hashmap_replay(K, R, W, tile_r=2, interpret=True)
    trep = t_make_hashmap_replay(K, R, W)
    opc = np.array([1, 1, 1, 2], np.int32)
    keys = np.array([-1, -16, 3, -13], np.int32)
    vals = np.array([111, 222, 333, 0], np.int32)
    js, ts = j_pallas_state(K, R), t_pallas_state(K, R, CPU)
    jv, jp, jr = jrep(*map(jnp.asarray, (opc, keys, vals)),
                      js["values"], js["present"])
    tv, tp, tr = trep(*map(torch.from_numpy, (opc, keys, vals)),
                      ts["values"], ts["present"])
    _eq(jv, tv)
    _eq(jp, tp)
    _eq(jr, tr)
    # floored: -1 % 16 = 15, -16 % 16 = 0, -13 % 16 = 3 (removed)
    assert tv[15].tolist() == [111, 111] and tv[0].tolist() == [222, 222]
    assert tr[3].tolist() == [1, 1] and tp[3].tolist() == [0, 0]


def test_lockstep_guard_raises_on_divergent_fleet():
    R, K = 4, 9
    spec = TSpec(capacity=256, n_replicas=R, gc_slack=64)
    d = t_make_hashmap(K)
    step = t_make_step(d, spec, 1, 1, combined=True, check_lockstep=True)
    log = t_log_init(spec, CPU)
    states = t_replicate(d.init_state(CPU), R)
    b = [torch.from_numpy(x) for x in
         _batches(np.random.default_rng(1), R, 1, 1, K)]
    log, states, _, _ = step(log, states, *b)  # lock-step: fine
    states["values"][2, 0] += 1
    with pytest.raises(LockstepError):
        step(log, states, *b)
    with pytest.raises(LockstepError):
        step(log._replace(ltails=log.ltails - 1), states, *b)
