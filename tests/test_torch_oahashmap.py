"""Differential tests of the port's open-addressing hash map against the
reference: the model (`node_replication_torch/models/oahashmap.py`
against `node_replication_tpu/models/oahashmap.py`) and its kernel path
(`node_replication_torch/ops/oahashmap.py` against
`node_replication_tpu/ops/pallas_oahashmap.py`, run as its own tests run
it: `interpret=True`, `jit=False`). On the CPU the port's wrapper runs
the kernel's plain version, so this holds K3 (`oahashmap_replay`)
bit-identical to the reference kernel, tolerance 0 (every output is an
integer):

- the uint32 `_mix` over edge keys (0, -1, +-2^31, keys whose products
  pass 2^63);
- the per-op writes and reads, the scan step (the model has no
  `window_apply`, so the scan engine takes it unchanged), and
  `NodeReplicated` on the chain;
- K3 and the K3 step (`tests/test_pallas_oahashmap.py`) with
  collisions, wrapped windows, tombstones and window-full drops (-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core import log as jlog
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.core.step import make_step as j_make_step
from node_replication_tpu.models import make_oahashmap as j_make_oa
from node_replication_tpu.models.oahashmap import _mix as j_mix
from node_replication_tpu.ops import pallas_oahashmap as jpo
from node_replication_tpu.ops.encoding import apply_read as j_apply_read
from node_replication_tpu.ops.encoding import apply_write as j_apply_write

from node_replication_torch import interop
from node_replication_torch.core import log as tlog
from node_replication_torch.core.replica import NodeReplicated as TNR
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step as t_make_step
from node_replication_torch.models import (
    DROPPED,
    OA_GET,
    OA_PUT,
    OA_REMOVE,
)
from node_replication_torch.models import make_oahashmap as t_make_oa
from node_replication_torch.models.oahashmap import _mix as t_mix
from node_replication_torch.models.oahashmap import probe_window
from node_replication_torch.ops import oahashmap as tpo
from node_replication_torch.ops.encoding import apply_read, apply_write

CPU = "cpu"
PLANES = ("keys", "vals", "flag")
N, PROBE = 300, 8  # the reference tests' table

j_write = jax.jit(j_apply_write, static_argnums=(0,))
j_read = jax.jit(j_apply_read, static_argnums=(0,))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def same_home_keys(n_slots, count, seed=0, near_end=None):
    """`count` distinct keys whose windows start at one home slot, or
    (with `near_end`) at homes within `near_end` slots of the end, whose
    windows wrap: found by hashing candidates with numpy."""
    rng = np.random.default_rng(seed)
    cand = np.unique(rng.integers(-(1 << 31), 1 << 31, 1 << 16)
                     .astype(np.int32))
    home = np.asarray(j_mix(jnp.asarray(cand))).astype(np.int64) % n_slots
    if near_end is not None:
        return cand[home >= n_slots - near_end][:count]
    return cand[home == home[0]][:count]


def window(rng, W, key_lo=-50, key_hi=50):
    """The reference kernel test's mix (`tests/test_pallas_oahashmap.py:
    44-55`) plus, up front, PUTs of more same-home keys than a window
    holds (drops), and keys whose windows wrap past the end."""
    opc = rng.choice(np.array([0, 1, 2, 9], np.int32), W,
                     p=[0.06, 0.55, 0.33, 0.06])
    args = np.stack([rng.integers(key_lo, key_hi, W),
                     rng.integers(1, 999, W), np.zeros(W)],
                    axis=1).astype(np.int32)
    crowd = same_home_keys(N, PROBE + 3, seed=int(rng.integers(1 << 16)))
    wrap = same_home_keys(N, 6, near_end=PROBE)
    opc[:len(crowd)] = OA_PUT
    args[:len(crowd), 0] = crowd
    at = rng.choice(np.arange(len(crowd), W), len(wrap), replace=False)
    args[at, 0] = wrap
    return opc, args


def _t(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


# ----------------------------------------------------------------- mix


def test_mix_matches_reference_over_edge_keys():
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 0x7FEB352D,
                     -0x7B935975, 0x0000FFFF, -0x10000, 1 << 30], np.int32)
    rng = np.random.default_rng(0)
    keys = np.concatenate([edge, rng.integers(-(1 << 31), 1 << 31, 1 << 14)
                           .astype(np.int32)])
    want = np.asarray(j_mix(jnp.asarray(keys))).astype(np.int64)
    got = t_mix(torch.from_numpy(keys)).numpy()
    assert np.array_equal(want, got)
    # the intermediate products of some of these pass 2^63 in int64:
    # the port never forms them
    x = keys.astype(np.int64) & 0xFFFFFFFF
    y = (x ^ (x >> 16)) * 0x7FEB352D & 0xFFFFFFFF
    assert ((y ^ (y >> 15)).astype(object) * 0x846CA68B >= 2 ** 63).any()
    idx = probe_window(torch.from_numpy(keys), N, PROBE).numpy()
    assert np.array_equal(idx[:, 0], want % N)
    assert np.array_equal(idx, (want[:, None] % N + np.arange(PROBE)) % N)


# --------------------------------------------------------------- model


@pytest.mark.parametrize("seed", [0, 1])
def test_write_and_read_ops_bit_identical(seed):
    rng = np.random.default_rng(seed)
    jd, td = j_make_oa(N, probe=PROBE), t_make_oa(N, probe=PROBE)
    opc, args = window(rng, 96)
    js = jd.init_state()
    ts = replicate_state(td.init_state(CPU), 3)
    resps = []
    for i in range(len(opc)):
        js, jr = j_write(jd, js, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        rep = lambda a: torch.from_numpy(np.repeat(a[i:i + 1], 3, 0))
        tr = apply_write(td, ts, rep(opc), rep(args))
        assert tr.tolist() == [int(jr)] * 3, i
        resps.append(int(jr))
        probe_args = args[rng.integers(0, len(opc)):][:1]
        jq = j_read(jd, js, jnp.asarray(OA_GET), jnp.asarray(probe_args[0]))
        tq = apply_read(td, ts, torch.full((3,), OA_GET, dtype=torch.int32),
                        torch.from_numpy(np.repeat(probe_args, 3, 0)))
        assert tq.tolist() == [int(jq)] * 3, i
    assert DROPPED in resps and 1 in resps  # drops and removals occurred
    assert (np.asarray(js["flag"]) == 2).any()  # and tombstones
    for k in PLANES:
        for r in range(3):
            _eq(js[k], ts[k][r], f"{k} replica {r}")


def test_tombstone_does_not_shadow_a_later_slot():
    # a key past a tombstone is still found and updated in place, not
    # re-inserted into the tombstone (`tests/test_cnr.py:154-162`)
    td = t_make_oa(16, probe=16)
    for nr in (JNR(j_make_oa(16, probe=16), n_replicas=1, log_entries=64,
                   gc_slack=8),
               TNR(td, n_replicas=1, log_entries=64, gc_slack=8,
                   device=CPU)):
        t = nr.register(0)
        nr.execute_mut((OA_PUT, 1, 10), t)
        nr.execute_mut((OA_PUT, 2, 20), t)
        assert nr.execute_mut((OA_REMOVE, 2, 0), t) == 1
        assert nr.execute_mut((OA_PUT, 1, 11), t) == 0
        assert nr.execute((OA_GET, 1), t) == 11
        assert nr.execute((OA_GET, 2), t) == -1
        assert nr.execute_mut((OA_REMOVE, 2, 0), t) == 0


@pytest.mark.parametrize("R", [1, 3])
def test_scan_step_takes_the_model_unchanged(R):
    # no window_apply: make_step's default is the scan engine, in both
    # packages, over a ring that wraps
    Bw, Br = 4, 2
    kw = dict(capacity=32, n_replicas=R, gc_slack=8)
    jspec, tspec = jlog.LogSpec(**kw), tlog.LogSpec(**kw)
    jd, td = j_make_oa(N, probe=PROBE), t_make_oa(N, probe=PROBE)
    assert td.window_apply is None and td.window_plan is None
    with pytest.raises(ValueError):
        t_make_step(td, tspec, Bw, Br, combined=True)
    jstep = j_make_step(jd, jspec, Bw, Br, donate=False)
    tstep = t_make_step(td, tspec, Bw, Br)
    rng = np.random.default_rng(R)
    jl, js = jlog.log_init(jspec), j_replicate(jd.init_state(), R)
    tl, ts = tlog.log_init(tspec, CPU), replicate_state(td.init_state(CPU), R)
    opc, args = window(rng, 12 * R * Bw, -30, 30)
    for s in range(12):
        sl = slice(s * R * Bw, (s + 1) * R * Bw)
        rd_args = np.zeros((R, Br, 3), np.int32)
        rd_args[..., 0] = rng.choice(args[:, 0], (R, Br))
        b = (opc[sl].reshape(R, Bw), args[sl].reshape(R, Bw, 3),
             np.ones((R, Br), np.int32), rd_args)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        _eq(jw, tw, f"wr {s}")
        _eq(jr, tr, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
    for k in PLANES:
        _eq(js[k], ts[k], k)
    assert int(tl.tail) > tspec.capacity


def test_node_replicated_chain_matches_reference():
    R = 3
    kw = dict(n_replicas=R, log_entries=256, gc_slack=32)
    jn = JNR(j_make_oa(N, probe=PROBE), **kw)
    tn = TNR(t_make_oa(N, probe=PROBE), device=CPU, **kw)
    jt = [jn.register(r) for r in range(R)]
    tt = [tn.register(r) for r in range(R)]
    rng = np.random.default_rng(9)
    opc, args = window(rng, 160)
    for c in range(0, 160, 16):
        rid = int(rng.integers(R))
        ops = [(int(o), int(a[0]), int(a[1])) for o, a in
               zip(opc[c:c + 16], args[c:c + 16])]
        assert jn.execute_mut_batch(ops, rid) == tn.execute_mut_batch(
            ops, rid), c
        for r in range(R):
            k = int(args[int(rng.integers(160)), 0])
            assert jn.execute((OA_GET, k), jt[r]) == tn.execute(
                (OA_GET, k), tt[r])
    assert jn.stats() == tn.stats()
    jn.sync()
    tn.sync()
    for k in PLANES:
        _eq(jn.states[k], tn.states[k], k)
    assert tn.replicas_equal()


# -------------------------------------------------------------- kernel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_matches_reference_kernel(seed):
    # the twin of test_pallas_oahashmap.py::TestOaKernel::
    # test_matches_sequential_fold, from a pre-filled state
    W, R = 96, 3
    rng = np.random.default_rng(seed)
    jd = j_make_oa(N, probe=PROBE)
    st0, _ = jd.init_state(), None
    pre_o, pre_a = window(rng, 64)
    for i in range(64):
        st0, _ = j_write(jd, st0, jnp.asarray(pre_o[i]),
                         jnp.asarray(pre_a[i]))
    opc, args = window(rng, W)
    jst = jpo.pallas_oahashmap_state(N, R, st0)
    jout = jpo.make_oahashmap_replay(N, PROBE, R, W, interpret=True)(
        jnp.asarray(opc), jnp.asarray(args), *(jst[k] for k in PLANES))
    tst = tpo.pallas_oahashmap_state(N, R, _t(st0), CPU)
    for k in PLANES:
        _eq(jst[k], tst[k], f"state {k}")
    tout = tpo.make_oahashmap_replay(N, PROBE, R, W)(
        torch.from_numpy(opc), torch.from_numpy(args),
        *(tst[k] for k in PLANES))
    for a, b, what in zip(jout, tout, PLANES + ("resps",)):
        _eq(a, b, what)
    assert (tout[3] == DROPPED).any() and (tout[3] == 1).any()
    # and both are the model's fold
    ref = st0
    resps = []
    for i in range(W):
        ref, r = j_write(jd, ref, jnp.asarray(opc[i]), jnp.asarray(args[i]))
        resps.append(int(r))
    assert tout[3].tolist() == resps
    view = tpo.oahashmap_model_view(dict(zip(PLANES, tout)), N)
    for k in PLANES:
        for r in range(R):
            _eq(ref[k], view[k][r], k)


def test_step_matches_reference_step_and_scan():
    # the twin of test_pallas_oahashmap.py::TestOaKernel::
    # test_step_matches_scan_step: ring, cursors, planes, responses
    R, Bw, Br, STEPS = 3, 4, 2, 6
    kw = dict(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jspec, tspec = jlog.LogSpec(**kw), tlog.LogSpec(**kw)
    jd, td = j_make_oa(N, probe=PROBE), t_make_oa(N, probe=PROBE)
    jstep = jpo.make_pallas_oahashmap_step(N, PROBE, jspec, Bw, Br,
                                           interpret=True, jit=False)
    tstep = tpo.make_pallas_oahashmap_step(N, PROBE, tspec, Bw, Br)
    sstep = t_make_step(td, tspec, Bw, Br)
    rng = np.random.default_rng(5)
    jl, tl, sl = (jlog.log_init(jspec), tlog.log_init(tspec, CPU),
                  tlog.log_init(tspec, CPU))
    js = jpo.pallas_oahashmap_state(N, R, jd.init_state())
    ts = tpo.pallas_oahashmap_state(N, R, device=CPU)
    ss = replicate_state(td.init_state(CPU), R)
    opc, args = window(rng, STEPS * R * Bw, -30, 30)
    for s in range(STEPS):
        c = slice(s * R * Bw, (s + 1) * R * Bw)
        rd_opc = rng.choice(np.array([0, 1, 1, 4], np.int32), (R, Br))
        rd_args = np.zeros((R, Br, 3), np.int32)
        rd_args[..., 0] = rng.choice(args[:, 0], (R, Br))
        b = (opc[c].reshape(R, Bw), args[c].reshape(R, Bw, 3), rd_opc,
             rd_args)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
        for w, r in ((jw, jr), (sw, sr)):
            _eq(w, tw, f"wr {s}")
            _eq(r, tr, f"rd {s}")
        for f in jl._fields:
            _eq(getattr(jl, f), getattr(tl, f), f"step {s} {f}")
        for k in PLANES:
            _eq(js[k], ts[k], f"step {s} {k}")
    view = tpo.oahashmap_model_view(ts, N)
    for k in PLANES:
        assert torch.equal(view[k], ss[k]), k


def test_config_rules_match_reference():
    def outcome(fn):
        try:
            fn()
            return "ok"
        except ValueError:
            return "ValueError"

    for n, probe in ((300, 8), (135, 8), (136, 8), (300, 129),
                     (384, 128), (383, 128)):
        assert outcome(lambda: jpo.make_oahashmap_replay(
            n, probe, 2, 8, interpret=True)) == outcome(
            lambda: tpo.make_oahashmap_replay(n, probe, 2, 8)), (n, probe)


def test_wrapper_routes_cpu_to_plain_and_checks_shapes():
    opc = torch.tensor([1, 1, 2, 7], dtype=torch.int32)
    args = torch.tensor([[5, 50, 0], [5, 51, 0], [5, 0, 0], [5, 9, 0]],
                        dtype=torch.int32)
    st = tpo.pallas_oahashmap_state(N, 2, device=CPU)
    before = tpo.REPLAY_KERNEL.launches
    k, v, f, resps = tpo.oahashmap_replay(opc, args, st["keys"],
                                          st["vals"], st["flag"], N, PROBE)
    assert resps.tolist() == [0, 0, 1, 0]
    home = int(probe_window(torch.tensor([5]), N, PROBE)[0, 0])
    assert k.reshape(2, -1)[:, home].tolist() == [5, 5]
    assert v.reshape(2, -1)[:, home].tolist() == [51, 51]
    assert f.reshape(2, -1)[:, home].tolist() == [2, 2]  # tombstone
    assert int(st["flag"].abs().sum()) == 0  # out of place
    assert tpo.REPLAY_KERNEL.launches == before
    with pytest.raises(ValueError):  # planes of different shapes
        tpo.oahashmap_replay(opc, args, st["keys"], st["vals"][:1],
                             st["flag"], N, PROBE)
    with pytest.raises(ValueError):  # rows shorter than n_slots
        tpo.oahashmap_replay(opc, args, st["keys"], st["vals"],
                             st["flag"], 1 << 20, PROBE)


def test_interop_round_trips_both_layouts():
    jd = j_make_oa(N, probe=PROBE)
    st, _ = j_write(jd, jd.init_state(), jnp.asarray(1),
                    jnp.asarray([7, 70, 0], jnp.int32))
    model = j_replicate(st, 2)
    tm = interop.oahashmap_from_numpy(model, CPU)
    back = interop.oahashmap_to_numpy(tm)
    for k in PLANES:
        assert np.array_equal(back[k], np.asarray(model[k]))
    kern = jpo.pallas_oahashmap_state(N, 2, st)
    tk = interop.oahashmap_from_numpy(kern, CPU, layout="kernel")
    view, jview = (tpo.oahashmap_model_view(tk, N),
                   jpo.oahashmap_model_view(kern, N))
    for k in PLANES:
        _eq(jview[k], view[k], k)
    with pytest.raises(ValueError):
        interop.oahashmap_from_numpy(model, CPU, layout="kernel")
