"""Differential tests of the port's flat vspace kernels and the paths
built on them (`node_replication_torch/ops/vspace.py`) against the
reference (`node_replication_tpu/ops/pallas_vspace.py`), which runs as
its own tests run it: `interpret=True`, `jit=False`. On the CPU the
port's wrappers run the kernels' plain versions, so this holds those
plain versions — K4 (`vspace_replay`), K7a (`vspace_plan_replay`), K5
(`vspace_fused_round`) — and everything around them bit-identical to
the reference, tolerance 0:

- the replay and plan replayers (`TestFlatKernel`);
- the lock-step step and the plan step (`TestPallasVspaceStep`,
  `TestPlanStep::test_flat_plan_step_matches_scan_step`);
- the fused tier, alone and under `NodeReplicated`, fenced fallback
  included (`tests/test_pallas_fused.py::TestVspaceFused` and
  `test_fenced_mask_without_fenced_variant_commits_chain`);
- the reads on the kernel layout, the eligibility rules, and the
  reference's kernel/model quirk near int32 wrap.

The windows carry negative vpages, spans with n <= 0 and n > max_span,
NOOP and unknown opcodes, overlapping spans, and vpages near 2^31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_replication_tpu.core import log as jlog
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.core.replica import replicate_state as j_replicate
from node_replication_tpu.core.step import make_step as j_make_step
from node_replication_tpu.models import make_vspace as j_make_vspace
from node_replication_tpu.ops import pallas_vspace as jpv
from node_replication_tpu.ops.encoding import apply_write as j_apply_write
from node_replication_tpu.ops.encoding import encode_ops as j_encode

from node_replication_torch import interop
from node_replication_torch.core import log as tlog
from node_replication_torch.core.replica import NodeReplicated as TNR
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.core.step import make_step as t_make_step
from node_replication_torch.models import make_vspace as t_make_vspace
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops import vspace as tpv
from node_replication_torch.ops.encoding import apply_write
from node_replication_torch.ops.encoding import encode_ops as t_encode

CPU = "cpu"


def window(rng, W, P, S, near_wrap=True, opcodes=(0, 1, 2, 9, -3)):
    p = [0.1, 0.45, 0.3, 0.1, 0.05] if len(opcodes) == 5 else None
    opc = rng.choice(np.array(opcodes, np.int32), W, p=p)
    args = np.stack([rng.integers(-P, 2 * P, W), rng.integers(0, 60, W),
                     rng.integers(-1, S + 3, W)], axis=1).astype(np.int32)
    if near_wrap:
        at = rng.choice(W, max(1, W // 16), replace=False)
        args[at, 0] = (2 ** 31 - 1 - rng.integers(0, S, at.size)).astype(
            np.int32)
        args[at[:1], 1] = 2 ** 31 - 2
    return opc, args


def frames0(rng, P):
    f = rng.integers(1, 90, P).astype(np.int32)
    f[rng.random(P) < 0.6] = 0
    return f


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _log_eq(jl, tl, what=""):
    for f in jl._fields:
        _eq(getattr(jl, f), getattr(tl, f), f"{what} {f}")


def _fold(td, f0, opc, args):
    """The port model's sequential fold on one replica."""
    st = {"frames": torch.from_numpy(f0).clone()[None]}
    resps = [int(apply_write(td, st, torch.from_numpy(opc[i:i + 1]),
                             torch.from_numpy(args[i:i + 1]))[0])
             for i in range(len(opc))]
    return st["frames"][0], resps


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("P,S,R,seed", [(300, 5, 3, 0), (512, 8, 1, 1),
                                        (600, 8, 4, 2)])
def test_replay_kernel_matches_reference(P, S, R, seed):
    W = 48
    rng = np.random.default_rng(seed)
    opc, args = window(rng, W, P, S)
    f0 = frames0(rng, P)
    jrep = jpv.make_vspace_replay(P, R, W, S, False, interpret=True)
    jst = jpv.pallas_vspace_state(P, R, False, {"frames": jnp.asarray(f0)})
    jf, jr = jrep(jnp.asarray(opc), jnp.asarray(args), jst["frames"])
    trep = tpv.make_vspace_replay(P, R, W, S, False)
    tst = tpv.pallas_vspace_state(P, R, False,
                                  {"frames": torch.from_numpy(f0)}, CPU)
    _eq(jst["frames"], tst["frames"], "state layout")
    tf, tr = trep(torch.from_numpy(opc), torch.from_numpy(args),
                  tst["frames"])
    _eq(jf, tf, "frames")
    _eq(jr, tr, "resps")
    assert torch.equal(tst["frames"], interop.vspace_from_numpy(
        jst, CPU, layout="kernel")["frames"])  # inputs untouched
    if P & (P - 1) == 0:
        # P a power of two: the kernel equals the model's fold even at
        # int32 wrap (see test_kernel_and_model_differ_near_int32_wrap)
        ff, fr = _fold(t_make_vspace(P, max_span=S), f0, opc, args)
        assert tr.tolist() == fr
        for r in range(R):
            assert torch.equal(tpv.model_view({"frames": tf}, P,
                                              False)["frames"][r], ff)


@pytest.mark.parametrize("P,S,seed", [(300, 5, 3), (600, 8, 4)])
def test_plan_replay_matches_reference(P, S, seed):
    W = 40
    rng = np.random.default_rng(seed)
    opc, args = window(rng, W, P, S)
    f0 = frames0(rng, P)
    jrep = jpv.make_vspace_plan_replay(P, W, S, False, interpret=True)
    jfr = jpv.pallas_vspace_state(P, 1, False,
                                  {"frames": jnp.asarray(f0)})["frames"]
    # the touched plane starts non-zero: a step's chunks carry it along
    t0 = (rng.random(jfr.shape) < 0.1).astype(np.int32)
    jf, jt, jr = jrep(jnp.asarray(opc), jnp.asarray(args), jfr,
                      jnp.asarray(t0))
    trep = tpv.make_vspace_plan_replay(P, W, S, False)
    tfr = interop.vspace_from_numpy({"frames": np.asarray(jfr)}, CPU,
                                    layout="kernel")["frames"]
    tf, tt, tr = trep(torch.from_numpy(opc), torch.from_numpy(args), tfr,
                      torch.from_numpy(t0))
    _eq(jf, tf, "frames")
    _eq(jt, tt, "touched")
    _eq(jr, tr, "resps")
    # the plan step's model layout [1, P] gives the same
    mf, mt, mr = trep(torch.from_numpy(opc), torch.from_numpy(args),
                      torch.from_numpy(f0)[None],
                      torch.from_numpy(t0.reshape(1, -1)[:, :P].copy()))
    assert torch.equal(mf[0], tf.reshape(-1)[:P])
    assert torch.equal(mt[0], tt.reshape(-1)[:P])
    assert torch.equal(mr, tr)


# The CUDA body replays each tile once per group of replica rows and
# merges it into the group's other rows: that is exact only if the
# replay is a state-free merge, every row ending as replica 0's replay on
# the pages the window touched and as its own input elsewhere, with the
# responses replica 0's alone. "row0": the other rows are one row that
# differs from replica 0's
@pytest.mark.parametrize("P,S,R,W,layout,rows", [
    (300, 5, 3, 48, "model", "differ"), (600, 8, 4, 64, "kernel", "differ"),
    (1500, 20, 5, 200, "model", "row0"), (4096, 64, 2, 300, "kernel",
                                          "differ")])
def test_flat_replay_is_a_state_free_merge(P, S, R, W, layout, rows):
    rng = np.random.default_rng(P + R)
    opc, args = window(rng, W, P, S)
    opc, args = torch.from_numpy(opc), torch.from_numpy(args)
    if rows == "row0":
        fr = np.stack([frames0(rng, P)] + [frames0(rng, P)] * (R - 1))
    else:
        fr = np.stack([frames0(rng, P) for _ in range(R)])
    assert not (fr[0] == fr[1]).all()
    fr = torch.from_numpy(fr)
    if layout == "kernel":
        fr = tpv._grid(None, P, R, CPU).reshape(R, -1).index_copy(
            1, torch.arange(P), fr).reshape(R, tpv.grid_rows(P), 128)
    got, resps = tpv.vspace_replay_plain(opc, args, fr, P, S)
    row0, touched, resps0 = tpv.vspace_plan_replay_plain(
        opc, args, fr[:1], torch.zeros_like(fr[:1]), P, S)
    assert bool(touched.any())
    want = torch.where(touched > 0, row0, fr)
    assert torch.equal(got, want)
    assert torch.equal(resps, resps0)


def test_kernel_and_model_differ_near_int32_wrap():
    # the reference's quirk, matched bit for bit: past 2^31 the kernel
    # takes page (vpage mod P + lane) mod P while the model takes the
    # wrapped int32 (vpage + lane) mod P; they agree when P divides 2^32
    S = 5
    opc = np.array([1], np.int32)
    args = np.array([[2 ** 31 - 3, 40, 5]], np.int32)
    for P, differ in ((300, True), (512, False)):
        f0 = np.zeros(P, np.int32)
        jd = j_make_vspace(P, max_span=S)
        jst, _ = j_apply_write(jd, {"frames": jnp.asarray(f0)},
                               jnp.asarray(opc[0]), jnp.asarray(args[0]))
        jrep = jpv.make_vspace_replay(P, 1, 1, S, False, interpret=True)
        jf, _ = jrep(jnp.asarray(opc), jnp.asarray(args),
                     jpv.pallas_vspace_state(P, 1, False)["frames"])
        jk = np.asarray(jpv.model_view({"frames": jf}, P, False)[
            "frames"][0])
        assert (not np.array_equal(jk, np.asarray(jst["frames"]))) == differ
        tm, _ = _fold(t_make_vspace(P, max_span=S), f0, opc, args)
        tk, _ = tpv.vspace_replay(torch.from_numpy(opc),
                                  torch.from_numpy(args),
                                  torch.from_numpy(f0)[None], P, S)
        _eq(jst["frames"], tm, "model")
        _eq(jk, tk[0], "kernel")


def test_quirk_pages_pinned():
    # P = 300, vpage 2^31 - 3: lanes 0-2 stay below 2^31 (>= P, idle);
    # lanes 3-4 wrap to -2^31...: the model maps pages 52-53, the kernel
    # pages 248-249 (2^31 mod 300 = 248)
    P, S = 300, 5
    opc = torch.tensor([1], dtype=torch.int32)
    args = torch.tensor([[2 ** 31 - 3, 40, 5]], dtype=torch.int32)
    tm, _ = _fold(t_make_vspace(P, max_span=S), np.zeros(P, np.int32),
                  opc.numpy(), args.numpy())
    tk, resp = tpv.vspace_replay(opc, args,
                                 torch.zeros((1, P), dtype=torch.int32),
                                 P, S)
    assert tm.nonzero().flatten().tolist() == [52, 53]
    assert tk[0].nonzero().flatten().tolist() == [248, 249]
    assert tm[52:54].tolist() == tk[0, 248:250].tolist() == [43, 44]
    assert resp.tolist() == [2]


def test_reads_on_kernel_layout_match_reference():
    P, S, R, B = 600, 8, 3, 16
    rng = np.random.default_rng(8)
    grid = np.zeros((R, tpv.grid_rows(P) * 128), np.int32)
    grid[:, :P] = np.stack([frames0(rng, P) for _ in range(R)])
    grid = grid.reshape(R, -1, 128)
    rd_opc = rng.choice(np.array([0, 1, 2, 3, -1], np.int32), (R, B))
    rd_args = window(rng, R * B, P, S)[1].reshape(R, B, 3)
    jq = jpv._vspace_reads(P, S, False)({"frames": jnp.asarray(grid)},
                                        jnp.asarray(rd_opc),
                                        jnp.asarray(rd_args))
    tq = tpv.vspace_reads(P, S)({"frames": torch.from_numpy(grid)},
                                torch.from_numpy(rd_opc),
                                torch.from_numpy(rd_args))
    _eq(jq, tq)


def test_eligibility_rules_match_reference():
    spec_j = jlog.LogSpec(capacity=512, n_replicas=2, gc_slack=64)
    spec_t = tlog.LogSpec(capacity=512, n_replicas=2, gc_slack=64)

    def outcome(fn):
        try:
            fn()
            return "ok"
        except ValueError:
            return "ValueError"

    for P, S in ((260, 5), (261, 5), (300, 44), (383, 128), (384, 128),
                 (2000, 600)):
        pairs = [
            (lambda: jpv.make_vspace_replay(P, 2, 8, S, False,
                                            interpret=True),
             lambda: tpv.make_vspace_replay(P, 2, 8, S, False)),
            (lambda: jpv.make_vspace_plan_replay(P, 8, S, False,
                                                 interpret=True),
             lambda: tpv.make_vspace_plan_replay(P, 8, S, False)),
            (lambda: jpv.FusedVspaceEngine(P, S, spec_j, interpret=True),
             lambda: tpv.FusedVspaceEngine(P, S, spec_t, device=CPU)),
        ]
        for jf, tf in pairs:
            assert outcome(jf) == outcome(tf), (P, S)
    jeng = jpv.FusedVspaceEngine(512, 8, spec_j, interpret=True)
    teng = tpv.FusedVspaceEngine(512, 8, spec_t, device=CPU)
    for w in (1, 16, 128, 256, 384, 448, 449, 512, 4096, 8192):
        assert jeng.supports(w) == teng.supports(w), w
    big_j = jlog.LogSpec(capacity=1 << 14, n_replicas=2, gc_slack=64)
    big_t = tlog.LogSpec(capacity=1 << 14, n_replicas=2, gc_slack=64)
    jeng = jpv.FusedVspaceEngine(512, 8, big_j, interpret=True)
    teng = tpv.FusedVspaceEngine(512, 8, big_t, device=CPU)
    for w in (4095, 4096, 4097, 8192):
        assert jeng.supports(w) == teng.supports(w), w
    # the radix model takes no row rule (its spans never wrap): only
    # max_span and one PML4 entry (n_pages <= 2^27) bound it
    for P, S in ((260, 5), (300, 44), (2000, 512)):
        tpv.make_vspace_replay(P, 2, 8, S, True)
        tpv.make_vspace_plan_replay(P, 8, S, True)
        assert set(tpv.pallas_vspace_state(P, 2, True, device=CPU)) == {
            "pt", "pd", "pdpt", "pml4"}
    for fn in (lambda: tpv.make_vspace_replay(512, 2, 8, 513, True),
               lambda: tpv.make_vspace_plan_replay((1 << 27) + 1, 8, 8,
                                                   True)):
        with pytest.raises(ValueError):
            fn()


# --------------------------------------------------------------- steps


def _step_batch(rng, R, Bw, Br, P, S, s):
    opc, args = window(rng, R * Bw, P, S, near_wrap=(s % 2 == 1))
    rd_opc = rng.choice(np.array([0, 1, 2], np.int32), (R, Br))
    rd_args = window(rng, R * Br, P, S)[1].reshape(R, Br, 3)
    return opc.reshape(R, Bw), args.reshape(R, Bw, 3), rd_opc, rd_args


@pytest.mark.parametrize("P,S,R", [(300, 5, 3), (512, 8, 4)])
def test_pallas_step_matches_reference_and_scan(P, S, R):
    Bw, Br, steps = 4, 2, 4
    jspec = jlog.LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    tspec = tlog.LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jstep = jpv.make_pallas_vspace_step(P, jspec, Bw, Br, S, radix=False,
                                        interpret=True, jit=False)
    tstep = tpv.make_pallas_vspace_step(P, tspec, Bw, Br, S, radix=False)
    td = t_make_vspace(P, max_span=S)
    sstep = t_make_step(td, tspec, Bw, Br, combined=False)
    rng = np.random.default_rng(P + R)
    f0 = frames0(rng, P)
    jl, tl, sl = (jlog.log_init(jspec), tlog.log_init(tspec, CPU),
                  tlog.log_init(tspec, CPU))
    js = jpv.pallas_vspace_state(P, R, False, {"frames": jnp.asarray(f0)})
    ts = tpv.pallas_vspace_state(P, R, False,
                                 {"frames": torch.from_numpy(f0)}, CPU)
    ss = replicate_state({"frames": torch.from_numpy(f0)}, R)
    for s in range(steps):
        b = _step_batch(rng, R, Bw, Br, P, S, s)
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        _eq(jw, tw, f"wr {s}")
        _eq(jr, tr, f"rd {s}")
        _log_eq(jl, tl, f"step {s}")
        _eq(js["frames"], ts["frames"], f"frames {s}")
        if P & (P - 1) == 0:  # the model's scan agrees (no wrap quirk)
            sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
            assert torch.equal(sw, tw) and torch.equal(sr, tr), s
            assert torch.equal(ss["frames"], tpv.model_view(
                ts, P, False)["frames"]), s


@pytest.mark.parametrize("P,S,R", [(600, 8, 2), (512, 8, 4)])
def test_plan_step_matches_reference_and_scan(P, S, R):
    Bw, Br, steps = 4, 2, 4
    jspec = jlog.LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    tspec = tlog.LogSpec(capacity=1 << 10, n_replicas=R, gc_slack=32)
    jd, td = j_make_vspace(P, max_span=S), t_make_vspace(P, max_span=S)
    jstep = jpv.make_pallas_vspace_plan_step(P, jspec, Bw, Br, S,
                                             radix=False, dispatch=jd,
                                             interpret=True, jit=False)
    tstep = tpv.make_pallas_vspace_plan_step(P, tspec, Bw, Br, S,
                                             radix=False, dispatch=td)
    sstep = t_make_step(td, tspec, Bw, Br, combined=False)
    jscan = j_make_step(jd, jspec, Bw, Br, combined=False, donate=False)
    rng = np.random.default_rng(3 + R)
    jl, tl, sl = (jlog.log_init(jspec), tlog.log_init(tspec, CPU),
                  tlog.log_init(tspec, CPU))
    jsl = jlog.log_init(jspec)
    js, jss = j_replicate(jd.init_state(), R), j_replicate(
        jd.init_state(), R)
    ts = replicate_state(td.init_state(CPU), R)
    ss = replicate_state(td.init_state(CPU), R)
    for s in range(steps):
        # vpages in [-P, 2P): the kernel, the model and the reference
        # all agree there
        b = _step_batch(rng, R, Bw, Br, P, S, 0)
        b[1][..., 0] = rng.integers(-P, 2 * P, (R, Bw))
        jl, js, jw, jr = jstep(jl, js, *map(jnp.asarray, b))
        tl, ts, tw, tr = tstep(tl, ts, *map(torch.from_numpy, b))
        jsl, jss, jsw, jsr = jscan(jsl, jss, *map(jnp.asarray, b))
        sl, ss, sw, sr = sstep(sl, ss, *map(torch.from_numpy, b))
        for w, r in ((jw, jr), (jsw, jsr), (sw, sr)):
            _eq(w, tw, f"wr {s}")
            _eq(r, tr, f"rd {s}")
        _log_eq(jl, tl, f"step {s}")
        _log_eq(jsl, sl, f"scan step {s}")
        _eq(js["frames"], ts["frames"], f"frames {s}")
        _eq(jss["frames"], ss["frames"], f"scan frames {s}")


# --------------------------------------------------------- fused tier


def test_fused_rounds_match_reference_across_ring_wrap():
    P, S, R = 512, 8, 3
    jspec = jlog.LogSpec(capacity=256, n_replicas=R, arg_width=3,
                         gc_slack=64)
    tspec = tlog.LogSpec(capacity=256, n_replicas=R, arg_width=3,
                         gc_slack=64)
    jeng = j_make_vspace(P, max_span=S).fused_factory(jspec,
                                                      interpret=True)
    td = t_make_vspace(P, max_span=S)
    teng = td.fused_factory(tspec, device=CPU)
    assert teng.launches(32) == 1 and not teng.supports_fenced
    rng = np.random.default_rng(11)
    jl, tl = jlog.log_init(jspec), tlog.log_init(tspec, CPU)
    f0 = frames0(rng, P)
    js = j_replicate({"frames": jnp.asarray(f0)}, R)
    ts = replicate_state({"frames": torch.from_numpy(f0)}, R)
    before = tpv.FUSED_KERNEL.launches
    for rnd in range(14):  # 14 x 20..31 entries wraps the 256-slot ring
        n = int(rng.integers(20, 32))
        opc, args = window(rng, n, P, S, near_wrap=(rnd % 3 == 0))
        ops = [(int(o), *map(int, a)) for o, a in zip(opc, args)]
        jo, ja, _ = j_encode(ops, 3, pad_to=32)
        to, ta, _ = t_encode(ops, 3, pad_to=32, device=CPU)
        jl, js, jr = jeng.round(jl, js, jo, ja, n)
        tl, ts, tr = teng.round(tl, ts, to, ta, n)
        _log_eq(jl, tl, f"round {rnd}")
        _eq(js["frames"], ts["frames"], f"frames {rnd}")
        _eq(jr, tr, f"resps {rnd}")
    assert int(tl.tail) > tspec.capacity
    assert tpv.FUSED_KERNEL.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="fenced"):
        teng.round(tl, ts, to, ta, n, fenced=np.zeros(R, bool))


def _vs_ops(rng, n, P):
    ops = []
    for _ in range(n):
        if rng.random() < 0.7:
            ops.append((1, int(rng.integers(-P, 2 * P)),
                        int(rng.integers(1, 1000)), int(rng.integers(0, 12))))
        else:
            ops.append((2, int(rng.integers(-P, 2 * P)),
                        int(rng.integers(0, 12))))
    return ops


def test_node_replicated_fused_tier_matches_reference():
    # engine='pallas' in both packages: fused rounds, then a fenced
    # replica sends rounds down the chain, then a repair brings the
    # fleet back to the fused tier; every response, state, cursor and
    # stats() field identical
    P, S, R = 512, 8, 3
    kw = dict(n_replicas=R, log_entries=512, gc_slack=64, engine="pallas")
    jn = JNR(j_make_vspace(P, max_span=S), **kw)
    tn = TNR(t_make_vspace(P, max_span=S), device=CPU, **kw)
    reg = get_registry()
    reg.enable()
    fb = reg.counter("nr.exec.engine.fused_fallback")
    rng = np.random.default_rng(7)
    jt, tt = jn.register(1), tn.register(1)
    for rnd in range(12):
        if rnd == 4:
            jn.fence_replica(2)
            tn.fence_replica(2)
            fb0 = fb.value
        if rnd == 8:
            assert fb.value > fb0  # the fenced rounds took the chain
            for n in (jn, tn):
                n.clone_replica_from(2, donor=0)
                n.unfence_replica(2)
        ops = _vs_ops(rng, int(rng.integers(8, 30)), P)
        rid = int(rng.integers(0, 2))
        assert jn.execute_mut_batch(ops, rid) == \
            tn.execute_mut_batch(ops, rid), rnd
        assert jn.last_round_tier == tn.last_round_tier, rnd
        assert tn.last_round_tier == ("pallas_fused" if rnd < 4 or rnd >= 8
                                      else tn.engine), rnd
        for v in (0, 5, -1, int(rng.integers(P))):
            assert jn.execute((1, v), jt) == tn.execute((1, v), tt)
            assert jn.execute((2, v, 9), jt) == tn.execute((2, v, 9), tt)
        assert jn.stats() == tn.stats(), rnd
    jn.sync()
    tn.sync()
    _eq(jn.states["frames"], tn.states["frames"])
    assert tn.replicas_equal() and tn.stats()["fused_rounds"] == 8


def test_fenced_mask_without_fenced_variant_commits_chain(monkeypatch):
    # with a quarantine mask and no fenced kernel there is nothing to
    # calibrate: the verdict commits to the chain at once, and split
    # rounds still defer, in both packages
    monkeypatch.setenv("NR_TPU_FUSED_CAL", "1")
    kw = dict(n_replicas=3, log_entries=512, gc_slack=64, engine="auto")
    fleets = (JNR(j_make_vspace(512, max_span=8), **kw),
              TNR(t_make_vspace(512, max_span=8), device=CPU, **kw))
    answers = []
    for nr in fleets:
        for i in range(8):
            nr.execute_mut_batch([(1, i, i + 1, 2), (1, i + 9, i, 2)], rid=0)
        assert nr.stats()["fused_tier"] in ("auto:pallas_fused",
                                            "auto:chain")
        nr.fence_replica(2)
        nr.execute_mut_batch([(1, 3, 7, 1)], rid=0)
        assert nr.stats()["fused_tier"] == "auto:chain"
        p = nr.begin_mut_batch([(1, 5, 6, 1)], rid=0)
        assert p.done is False
        answers.append(nr.finish_mut_batch(p))
    assert answers[0] == answers[1] == [0]
    _eq(fleets[0].states["frames"], fleets[1].states["frames"])


def test_wrappers_route_cpu_to_plain_and_count_no_launch():
    P, S = 300, 5
    opc = torch.tensor([1, 2, 0], dtype=torch.int32)
    args = torch.tensor([[-2, 5, 4], [299, 1, 0], [0, 0, 0]],
                        dtype=torch.int32)
    fr = torch.zeros((2, P), dtype=torch.int32)
    counts = [k.launches for k in (tpv.REPLAY_KERNEL, tpv.PLAN_KERNEL)]
    out, resps = tpv.vspace_replay(opc, args, fr, P, S)
    assert resps.tolist() == [4, 1, 0]  # -2 wraps onto pages 298..1
    assert out[:, [298, 299, 0, 1]].tolist() == [[5, 0, 7, 8]] * 2
    _, tch, _ = tpv.vspace_plan_replay(opc, args, fr, torch.zeros_like(fr),
                                       P, S)
    assert tch[0].nonzero().flatten().tolist() == [0, 1, 298, 299]
    assert int(fr.abs().sum()) == 0  # out of place
    assert counts == [k.launches for k in (tpv.REPLAY_KERNEL,
                                           tpv.PLAN_KERNEL)]
    with pytest.raises(ValueError):  # wrong dtype is refused
        tpv.vspace_replay(opc, args, fr.long(), P, S)
    with pytest.raises(ValueError):  # a span's pages must be distinct
        tpv.vspace_replay(opc, args, fr, P, P + 1)
