"""The port's overload plane (`node_replication_torch/serve/overload.py`
and its wiring in `ServeFrontend`) against the reference's.

Each case runs one scenario through the reference package and through
the port (seqreg fleets; the port's on `device="cpu"`) and asserts that
the two outcomes are equal, then what `tests/test_overload.py` asserts
of the reference: the AIMD schedule, the backpressure watermarks, the
brownout hysteresis, strict-priority shedding and eviction, the eager
sweep of expired requests at admission, brownout reads, the circuit
breaker, per-cause retry accounting and the WAL fsync-lag source.
Seeded streams of controller rounds and of prioritised submissions
hold the governor's limits and the frontends' admit/shed/evict
decisions, responses, ring and states against the reference, and the
bounded-staleness read (`read(min_pos=, wait_s=)`) is held against it
too. The two threaded end-to-end cases cannot pin one interleaving in
both packages; there the reference replays the port's ring and must
give every acked response and the port's states.
"""

import threading
import time
import types

import numpy as np
import pytest

import node_replication_tpu.serve as jserve
from node_replication_tpu.core.log import ring_slice as j_ring_slice
from node_replication_tpu.core.replica import NodeReplicated as JNR
from node_replication_tpu.durable.wal import WriteAheadLog as JWAL
from node_replication_tpu.models import make_seqreg as j_make_seqreg
from node_replication_tpu.obs.metrics import get_registry as j_registry

import node_replication_torch.serve as tserve
from node_replication_torch.core.log import ring_slice as t_ring_slice
from node_replication_torch.core.replica import NodeReplicated as TNR
from node_replication_torch.durable.wal import WriteAheadLog as TWAL
from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
from node_replication_torch.obs.metrics import get_registry as t_registry

NR_KW = dict(log_entries=512, gc_slack=64)
CRITICAL, NORMAL, BULK = tserve.CRITICAL, tserve.NORMAL, tserve.BULK

REF = types.SimpleNamespace(
    serve=jserve, WAL=JWAL, registry=j_registry, ring_slice=j_ring_slice,
    make_nr=lambda regs=8, replicas=1: JNR(
        j_make_seqreg(regs), n_replicas=replicas, **NR_KW),
)
PORT = types.SimpleNamespace(
    serve=tserve, WAL=TWAL, registry=t_registry, ring_slice=t_ring_slice,
    make_nr=lambda regs=8, replicas=1: TNR(
        make_seqreg(regs), n_replicas=replicas, device="cpu", **NR_KW),
)


def both(scenario, *args):
    """Run `scenario(pkg, *args)` on the reference and the port; the
    outcomes must be equal. Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def desc(exc):
    """A package-free description of a serve outcome."""
    if exc is None:
        return None
    d = {"type": type(exc).__name__}
    for f in ("rid", "depth", "priority", "evicted", "maybe_executed",
              "applied_pos", "min_pos"):
        if hasattr(exc, f):
            d[f] = getattr(exc, f)
    return d


def fleet(p, nr):
    """Ring entries still held, cursors and states as plain lists."""
    tail = int(np.asarray(nr.log.tail))
    lo = max(0, tail - nr.spec.capacity)
    ops, args = p.ring_slice(nr.spec, nr.log, lo, tail)
    return {
        "tail": tail,
        "ops": np.asarray(ops).tolist(),
        "args": np.asarray(args).tolist(),
        "ltails": np.asarray(nr.log.ltails).tolist(),
        "values": np.asarray(nr.states["values"]).tolist(),
    }


def fast(p, **kw):
    kw.setdefault("batch_linger_s", 0.0)
    return p.serve.ServeConfig(**kw)


# ---------------------------------------------------------------- governor


@pytest.mark.parametrize("kw", [
    dict(target_delay_s=0), dict(decrease=1.0),
    dict(brownout_enter=1.0, brownout_exit=1.0), dict(min_limit=0),
    dict(increase=0), dict(brownout_max_lag=-1), dict(ewma_alpha=0.0),
], ids=lambda kw: ",".join(kw))
def test_config_validation(kw):
    def sc(p):
        with pytest.raises(ValueError) as ei:
            p.serve.OverloadConfig(**kw)
        return str(ei.value)

    both(sc)


def run_governor(p, cfg_kw, depth, rounds, source=None):
    """Drive one governor through `rounds` of `(rid, delay_s, lag)`;
    returns every round's (limit, brownout, backpressure) and the
    final stats."""
    g = p.serve.OverloadGovernor(p.serve.OverloadConfig(**cfg_kw),
                                 queue_depth=depth)
    lag = [0]
    if source is not None:
        g.add_source(p.serve.LagSource("x", lambda: lag[0], *source))
    for rid in sorted({r for r, _, _ in rounds}):
        g.register_replica(rid)
    trace = []
    for rid, delay, lag[0] in rounds:
        lim = g.on_round(rid, delay, 8)
        assert lim == g.limit(rid)
        trace.append((lim, g.brownout(), g.backpressure()))
    return trace, g.stats()


def limits(trace):
    return [t[0] for t in trace]


def test_congested_round_multiplicative_decrease():
    cfg = dict(target_delay_s=0.01, min_limit=4, decrease=0.5)
    trace, _ = both(run_governor, cfg, 64, [(0, 0.05, 0)] * 12)
    assert limits(trace)[:4] == [32, 16, 8, 4]
    assert limits(trace)[-1] == 4  # clamped at min_limit


def test_clean_round_additive_increase():
    cfg = dict(target_delay_s=0.01, increase=4)
    trace, _ = both(run_governor, cfg, 64,
                    [(0, 0.05, 0)] + [(0, 0.001, 0)] * 21)
    assert limits(trace)[:2] == [32, 36]
    assert limits(trace)[-1] == 64  # capped at the static depth


def test_backpressure_watermarks():
    rounds = [(0, 0.05, 0), (0, 0.001, 0), (0, 0.001, 150),
              (0, 0.001, 250)]
    trace, st = both(run_governor, dict(target_delay_s=0.01), 64,
                     rounds, (100, 200))
    # below low: growth; between: growth pauses; past high: decrease
    assert limits(trace) == [32, 36, 36, 18]
    assert trace[-1][2] >= 1.0 and st["sources"] == ["x"]


def test_brownout_hysteresis():
    cfg = dict(target_delay_s=0.01, brownout_enter=2.0,
               brownout_exit=0.75, ewma_alpha=1.0)
    trace, _ = both(run_governor, cfg, 64,
                    [(0, 0.03, 0), (0, 0.012, 0), (0, 0.001, 0)])
    # enters above 2x target, stays between exit and enter, leaves below
    assert [t[1] for t in trace] == [True, True, False]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_rounds_equal_reference(seed):
    # a seeded stream of rounds over three replicas with a lag source
    # moving through its watermarks: every limit, brownout flip,
    # pressure reading and the final stats (EWMA included) match
    rng = np.random.default_rng(seed)
    rounds = [(int(rng.integers(3)),
               float(rng.choice([0.0, 0.004, 0.011, 0.03, 0.08])),
               int(rng.choice([0, 50, 120, 180, 260])))
              for _ in range(120)]
    cfg = dict(target_delay_s=0.01, min_limit=3, increase=5,
               decrease=0.6, ewma_alpha=0.4)
    trace, st = both(run_governor, cfg, 48, rounds, (100, 200))
    assert len(set(limits(trace))) > 3
    assert any(t[1] for t in trace) and not all(t[1] for t in trace)
    assert sorted(st["limits"]) == [0, 1, 2]


def test_duplicate_source_and_unregistered_rid():
    def sc(p):
        g = p.serve.OverloadGovernor(p.serve.OverloadConfig(),
                                     queue_depth=17)
        g.add_source(p.serve.LagSource("x", lambda: 0, 1, 2))
        with pytest.raises(ValueError) as dup:
            g.add_source(p.serve.LagSource("x", lambda: 0, 1, 2))
        with pytest.raises(ValueError) as bad:
            p.serve.LagSource("bad", lambda: 0, low=5, high=5)
        return str(dup.value), str(bad.value), g.limit(5)

    assert both(sc)[2] == 17


# ----------------------------------------------------- priority admission


def run_admission(p, depth, prios, batch_max_ops=64):
    """Submit `(SR_SET, 0, 10*(i+1))` at `prios[i]` into a paused
    frontend, then serve and drain. Seqreg's fetch-and-set exposes the
    execution order: each response is the value written before it."""
    nr = p.make_nr()
    fe = p.serve.ServeFrontend(
        nr, fast(p, queue_depth=depth, batch_max_ops=batch_max_ops),
        auto_start=False,
    )
    admitted, futs = [], []
    for i, prio in enumerate(prios):
        try:
            futs.append(fe.submit((SR_SET, 0, 10 * (i + 1)),
                                  priority=prio))
            admitted.append(None)
        except p.serve.Overloaded as e:
            futs.append(None)
            admitted.append(desc(e))
    queued = fe.stats()
    fe.start()
    assert fe.drain(10.0)
    results = []
    for f in futs:
        if f is None:
            results.append("shed")
            continue
        exc = f.exception(10.0)
        results.append(desc(exc) if exc is not None else f.result(10.0))
    st = fe.stats()
    fe.close()
    keys = ("accepted", "shed", "completed", "evicted",
            "priority_inversions", "shed_by_priority", "queued")
    return {
        "admitted": admitted,
        "queued": {k: queued[k] for k in keys},
        "results": results,
        "stats": {k: st[k] for k in keys},
        "fleet": fleet(p, nr),
    }


@pytest.mark.parametrize("case", [
    # (depth, priorities)
    ("evict-bulk-then-normal", 3,
     [BULK, NORMAL, NORMAL, CRITICAL, CRITICAL]),
    ("critical-sheds-only-into-critical", 2,
     [CRITICAL, CRITICAL, CRITICAL]),
    ("bulk-sheds-without-evicting", 1, [NORMAL, BULK]),
    ("strict-priority-drain-order", 8, [BULK, CRITICAL, NORMAL]),
], ids=lambda c: c[0])
def test_priority_admission(case):
    name, depth, prios = case
    out = both(run_admission, depth, prios)
    st, res = out["stats"], out["results"]
    assert st["priority_inversions"] == 0
    if name == "evict-bulk-then-normal":
        # a full queue: CRITICAL evicts the BULK op, then the NEWEST
        # queued NORMAL one, so the older NORMAL op stays
        assert res[0] == {"type": "Overloaded", "rid": 0, "depth": 3,
                          "priority": BULK, "evicted": True}
        assert res[2]["evicted"] and res[2]["priority"] == NORMAL
        assert res[1] != "shed" and not isinstance(res[1], dict)
        assert st["evicted"] == 2
        assert st["shed_by_priority"] == {"critical": 0, "normal": 1,
                                          "bulk": 1}
    elif name == "critical-sheds-only-into-critical":
        assert out["admitted"][2]["priority"] == CRITICAL
        assert st["evicted"] == 0
    elif name == "bulk-sheds-without-evicting":
        assert out["admitted"] == [None, {"type": "Overloaded", "rid": 0,
                                          "depth": 1, "priority": BULK,
                                          "evicted": False}]
        assert st["evicted"] == 0
    else:
        # CRITICAL saw the initial 0, NORMAL the CRITICAL's write,
        # BULK the NORMAL's
        assert res == [30, 0, 20]


@pytest.mark.parametrize("seed,depth,batch", [(0, 5, 64), (1, 7, 3),
                                              (2, 4, 2)])
def test_seeded_priority_stream_equals_reference(seed, depth, batch):
    rng = np.random.default_rng(seed)
    prios = [int(p) for p in rng.integers(0, 3, size=24)]
    out = both(run_admission, depth, prios, batch)
    st = out["stats"]
    assert st["priority_inversions"] == 0
    assert st["accepted"] == sum(a is None for a in out["admitted"])
    assert st["completed"] == out["fleet"]["tail"]


def test_restart_fold_keeps_priority_breakdown():
    # a failover restart retires the queue; its per-priority shed
    # counts fold into the aggregates like the totals do
    def sc(p):
        fe = p.serve.ServeFrontend(
            p.make_nr(), fast(p, queue_depth=1, failover=True),
            auto_start=False,
        )
        fe.submit((SR_SET, 0, 1), priority=NORMAL)
        with pytest.raises(p.serve.Overloaded):
            fe.submit((SR_SET, 0, 2), priority=BULK)
        fe._fail_replica(0, fe._queues[0], RuntimeError("test kill"))
        fe.restart_replica(0)
        st = fe.stats()
        fe.close(drain=False)
        return st["shed"], st["shed_by_priority"]

    shed, by_prio = both(sc)
    assert shed == 1 == sum(by_prio.values()) and by_prio["bulk"] == 1


def test_bad_priority_rejected():
    def sc(p):
        with p.serve.ServeFrontend(p.make_nr(), p.serve.ServeConfig()) \
                as fe:
            with pytest.raises(ValueError) as ei:
                fe.submit((SR_SET, 0, 1), priority=7)
        return str(ei.value)

    both(sc)


# ------------------------------------------------------ expired sweep


@pytest.mark.parametrize("room", [False, True],
                         ids=["full-of-corpses", "room-left"])
def test_expired_sweep_at_admission(room):
    def sc(p):
        fe = p.serve.ServeFrontend(
            p.make_nr(), fast(p, queue_depth=8 if room else 4),
            auto_start=False,
        )
        dead = [fe.submit((SR_SET, 0, i + 1), deadline_s=0.01)
                for i in range(1 if room else 4)]
        time.sleep(0.03)  # every one expires in the queue
        live = fe.submit((SR_SET, 0, 99), deadline_s=10.0)
        swept = [f.done() for f in dead]
        st = fe.stats()
        fe.start()
        out = [desc(f.exception(10.0)) for f in dead]
        val = live.result(10.0)
        fe.close()
        return swept, out, val, {k: st[k] for k in
                                 ("deadline_missed", "shed", "queued")}

    swept, out, val, st = both(sc)
    assert val == 0  # no expired request reached the log
    assert all(o["type"] == "DeadlineExceeded" for o in out)
    if room:
        # the sweep runs only at the limit
        assert swept == [False] and st["queued"] == 2
    else:
        assert all(swept)
        assert st == {"deadline_missed": 4, "shed": 0, "queued": 1}


# -------------------------------------------------------- brownout reads


@pytest.mark.parametrize("max_lag,min_pos", [(4096, None), (4096, 0),
                                             (0, None)])
def test_brownout_reads(max_lag, min_pos):
    def sc(p):
        cfg = fast(p, queue_depth=64, overload=p.serve.OverloadConfig(
            target_delay_s=0.01, ewma_alpha=1.0,
            brownout_max_lag=max_lag))
        with p.serve.ServeFrontend(p.make_nr(), cfg) as fe:
            fe.call((SR_SET, 3, 42), timeout=10.0)
            fe.governor.on_round(0, 0.1, 8)  # a hot round: brownout
            assert fe.governor.brownout()
            v = fe.read((SR_GET, 3), rid=0, min_pos=min_pos)
            st = fe.governor.stats()
        return v, st["brownout_reads"], st["max_brownout_lag"]

    v, reads, lag = both(sc)
    assert v == 42 and lag == 0
    # an explicit min_pos (read-your-writes) never takes the stale path
    assert reads == (0 if min_pos is not None else 1)


def test_execute_stale_reads_current_state():
    def sc(p):
        nr = p.make_nr()
        tok = nr.register(0)
        nr.execute_mut_batch([(SR_SET, 0, 9)], 0)
        return (nr.execute_stale((SR_GET, 0), tok), nr.read_lag(0),
                nr.execute_stale_bounded((SR_GET, 0), tok, 10))

    assert both(sc) == (9, 0, (9, 0))


def test_linger_at_or_above_target_rejected():
    def sc(p):
        with pytest.raises(ValueError) as ei:
            p.serve.ServeConfig(batch_linger_s=0.02,
                                overload=p.serve.OverloadConfig(
                                    target_delay_s=0.01))
        return str(ei.value)

    both(sc)


@pytest.mark.parametrize("kind", ["reached", "stale", "reached-waiting"])
def test_bounded_staleness_read(kind):
    # read(min_pos, wait_s): dispatch once the replica's applied cursor
    # reaches min_pos, wait at most wait_s, else a typed StaleRead
    def sc(p):
        nr = p.make_nr(replicas=2)
        with p.serve.ServeFrontend(nr, fast(p)) as fe:
            for i in range(5):
                fe.call((SR_SET, 1, i + 1), rid=i % 2, timeout=10.0)
            tail = int(np.asarray(nr.log.tail))
            if kind == "reached":
                return fe.read((SR_GET, 1), rid=1, min_pos=tail), tail
            if kind == "stale":
                with pytest.raises(p.serve.StaleRead) as ei:
                    fe.read((SR_GET, 1), rid=1, min_pos=tail + 3,
                            wait_s=0.02)
                return desc(ei.value), tail
            writer = threading.Timer(
                0.05, lambda: fe.call((SR_SET, 1, 77), timeout=10.0))
            writer.start()
            try:
                v = fe.read((SR_GET, 1), rid=1, min_pos=tail + 1,
                            wait_s=10.0)
            finally:
                writer.join(10.0)
            return v, tail

    v, tail = both(sc)
    assert tail == 5
    if kind == "reached":
        assert v == 5
    elif kind == "stale":
        assert v == {"type": "StaleRead", "rid": 1, "applied_pos": 5,
                     "min_pos": 8}
    else:
        assert v == 77


# ------------------------------------------------------- circuit breaker


def run_breaker(p, kw, steps):
    """Script a breaker: `call` (before_call: 'admitted' or 'refused'),
    `fail`, `ok` (record_success), `sleep` (a cool-down and a fifth);
    returns each step's outcome, each followed by the breaker's state."""
    b = p.serve.CircuitBreaker(**kw)
    out = []
    for step in steps:
        if step == "call":
            try:
                b.before_call()
                out.append("admitted")
            except p.serve.CircuitOpen as e:
                assert e.retry_after_s > 0
                out.append("refused")
        elif step == "fail":
            b.record_failure()
        elif step == "ok":
            b.record_success()
        else:
            time.sleep(kw["cooldown_s"] * 1.2)
        out.append(b.state)
    return out


BREAKER_CASES = {
    # the half-open probe: one at a time, its success closes
    "half-open-probe": (dict(failure_threshold=3, cooldown_s=0.05),
                        ["call", "fail"] * 3 + ["call", "sleep", "call",
                                                "call", "ok", "call"]),
    "half-open-failure-reopens": (
        dict(failure_threshold=2, cooldown_s=0.05),
        ["fail", "fail", "sleep", "call", "fail", "call"]),
    "success-resets-count": (dict(failure_threshold=3, cooldown_s=1.0),
                             ["fail", "fail", "ok", "fail", "fail"]),
    # a probe whose caller never reports back holds a lease one
    # cool-down long; then the next caller takes it over
    "lost-probe-lease-expires": (
        dict(failure_threshold=1, cooldown_s=0.05),
        ["fail", "sleep", "call", "call", "sleep", "call", "ok"]),
}


@pytest.mark.parametrize("name", sorted(BREAKER_CASES))
def test_circuit_breaker(name):
    kw, steps = BREAKER_CASES[name]
    out = both(run_breaker, kw, steps)
    calls = [o for o in out if o in ("admitted", "refused")]
    if name == "half-open-probe":
        # only ONE probe at a time; its success closes the circuit
        assert calls == ["admitted"] * 3 + ["refused", "admitted",
                                            "refused", "admitted"]
        assert out[-1] == "closed"
    elif name == "half-open-failure-reopens":
        assert calls == ["admitted", "refused"] and out[-1] == "open"
    elif name == "success-resets-count":
        assert out[-1] == "closed"
    else:
        assert calls == ["admitted", "refused", "admitted"]
        assert out[-1] == "closed"


@pytest.mark.parametrize("kw", [dict(failure_threshold=0),
                                dict(cooldown_s=0)],
                         ids=["threshold", "cooldown"])
def test_circuit_breaker_validation(kw):
    def sc(p):
        with pytest.raises(ValueError) as ei:
            p.serve.CircuitBreaker(**kw)
        return str(ei.value)

    both(sc)


# ------------------------------------------------------ retry by cause


class _FlakyFrontend:
    """Stub: raises the scripted errors, then succeeds."""

    def __init__(self, errors):
        self.errors = list(errors)
        self.calls = 0

    def call(self, op, rid=0, deadline_s=None, timeout=None, **kwargs):
        self.calls += 1
        if self.errors:
            raise self.errors.pop(0)
        return 42

    def healthy_rids(self):
        return [0, 1]


CAUSES = ("overloaded", "replica_failed", "circuit_open")


@pytest.mark.parametrize("case", ["split-by-cause", "breaker-wired",
                                  "maybe-executed", "non-transient"])
def test_retry_by_cause(case):
    def sc(p):
        s = p.serve
        reg = p.registry()
        was = reg.enabled
        reg.enable()
        try:
            before = {c: reg.counter(f"serve.retry.{c}").value
                      for c in CAUSES}
            policy = s.RetryPolicy(max_attempts=10,
                                   base_backoff_s=0.0001,
                                   max_backoff_s=0.001)
            b = None
            if case == "split-by-cause":
                fe = _FlakyFrontend([s.Overloaded(0, 4),
                                     s.ReplicaFailed(0, None, False)])
            elif case == "breaker-wired":
                # enough sheds to trip the breaker, then success: the
                # loop rides out the cool-down and lands the op
                fe = _FlakyFrontend([s.Overloaded(0, 4)] * 3)
                b = s.CircuitBreaker(failure_threshold=2,
                                     cooldown_s=0.02)
            elif case == "maybe-executed":
                fe = _FlakyFrontend([s.ReplicaFailed(
                    0, None, maybe_executed=True)])
                b = s.CircuitBreaker()
            else:
                fe = _FlakyFrontend([s.DeadlineExceeded(0, 0.01)])
                b = s.CircuitBreaker(failure_threshold=1,
                                     cooldown_s=10.0)
            try:
                out = s.call_with_retry(fe, (SR_SET, 0, 1),
                                        policy=policy, breaker=b)
            except s.ServeError as e:
                out = desc(e)
            after = {c: reg.counter(f"serve.retry.{c}").value
                     for c in CAUSES}
        finally:
            if not was:
                reg.disable()
        delta = {c: after[c] - before[c] for c in CAUSES}
        return (out, fe.calls, delta,
                None if b is None else b.stats()["state"])

    out, calls, delta, state = both(sc)
    if case == "split-by-cause":
        assert out == 42 and delta == {"overloaded": 1,
                                       "replica_failed": 1,
                                       "circuit_open": 0}
    elif case == "breaker-wired":
        assert out == 42 and state == "closed"
        assert delta["overloaded"] > 0 and delta["circuit_open"] > 0
    elif case == "maybe-executed":
        assert out["type"] == "ReplicaFailed" and calls == 1
    else:
        # a DeadlineExceeded outcome still reports to the breaker
        assert out["type"] == "DeadlineExceeded" and state == "open"


# ------------------------------------------------- backpressure wiring


def test_wal_fsync_lag_export(tmp_path):
    def sc(p):
        wal = p.WAL(str(tmp_path / p.WAL.__module__ / "wal"),
                    policy="batch", arg_width=2)
        out = [wal.fsync_lag()]
        wal.append(0, [(1, 0, 5), (1, 1, 6)])
        out.append(wal.fsync_lag())
        wal.sync()
        out.append(wal.fsync_lag())
        wal.close()
        return out

    assert both(sc) == [0, 2, 0]


@pytest.mark.parametrize("attach_first", [True, False],
                         ids=["attached-before", "attached-after"])
def test_frontend_wires_wal_fsync_lag(tmp_path, attach_first):
    # the source resolves the WAL when polled, so a WAL attached after
    # the frontend was built still throttles admission
    def sc(p):
        nr = p.make_nr()
        path = str(tmp_path / p.WAL.__module__ / "wal")

        def attach():
            nr.attach_wal(p.WAL(path, policy="none",
                                arg_width=nr.spec.arg_width))

        if attach_first:
            attach()
        cfg = fast(p, overload=p.serve.OverloadConfig(), wal_lag_low=1,
                   wal_lag_high=4)
        with p.serve.ServeFrontend(nr, cfg) as fe:
            sources = fe.governor.stats()["sources"]
            pressure = [fe.governor.backpressure()]
            if not attach_first:
                attach()
            for i in range(6):
                fe.call((SR_SET, 0, i + 1), timeout=10.0)
            # 6 journaled, none fsynced: past the high watermark
            pressure.append(fe.governor.backpressure())
            lim = fe.governor.limit(0)
        nr.detach_wal().close()
        return sources, pressure, lim

    sources, pressure, lim = both(sc)
    assert sources == ["wal-fsync"]
    assert pressure[0] == 0.0 and pressure[1] >= 1.0
    # the rounds that saw 4 and 5 unfsynced records halved the default
    # depth of 256 twice
    assert lim == 64


def test_high_lag_clamps_admission():
    def sc(p):
        cfg = fast(p, queue_depth=64, overload=p.serve.OverloadConfig(
            target_delay_s=10.0, min_limit=4))
        with p.serve.ServeFrontend(p.make_nr(), cfg) as fe:
            lag = [10_000]
            fe.governor.add_source(p.serve.LagSource(
                "downstream", lambda: lag[0], low=100, high=1000))
            # clean delay, but past the high watermark: every round
            # shrinks admission toward the floor
            for _ in range(10):
                fe.governor.on_round(0, 0.0, 8)
            low = fe.governor.limit(0)
            lag[0] = 0  # backlog drained: admission recovers
            for _ in range(20):
                fe.governor.on_round(0, 0.0, 8)
            return low, fe.governor.limit(0)

    assert both(sc) == (4, 64)


# ------------------------------------------------------- end to end


def _reference_replay(nr, regs):
    """Replay the port's ring through the reference wrapper: returns
    {(register, value written): response} and the reference's states
    (the ring must still hold the whole history)."""
    f = fleet(PORT, nr)
    assert f["tail"] <= nr.spec.capacity
    ops = [(int(o),) + tuple(int(x) for x in a)
           for o, a in zip(f["ops"], f["args"])]
    jn = REF.make_nr(regs=regs)
    resps = jn.execute_mut_batch(ops, 0)
    by_write = {(op[1] % regs, op[2]): r for op, r in zip(ops, resps)}
    assert len(by_write) == len(ops)  # every write is unique
    return by_write, np.asarray(jn.states["values"]).tolist(), f


def test_no_loss_no_inversion_under_burst():
    nr = PORT.make_nr(regs=8)
    cfg = fast(PORT, queue_depth=16, batch_max_ops=8,
               overload=tserve.OverloadConfig(target_delay_s=0.002,
                                              min_limit=2))
    outcomes = {"ok": 0, "shed": 0, "evicted": 0}
    acked = {}
    with tserve.ServeFrontend(nr, cfg) as fe:
        futs = []
        for i in range(200):
            try:
                futs.append((i, fe.submit((SR_SET, i % 8, i + 1),
                                          priority=(CRITICAL, NORMAL,
                                                    BULK)[i % 3])))
            except tserve.Overloaded:
                outcomes["shed"] += 1
        assert fe.drain(10.0)
        for i, f in futs:
            exc = f.exception(10.0)
            if exc is None:
                outcomes["ok"] += 1
                acked[(i % 8, i + 1)] = f.result(10.0)
            else:
                assert isinstance(exc, tserve.Overloaded) and exc.evicted
                outcomes["evicted"] += 1
        st = fe.stats()
    assert outcomes["ok"] + outcomes["evicted"] == len(futs)
    assert st["priority_inversions"] == 0
    assert st["accepted"] == len(futs)
    assert st["completed"] == outcomes["ok"]
    by_write, values, f = _reference_replay(nr, 8)
    # the log holds exactly the acked ops, each response is the
    # reference's for that position, and the states agree
    assert f["tail"] == outcomes["ok"] and set(by_write) == set(acked)
    assert acked == by_write
    assert values == f["values"]


def test_concurrent_clients_with_breakers():
    nr = PORT.make_nr(regs=4)
    cfg = fast(PORT, queue_depth=8, batch_max_ops=4,
               overload=tserve.OverloadConfig(target_delay_s=0.001,
                                              min_limit=2))
    errs, acked = [], {}

    def client(fe, c):
        b = tserve.CircuitBreaker(failure_threshold=4, cooldown_s=0.01)
        policy = tserve.RetryPolicy(max_attempts=12,
                                    base_backoff_s=0.0005,
                                    max_backoff_s=0.01)
        prev = 0
        for i in range(50):
            try:
                resp = tserve.call_with_retry(
                    fe, (SR_SET, c, i + 1), policy=policy, breaker=b,
                    priority=(i % 3), timeout=10.0,
                )
            except (tserve.Overloaded, tserve.CircuitOpen):
                continue  # budget exhausted: op provably shed
            acked[(c, i + 1)] = resp
            if resp != prev:
                errs.append((c, i, resp, prev))
            prev = i + 1

    with tserve.ServeFrontend(nr, cfg) as fe:
        ths = [threading.Thread(target=client, args=(fe, c))
               for c in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60.0)
        assert not any(t.is_alive() for t in ths)
    assert not errs, errs[:5]
    by_write, values, f = _reference_replay(nr, 4)
    assert acked == by_write and values == f["values"]
