"""nrcheck over the port: whole-program lock-discipline analysis and
the checked lock factory (`node_replication_torch/analysis/`).

The twin of tests/test_concurrency.py, plus differentials against the
reference package's factory (one scripted acquisition sequence gives
the same edges and the same `LockOrderError` points on both) and an
in-process served fleet with a shipper and a follower under
`NR_TPU_LOCKCHECK=1`, whose observed lock graph must be a subgraph of
the port's static one.

Static half (`analysis/concurrency.py`): fixture modules exercise the
guarded-by inference (true positive, true negative, both annotation
escape hatches), the global lock-order graph (direct nesting,
interprocedural nesting, declared edges, cycle reporting), and the two
satellite rules. Fixtures follow `test_analysis.py`'s convention:
self-contained snippets written to tmp_path, analyzed purely
syntactically.

Runtime half (`analysis/locks.py`): the instrumented factory under a
private `fresh_state()` — single-thread order inversion, a LIVE
two-thread deadlock interleaving that `LockOrderError` catches before
either thread hangs, reentrancy, trylock probes, Condition
integration, the passthrough contract, and the lockgraph dump that
`--check-dynamic` gates against the static graph.
"""

import json
import textwrap
import threading
import time

import pytest

from node_replication_torch.analysis import concurrency
from node_replication_torch.analysis import locks as locks_mod
from node_replication_torch.analysis.lint import (
    audit_suppressions,
    build_project,
    main,
    run_lint,
)
from node_replication_torch.analysis.locks import (
    LockOrderError,
    _CheckedLock,
    _CheckedRLock,
    dump_lockgraph,
    fresh_state,
    make_condition,
    make_lock,
    make_rlock,
)


def lint_src(tmp_path, source, name="snippet.py", select=None):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    diags, errors = run_lint([str(p)], select=select)
    assert not errors, errors
    return diags


def firing(diags, rule_id):
    return [d for d in diags if d.rule_id == rule_id and not d.suppressed]


def analyze_src(tmp_path, source, name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    modules, project, errors = build_project([str(p)])
    assert not errors, errors
    return concurrency.analyze(project)


# a thread-shared fixture class: spawns a role-named worker that
# stores `_v` under `_lock`, so `_v` is inferred guarded-by `_lock`
SHARED_CLASS = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._v = 0
            self._t = threading.Thread(
                target=self._run, name="serve-worker-0"
            )
            self._t.start()

        def _run(self):
            with self._lock:
                self._v += 1
"""


class TestRoleOracle:
    def test_prefixes_mirror_obs_profile(self):
        # the analysis ships its own copy (analysis must not import
        # runtime modules); this pin keeps the two tables in lockstep
        from node_replication_torch.obs import profile

        assert set(concurrency.ROLE_PREFIXES) == set(
            profile._ROLE_PREFIXES
        )

    def test_prefixes_equal_the_reference_analyzer(self):
        from node_replication_tpu.analysis import concurrency as ref

        assert concurrency.ROLE_PREFIXES == ref.ROLE_PREFIXES


class TestGuardedByInference:
    def test_unlocked_read_in_shared_class_fires(self, tmp_path):
        diags = lint_src(tmp_path, SHARED_CLASS + """
            def peek(self):
                return self._v
        """ .replace("\n    ", "\n"))
        hits = firing(diags, "nrcheck-guarded-by")
        assert len(hits) == 1
        assert "Box._v" in hits[0].message
        assert "Box._lock" in hits[0].message

    def test_locked_read_clean(self, tmp_path):
        diags = lint_src(tmp_path, SHARED_CLASS + """
            def peek(self):
                with self._lock:
                    return self._v
        """ .replace("\n    ", "\n"))
        assert not firing(diags, "nrcheck-guarded-by")

    def test_unshared_annotation_silences(self, tmp_path):
        diags = lint_src(tmp_path, SHARED_CLASS + """
            def peek(self):
                # nrcheck: unshared — lock-free poll, fixture
                return self._v
        """ .replace("\n    ", "\n"))
        assert not firing(diags, "nrcheck-guarded-by")

    def test_guarded_by_method_annotation_silences(self, tmp_path):
        # caller-holds-the-lock contract: the whole method is a region
        diags = lint_src(tmp_path, SHARED_CLASS + """
            # guarded-by: _lock
            def peek(self):
                return self._v
        """ .replace("\n    ", "\n"))
        assert not firing(diags, "nrcheck-guarded-by")

    def test_unshared_class_not_flagged(self, tmp_path):
        # same shape, but nothing spawns a thread: single-threaded
        # callers may read lock-free without a diagnostic
        diags = lint_src(tmp_path, """
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._v = 0

                def bump(self):
                    with self._lock:
                        self._v += 1

                def peek(self):
                    return self._v
        """)
        assert not firing(diags, "nrcheck-guarded-by")


class TestLockOrder:
    def test_direct_inversion_cycle_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def ab():
                with lock_a:
                    with lock_b:
                        pass

            def ba():
                with lock_b:
                    with lock_a:
                        pass
        """)
        assert firing(diags, "nrcheck-lock-order")

    def test_consistent_order_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def ab():
                with lock_a:
                    with lock_b:
                        pass

            def ab_again():
                with lock_a:
                    with lock_b:
                        pass
        """)
        assert not firing(diags, "nrcheck-lock-order")

    def test_interprocedural_cycle_fires(self, tmp_path):
        # outer holds A and reaches B only through a call: the edge
        # comes from the callee's transitive acquire summary
        diags = lint_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def outer():
                with lock_a:
                    inner()

            def inner():
                with lock_b:
                    pass

            def rev():
                with lock_b:
                    with lock_a:
                        pass
        """)
        assert firing(diags, "nrcheck-lock-order")

    def test_declared_edge_enters_graph(self, tmp_path):
        # a `# nrcheck: lock-order` declaration is a real edge: with
        # the reverse nesting in code, the cycle is reported
        diags = lint_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            # nrcheck: lock-order snippet.lock_a -> snippet.lock_b — fixture
            def rev():
                with lock_b:
                    with lock_a:
                        pass
        """)
        assert firing(diags, "nrcheck-lock-order")

    def test_static_edge_list(self, tmp_path):
        analysis = analyze_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def ab():
                with lock_a:
                    with lock_b:
                        pass
        """)
        assert ["snippet.lock_a", "snippet.lock_b"] in analysis.edge_list()
        assert not analysis.cycles

    def test_check_dynamic_subgraph(self, tmp_path):
        analysis = analyze_src(tmp_path, """
            import threading

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def ab():
                with lock_a:
                    with lock_b:
                        pass
        """)
        assert analysis.check_dynamic(
            [["snippet.lock_a", "snippet.lock_b"]]
        ) == []
        rogue = analysis.check_dynamic(
            [["snippet.lock_b", "snippet.lock_a"]]
        )
        assert len(rogue) == 1


class TestAnnotationDiags:
    def test_malformed_nrcheck_comment_warns(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            # nrcheck: unshareable
            x = 1
        """)
        assert firing(diags, "nrcheck-annotation")

    def test_factory_name_drift_warns(self, tmp_path):
        diags = lint_src(tmp_path, """
            from node_replication_torch.analysis.locks import make_lock

            class Box:
                def __init__(self):
                    self._lock = make_lock("Wrong._lock")
        """)
        hits = firing(diags, "nrcheck-annotation")
        assert len(hits) == 1
        assert "Box._lock" in hits[0].message

    def test_factory_name_match_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            from node_replication_torch.analysis.locks import make_lock

            class Box:
                def __init__(self):
                    self._lock = make_lock("Box._lock")
        """)
        assert not firing(diags, "nrcheck-annotation")


class TestConditionWaitRule:
    RULE = "condition-wait-without-predicate-loop"

    def test_bare_wait_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class W:
                def __init__(self):
                    self._cond = threading.Condition()
                    self.ready = False

                def bad(self):
                    with self._cond:
                        self._cond.wait()
        """)
        assert len(firing(diags, self.RULE)) == 1

    def test_wait_in_predicate_loop_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class W:
                def __init__(self):
                    self._cond = threading.Condition()
                    self.ready = False

                def good(self):
                    with self._cond:
                        while not self.ready:
                            self._cond.wait()
        """)
        assert not firing(diags, self.RULE)

    def test_timed_wait_clean(self, tmp_path):
        # a timed wait is a poll: the caller re-checks by construction
        diags = lint_src(tmp_path, """
            import threading

            class W:
                def __init__(self):
                    self._cond = threading.Condition()

                def poll(self):
                    with self._cond:
                        self._cond.wait(0.05)
        """)
        assert not firing(diags, self.RULE)


class TestLockHeldAcrossBlockingCall:
    RULE = "lock-held-across-blocking-call"

    def test_sendall_under_lock_fires(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class S:
                def __init__(self, sock):
                    self._lock = threading.Lock()
                    self.sock = sock

                def bad(self, data):
                    with self._lock:
                        self.sock.sendall(data)
        """)
        assert len(firing(diags, self.RULE)) == 1

    def test_sendall_outside_lock_clean(self, tmp_path):
        diags = lint_src(tmp_path, """
            import threading

            class S:
                def __init__(self, sock):
                    self._lock = threading.Lock()
                    self.sock = sock
                    self.buf = b""

                def good(self, data):
                    with self._lock:
                        self.buf = bytes(data)
                    self.sock.sendall(self.buf)
        """)
        assert not firing(diags, self.RULE)


# ---------------------------------------------------------------- runtime


class TestCheckedLocks:
    def test_single_thread_inversion_raises(self):
        with fresh_state():
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            with a:
                with b:
                    pass
            with b:
                with pytest.raises(LockOrderError):
                    a.acquire()

    def test_two_thread_deadlock_caught_before_hang(self):
        # the LIVE interleaving: T1 takes A then B, T2 takes B then A,
        # a barrier forcing both outer locks held. Unchecked this
        # deadlocks; the checker fails exactly one thread fast and
        # BOTH threads finish.
        with fresh_state():
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            barrier = threading.Barrier(2, timeout=10)
            errs = []

            def run(first, second):
                with first:
                    barrier.wait()
                    try:
                        with second:
                            pass
                    except LockOrderError as e:
                        errs.append(e)

            t1 = threading.Thread(target=run, args=(a, b))
            t2 = threading.Thread(target=run, args=(b, a))
            t1.start()
            t2.start()
            t1.join(10)
            t2.join(10)
            assert not t1.is_alive() and not t2.is_alive()
            assert len(errs) == 1
            assert "cycle" in str(errs[0])

    def test_self_deadlock_raises(self):
        with fresh_state():
            a = _CheckedLock("A")
            with a:
                with pytest.raises(LockOrderError):
                    a.acquire()

    def test_rlock_reentry_no_edges(self):
        with fresh_state() as st:
            r = _CheckedRLock("R")
            with r:
                with r:
                    pass
            assert st.edge_list() == []

    def test_trylock_probe_records_but_never_raises(self):
        # `_locked`'s contention fast path: a non-blocking probe in
        # cycle-closing order records the edge (for the dump) but
        # cannot deadlock, so it must not raise
        with fresh_state() as st:
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            with a:
                with b:
                    pass
            with b:
                assert a.acquire(blocking=False)
                a.release()
            assert ["B", "A"] in st.edge_list()

    def test_nesting_records_all_pairs(self):
        with fresh_state() as st:
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            c = _CheckedLock("C")
            with a:
                with b:
                    with c:
                        pass
            assert st.edge_list() == [
                ["A", "B"], ["A", "C"], ["B", "C"],
            ]

    def test_condition_wait_notify_roundtrip(self, monkeypatch):
        # Condition built on a checked lock: wait() releases and
        # re-acquires through the held-stack bookkeeping
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "1")
        with fresh_state():
            cond = make_condition("Fixture._cond")
            results = []

            def waiter():
                with cond:
                    results.append(cond.wait(timeout=10))

            t = threading.Thread(target=waiter)
            t.start()
            deadline = time.time() + 10
            while not results and time.time() < deadline:
                with cond:
                    cond.notify_all()
                time.sleep(0.005)
            t.join(10)
            assert results == [True]

    def test_checked_rlock_condition_roundtrip(self, monkeypatch):
        # the paired-lock idiom on a reentrant lock: Condition uses
        # _release_save/_acquire_restore, which must keep the
        # held-stack count balanced through the wait
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "1")
        with fresh_state() as st:
            rlock = make_rlock("Fixture._lock")
            cond = make_condition("Fixture._lock", lock=rlock)
            with cond:
                assert not cond.wait(timeout=0.01)  # times out
            assert st.held() == []


class TestFactoryContract:
    def test_passthrough_when_disabled(self, monkeypatch):
        monkeypatch.delenv("NR_TPU_LOCKCHECK", raising=False)
        assert type(make_lock("X._lock")) is type(threading.Lock())
        assert type(make_rlock("X._rlock")) is type(threading.RLock())
        assert isinstance(make_condition("X._cond"), threading.Condition)

    def test_checked_when_enabled(self, monkeypatch):
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "1")
        with fresh_state():
            assert isinstance(make_lock("X._lock"), _CheckedLock)
            assert isinstance(make_rlock("X._rlock"), _CheckedRLock)

    def test_dump_merges_existing(self, tmp_path):
        path = tmp_path / "lockgraph.json"
        path.write_text(json.dumps({"edges": [["P", "Q"]]}))
        with fresh_state():
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            with a:
                with b:
                    pass
            dump_lockgraph(str(path))
        data = json.loads(path.read_text())
        assert ["A", "B"] in data["edges"]
        assert ["P", "Q"] in data["edges"]


# ------------------------------------------------------------- CLI gates


class TestCLI:
    AB = """
        import threading

        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def ab():
            with lock_a:
                with lock_b:
                    pass
    """

    def test_lockgraph_out_and_check_dynamic(self, tmp_path):
        src = tmp_path / "snippet.py"
        src.write_text(textwrap.dedent(self.AB))
        out = tmp_path / "static.json"
        assert main([str(src), "--lockgraph-out", str(out)]) == 0
        data = json.loads(out.read_text())
        assert ["snippet.lock_a", "snippet.lock_b"] in data["edges"]

        dyn = tmp_path / "dyn.json"
        dyn.write_text(json.dumps(
            {"edges": [["snippet.lock_a", "snippet.lock_b"]]}
        ))
        assert main([str(src), "--check-dynamic", str(dyn)]) == 0
        dyn.write_text(json.dumps({"edges": [["rogue.x", "rogue.y"]]}))
        assert main([str(src), "--check-dynamic", str(dyn)]) == 1

    def test_suppressions_audit_flags_stale_and_unjustified(
            self, tmp_path, capsys):
        p = tmp_path / "s.py"
        p.write_text(textwrap.dedent("""
            import threading

            x = 1  # nrlint: disable=nrcheck-guarded-by
        """))
        assert audit_suppressions([str(p)]) == 1
        out = capsys.readouterr().out
        assert "STALE" in out
        assert "UNJUSTIFIED" in out

    def test_suppressions_audit_accepts_live_justified(
            self, tmp_path, capsys):
        p = tmp_path / "s.py"
        p.write_text(textwrap.dedent("""
            import threading

            class W:
                def __init__(self):
                    self._cond = threading.Condition()

                def bad(self):
                    with self._cond:
                        self._cond.wait()  # nrlint: disable=condition-wait-without-predicate-loop — fixture
        """))
        assert audit_suppressions([str(p)]) == 0
        out = capsys.readouterr().out
        assert "STALE" not in out and "UNJUSTIFIED" not in out

    @pytest.mark.slow
    def test_package_lint_is_clean(self):
        # the acceptance gate: the analysis over the port's own
        # package must exit 0 (no unguarded shared-attribute access,
        # acyclic lock-order graph, every suppression live and
        # justified). slow-marked, as in the reference: two
        # whole-package passes — the tier-1 run already gates
        # lint-cleanliness through
        # test_torch_analysis.py::TestRepoIsClean (nrcheck rules
        # included)
        import os

        import node_replication_torch

        pkg = os.path.dirname(node_replication_torch.__file__)
        assert main([pkg]) == 0
        assert audit_suppressions([pkg]) == 0


# ------------------------------------------------------ the port's factory


class TestFactoryExtensions:
    def test_nodes_and_violations_are_recorded(self):
        # every acquired lock is a node (nested or not), and each
        # raised LockOrderError is counted
        with fresh_state() as st:
            a = _CheckedLock("A")
            b = _CheckedLock("B")
            with a:
                pass
            with b:
                with a:
                    pass
            with a:
                with pytest.raises(LockOrderError):
                    b.acquire()
                with pytest.raises(LockOrderError):
                    a.acquire()
            assert st.node_list() == ["A", "B"]
            assert st.violations == 2
            assert locks_mod.current_nodes() == ["A", "B"]
            assert locks_mod.current_violations() == 2

    def test_dump_carries_nodes_and_merges_them(self, tmp_path):
        path = tmp_path / "lockgraph.json"
        path.write_text(json.dumps({"edges": [["P", "Q"]],
                                    "nodes": ["Z"]}))
        with fresh_state():
            a = _CheckedLock("A")
            with a:
                pass
            dump_lockgraph(str(path))
        data = json.loads(path.read_text())
        assert data["edges"] == [["P", "Q"]]
        assert data["nodes"] == ["A", "P", "Q", "Z"]

    def test_module_locks_follow_the_env_at_construction(self,
                                                         monkeypatch):
        # the mode is chosen when a lock is built: a module-level lock
        # is checked only if NR_TPU_LOCKCHECK=1 was set before import
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "1")
        assert locks_mod.lockcheck_enabled()
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "0")
        assert not locks_mod.lockcheck_enabled()
        assert type(make_lock("X._lock")) is type(threading.Lock())


def _scripted(mod) -> tuple[list, list]:
    """One scripted single-thread acquisition sequence on factory
    module `mod`: `(edges, indices of the steps that raised)`."""
    with mod.fresh_state() as st:
        a, b, c = (mod._CheckedLock(n) for n in "ABC")
        r = mod._CheckedRLock("R")

        def nest(*ls):
            def run():
                held = []
                try:
                    for lk in ls:
                        lk.acquire()
                        held.append(lk)
                finally:
                    for lk in reversed(held):
                        lk.release()
            return run

        def probe(outer, inner):
            def run():
                with outer:
                    assert inner.acquire(blocking=False)
                    inner.release()
            return run

        steps = [
            nest(a, b), nest(b, c),
            nest(c, a),              # closes A -> B -> C -> A: raises
            nest(a, a),              # self-deadlock: raises
            probe(c, b),             # a trylock never raises
            nest(r, r, a),           # RLock re-entry adds no edge
            nest(b, r),              # B -> R closes R -> A -> B: raises
            nest(r, b),              # R -> B after B -> R: raises
            nest(c, r, r),           # C -> R closes R -> A -> B -> C
            probe(a, r),
        ]
        raised = []
        for i, step in enumerate(steps):
            try:
                step()
            except mod.LockOrderError:
                raised.append(i)
        assert st.held() == []
        return st.edge_list(), raised


class TestFactoryDifferential:
    def test_scripted_sequence_matches_the_reference(self):
        from node_replication_tpu.analysis import locks as ref_locks

        got = _scripted(locks_mod)
        want = _scripted(ref_locks)
        assert got == want
        assert got[1] == [2, 3, 6, 7, 8]

    def test_two_thread_interleaving_matches_the_reference(self):
        # the live AB/BA interleaving: both factories fail exactly one
        # thread, and record the same two edges
        from node_replication_tpu.analysis import locks as ref_locks

        def run(mod):
            with mod.fresh_state() as st:
                a, b = mod._CheckedLock("A"), mod._CheckedLock("B")
                barrier = threading.Barrier(2, timeout=10)
                errs = []

                def go(first, second):
                    with first:
                        barrier.wait()
                        try:
                            with second:
                                pass
                        except mod.LockOrderError as e:
                            errs.append(type(e).__name__)

                ts = [threading.Thread(target=go, args=(a, b)),
                      threading.Thread(target=go, args=(b, a))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(10)
                return st.edge_list(), errs

        assert run(locks_mod) == run(ref_locks) == (
            [["A", "B"], ["B", "A"]], ["LockOrderError"])


_STATIC = {}


def port_static_edges() -> set:
    if "e" not in _STATIC:
        import os

        import node_replication_torch

        pkg = os.path.dirname(node_replication_torch.__file__)
        _, project, errors = build_project([pkg])
        assert not errors
        _STATIC["e"] = {tuple(e)
                        for e in concurrency.analyze(project).edge_list()}
    return _STATIC["e"]


class TestCheckedServedFleet:
    def test_dynamic_edges_are_a_static_subgraph(self, tmp_path,
                                                 monkeypatch):
        # a small served fleet (WAL attached, ship-before-ack into a
        # feed, a follower applying it) under the checked factory: no
        # LockOrderError, and every observed nesting is one the static
        # analysis knows
        monkeypatch.setenv("NR_TPU_LOCKCHECK", "1")
        from node_replication_torch.models import HM_GET, make_hashmap
        from node_replication_torch.obs.metrics import get_registry
        from node_replication_torch.repl import (
            DirectoryFeed,
            Follower,
            ReplicationShipper,
        )
        from node_replication_torch.serve import ServeConfig, ServeFrontend

        kw = dict(n_replicas=2, log_entries=256, device="cpu")
        reg = get_registry()
        was = reg.enabled
        reg.enable()
        with fresh_state() as st:
            cfg = ServeConfig(batch_max_ops=16, batch_linger_s=0.001,
                              durability="batch")
            fe = ServeFrontend.from_recovery(
                str(tmp_path / "primary"), make_hashmap(64), cfg,
                rids=range(2), nr_kwargs=kw)
            feed = DirectoryFeed(str(tmp_path / "feed"), arg_width=3)
            shipper = ReplicationShipper(fe.nr.wal, feed)
            fe.ack_barrier = shipper.barrier
            fol = Follower(make_hashmap(64), feed, str(tmp_path / "f1"),
                           config=ServeConfig(batch_max_ops=16,
                                              batch_linger_s=0.001),
                           nr_kwargs=kw, name="f1", rids=range(2))
            try:
                acked = {}

                def client(c):
                    for i in range(12):
                        k = 8 * c + i % 8
                        fe.submit((1, k, 100 * c + i),
                                  rid=c % 2).result(timeout=60)
                        acked[k] = 100 * c + i

                ts = [threading.Thread(target=client, args=(c,),
                                       name=f"serve-client-{c}")
                      for c in range(3)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(60)
                assert len(acked) == 24
                assert fol.wait_applied(feed.tail_pos(), timeout=60)
                for k, v in acked.items():
                    assert fol.read((HM_GET, k), rid=k % 2) == v
            finally:
                shipper.stop()
                fol.close()
                fe.close()
                if not was:
                    reg.disable()
            edges = {tuple(e) for e in st.edge_list()}
            assert st.violations == 0
            assert {"ServeFrontend._lock", "WriteAheadLog._lock",
                    "Follower._cond", "ReplicationShipper._cond"} <= \
                set(st.node_list())
        assert edges, "nothing nested: the fleet was not checked"
        assert edges <= port_static_edges(), edges - port_static_edges()
