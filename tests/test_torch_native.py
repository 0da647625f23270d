"""The port's native C++ engine (`node_replication_torch/native/`).

Twins of the 31 tests of `tests/test_native.py` (unit, concurrency,
comparison baselines) against the port's own build of its own copy of
`nr_native.cpp`; the differential idiom runs one op stream through the
port's `NodeReplicated` (on the CPU) and the native engine — and, once,
through the reference's `NodeReplicated` too — with identical responses
and final state (integer data, tolerance 0). Bench durations are 200 ms
or less.
"""

import random
import threading
import time

import numpy as np
import pytest

from pathlib import Path

import node_replication_torch.native as native
from node_replication_torch.native import (
    MODEL_HASHMAP,
    MODEL_STACK,
    NativeEngine,
    NativeRwLock,
)
from node_replication_torch.native.engine import (
    bench_log_append,
    bench_rwlock,
)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


# ------------------------------------------------------------------ basics


class TestEngineBasics:
    def test_hashmap_semantics(self):
        with NativeEngine(MODEL_HASHMAP, 64, n_replicas=1) as e:
            t = e.register(0)
            assert e.execute((1, 3), t) == -1  # absent
            assert e.execute_mut((1, 3, 99), t) == 0  # put
            assert e.execute((1, 3), t) == 99
            assert e.execute_mut((2, 3), t) == 1  # remove present
            assert e.execute_mut((2, 3), t) == 0  # remove absent
            assert e.execute((1, 3), t) == -1

    def test_stack_semantics(self):
        with NativeEngine(MODEL_STACK, 4, n_replicas=1) as e:
            t = e.register(0)
            assert e.execute_mut((2,), t) == -1  # pop empty
            assert e.execute_mut((1, 10), t) == 1
            assert e.execute_mut((1, 11), t) == 2
            assert e.execute((1,), t) == 11  # peek
            assert e.execute((2,), t) == 2  # len
            assert e.execute_mut((2,), t) == 11
            # overflow: capacity 4
            for v in range(4):
                e.execute_mut((1, v), t)
            assert e.execute_mut((1, 99), t) == -1

    def test_register_limits(self):
        with NativeEngine(MODEL_HASHMAP, 8, n_replicas=2) as e:
            with pytest.raises(RuntimeError):
                e.register(5)

    def test_invalid_engine_configs(self):
        # stack is not concurrent-safe: CNR mode must be rejected
        with pytest.raises(ValueError):
            NativeEngine(MODEL_STACK, 8, n_replicas=1, nlogs=2)
        with pytest.raises(ValueError):
            NativeEngine(0, 8, n_replicas=1)
        # zero/negative model size would div-by-zero in dispatch
        with pytest.raises(ValueError):
            NativeEngine(MODEL_HASHMAP, 0, n_replicas=1)
        # a log too small to ever fit one combiner batch under GC slack
        with pytest.raises(ValueError):
            NativeEngine(MODEL_HASHMAP, 16, n_replicas=1, log_capacity=32)

    def test_cursor_telemetry(self):
        with NativeEngine(MODEL_HASHMAP, 16, n_replicas=2) as e:
            t0 = e.register(0)
            e.execute_mut_batch([(1, k, k) for k in range(8)], t0)
            assert e.log_tail() == 8
            assert e.log_ltail(0, 0) == 8  # own replica replayed
            assert e.log_ctail() == 8
            e.sync(1)
            assert e.log_ltail(0, 1) == 8

    def test_read_your_writes_across_replicas(self):
        with NativeEngine(MODEL_HASHMAP, 16, n_replicas=2) as e:
            t0, t1 = e.register(0), e.register(1)
            e.execute_mut((1, 7, 123), t0)
            # read on the OTHER replica must observe the ctail'd write
            assert e.execute((1, 7), t1) == 123

    def test_batched_reads_match_per_op(self):
        # read-side flat combining (r5): one ctail gate + one lock hold
        # per batch, same answers as the per-op path, including across
        # replicas and chunking past the 32-slot batch limit
        with NativeEngine(MODEL_HASHMAP, 64, n_replicas=2) as e:
            t0, t1 = e.register(0), e.register(1)
            e.execute_mut_batch(
                [(1, k, k * 3 + 1) for k in range(40)], t0
            )
            reads = [(1, k) for k in range(64)]
            want = [e.execute(op, t0) for op in reads]
            assert e.execute_batch(reads, t0) == want
            assert e.execute_batch(reads, t1) == want
            assert want[:40] == [k * 3 + 1 for k in range(40)]
            assert want[40:] == [-1] * 24

    def test_batched_reads_multilog(self):
        # CNR mode: the batch falls back to per-op gating (each key has
        # its own log's ctail) but keeps the one-call surface
        with NativeEngine(MODEL_HASHMAP, 64, n_replicas=2, nlogs=4) as e:
            t0 = e.register(0)
            e.execute_mut_batch([(1, k, 100 + k) for k in range(16)], t0)
            got = e.execute_batch([(1, k) for k in range(20)], t0)
            assert got == [100 + k for k in range(16)] + [-1] * 4


class TestLogWrap:
    def test_wraparound_and_gc(self):
        # log capacity 1024, slack=256; push 10 laps of ops through
        with NativeEngine(
            MODEL_HASHMAP, 32, n_replicas=1, log_capacity=1024
        ) as e:
            t = e.register(0)
            total = 10 * 1024
            for i in range(total // 32):
                e.execute_mut_batch(
                    [(1, (i * 32 + j) % 32, i) for j in range(32)], t
                )
            assert e.log_tail() == total
            assert e.log_head() > 0  # GC advanced
            lap = total // 32 - 1
            assert all(e.state_dump(0)[:32] == lap)

    def test_stuck_counter_fires_on_dormant_replica(self):
        # Replica 1 never syncs; appender must help-and-wait, bumping the
        # starvation counter (the CNR gc-callback capability,
        # `cnr/src/log.rs:505-515`), until replica 1 is synced.
        e = NativeEngine(MODEL_HASHMAP, 16, n_replicas=2, log_capacity=1024)
        t0 = e.register(0)
        done = threading.Event()

        def appender():
            # 2048 ops > capacity: must block on the dormant replica
            for i in range(2048 // 32):
                e.execute_mut_batch([(1, j % 16, i) for j in range(32)], t0)
            done.set()

        th = threading.Thread(target=appender, daemon=True)
        th.start()
        # replica 1 stays dormant: the appender MUST stall at the ring's
        # GC boundary and bump the counter (deterministic — syncing
        # early would race the stall away)
        deadline = time.time() + 10
        while e.stuck_events() == 0 and time.time() < deadline:
            time.sleep(0.001)
        assert e.stuck_events() >= 1
        # now release it: sync the dormant replica until the run finishes
        deadline = time.time() + 30
        while not done.is_set() and time.time() < deadline:
            e.sync(1)
            time.sleep(0.001)
        assert done.is_set()
        th.join()
        e.sync()
        assert e.replicas_equal()
        e.close()


# -------------------------------------------------------------- concurrency


class TestConcurrency:
    def test_threads_converge_and_count(self):
        R, T, OPS = 2, 4, 400
        with NativeEngine(
            MODEL_HASHMAP, 128, n_replicas=R, log_capacity=1 << 12
        ) as e:
            errs = []

            def worker(rid, seed):
                try:
                    tok = e.register(rid)
                    rng = random.Random(seed)
                    for _ in range(OPS):
                        k = rng.randrange(128)
                        if rng.random() < 0.7:
                            e.execute_mut((1, k, rng.randrange(1000)), tok)
                        else:
                            e.execute((1, k), tok)
                except Exception as ex:  # pragma: no cover
                    errs.append(ex)

            ts = [
                threading.Thread(target=worker, args=(g % R, g))
                for g in range(R * T)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert not errs
            e.sync()
            assert e.replicas_equal()

    def test_stack_per_thread_order_preserved(self):
        # The reference's VerifyStack idiom (`nr/tests/stack.rs:236-276`):
        # tagged pushes (count<<8 | thread) must appear in per-thread
        # monotone order in the final replayed stack.
        R, T, OPS = 2, 3, 100
        with NativeEngine(
            MODEL_STACK, 4096, n_replicas=R, log_capacity=1 << 12
        ) as e:

            def worker(rid, g):
                tok = e.register(rid)
                for c in range(OPS):
                    e.execute_mut((1, (c << 8) | g), tok)

            ts = [
                threading.Thread(target=worker, args=(g % R, g))
                for g in range(R * T)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            e.sync()
            assert e.replicas_equal()
            dump = e.state_dump(0)
            top, buf = dump[0], dump[1:]
            assert top == R * T * OPS
            vals = buf[:top]
            for g in range(R * T):
                counts = [v >> 8 for v in vals if (v & 0xFF) == g]
                assert counts == sorted(counts)
                assert len(counts) == OPS

    def test_cnr_aliasing_keys_share_a_log(self):
        # Raw keys 5 and 15 alias the same cell when n_keys=10; the native
        # LogMapper must canonicalize (mod n_keys) before % nlogs or the
        # conflicting ops replay in different orders per replica.
        for trial in range(5):
            with NativeEngine(
                MODEL_HASHMAP, 10, n_replicas=2, nlogs=3
            ) as e:

                def worker(rid, key, val):
                    tok = e.register(rid)
                    for i in range(200):
                        e.execute_mut((1, key, val + i), tok)

                a = threading.Thread(target=worker, args=(0, 5, 1000))
                b = threading.Thread(target=worker, args=(1, 15, 5000))
                a.start(), b.start()
                a.join(), b.join()
                e.sync()
                assert e.replicas_equal(), f"diverged on trial {trial}"

    def test_cnr_multilog_concurrent(self):
        R, T, OPS, L = 2, 4, 300, 4
        with NativeEngine(
            MODEL_HASHMAP, 256, n_replicas=R, log_capacity=1 << 12, nlogs=L
        ) as e:

            def worker(rid, seed):
                tok = e.register(rid)
                rng = random.Random(seed)
                for _ in range(OPS):
                    k = rng.randrange(256)
                    e.execute_mut((1, k, rng.randrange(1000)), tok)

            ts = [
                threading.Thread(target=worker, args=(g % R, g))
                for g in range(R * T)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            e.sync()
            assert e.replicas_equal()
            assert sum(e.log_tail(i) for i in range(L)) == R * T * OPS


class TestRwLock:
    def test_mutual_exclusion(self):
        # Writers protect a non-atomic critical section with a sleep inside
        # (GIL released) — lost updates would show without the lock.
        lock = NativeRwLock(64)
        shared = [0]

        def writer():
            for _ in range(50):
                lock.write_acquire()
                v = shared[0]
                time.sleep(0.0002)
                shared[0] = v + 1
                lock.write_release()

        ts = [threading.Thread(target=writer) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert shared[0] == 200

    def test_readers_parallel_with_no_writer(self):
        lock = NativeRwLock(8)
        inside = []
        barrier = threading.Barrier(4)

        def reader(slot):
            lock.read_acquire(slot)
            barrier.wait(timeout=10)  # all 4 hold the read lock at once
            inside.append(slot)
            lock.read_release(slot)

        ts = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sorted(inside) == [0, 1, 2, 3]

    def test_bench_runs(self):
        total, writes = bench_rwlock(2, 1, 50)
        assert total > 0 and writes > 0


# -------------------------------------------------------------- differential


def _hashmap_dump(nr, rid=0):
    state = nr.verify(lambda s: s, rid)
    return np.concatenate(
        [state["values"], state["present"].astype(np.int32)]
    )


def _hashmap_stream(drive, K, R, N, seed):
    """One seeded op stream through `drive(kind, op, r) -> (a, b)`,
    every pair of responses equal."""
    rng = random.Random(seed)
    for i in range(N):
        r = rng.randrange(R)
        k = rng.randrange(K)
        p = rng.random()
        if p < 0.45:
            kind, op = "mut", (1, k, rng.randrange(10_000))
        elif p < 0.6:
            kind, op = "mut", (2, k)
        else:
            kind, op = "read", (1, k)
        a, b = drive(kind, op, r)
        assert a == b, (i, op, a, b)


class TestDifferentialVsPort:
    """One op stream → the port's `NodeReplicated` (CPU) and the native
    path → identical responses + identical final state."""

    def test_hashmap_differential(self):
        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.models import make_hashmap

        K, R, N = 32, 2, 300
        nr = NodeReplicated(make_hashmap(K), n_replicas=R,
                            log_entries=1 << 10, gc_slack=64, device=CPU)
        nat = NativeEngine(MODEL_HASHMAP, K, n_replicas=R,
                           log_capacity=1 << 10)
        tt = [nr.register(r) for r in range(R)]
        nt = [nat.register(r) for r in range(R)]

        def drive(kind, op, r):
            if kind == "mut":
                return nr.execute_mut(op, tt[r]), nat.execute_mut(op, nt[r])
            return nr.execute(op, tt[r]), nat.execute(op, nt[r])

        _hashmap_stream(drive, K, R, N, 42)
        nr.sync()
        nat.sync()
        for r in range(R):
            np.testing.assert_array_equal(_hashmap_dump(nr, r),
                                          nat.state_dump(r))
        nat.close()

    def test_hashmap_differential_against_the_reference(self):
        # the same stream through the reference's NodeReplicated, the
        # port's and the native engine: all three answer alike
        from node_replication_tpu.core.replica import (
            NodeReplicated as JNodeReplicated,
        )
        from node_replication_tpu.models import make_hashmap as j_hashmap

        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.models import make_hashmap

        K, R, N = 24, 2, 120
        jx = JNodeReplicated(j_hashmap(K), n_replicas=R,
                             log_entries=1 << 10, gc_slack=64)
        nr = NodeReplicated(make_hashmap(K), n_replicas=R,
                            log_entries=1 << 10, gc_slack=64, device=CPU)
        nat = NativeEngine(MODEL_HASHMAP, K, n_replicas=R,
                           log_capacity=1 << 10)
        jt = [jx.register(r) for r in range(R)]
        tt = [nr.register(r) for r in range(R)]
        nt = [nat.register(r) for r in range(R)]

        def drive(kind, op, r):
            if kind == "mut":
                got = (jx.execute_mut(op, jt[r]), nr.execute_mut(op, tt[r]))
                want = nat.execute_mut(op, nt[r])
            else:
                got = (jx.execute(op, jt[r]), nr.execute(op, tt[r]))
                want = nat.execute(op, nt[r])
            return got, (want, want)

        _hashmap_stream(drive, K, R, N, 7)
        jx.sync()
        nr.sync()
        nat.sync()
        for r in range(R):
            st = jx.verify(lambda s: s, r)
            ref = np.concatenate([np.asarray(st["values"]),
                                  np.asarray(st["present"]).astype(np.int32)])
            np.testing.assert_array_equal(ref, nat.state_dump(r))
            np.testing.assert_array_equal(_hashmap_dump(nr, r), ref)
        nat.close()

    def test_stack_differential(self):
        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.models import make_stack

        CAP, R, N = 64, 2, 250
        rng = random.Random(7)
        nr = NodeReplicated(make_stack(CAP), n_replicas=R,
                            log_entries=1 << 10, gc_slack=64, device=CPU)
        nat = NativeEngine(MODEL_STACK, CAP, n_replicas=R,
                           log_capacity=1 << 10)
        tt = [nr.register(r) for r in range(R)]
        nt = [nat.register(r) for r in range(R)]
        for i in range(N):
            r = rng.randrange(R)
            p = rng.random()
            if p < 0.5:
                op = (1, rng.randrange(1000))
                assert nr.execute_mut(op, tt[r]) == nat.execute_mut(op, nt[r])
            elif p < 0.8:
                op = (2,)
                assert nr.execute_mut(op, tt[r]) == nat.execute_mut(op, nt[r])
            else:
                op = (1,) if rng.random() < 0.5 else (2,)
                assert nr.execute(op, tt[r]) == nat.execute(op, nt[r])
        nr.sync()
        nat.sync()
        for r in range(R):
            st = nr.verify(lambda s: s, r)
            dump = nat.state_dump(r)
            assert dump[0] == st["top"]
            np.testing.assert_array_equal(
                dump[1 : 1 + int(st["top"])], st["buf"][: int(st["top"])]
            )
        nat.close()


class TestBenchEntryPoints:
    def test_hashmap_bench_smoke(self):
        with NativeEngine(
            MODEL_HASHMAP, 1024, n_replicas=2, log_capacity=1 << 14
        ) as e:
            total, per, per_sec = e.bench_hashmap(
                threads_per_replica=2,
                write_pct=20,
                keyspace=1024,
                duration_ms=100,
            )
            assert total > 0
            assert len(per) == 4
            assert sum(per) == total
            # per-second bins are real records, not a post-hoc division:
            # they must sum to each thread's total
            assert per_sec.shape[0] == 4
            assert (per_sec.sum(axis=1) == per).all()
            e.sync()
            assert e.replicas_equal()

    def test_log_append_bench_smoke(self):
        assert bench_log_append(1 << 12, 2, 16, 50) > 0


class TestNativeSortedSet:
    def test_differential_vs_port_sortedset(self):
        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.models import make_sortedset
        from node_replication_torch.native import MODEL_SORTEDSET

        K, R, N = 64, 2, 300
        rng = random.Random(12)
        jx = NodeReplicated(
            make_sortedset(K), n_replicas=R, log_entries=1 << 10,
            gc_slack=64, device=CPU,
        )
        nat = NativeEngine(MODEL_SORTEDSET, K, n_replicas=R,
                           log_capacity=1 << 10)
        jt = [jx.register(r) for r in range(R)]
        nt = [nat.register(r) for r in range(R)]
        for _ in range(N):
            r = rng.randrange(R)
            k = rng.randrange(K)
            p = rng.random()
            if p < 0.4:
                op = (1, k)
                assert jx.execute_mut(op, jt[r]) == nat.execute_mut(op, nt[r])
            elif p < 0.6:
                op = (2, k)
                assert jx.execute_mut(op, jt[r]) == nat.execute_mut(op, nt[r])
            elif p < 0.75:
                op = (1, k)
                assert jx.execute(op, jt[r]) == nat.execute(op, nt[r])
            elif p < 0.9:
                lo = rng.randrange(K)
                op = (2, lo, lo + rng.randrange(K))
                assert jx.execute(op, jt[r]) == nat.execute(op, nt[r])
            else:
                op = (3, k)
                assert jx.execute(op, jt[r]) == nat.execute(op, nt[r])
        jx.sync()
        nat.sync()
        st = jx.verify(lambda s: s)
        np.testing.assert_array_equal(
            st["present"].astype(np.int32), nat.state_dump(0)
        )
        nat.close()

    def test_cnr_mode_concurrent_inserts(self):
        from node_replication_torch.native import MODEL_SORTEDSET

        with NativeEngine(MODEL_SORTEDSET, 256, n_replicas=2,
                          log_capacity=1 << 12, nlogs=4) as e:

            def worker(rid, lo):
                tok = e.register(rid)
                for k in range(lo, lo + 100):
                    e.execute_mut((1, k % 256), tok)

            ts = [
                threading.Thread(target=worker, args=(g % 2, g * 50))
                for g in range(4)
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            e.sync()
            assert e.replicas_equal()

    def test_cnr_multikey_read_sees_all_logs(self):
        # ADVICE r1: SS_RANGE_COUNT / SS_RANK aggregate over many keys, so
        # in CNR mode they conflict with writes on EVERY log — the read
        # path must sync all logs, not just the one mapped by args[0]
        # (LogMapper contract, cnr/src/lib.rs:123-137).
        from node_replication_torch.native import MODEL_SORTEDSET

        with NativeEngine(MODEL_SORTEDSET, 256, n_replicas=2,
                          log_capacity=1 << 12, nlogs=4) as e:
            t0 = e.register(0)
            t1 = e.register(1)
            for k in range(16):  # keys 0..15 spread over all 4 logs
                e.execute_mut((1, k), t0)
            # replica 1 has combined nothing; an aggregate read must still
            # observe every insert (args[0]=0 maps to log 0 only).
            assert e.execute((2, 0, 256), t1) == 16  # range_count
            assert e.execute((3, 256), t1) == 16  # rank

    def test_cnr_mixed_log_batch_spans_logs(self):
        # A batch whose ops map to different logs is collected sub-batch
        # by sub-batch by each log's combiner (per-op hash tags,
        # `cnr/src/context.rs:18`); responses land out of log order but
        # in batch-slot order, and every log advances.
        from node_replication_torch.native import MODEL_SORTEDSET

        with NativeEngine(MODEL_SORTEDSET, 256, n_replicas=2,
                          log_capacity=1 << 12, nlogs=4) as e:
            tok = e.register(0)
            # keys 0..7 spread over all 4 logs; all fresh inserts → resp 1
            resps = e.execute_mut_batch([(1, k) for k in range(8)], tok)
            assert resps == [1] * 8
            # duplicates now answer 0, interleaved with fresh inserts
            resps = e.execute_mut_batch(
                [(1, 0), (1, 8), (1, 1), (1, 9)], tok
            )
            assert resps == [0, 1, 0, 1]
            e.sync()
            assert e.replicas_equal()


class TestMultikeyReadBounds:
    def test_range_count_bounded_under_concurrent_writer(self):
        # The CNR multikey read is a RELAXED snapshot (documented at
        # multikey_rd_mask): under a concurrent writer it must stay
        # within [completed-before-read, issued-by-read-end] — bounds,
        # not exactness (ADVICE r2 medium).
        import threading

        from node_replication_torch.native import MODEL_SORTEDSET

        N = 4000
        with NativeEngine(MODEL_SORTEDSET, N, n_replicas=1,
                          log_capacity=1 << 14, nlogs=4) as e:
            tok_w = e.register(0)
            tok_r = e.register(0)
            completed = [0]
            done = threading.Event()

            def writer():
                for k in range(N):
                    e.execute_mut((1, k), tok_w)  # distinct keys: count
                    completed[0] = k + 1         # = completed inserts
                done.set()

            t = threading.Thread(target=writer)
            t.start()
            violations = []
            reads = 0
            while not done.is_set():
                lo = completed[0]
                resp = e.execute((2, 0, N), tok_r)  # SS_RANGE_COUNT [0,N)
                hi = completed[0] + 1  # writer may be mid-op
                if not (lo - 0 <= resp <= hi):
                    violations.append((lo, resp, hi))
                reads += 1
            t.join()
            assert reads > 0
            assert not violations, violations[:5]
            # quiescent: the scan is exact again
            e.sync()
            assert e.execute((2, 0, N), tok_r) == N


class TestComparisonBaselines:
    def test_cmp_systems_run_and_count(self):
        # Non-NR baselines behind the same workload loop
        # (`benches/hashmap_comparisons.rs:25-176` analog).
        from node_replication_torch.native import bench_cmp

        for system in ("mutex", "lockfree", "partitioned"):
            total, per = bench_cmp(system, 2, 50, 1024, duration_ms=100)
            assert total > 0
            assert len(per) == 2
            assert sum(per) == total

    def test_cmp_lockfree_beats_mutex_read_heavy(self):
        # the r4 competitive middle (`benches/hashmap_comparisons.rs:
        # 281-435` urcu analog): wait-free readers must clearly beat the
        # single-mutex floor on a read-heavy mix
        from node_replication_torch.native import bench_cmp

        lf, _ = bench_cmp("lockfree", 4, 0, 4096, duration_ms=200)
        mx, _ = bench_cmp("mutex", 4, 0, 4096, duration_ms=200)
        assert lf > 1.5 * mx, (lf, mx)

    def test_cmp_evmap_runs_and_dominates_reads(self):
        # the read-optimized class (left-right map): wait-free epoch-
        # pinned reads must beat the mutex map on a 100%-read mix
        from node_replication_torch.native import bench_cmp

        t_ev, per = bench_cmp("evmap", 4, 0, 4096, 32, 200, 7)
        t_mu, _ = bench_cmp("mutex", 4, 0, 4096, 32, 200, 7)
        assert t_ev > 0 and len(per) == 4
        assert t_ev > t_mu
        # and it survives a write-heavy mix without deadlocking the
        # flip/drain protocol
        t_wr, _ = bench_cmp("evmap", 4, 80, 4096, 32, 100, 7)
        assert t_wr > 0

    def test_cmp_evmap_oversized_keyspace_rejected(self):
        import pytest

        from node_replication_torch.native import bench_cmp

        with pytest.raises(ValueError):
            bench_cmp("evmap", 2, 0, 1 << 27, 32, 50, 1)

    def test_cmp_unknown_system_rejected(self):
        import pytest

        from node_replication_torch.native import bench_cmp

        with pytest.raises(KeyError):
            bench_cmp("flurry", 2, 50, 1024, duration_ms=10)


class TestPortSource:
    def test_source_is_the_references_byte_for_byte(self):
        ours = ROOT / "node_replication_torch" / "native" / "nr_native.cpp"
        ref = ROOT / "node_replication_tpu" / "native" / "nr_native.cpp"
        assert ours.read_bytes() == ref.read_bytes()
        # built from the port's own copy, into its own build directory
        assert Path(native._SRC) == ours
        assert Path(native.build()).parent == ours.parent / "build"

    def test_failed_build_raises_with_gpp_stderr(self, monkeypatch,
                                                 tmp_path):
        bad = tmp_path / "bad.cpp"
        bad.write_text("int main( {\n")
        monkeypatch.setattr(native, "_SRC", str(bad))
        monkeypatch.setattr(native, "_SO", str(tmp_path / "libbad.so"))
        with pytest.raises(RuntimeError, match="native build failed"):
            native.build(force=True)
        assert not list(tmp_path.glob("*.tmp"))
