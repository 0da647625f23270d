"""Pythonic wrappers over the native C ABI.

The port of `node_replication_tpu/native/engine.py`. `NativeEngine`
mirrors `NodeReplicated`'s surface (register / execute_mut / execute /
sync / verify-style state dump) so differential tests can drive the
PyTorch path and the native CPU path from one op stream, and the
mkbench-style harness can run both under the same runner protocol
(`benches/mkbench.rs:77-139` capability).
"""

from __future__ import annotations

import ctypes

import numpy as np

MODEL_HASHMAP = 1
MODEL_STACK = 2
MODEL_SORTEDSET = 3


class NativeEngine:
    """N replicas of a native data structure behind shared native log(s)."""

    def __init__(
        self,
        model: int,
        model_param: int,
        n_replicas: int = 1,
        log_capacity: int = 1 << 16,
        nlogs: int = 1,
    ):
        from node_replication_torch.native import load

        self._lib = load()
        self._h = self._lib.nr_engine_create(
            model, model_param, n_replicas, log_capacity, nlogs
        )
        if not self._h:
            raise ValueError(
                "engine creation failed (bad model id, replica count, or a "
                "non-concurrent model with nlogs > 1)"
            )
        self.model = model
        self.n_replicas = n_replicas
        self.nlogs = nlogs
        self.max_batch = int(self._lib.nr_max_batch())

    def close(self):
        if self._h:
            self._lib.nr_engine_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ----------------------------------------------------------------- API

    def register(self, rid: int = 0) -> tuple[int, int]:
        tid = self._lib.nr_register(self._h, rid)
        if tid < 0:
            raise RuntimeError(f"register failed on replica {rid}")
        return (rid, tid)

    @staticmethod
    def _argbuf(args) -> ctypes.Array:
        a = (ctypes.c_int32 * 3)()
        for i, v in enumerate(args[:3]):
            a[i] = int(v)
        return a

    def execute_mut(self, op: tuple, token: tuple[int, int]) -> int:
        rid, tid = token
        return int(
            self._lib.nr_execute_mut(
                self._h, rid, tid, int(op[0]), self._argbuf(op[1:])
            )
        )

    def execute_mut_batch(self, ops: list[tuple], token: tuple[int, int]):
        """Batched write path (flat-combining batch semantics). In CNR
        mode a batch may span logs: each op is hash-tagged with its log
        and every log's combiner collects its own sub-batch (the cnr
        hash-tagged context, `cnr/src/context.rs:18`)."""
        rid, tid = token
        out = []
        for i in range(0, len(ops), self.max_batch):
            chunk = ops[i : i + self.max_batch]
            n = len(chunk)
            opcodes = (ctypes.c_int32 * n)(*[int(o[0]) for o in chunk])
            args = (ctypes.c_int32 * (3 * n))()
            for j, o in enumerate(chunk):
                for k, v in enumerate(o[1:4]):
                    args[3 * j + k] = int(v)
            resps = (ctypes.c_int32 * n)()
            rc = self._lib.nr_execute_mut_batch(
                self._h, rid, tid, n, opcodes, args, resps
            )
            if rc != 0:
                raise ValueError(f"batch rejected (rc={rc})")
            out.extend(int(r) for r in resps)
        return out

    def execute(self, op: tuple, token: tuple[int, int]) -> int:
        rid, tid = token
        return int(
            self._lib.nr_execute(
                self._h, rid, tid, int(op[0]), self._argbuf(op[1:])
            )
        )

    def execute_batch(self, ops: list[tuple], token: tuple[int, int]):
        """Batched read path: one ctail gate + one read-lock hold per
        chunk (read-side flat combining — the wr=0 rescue, r5; see
        `nr_execute_batch` in nr_native.cpp)."""
        rid, tid = token
        out = []
        for i in range(0, len(ops), self.max_batch):
            chunk = ops[i : i + self.max_batch]
            n = len(chunk)
            opcodes = (ctypes.c_int32 * n)(*[int(o[0]) for o in chunk])
            args = (ctypes.c_int32 * (3 * n))()
            for j, o in enumerate(chunk):
                for k, v in enumerate(o[1:4]):
                    args[3 * j + k] = int(v)
            resps = (ctypes.c_int32 * n)()
            rc = self._lib.nr_execute_batch(
                self._h, rid, tid, n, opcodes, args, resps
            )
            if rc != 0:
                raise ValueError(f"read batch rejected (rc={rc})")
            out.extend(int(r) for r in resps)
        return out

    def sync(self, rid: int | None = None) -> None:
        for r in range(self.n_replicas) if rid is None else [rid]:
            self._lib.nr_sync(self._h, r)

    def sync_log(self, rid: int, log_idx: int) -> None:
        self._lib.nr_sync_log(self._h, rid, log_idx)

    def state_dump(self, rid: int = 0) -> np.ndarray:
        """Sync replica `rid` and dump its state words (the `verify` hook)."""
        n = int(self._lib.nr_state_words(self._h))
        buf = (ctypes.c_int32 * n)()
        self._lib.nr_state_dump(self._h, rid, buf)
        return np.ctypeslib.as_array(buf).copy()

    def replicas_equal(self) -> bool:
        ref = self.state_dump(0)
        return all(
            np.array_equal(ref, self.state_dump(r))
            for r in range(1, self.n_replicas)
        )

    # ------------------------------------------------------------- telemetry

    def log_tail(self, li: int = 0) -> int:
        return int(self._lib.nr_log_tail(self._h, li))

    def log_head(self, li: int = 0) -> int:
        return int(self._lib.nr_log_head(self._h, li))

    def log_ctail(self, li: int = 0) -> int:
        return int(self._lib.nr_log_ctail(self._h, li))

    def log_ltail(self, li: int, rid: int) -> int:
        return int(self._lib.nr_log_ltail(self._h, li, rid))

    def stuck_events(self) -> int:
        return int(self._lib.nr_stuck_events(self._h))

    def warn_events(self) -> int:
        return int(self._lib.nr_warn_events(self._h))

    # ---------------------------------------------------------- bench loops

    def bench_hashmap(
        self,
        threads_per_replica: int,
        write_pct: int,
        keyspace: int,
        batch: int = 32,
        duration_ms: int = 1000,
        seed: int = 1,
    ) -> tuple[int, np.ndarray, np.ndarray]:
        """In-process measured loop (threads never cross the FFI per op).
        Returns (total_ops, per_thread_ops, per_sec_ops) where
        `per_sec_ops[t, s]` is thread t's completed ops in wall-clock
        second s — real bins recorded in the loop, the reference's
        per-(thread, second) CSV granularity
        (`benches/mkbench.rs:498-552`)."""
        total_threads = self.n_replicas * threads_per_replica
        max_secs = max(1, -(-duration_ms // 1000))
        per = (ctypes.c_uint64 * total_threads)()
        per_sec = (ctypes.c_uint64 * (total_threads * max_secs))()
        total = self._lib.nr_bench_hashmap(
            self._h,
            threads_per_replica,
            write_pct,
            keyspace,
            batch,
            duration_ms,
            seed,
            per,
            per_sec,
            max_secs,
        )
        return (
            int(total),
            np.ctypeslib.as_array(per).copy(),
            np.ctypeslib.as_array(per_sec)
            .copy()
            .reshape(total_threads, max_secs),
        )


class NativeRwLock:
    """Distributed reader-writer lock (`nr/src/rwlock.rs` capability)."""

    def __init__(self, n_slots: int = 256):
        from node_replication_torch.native import load

        self._lib = load()
        self._h = self._lib.nr_rwlock_create(n_slots)
        self.n_slots = n_slots

    def close(self):
        if self._h:
            self._lib.nr_rwlock_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read_acquire(self, slot: int):
        self._lib.nr_rwlock_read_acquire(self._h, slot)

    def read_release(self, slot: int):
        self._lib.nr_rwlock_read_release(self._h, slot)

    def write_acquire(self):
        self._lib.nr_rwlock_write_acquire(self._h)

    def write_release(self):
        self._lib.nr_rwlock_write_release(self._h)


def bench_log_append(
    log_capacity: int, n_threads: int, batch: int, duration_ms: int
) -> int:
    from node_replication_torch.native import load

    return int(
        load().nr_bench_log_append(log_capacity, n_threads, batch, duration_ms)
    )


def bench_rwlock(
    n_readers: int, n_writers: int, duration_ms: int
) -> tuple[int, int]:
    from node_replication_torch.native import load

    import ctypes as c

    writes = c.c_uint64()
    total = load().nr_bench_rwlock(
        n_readers, n_writers, duration_ms, c.byref(writes)
    )
    return int(total), int(writes.value)


def bench_cmp(
    system: str,
    n_threads: int,
    write_pct: int,
    keyspace: int,
    batch: int = 32,
    duration_ms: int = 1000,
    seed: int = 1,
) -> tuple[int, np.ndarray]:
    """Non-NR comparison baselines under the same splitmix workload loop
    as `bench_hashmap` (`benches/hashmap_comparisons.rs:25-176` analog):
    'mutex' = one std::unordered_map behind a mutex; 'lockfree' = a
    shared lock-free open-addressing map (wait-free readers — the
    urcu-class competitive middle of the reference's headline graphs,
    `benches/hashmap_comparisons.rs:281-435`); 'evmap' = a left-right
    reader/writer-split map (two copies, epoch-pinned wait-free reads,
    single-writer apply-flip-drain-replay — the read-optimized
    specialist the reference's hashbench drives,
    `benches/hashbench.rs:26-105`); 'partitioned' = one private map per
    thread over its key congruence class (the no-sharing ceiling).
    Returns (total_ops, per_thread_ops)."""
    from node_replication_torch.native import load

    if system in ("lockfree", "evmap") and keyspace > (1 << 26):
        raise ValueError(
            f"{system} cmp map caps keyspace at 2^26 (its fixed "
            "table(s) would exceed 1 GiB); shrink --keys for the "
            "comparison sweep"
        )
    lib = load()
    fn = {
        "mutex": lib.nr_bench_cmp_mutex,
        "lockfree": lib.nr_bench_cmp_lockfree,
        "evmap": lib.nr_bench_cmp_evmap,
        "partitioned": lib.nr_bench_cmp_partitioned,
    }[system]
    per = (ctypes.c_uint64 * n_threads)()
    total = fn(n_threads, write_pct, keyspace, batch, duration_ms, seed, per)
    if total == 2**64 - 1:  # FFI error sentinel (see nr_native.cpp)
        raise ValueError(f"native cmp bench '{system}' rejected the config")
    return int(total), np.ctypeslib.as_array(per).copy()
