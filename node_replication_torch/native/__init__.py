"""Native host-side engine: build-on-demand ctypes binding.

The port of `node_replication_tpu/native/`. `nr_native.cpp` is the
package's own byte-identical copy of the reference's source (the
multi-threaded C++ engine: flat combining over a shared log, CNR's
per-log combiners, the distributed reader-writer lock and the native
comparison baselines). It runs on the host CPU, with or without a card.

The shared library is compiled from that source with the system g++
the first time it is needed (and whenever the source is newer than the
built `.so`), into `native/build/`. No pip/pybind dependency: the C
ABI is consumed with ctypes. A failed build raises with g++'s stderr.

Race detection: set `NR_TPU_TSAN=1` before first import to compile with
`-fsanitize=thread` and run the engine under ThreadSanitizer. The TSAN
build lands in a separate `.so`, so the fast build is untouched.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "nr_native.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
_TSAN = os.environ.get("NR_TPU_TSAN", "") == "1"
_SO = os.path.join(
    BUILD_DIR, "libnr_native_tsan.so" if _TSAN else "libnr_native.so"
)

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> str:
    """Compile the native library if missing/stale; return the .so path."""
    with _lock:
        if (
            not force
            and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
        ):
            return _SO
        os.makedirs(BUILD_DIR, exist_ok=True)
        # pid-unique temp path: concurrent processes may race the build;
        # each compiles privately, then atomically publishes.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [
            "g++",
            "-std=c++17",
            "-O1" if _TSAN else "-O3",
            "-fPIC",
            "-shared",
            "-pthread",
            *(["-fsanitize=thread", "-g"] if _TSAN else []),
            "-o",
            tmp,
            _SRC,
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build failed (g++ exit {proc.returncode}):\n"
                    f"{proc.stderr}"
                )
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return _SO


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library, with signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    lib = ctypes.CDLL(path)
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    u64p = c.POINTER(c.c_uint64)

    lib.nr_engine_create.restype = c.c_void_p
    lib.nr_engine_create.argtypes = [
        c.c_int, c.c_int64, c.c_int, c.c_uint64, c.c_int,
    ]
    lib.nr_engine_destroy.argtypes = [c.c_void_p]
    lib.nr_register.restype = c.c_int
    lib.nr_register.argtypes = [c.c_void_p, c.c_int]
    lib.nr_execute_mut.restype = c.c_int32
    lib.nr_execute_mut.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int32, i32p]
    lib.nr_execute_mut_batch.restype = c.c_int
    lib.nr_execute_mut_batch.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_int, i32p, i32p, i32p,
    ]
    lib.nr_execute.restype = c.c_int32
    lib.nr_execute.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int32, i32p]
    lib.nr_execute_batch.restype = c.c_int
    lib.nr_execute_batch.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_int, i32p, i32p, i32p,
    ]
    lib.nr_sync.argtypes = [c.c_void_p, c.c_int]
    lib.nr_sync_log.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.nr_state_words.restype = c.c_int64
    lib.nr_state_words.argtypes = [c.c_void_p]
    lib.nr_state_dump.argtypes = [c.c_void_p, c.c_int, i32p]
    for name in ("nr_stuck_events", "nr_warn_events"):
        fn = getattr(lib, name)
        fn.restype = c.c_uint64
        fn.argtypes = [c.c_void_p]
    lib.nr_log_tail.restype = c.c_uint64
    lib.nr_log_tail.argtypes = [c.c_void_p, c.c_int]
    lib.nr_log_head.restype = c.c_uint64
    lib.nr_log_head.argtypes = [c.c_void_p, c.c_int]
    lib.nr_log_ctail.restype = c.c_uint64
    lib.nr_log_ctail.argtypes = [c.c_void_p, c.c_int]
    lib.nr_log_ltail.restype = c.c_uint64
    lib.nr_log_ltail.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.nr_max_batch.restype = c.c_int

    lib.nr_rwlock_create.restype = c.c_void_p
    lib.nr_rwlock_create.argtypes = [c.c_int]
    lib.nr_rwlock_destroy.argtypes = [c.c_void_p]
    lib.nr_rwlock_read_acquire.argtypes = [c.c_void_p, c.c_int]
    lib.nr_rwlock_read_release.argtypes = [c.c_void_p, c.c_int]
    lib.nr_rwlock_write_acquire.argtypes = [c.c_void_p]
    lib.nr_rwlock_write_release.argtypes = [c.c_void_p]

    lib.nr_bench_hashmap.restype = c.c_uint64
    lib.nr_bench_hashmap.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_int64, c.c_int, c.c_int,
        c.c_uint64, u64p, u64p, c.c_int,
    ]
    lib.nr_bench_log_append.restype = c.c_uint64
    lib.nr_bench_log_append.argtypes = [c.c_uint64, c.c_int, c.c_int, c.c_int]
    lib.nr_bench_rwlock.restype = c.c_uint64
    lib.nr_bench_rwlock.argtypes = [c.c_int, c.c_int, c.c_int, u64p]
    # comparison baselines (non-NR systems under the same workload loop)
    for fn in (lib.nr_bench_cmp_mutex, lib.nr_bench_cmp_partitioned,
               lib.nr_bench_cmp_lockfree, lib.nr_bench_cmp_evmap):
        fn.restype = c.c_uint64
        fn.argtypes = [
            c.c_int, c.c_int, c.c_int64, c.c_int, c.c_int, c.c_uint64, u64p,
        ]

    _lib = lib
    return lib


from node_replication_torch.native.engine import (  # noqa: E402
    MODEL_HASHMAP,
    MODEL_SORTEDSET,
    MODEL_STACK,
    NativeEngine,
    NativeRwLock,
    bench_cmp,
)

__all__ = [
    "build",
    "load",
    "NativeEngine",
    "NativeRwLock",
    "MODEL_HASHMAP",
    "MODEL_STACK",
    "MODEL_SORTEDSET",
    "bench_cmp",
]
