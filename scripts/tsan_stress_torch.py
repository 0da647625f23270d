#!/usr/bin/env python
"""ThreadSanitizer stress for the port's native engine (run with
NR_TPU_TSAN=1).

`node_replication_torch/native/` carries its own copy of the native
engine and builds it itself; this script runs that copy's concurrency
surfaces under `-fsanitize=thread`, as `scripts/tsan_stress.py` runs
the JAX package's:

1. NR flat combining: many threads, batched writes + reads, one log;
2. CNR per-log collection: cross-log batches exercising the publication
   record seqlock (hash-tagged slots, out-of-order response completion);
3. the distributed rwlock via the single-log read path;
4. relaxed multikey reads racing writers.

TSAN reports go to stderr; the script exits non-zero if the engine
diverged, and TSAN makes the exit code 66 at process exit if it
reported anything. The gate is exit 0 with no `WARNING:
ThreadSanitizer` line on stderr. The sanitized build lands in
`node_replication_torch/native/build/libnr_native_tsan.so`. No card is
needed. Usage:

    NR_TPU_TSAN=1 python scripts/tsan_stress_torch.py [seconds-per-phase]

Note: a `data race` report on `PubRecord::opcodes/args` between the
owner's (seqlock-odd) publication writes and a combiner's speculative
scan would be the EXPECTED seqlock pattern (reads validated and
discarded on seq mismatch) — real findings are races on ring cells,
cursors, or response slots.
"""

import os
import subprocess
import sys
import threading
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

if os.environ.get("NR_TPU_TSAN") != "1":
    sys.exit("set NR_TPU_TSAN=1 (the sanitized build) before running")

if "libtsan" not in os.environ.get("LD_PRELOAD", ""):
    # a dlopen'd -fsanitize=thread library hits the static-TLS limit
    # ("cannot allocate memory in static TLS block"); the runtime must be
    # preloaded before the interpreter starts — re-exec with LD_PRELOAD
    tsan = subprocess.run(
        ["g++", "-print-file-name=libtsan.so"],
        capture_output=True, text=True,
    ).stdout.strip()
    env = dict(os.environ, LD_PRELOAD=tsan,
               TSAN_OPTIONS=os.environ.get("TSAN_OPTIONS", "")
               + " report_bugs=1")
    os.execvpe(sys.executable, [sys.executable] + sys.argv, env)

from node_replication_torch.native import (  # noqa: E402
    MODEL_HASHMAP,
    MODEL_SORTEDSET,
    NativeEngine,
)

DUR = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0


def drive(e, n_threads, mixed_logs, keyspace):
    stop = threading.Event()
    errs = []

    def worker(g):
        try:
            tok = e.register(g % e.n_replicas)
            n = 0
            while not stop.is_set():
                ops = [
                    (1, (g * 131 + n + j) % keyspace, n + j)
                    for j in range(16)
                ]
                e.execute_mut_batch(ops, tok)
                e.execute((1, (g + n) % keyspace), tok)
                # batched read path: read-lock held across the batch,
                # racing other threads' combiners (r5)
                e.execute_batch(
                    [(1, (g + n + j) % keyspace) for j in range(8)], tok
                )
                if mixed_logs:
                    # multikey relaxed read racing the writers
                    e.execute((2, 0, keyspace), tok)
                n += 16
        except Exception as ex:  # pragma: no cover
            errs.append(ex)

    ts = [threading.Thread(target=worker, args=(g,),
                           name=f"tsan-worker-{g}")
          for g in range(n_threads)]
    for t in ts:
        t.start()
    time.sleep(DUR)
    stop.set()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    e.sync()
    assert e.replicas_equal(), "replicas diverged under stress"


def main():
    print(f"phase 1: NR flat combining ({DUR}s)", flush=True)
    with NativeEngine(MODEL_HASHMAP, 512, n_replicas=2,
                      log_capacity=1 << 14) as e:
        drive(e, n_threads=6, mixed_logs=False, keyspace=512)

    print(f"phase 2: CNR cross-log batches ({DUR}s)", flush=True)
    with NativeEngine(MODEL_HASHMAP, 512, n_replicas=2,
                      log_capacity=1 << 14, nlogs=4) as e:
        drive(e, n_threads=6, mixed_logs=False, keyspace=512)

    print(f"phase 3: CNR + relaxed multikey reads ({DUR}s)", flush=True)
    with NativeEngine(MODEL_SORTEDSET, 512, n_replicas=2,
                      log_capacity=1 << 14, nlogs=4) as e:
        drive(e, n_threads=6, mixed_logs=True, keyspace=512)

    # r5: the comparison maps have their own concurrency protocols —
    # the lockfree map's packed-slot CAS probes and the evmap left-right
    # pin/flip/drain/replay cycle (reads race plain table stores unless
    # the drain is airtight; the r5 review found a re-pin hole here)
    print(f"phase 4: comparison maps (lockfree, evmap) ({DUR}s)",
          flush=True)
    from node_replication_torch.native import bench_cmp

    for system in ("lockfree", "evmap"):
        total, _ = bench_cmp(system, 8, 30, 4096, 32, int(DUR * 1000), 3)
        assert total > 0, system

    print("tsan stress OK (see stderr for sanitizer reports)", flush=True)


if __name__ == "__main__":
    main()
