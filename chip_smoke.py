#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # needs one CUDA card; 11-17 minutes
    python3 chip_smoke.py --crash-child DIR   # phase 14's victim (internal)
    python3 chip_smoke.py --repl-primary DIR  # phase 23's primary (internal)
    python3 chip_smoke.py --txn-child DIR     # phase 25's victim (internal)
    python3 chip_smoke.py --obs-primary DIR   # phase 26's primary (internal)
    python3 chip_smoke.py --obs-leaf DIR      # phase 26's leaf (internal)
    python3 chip_smoke.py --lockcheck-child DIR   # phase 29's checked run

Four models, end to end, from numpy seeds, then the serving path, then
CNR and the other models. The replicated hashmap at the flagship width
(R = 4096 replicas, K = 10000 keys):

1. build every CUDA source under `node_replication_torch/csrc/` (one
   nvcc per source, all at once) and, beside them, the native engine
   (`node_replication_torch/native/nr_native.cpp`, g++);
2. the replay kernel (K2) against its plain PyTorch version, W = 4096,
   then on windows with inert opcodes (0, 7), keys in [-3K, 3K) and half
   of the entries on 8 hot keys, over the flagship planes and over
   R - 2 columns (not 16-byte aligned); logs K2's tile, its device time
   (`torch.profiler`) and its ptxas registers and spills;
3. the fused combiner-round kernel (K1) over the model's `[R, K]`
   states (the instance `round_fn` launches, on every path), fenced and
   unfenced, against its plain version over rounds of W = 256 that wrap
   a 2^16 ring; its device time beside its bound
   (`k1_model_round_bytes`) and its ptxas registers and spills; then K1
   at R = 1024 (a mesh shard) and R = 4097 (a fleet grown by one) over 4
   rounds across the wrap, each with its event, profiler and queued
   device time;
4. the lock-step step path: 64 steps of `make_pallas_step` (K2) and of
   `make_step(combined=True)` (PyTorch ops), bit-identical; then what
   sets the K2 step's pace (host enqueue time against device kernel time);
5. `NodeReplicated` with `engine='pallas'` (K1) and `'combined'`: 36
   batched rounds of 256 writes plus cross-replica reads, identical to
   each other and to a plain dict model of the map.

The flat vspace (NrOS page table) at the long-log deployment of
`benches/vspace.py` (P = 2^18 pages, max_span = 64, MAP:UNMAP = 3:1,
npages = 1 + pframe % 64), at R = 256:

6. the span replay kernel (K4) against its plain version, W = 4096,
   with negative vpages, vpages near 2^31 and inert opcodes, then on a
   hot-spot window (every entry on one tile) and an int32-wrap window;
   logs K4's event, wrapper and device time (`torch.profiler`, the
   decode and the replay), those of the state copy alone and of an
   all-NOOP window, and ptxas's registers and spills of its kernels;
7. the step paths: 24 steps of W = 4096 (the 2^16 ring wraps) through
   `make_pallas_vspace_step` (K4), `make_pallas_vspace_plan_step` (K7a)
   and `make_step(combined=True)`, bit-identical; then what sets the K4
   step's pace; then K7a against its plain version, with phase 6's
   reads;
8. `NodeReplicated(make_vspace(2^18, 64), 256)` with `engine='pallas'`
   (K5) and `'combined'`: 72 rounds of 1024 writes (the ring wraps)
   plus cross-replica IDENTIFY/RESOLVED reads, a few rounds with one
   replica fenced (they take the chain), identical to each other and
   to a numpy page table; then K5 against its plain version, with phase
   6's reads.

The radix vspace (4-level page table, the default model of
`benches/vspace.py`) at the same long-log deployment and R = 256, with
its write mix MAP:MAP_DEVICE:UNMAP:UNMAP_TABLE = 3:1:1:1:

9. the radix replay kernel (K6) against its plain version, W = 4096,
   over random pt and PD bits, with PDPT/PML4 set and unset, inert
   opcodes, vpages below 0 and past P, n <= 0 maps, spans crossing a
   PD boundary or passing P, and teardowns of unmapped regions; then a
   hot-spot window (every entry on one tile) and a window whose first
   live MAP comes late, from unset PDPT/PML4; logs K6's device time
   (`torch.profiler`) and ptxas's registers and spills of its kernels;
10. the step paths: 24 steps of W = 4096 through
   `make_pallas_vspace_step(radix=True)` (K6),
   `make_pallas_vspace_plan_step(radix=True)` (K7b) and
   `make_step(combined=True)`, with IDENTIFY/RESOLVED/TABLES reads,
   bit-identical, replica 0 equal to a numpy radix page table of the
   stream; then what sets the K6 step's pace (host enqueue time against
   device kernel time, K6's share); then K7b against its plain version,
   with its device time.

The open-addressing map at `benches/hashmap.py --sparse --full` (2^22
keys, N = 2^23 slots, probe 16, 50% PUT/REMOVE, batch 32), R = 16:

11. a pre-fill of 2^21 distinct keys through K3 (windows of 2^16), every
   key read back by GET; 24 steps of `make_pallas_oahashmap_step` (K3)
   against the scan step from that state, bit-identical; then K3
   against its plain version at W = 4096, half the keys present, 17
   keys sharing one home (window-full drops) and windows that wrap,
   and at the step's W = 256, with its device time there.

The serving path (`serve/`, `fault/`, `durable/`):

12. the seqreg verifier of `bench.py --serve`/`--chaos` on the card:
   `NodeReplicated(make_seqreg(8), 2, log_entries=4096, gc_slack=256,
   exec_window=256)` behind `ServeFrontend` (queue_depth 256,
   batch_max_ops 64, linger 1 ms), 8 closed-loop clients, 10,000
   fetch-and-set ops, every response the client's previous value; at
   pipeline depth 0 and 1, then with failover under a serve-batch kill
   of replica 1 (availability 1.0, the repaired replica bit-identical),
   then with a `grow(1)` mid-traffic; acked ops/s and p50/p99;
13. the hashmap flagship served through K1: `NodeReplicated(
   make_hashmap(10000), 4096, log_entries=2^16, engine="pallas")`
   behind `ServeFrontend(rids=range(8), batch_max_ops=256)`, 16
   closed-loop clients of 1000 ops (50/50 PUT/REMOVE), each on its own
   625 keys, at depth 0 and 1 with a `grow(1)` mid-run in the second:
   every response equal to a per-client model, every round one K1
   launch (R = 4097 after the grow), every touched key read back
   (key k from served rid k mod 8), all replicas equal to each other and
   the model;
   acked ops/s, p50/p99, rounds and mean batch; then a profiled run:
   K1's and all device time per served round against its host wall;
14. crash and recovery at the flagship widths: a child
   (`--crash-child DIR`) serves the phase-13 fleet from
   `ServeFrontend.from_recovery(DIR, durability="batch")`, snapshots
   once, logs each acked op after its future resolved, and is SIGKILLed
   at a WAL fsync; the parent recovers on the card with `from_recovery`
   (the WAL replayed through K1): every acked op in the WAL once and in
   order, the state equal to a numpy replay of the WAL, replicas equal,
   acked keys read back (key k from rid k mod 8); snapshot bytes, records
   replayed, recovery seconds.

CNR, `cnr`'s multi-log node replication (`core/multilog.py`,
`core/cnr.py`), at the flagship widths with L = 8 logs (the default of
`benches/hashmap.py --cmp --logs`), LogMapper key % 8:

15. the CNR step: 16 steps of `make_multilog_step` over
   `make_partitioned_hashmap(10000, 8)` (512 writes a log, 4096 a
   step, and one read a replica; the 2^12 rings wrap), against the
   sequential fold on `make_hashmap(10000)` and a numpy map; dispatches/s,
   host enqueue against device time, the device's idle share (no kernel
   of the package runs here);
16. `MultiLogReplicated(make_hashmap(10000), key % 8, nlogs=8,
   n_replicas=4096, log_entries=2^16)` with `engine="pallas"` against
   `engine="scan"`: first K1 against its plain version at the per-log
   windows (W = 32, 64); then 29 batches of 256 ops from rotating rids,
   responses, rings, int64 cursors and states bit-identical and equal to
   a dict; every per-log sub-batch one K1 launch (the wrapper's count,
   `stats()`, and `torch.profiler` over the last 4 batches, after one
   batch that warms the tracer up); K1's device time per per-log round
   against its bound at the mean per-log window; batch latency fused
   against scan;
17. phase 16's K1 fleet behind `ServeFrontend` (rids 0-7,
   batch_max_ops 256): 16 closed-loop clients of 250 ops, 50/50
   PUT/REMOVE, each on its own 625 keys; every response against a dict
   seeded from the fleet, the touched keys read back from another rid,
   the fleet equal to the dicts; acked ops/s, p50/p99, rounds, K1
   launches a round, then a profiled segment: a round's host wall
   against its device time, K1 a launch against its bound at the mean
   per-log sub-batch;
18. the other models, no kernel among them, at R = 16 and 32 writes a
   replica a step: the stack and the queue at `benches/stack.py`'s
   capacity 2^16, the sorted set at 2^16 keys (combined step = scan
   step = host model), synthetic at `benches/synthetic.py`'s costs (n =
   200,000, 20/5/2/1; its scan step = a numpy twin), memfs at
   `benches/nrfs.py --full` widths through the CNR step
   (`make_partitioned_memfs(4096, 64, 8)` = the fold).

The mesh (`parallel/`), "N shards" being `cuda:i % device_count()`
for i < N (one shard a card while there are cards, else all on
`cuda:0`; the mapping is printed):

19. the mesh-fused hashmap flagship: `NodeReplicated(make_hashmap(
   10000), 4096, log_entries=2^16, engine="pallas",
   mesh=replica_mesh(4))`, phase 5's 36 rounds of 256 ops with a read
   on each shard, rounds 24-29 with a replica of shard 2 fenced, plus a
   warm-up and 4 profiled rounds; against un-meshed `"pallas"` and
   `"combined"` fleets and a dict; every round `mesh_fused` with
   exactly 4 K1 launches (the wrapper's count, `stats()`,
   `torch.profiler`); first K1 against its plain version at a shard's
   shape (R = 1024, W = 256) with its device time and bound; meshed
   against un-meshed round latency; a round's host wall against its
   device time;
20. the chain tiers on 4 shards: a `"scan"` fleet (`shmap`) and a
   `"combined"` fleet (`gspmd`), 4 rounds of 256 each against their
   un-meshed twins; then a 1024-entry backlog appended with every
   cursor equal, replayed by `sync()` through the ring tier (chunk 256,
   W = 1024), against an un-meshed `sync()`; ring seconds against scan;
21. the mesh-fused flat vspace: phase 8's fleet (R = 256) on 4 shards of
   64, 24 rounds of 1024 ops with reads, 4 K5 launches a round, rounds
   16-19 fenced on the chain, against un-meshed pallas and combined
   fleets and the numpy table; then K5 against its plain version at a
   shard's shape (R = 64) with its device time and bound;
22. phase 19's fleet served (rids 0-7, batch_max_ops 256, 16 clients of
   250 ops) against per-client dicts, every round mesh-fused, the
   frontend's `device_of_rid` and `stats()["mesh"]` against
   `replica_device`; then `MultiLogReplicated(..., nlogs=8,
   n_replicas=4096, engine="scan", mesh=make_mesh(2, 2))`, 8 batches of
   256 against the un-meshed fleet and a dict, `replica_device` by mesh
   row.

The replication plane (`repl/`):

23. the replicated flagship, laid out as the reference's replication
   gate (`bench.py --follower`) on phase 13's fleet: a child
   (`--repl-primary DIR`) serves it with durable acks and
   ship-before-ack (`ReplicationShipper.barrier` as the frontend's
   `ack_barrier`, into a `DirectoryFeed`), runs a `FeedServer` with
   snapshot serving on 127.0.0.1, snapshots once halfway to the kill
   and logs every acked op; in this process follower F1 (the same
   fleet on the card, `engine="pallas"`) applies the shipped WAL, one
   K1 launch a record, and serves reads at `max_lag_pos` 64 under load;
   a cold leaf follows over SocketFeed -> RelayNode -> SocketFeed and
   boots from the child's snapshot; the child is SIGKILLed at a seeded
   ack count near 2,000, `PromotionManager` (0.5 s heartbeat timeout)
   detects the silence and promotes F1, a publish of the dead epoch is
   refused, and the 16 clients run 250 ops each through F1's frontend,
   one K1 a round. No acked write is lost, F1's WAL equals the child's
   record for record, F1, the leaf and every read equal a numpy replay
   of the child's WAL (a read at a record boundary its replica could
   have held), and K1 launches cover every applied record; then K1's
   device time per applied record (a follower of the dead feed, after a
   traced warm-up) and K1 against its plain version at the records'
   shapes. Prints follower records/s against the primary's, apply lag,
   read p50/p99 and stale reads, the RTO, acked ops/s after the
   promotion, the leaf's boot, and the phase's peak memory.

The shard plane (`shard/`, `durable/txnlog.py`):

24. the sharded flagship, `bench.py --sharded`'s layout (3 shards) in
   one process: `ShardGroup(3, make_hashmap(10000), durability="batch",
   batch_max_ops=256, nr_kwargs=phase 13's fleet, rids=range(8),
   heartbeat_timeout_s=0.5)`, each shard a primary and a follower on
   the card. (a) 8 cross-shard `router.execute_batch` calls of 256
   ops, then 16 closed-loop clients of 250 ops over their own 625 keys
   through `call_with_retry(group.router, ...)`; (b) at a seeded ack
   count in the middle of that load shard 1's primary is killed, its
   `PromotionManager` detects the silence and `group.promote(1)`
   re-homes the slice under a bumped, re-published map; an op in
   flight at the kill is resolved by a read on the new home; a submit
   under the old version to shard 0 is fenced; (c) shard 2 behind a
   `ShardServer` on 127.0.0.1, one client of 250 ops through a second
   router whose shard-2 backend is a `SocketShardClient`, a misroute
   answered as a typed `WrongShard` over the wire, a stale HELLO
   fenced after a map bump; (d) `ReshardPlan(group, donor=0).split()`
   under 8 per-key writers (0.5 s warm-up, 1.5 s window), class 3 of 6
   re-homed onto shard 0's promoted follower; (e) 64 cross-shard
   transactions of 2-3 PUTs through `group.coordinator()`, and one over
   a held intent that aborts with zero effect; then a profiled segment
   after a traced warm-up. Every response equals the client models;
   each shard's fleet holds only its class until the split; the
   promoted follower's WAL equals the dead primary's and holds every
   acked op of the slice once; no moved-key write is lost or applied
   twice; every shard round and applied record is one K1 launch (the
   wrapper's count, `stats()` and the registry, leg by leg). Prints
   acked ops/s (beside phase 13's), per-shard rates, the RTO, the
   survivors' hold, `fence_s`, txns/s, K1 a shard round against its
   bound, and the phase's peak memory;
25. `bench.py --txn`'s SIGKILL matrix on phase 13's fleet (2 shards, no
   followers, rids 0-7; the bench's fleet is R = 1 over 4096 keys): a
   child (`--txn-child DIR`) per crash window (`txn-prepare`,
   `txn-commit`, `txn-decide`) drives 24 cross-shard transactions,
   fsyncing each acked one, and is SIGKILLed at a seeded hit in their
   middle half; the parent recovers the group in place on the card
   (`recover=True`, the WAL replayed through K1), bumps the coordinator
   epoch, re-drives published commits and resolves every in-doubt
   intent: every acked transaction visible, every in-doubt one all or
   nothing by its decision, no transactional write in a WAL twice; then
   non-transactional throughput with and without `with_txn` in
   alternating slices (the reference's 0.9 printed beside);
26. the observed flagship (`obs/`). Leg A, on phase 13's fleet here:
   up to 3 pairs of 16 clients x 250 ops (phase 13's 1000, cut for
   time), `ServeConfig(profile_hz=None)` then `97`, every response
   against the client models, the best on/off ratio kept
   (`bench.py --serve --profile`): prints the overhead ratio beside the
   reference's 0.95, the attributed share beside its 0.9, the duty
   cycle and each stage's share of the host budget (the shares must sum
   to 1); then `obs_port=0` with the profiler: a `device-trace` of 1 s
   over the socket while the clients drive (backend `cuda`; a second
   request answers "capture in progress"), its chrome trace holding K1
   kernels (their count beside the window's `kernel-launch` events and
   their mean device time beside the served bound), a socket scrape
   whose serve stats equal `stats()` and whose `pallas_fused` rise
   equals K1's launches, parsing Prometheus text, and `threads()` by
   role. Leg B, `bench.py --tree --tree-obs`: an `--obs-primary DIR`
   child (ship-before-ack, ring tracer, sampling 1 record in 4,
   `obs_port=0`), a `RelayNode` here over `SocketFeed` and an
   `--obs-leaf DIR` child on it (rids 0-7, one K1 launch a record),
   each with its exporter, scraped by a `FleetCollector` into
   fleet.jsonl while 8 clients x 250 ops drive the primary: the
   report's Fleet section holds all three nodes, a complete record
   across 3 processes and a `submit->ack` edge, and prints each hop
   edge's p50/p95; the leaf holds every acked write.

The harness (`harness/`, `native/`), `bench.py`'s default config
(R = 4096, K = 10000, uniform keys, 50/50):

27. a `ScaleBenchBuilder` sweep of nr and partitioned at 1 write + 1
   read a replica (0.5 s each; CSVs in `chiprun_out/phase27/`), then
   the nr runner's state after a step against the concurrent fold's
   (its one step timed; its sweep window cut for time) and a numpy
   map's; `measure_kernel(10000, 4096, 256)`: every
   tier bit-identical to the scan chain, one K1 launch a `pallas_fused`
   round and two programs a chain round, the fenced p50/p95 beside K1's
   bound, and `torch.profiler` over a short `pallas_fused` call (one
   `hashmap_round_kernel` a launch); then on 4 shards of the card,
   `mesh_fused` (K1 once a shard: 4 a round) and `shmap` (2 verify
   rounds), and
   `measure_mesh` at 1 and 4 shards, bit-identical; `measure_serve`
   over phase 13's fleet (8 closed-loop clients x 250 ops on rids 0-7,
   every response against the client models, one K1 a round); and
   `measure_native`, the C++ engine that phase 1 built with g++ (2
   replicas x 2 threads, 0.5 s).

The simulation plane (`sim/`), on the card:

28. A, the CI `sim-smoke` sweep: `python -m node_replication_torch.sim.
   explore --seeds 500 --procs 4 --out chiprun_out/sim` in a subprocess
   (every model, wrapper and flavor; each case's fleets on the card, the
   hashmap fleets launching K1 through the auto tier's calibration):
   exit 0, no artifact; prints its coverage and seeds/s. B, in process:
   the first 24 seeds (and more until every flavor and both wrappers
   appear) on the card and on the CPU, both clean with equal digests
   and events, K1 launched, rounds by tier; K1 against its plain version
   at the sim's fleets (R = 1-3, K = 32, a 256-slot ring, gc_slack 32,
   W = 1 and 16, fenced and not, across the wrap), its time a launch by
   CUDA events over queued calls beside its bound; each canary caught
   by `explore --canary NAME --no-shrink` on the card and replayed
   byte-identically. C, the crash flavor's checks on phase 13's fleet
   (`engine="pallas"`, a WAL attached, under a SimClock): a
   `SimScheduler` steps 120 quanta of 256-op writes (one K1 launch each),
   reads, WAL syncs and up to 2 snapshots, each held to the numpy
   oracle, then a simulated kill -9 (the active segment cut to its last
   fsynced size plus a torn remainder) and `recover_fleet` on the card:
   durable-ack survival, log content, bit identity and state.

The lock-checked flagship (`analysis/`), on the card:

29. a child (`--lockcheck-child DIR`) started with `NR_TPU_LOCKCHECK=1`
   and `NR_TPU_LOCKGRAPH=DIR/lockgraph.json`, so every factory lock,
   module-level ones too, is the order-checking kind: phase 13's fleet
   (a WAL attached, K1 a round) with ship-before-ack into a
   `DirectoryFeed` and an in-process `Follower` (rids 0-7), the
   exporter (`obs_port=0`) and the profiler at 97 Hz, 8 clients x 250
   ops checked against the client models, a socket scrape, every acked
   write read back from the follower; then phase 25's 2-shard group
   with 16 cross-shard transactions. It prints K1's launches, the acked
   ops/s and the `LockOrderError`s seen (0). The parent runs `python -m
   node_replication_torch.analysis.lint node_replication_torch
   --check-dynamic DIR/lockgraph.json` (the whole-package lint and the
   dynamic-in-static check, exit 0) and the `--suppressions` audit
   (exit 0, beside the child), and requires the six subsystem locks of
   `LC_NODES` among the dynamic graph's nodes.

The port's examples, as its users run them:

30. each of the ten `examples/torch/*.py` (the reference's `examples/`,
   one for one, at the reference's own sizes) as `python3
   examples/torch/NAME.py` from the checkout's root, three at a time,
   each a process of its own on the card (no `--device`) with a 60 s
   timeout and `NR_TPU_TRACE=.chip_smoke_examples/NAME.jsonl`
   (`fleet_dashboard` untraced: it installs its own ring tracer):
   exit 0 and the example's `NAME OK: ...` line; prints each one's wall
   seconds, OK line and K1 launches, read from the `kernel-launch`
   events of its trace, and requires K1 in `nr_hashmap`, `nr_elastic`
   and `serve_hashmap` (their auto tier finishes its calibration); then
   K1 over the states at the examples' fleets (R = 2, K = 1024, ring
   2048, W = 1) against its plain version, fenced and not, across the wrap, its
   time a launch by CUDA events over queued calls beside its bound.

Every comparison is exact (integer data, tolerance 0). Launch counts
are zeroed just before each main-path phase (4, 5, 7, 8, 10-14, 16,
17, 19-29; phase 29's child counts its own, phase 30's examples
their trace's) and read just after; a kernel that its path never launched
fails the run; on the mesh only the meshed fleet's launches count. Every
read of K1's count (`k1_launches`) requires each launch to have gone
over the model's states.
The last
two lines are a `{"kernels": [...]}` summary and `{"ok": true,
"device": ...}`; any failure exits non-zero before them. Without a
CUDA device, or without the package beside this script, it exits
non-zero at once. Details of the run go to
`chiprun_out/chip_smoke.json`, phase 26's profiles to
`chiprun_out/phase26_*.folded` (flamegraph.pl / speedscope input),
phase 27's CSVs to `chiprun_out/phase27/`, phase 28's sweep and canary
output to `chiprun_out/phase28_*.txt`, phase 30's example output to
`chiprun_out/phase30/NAME.log`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 20261016
R, K = 4096, 10000
W_STEP = R          # K2's window on the step path: one write per replica
W_ROUND = 256       # K1's window: one combiner round of 256 ops
# phase 3's other K1 shapes: a mesh shard's R, and the scalar path of a
# fleet grown by one; a few rounds each across the ring's wrap
K1_SHAPES = (1024, 4097)
K1_SHAPE_ROUNDS = 4
VS_P, VS_SPAN, VS_R = 1 << 18, 64, 256  # flat vspace, long-log config
VS_BW = 16          # writes per replica per step: W = 4096 a step
VS_ROUND = 1024     # ops per NodeReplicated round
# open-addressing map, `benches/hashmap.py --sparse --full`
OA_KEYS, OA_N, OA_PROBE, OA_R = 1 << 22, 1 << 23, 16, 16
OA_BW = OA_BR = 16  # batch 32: 50% writes
OA_FILL, OA_FILL_W = 1 << 21, 1 << 16  # pre-fill keys, per K3 launch
OA_W = 4096         # K3's window against its plain version
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# the flat kernels' entry functions (ptxas's lines, the step's share)
VS_ENTRIES = ("flat_decode_kernel", "flat_kernel")


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn()` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> float:
    """Median host time of one call of `fn` in ms: what a wrapper takes
    to enqueue its work (no synchronisation inside), from an idle device,
    as in `cuda_ms`, whose event time includes it."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def max_abs_err(got, want) -> int:
    """Largest absolute difference over paired integer tensors."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_model_round_bytes(R: int, W: float, L: int = 1 << 16,
                         n_keys: int = K) -> float:
    """Bytes one K1 round over the model's states must move: the int32
    values and byte present `[R, K]` in and out, the `[R, W]` responses,
    the ring's opcodes and args in and out, and the window of W
    entries."""
    return 4 * (2 * n_keys * R + W * R + 2 * L * 4 + W * 4) + 2 * n_keys * R


def k1_launches() -> int:
    """K1's launches since the counters were last reset."""
    from node_replication_torch.ops.replay import FUSED_KERNEL

    return FUSED_KERNEL.launches


def planes_to_states(vals, pres, n_keys: int = K) -> tuple:
    """The model's states `(values int32[R, K], present bool[R, K])` of
    `[Kp, R]` int32 planes."""
    return (vals[:n_keys].T.contiguous(),
            (pres[:n_keys] > 0).T.contiguous())


def random_planes(gen, dev, kp: int):
    import torch

    vals = torch.randint(-(1 << 30), 1 << 30, (kp, R), generator=gen,
                         device=dev, dtype=torch.int32)
    pres = torch.randint(0, 2, (kp, R), generator=gen, device=dev,
                         dtype=torch.int32)
    return vals, pres


def phase_build() -> dict:
    from node_replication_torch import native
    from node_replication_torch.ops import kernel_lib

    # the native engine (phase 27) builds with g++ beside the nvcc jobs
    native_build: dict = {}

    def build_native():
        t = time.perf_counter()
        try:
            native.build(force=True)
        except Exception as e:  # re-raised below, after nvcc finished
            native_build["error"] = e
        native_build["s"] = time.perf_counter() - t

    g = threading.Thread(target=build_native, name="native-build")
    t0 = time.perf_counter()
    g.start()
    kernel_lib.build_all(force=True)
    secs = time.perf_counter() - t0
    g.join()
    if "error" in native_build:
        raise native_build["error"]
    names = [p.name for p in kernel_lib.sources()]
    log(f"phase 1: built {', '.join(names)} in {secs:.2f} s; the native "
        f"engine (g++) in {native_build['s']:.2f} s")
    for name in names:
        for line in kernel_lib.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return {"build_s": secs, "native_build_s": native_build["s"],
            "ptxas": dict(kernel_lib.BUILD_LOG)}


def ptxas_report(build_log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines of the entry functions whose
    (mangled) name holds `kernel`."""
    out, inside = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def phase_replay(dev, rng, gen) -> dict:
    """K2 against its plain version at W = 4096: the flagship window,
    then windows of inert opcodes, negative keys and hot keys (their own
    numpy seed, so later phases' inputs stay as they were)."""
    import torch

    from node_replication_torch.ops import kernel_lib
    from node_replication_torch.ops.replay import (
        hashmap_replay,
        hashmap_replay_plain,
        replay_tile,
    )

    kp = -(-K // 8) * 8
    W = W_STEP
    opc = torch.from_numpy(rng.choice(np.array([1, 2], np.int32), W)).to(dev)
    key = torch.from_numpy(rng.integers(0, K, W).astype(np.int32)).to(dev)
    val = torch.from_numpy(
        rng.integers(1, 1 << 31, W).astype(np.int32)).to(dev)
    vals, pres = random_planes(gen, dev, kp)
    args = (opc, key, val, vals, pres, K)
    got = hashmap_replay(*args)
    want = hashmap_replay_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    del got, want
    ms = cuda_ms(lambda: hashmap_replay(*args), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: hashmap_replay_plain(*args), reps=3)
    empty = (opc[:0], key[:0], val[:0], vals, pres, K)
    copy_ms = cuda_ms(lambda: hashmap_replay(*empty), reps=10, warmup=2)
    dt = device_time(lambda: hashmap_replay(*args))
    n_bytes = 4 * (4 * kp * R + W * R + 3 * W)
    bound_ms, by = bound(n_bytes, 4 * W * R)
    log(f"phase 2: K2 R={R} K={K} W={W}: bit-identical; kernel {ms:.4f} "
        f"ms (state copy alone {copy_ms:.4f} ms), plain {plain_ms:.2f} "
        f"ms, bound {bound_ms:.4f} ms ({n_bytes} bytes)")
    log_device("phase 2: K2", dt)
    # the edges: inert opcodes, keys in [-3K, 3K), half of the entries on
    # 8 hot keys; over the flagship planes and over R - 2 columns
    edge = np.random.default_rng(SEED + 2)
    for cols, w in ((R, W), (R - 2, 1024)):
        e_opc = edge.choice(np.array([0, 1, 2, 7], np.int32), w)
        e_key = edge.integers(-3 * K, 3 * K, w).astype(np.int32)
        hot = edge.random(w) < 0.5
        e_key[hot] = edge.choice(e_key[:8], int(hot.sum()))
        e_val = edge.integers(-(1 << 31), 1 << 31, w).astype(np.int32)
        e_args = (*(torch.from_numpy(a).to(dev)
                    for a in (e_opc, e_key, e_val)),
                  vals[:, :cols].contiguous(), pres[:, :cols].contiguous(),
                  K)
        got = hashmap_replay(*e_args)
        want = hashmap_replay_plain(*e_args)
        torch.cuda.synchronize()
        err_e = max_abs_err(got, want)
        if err_e:
            raise AssertionError(f"K2 disagrees with its plain version on "
                                 f"the edge window over {cols} columns: "
                                 f"{err_e}")
        del got, want, e_args
    tile = replay_tile()
    ptxas = ptxas_report(kernel_lib.BUILD_LOG.get("hashmap_replay.cu", ""),
                         "hashmap_replay_kernel")
    log(f"phase 2: K2 edge windows (inert opcodes, keys in [-3K, 3K), "
        f"8 hot keys) over {R} and {R - 2} columns: bit-identical; tile "
        f"{tile}")
    for line in ptxas:
        log(f"  ptxas hashmap_replay_kernel: {line}")
    return {"max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "copy_ms": copy_ms, **dt,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": by, "R": R,
            "K": K, "W": W, "tile": tile, "ptxas": ptxas}


def phase_fused(dev, rng, gen) -> dict:
    """K1 over the model's states (the instance `round_fn` launches),
    unfenced and fenced, against its plain version, W = 256, over enough
    rounds to wrap a 2^16-slot ring; then K1 at the other fleets'
    shapes."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops import kernel_lib
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model,
        hashmap_fused_round_model_plain,
    )

    kp = -(-K // 8) * 8
    W = W_ROUND
    spec = LogSpec(capacity=1 << 16, n_replicas=R, arg_width=3)
    L = spec.capacity
    ring_opc = torch.zeros(L, dtype=torch.int32, device=dev)
    ring_args = torch.zeros((L, 3), dtype=torch.int32, device=dev)
    states = planes_to_states(*random_planes(gen, dev, kp))
    fen = torch.zeros(R, dtype=torch.int32, device=dev)
    fen[[0, 127, 128, R // 2 - 1, R - 1]] = 1
    kern = plain = (ring_opc, ring_args, *states)
    tail, err, rnd = 0, 0, 0
    times = {False: ([], []), True: ([], [])}
    while tail <= L + W:  # past one whole wrap of the ring
        count = int(rng.integers(W // 2, W + 1))
        opc = np.zeros(W, np.int32)
        opc[:count] = rng.choice(np.array([1, 2], np.int32), count)
        args = np.zeros((W, 3), np.int32)
        args[:count, 0] = rng.integers(0, K, count)
        args[:count, 1] = rng.integers(1, 1 << 31, count)
        opc_t = torch.from_numpy(opc).to(dev)
        args_t = torch.from_numpy(args).to(dev)
        tail_t = torch.tensor(tail, dtype=torch.int64, device=dev)
        fenced = 100 <= rnd < 160
        f = fen if fenced else None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out_k = hashmap_fused_round_model(spec, tail_t, count, opc_t,
                                          args_t, *kern, K, f)
        ev[1].record()
        ev[2].record()
        out_p = hashmap_fused_round_model_plain(spec, tail_t, count, opc_t,
                                                args_t, *plain, K, f)
        ev[3].record()
        ev[3].synchronize()
        times[fenced][0].append(ev[0].elapsed_time(ev[1]))
        times[fenced][1].append(ev[2].elapsed_time(ev[3]))
        e = max_abs_err(out_k, out_p)
        if e or any(a.dtype != b.dtype for a, b in zip(out_k, out_p)):
            raise AssertionError(
                f"K1 disagrees with its plain version in round {rnd} "
                f"(fenced={fenced}): {e}")
        err = max(err, e)
        kern, plain = out_k[:4], out_p[:4]
        tail += count
        rnd += 1
    rounds = rnd
    # one standalone unfenced call on the last round's inputs
    dt = device_time(lambda: hashmap_fused_round_model(
        spec, tail_t, count, opc_t, args_t, *kern, K, None))
    n_bytes = k1_model_round_bytes(R, W, L)
    bound_ms, by = bound(n_bytes, 4 * W * R)
    ms = statistics.median(times[False][0][1:])
    ms_f = statistics.median(times[True][0])
    plain_ms = statistics.median(times[False][1][1:])
    plain_ms_f = statistics.median(times[True][1])
    log(f"phase 3: K1 over the states R={R} K={K} W={W} ring={L}: {rounds} "
        f"rounds to tail {tail}, bit-identical; kernel {ms:.4f} ms (fenced "
        f"{ms_f:.4f}), plain {plain_ms:.2f} ms (fenced {plain_ms_f:.2f}), "
        f"bound {bound_ms:.4f} ms ({n_bytes:.0f} bytes)")
    log_device("phase 3: K1", dt)
    ptxas = ptxas_report(kernel_lib.BUILD_LOG.get("hashmap_replay.cu", ""),
                         "hashmap_round_kernel")
    for line in ptxas:
        log(f"  ptxas hashmap_round_kernel: {line}")
    del plain, out_k, out_p, kern
    shapes = {Rk: _k1_shape_check(dev, Rk) for Rk in K1_SHAPES}
    return {"max_abs_err": max([err] + [c["max_abs_err"]
                                        for c in shapes.values()]),
            "ms": ms, "ms_fenced": ms_f, **dt,
            "plain_ms": plain_ms, "plain_ms_fenced": plain_ms_f,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": by,
            "rounds": rounds, "tail": tail, "R": R, "K": K, "W": W,
            "capacity": L, "shapes": shapes, "ptxas": ptxas}


def _k1_shape_check(dev, Rk: int) -> dict:
    """K1 over the states against its plain version at R = Rk replicas:
    K1_SHAPE_ROUNDS rounds of W = 256 from a tail just below 2^16, so
    that they cross the ring's wrap, unfenced and fenced in turn (fenced
    rows at the replica tiles' edges); then its event, profiler and
    queued device time and its bound at W = 256. Its own seeds: later
    phases' inputs stay as they were."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    kp = -(-K // 8) * 8
    W = W_ROUND
    spec = LogSpec(capacity=1 << 16, n_replicas=Rk, arg_width=3)
    L = spec.capacity
    rng = np.random.default_rng(SEED + Rk)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + Rk)
    vals = torch.randint(-(1 << 30), 1 << 30, (kp, Rk), generator=gen,
                         device=dev, dtype=torch.int32)
    pres = torch.randint(0, 2, (kp, Rk), generator=gen, device=dev,
                         dtype=torch.int32)
    ring = (torch.zeros(L, dtype=torch.int32, device=dev),
            torch.zeros((L, 3), dtype=torch.int32, device=dev))
    fen = torch.zeros(Rk, dtype=torch.int32, device=dev)
    fen[[0, 511, 512, Rk // 2, Rk - 1]] = 1
    kern = plain = (*ring, *planes_to_states(vals, pres))
    tail, err = L - 300, 0
    for rnd in range(K1_SHAPE_ROUNDS):
        count = W if rnd == K1_SHAPE_ROUNDS - 1 else \
            int(rng.integers(W // 2, W + 1))
        opc = np.zeros(W, np.int32)
        opc[:count] = rng.choice(np.array([1, 2], np.int32), count)
        args = np.zeros((W, 3), np.int32)
        args[:count, 0] = rng.integers(-K, 2 * K, count)
        args[:count, 1] = rng.integers(1, 1 << 31, count)
        inputs = (spec, torch.tensor(tail, dtype=torch.int64, device=dev),
                  count, torch.from_numpy(opc).to(dev),
                  torch.from_numpy(args).to(dev))
        f = fen if rnd % 2 else None
        out_k = k1(*inputs, *kern, K, f)
        out_p = k1_plain(*inputs, *plain, K, f)
        e = max_abs_err(out_k, out_p)
        if e:
            raise AssertionError(
                f"phase 3: K1 at R={Rk} disagrees with its plain version "
                f"in round {rnd} (fenced={f is not None}): {e}")
        err = max(err, e)
        kern, plain = out_k[:4], out_p[:4]
        tail += count
    if tail <= L:
        raise AssertionError(f"phase 3: K1 at R={Rk} never wrapped")
    # the last round again, unfenced, on its own inputs
    inputs = (*inputs, *kern, K, None)
    ms = cuda_ms(lambda: k1(*inputs), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: k1_plain(*inputs), reps=2)
    dt = device_time(lambda: k1(*inputs))
    q_ms = queued_ms(lambda: k1(*inputs))
    n_bytes = k1_model_round_bytes(Rk, W, L)
    bound_ms, by = bound(n_bytes, 4 * W * Rk)
    log(f"phase 3: K1 R={Rk} K={K} W={W} ring={L}: {K1_SHAPE_ROUNDS} rounds "
        f"across the wrap, fenced and not, bit-identical; kernel {ms:.4f} "
        f"ms, queued {q_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{bound_ms:.4f} ms ({n_bytes:.0f} bytes)")
    log_device(f"phase 3: K1 R={Rk}", dt)
    return {"max_abs_err": err, "ms": ms, "queued_ms": q_ms, **dt,
            "plain_ms": plain_ms, "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": by, "R": Rk, "W": W}


def _step_batches(rng, dev, steps):
    import torch

    out = []
    for _ in range(steps):
        wr_opc = rng.choice(np.array([1, 2], np.int32), (R, 1))
        wr_args = np.zeros((R, 1, 3), np.int32)
        wr_args[..., 0] = rng.integers(0, K, (R, 1))
        wr_args[..., 1] = rng.integers(1, 1 << 31, (R, 1))
        rd_opc = np.ones((R, 1), np.int32)
        rd_args = np.zeros((R, 1, 3), np.int32)
        rd_args[..., 0] = rng.integers(0, K, (R, 1))
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (wr_opc, wr_args, rd_opc, rd_args)))
    return out


def phase_step(dev, rng, card: str, steps: int = 64) -> dict:
    """The lock-step step path at full width: K2's step against the
    combined PyTorch step."""
    import torch

    from node_replication_torch import LogSpec, log_init, make_step
    from node_replication_torch.core.replica import replicate_state
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        make_pallas_step,
        pallas_hashmap_state,
        reset_launch_counts,
    )

    d = make_hashmap(K)
    spec = LogSpec(n_replicas=R, arg_width=3)
    k_step = make_pallas_step(K, spec, 1, 1)
    c_step = make_step(d, spec, 1, 1, combined=True)
    batches = _step_batches(rng, dev, steps)
    # warm both paths (allocator, the library) on throwaway state
    k_step(log_init(spec, dev), pallas_hashmap_state(K, R, dev),
           *batches[0])
    c_step(log_init(spec, dev), replicate_state(d.init_state(dev), R),
           *batches[0])
    torch.cuda.synchronize()

    def run(step, states):
        lg = log_init(spec, dev)
        resps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            lg, states, wr, rd = step(lg, states, *b)
            resps.append((wr, rd))
        torch.cuda.synchronize()
        return lg, states, resps, time.perf_counter() - t0

    reset_launch_counts()
    lk, sk, rk, tk = run(k_step, pallas_hashmap_state(K, R, dev))
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    if launches["hashmap_replay"] == 0:
        raise AssertionError("the step path never launched K2")
    lc, sc, rc, tc = run(c_step, replicate_state(d.init_state(dev), R))
    for f in lk._fields:
        if not torch.equal(getattr(lk, f), getattr(lc, f)):
            raise AssertionError(f"step path: log field {f} differs")
    if not (torch.equal(sk["values"][:K].T, sc["values"])
            and torch.equal(sk["present"][:K].T > 0, sc["present"])):
        raise AssertionError("step path: replica states differ")
    for i, (a, b) in enumerate(zip(rk, rc)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"step path: responses of step {i} differ")
    n_disp = steps * R * 2
    log(f"phase 4: step path R={R} K={K} 1w+1r x {steps} steps (ring "
        f"{spec.capacity}, tail {int(lk.tail)}): bit-identical; K2 step "
        f"{n_disp / tk:.6g} dispatches/s, combined step "
        f"{n_disp / tc:.6g} dispatches/s (fenced), on {card}; launches "
        f"{launches}")
    del lk, sk, rk, lc, sc, rc
    return {"steps": steps, "dispatches": n_disp,
            "pallas_dispatches_per_s": n_disp / tk,
            "combined_dispatches_per_s": n_disp / tc,
            "pallas_s": tk, "combined_s": tc, "launches": launches,
            "pace": step_pace(k_step, batches, spec, dev,
                              lambda: pallas_hashmap_state(K, R, dev),
                              "phase 4: K2", "hashmap_replay_kernel")}


def device_kernels(run, n: int) -> list[tuple[float, int, str]]:
    """`torch.profiler`'s device time of every kernel that `run()`
    launches, as (ms per call, launches per call, name), largest first;
    `run` makes `n` calls of what is measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)  # the tracer starts before the first launch
        run()
        torch.cuda.synchronize()
    # the tracer can still miss the first call's first kernels: a
    # kernel's time per call is its mean launch times its launches per
    # call, rounded (kernels launched less than once every other call
    # are left out)
    out = []
    for e in prof.key_averages():
        per = round(e.count / n)
        if e.device_type == DeviceType.CUDA and per:
            out.append((e.self_device_time_total / 1e3 / e.count * per, per,
                        e.key))
    return sorted(out, reverse=True)


def device_time(call, n: int = 10) -> dict:
    """`device_kernels` of `n` calls of `call()`: the device time of one
    call in ms (None where the profiler saw no device time) and its
    kernels."""
    parts = device_kernels(lambda: [call() for _ in range(n)], n)
    return {"device_ms": sum(k[0] for k in parts) or None,
            "device_kernels": [{"ms": m, "per_call": c, "name": k[:80]}
                               for m, c, k in parts]}


def log_device(label: str, dt: dict) -> None:
    """One log line of a `device_time` read, with its kernels."""
    ms = dt["device_ms"]
    log(f"{label} device time " + (f"{ms:.4f} ms: " if ms else
                                   "not measured")
        + ", ".join(f"{k['name'][:48]} x{k['per_call']:g} {k['ms']:.4f} ms"
                    for k in dt["device_kernels"]))


def step_pace(step, batches, spec, dev, init, label: str,
              kernel) -> dict:
    """What sets a step path's pace: the host's time to enqueue the steps
    (no synchronisation until the end) against the device's kernel time
    in them (`torch.profiler`, a second pass), per step in ms, and the
    share of that device time spent in the kernels whose names hold
    `kernel` (a name, or a tuple of names)."""
    import torch

    from node_replication_torch import log_init

    def run():
        lg, st = log_init(spec, dev), init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            lg, st, _, _ = step(lg, st, *b)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return queued, time.perf_counter() - t0

    n = len(batches)
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    queued, wall = run()
    kernels = device_kernels(run, n)
    device_ms = sum(k[0] for k in kernels)
    kernel_ms = sum(k[0] for k in kernels
                    if any(name in k[2] for name in names))
    out = {"enqueue_ms": queued / n * 1e3, "wall_ms": wall / n * 1e3,
           "device_ms": device_ms or None, "kernel": "/".join(names),
           "kernel_ms": kernel_ms or None,
           "kernel_share": kernel_ms / device_ms if device_ms else None,
           "kernels": [{"ms": ms, "per_step": c, "name": name[:80]}
                       for ms, c, name in kernels[:8]]}
    log(f"{label} step pace, per step: host enqueues it in "
        f"{out['enqueue_ms']:.4f} ms, wall {out['wall_ms']:.4f} ms, device "
        f"kernel time "
        + (f"{device_ms:.4f} ms, {out['kernel']} {kernel_ms:.4f} ms of it "
           f"({100 * out['kernel_share']:.1f}%)" if device_ms
           else "not measured")
        + "; top kernels " + ", ".join(
            f"{k['name'][:40]} x{k['per_step']:g} {k['ms']:.4f} ms"
            for k in out["kernels"][:5]))
    return out


def phase_replica(dev, rng, rounds: int = 36) -> dict:
    """`NodeReplicated` at full width: the fused tier (K1) against the
    combined tier and a plain dict model of the map."""
    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )

    def fleet(engine):
        return NodeReplicated(make_hashmap(K), R, engine=engine, device=dev)

    reset_launch_counts()
    nk, nc = fleet("pallas"), fleet("combined")
    readers = [1, 7, R // 2, R - 1]
    tk = [nk.register(r) for r in readers]
    tc = [nc.register(r) for r in readers]
    model: dict[int, int] = {}
    lat = {"pallas": [], "combined": []}
    for rnd in range(rounds):
        rid = int(rng.integers(R))
        n = W_ROUND
        opc = rng.choice(np.array([1, 2]), n)
        keys = rng.integers(0, K, n)
        vals = rng.integers(1, 1 << 31, n)
        ops = [(int(o), int(k), int(v)) if o == HM_PUT else (int(o), int(k))
               for o, k, v in zip(opc, keys, vals)]
        want = []
        for op in ops:
            if op[0] == HM_PUT:
                model[op[1]] = op[2]
                want.append(0)
            else:
                want.append(int(model.pop(op[1], None) is not None))
        got = {}
        for name, nr in (("pallas", nk), ("combined", nc)):
            t0 = time.perf_counter()
            got[name] = nr.execute_mut_batch(ops, rid)
            lat[name].append(time.perf_counter() - t0)
        if not got["pallas"] == got["combined"] == want:
            raise AssertionError(f"round {rnd}: responses differ")
        for i, r in enumerate(readers):
            k = int(keys[(rnd + i) % n])
            a = nk.execute((HM_GET, k), tk[i])
            b = nc.execute((HM_GET, k), tc[i])
            if not a == b == model.get(k, -1):
                raise AssertionError(f"round {rnd}: read of {k} on "
                                     f"replica {r} differs")
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    nk.sync()
    nc.sync()
    if launches["hashmap_fused_round"] == 0:
        raise AssertionError("NodeReplicated never launched K1")
    sk, sc = nk.stats(), nc.stats()
    if sk["fused_rounds"] != launches["hashmap_fused_round"]:
        raise AssertionError(f"{sk['fused_rounds']} fused rounds but "
                             f"{launches} launches")
    for f in ("appended", "head", "ctail", "min_ltail", "max_lag"):
        if sk[f] != sc[f]:
            raise AssertionError(f"stats field {f}: {sk[f]} != {sc[f]}")
    if not torch.equal(nk.log.ltails, nc.log.ltails):
        raise AssertionError("replica cursors differ")
    for f in ("values", "present"):
        if not torch.equal(nk.states[f], nc.states[f]):
            raise AssertionError(f"replica states differ in {f}")
    if not (nk.replicas_equal() and nc.replicas_equal()):
        raise AssertionError("replicas did not converge")
    present = nk.states["present"][0].cpu().numpy()
    values = nk.states["values"][0].cpu().numpy()
    if set(np.nonzero(present)[0].tolist()) != set(model) or any(
            int(values[k]) != v for k, v in model.items()):
        raise AssertionError("final state differs from the dict model")
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in lat.items()}
    log(f"phase 5: NodeReplicated R={R} K={K}: {rounds} rounds of "
        f"{W_ROUND} ops + {len(readers)} reads each; identical to each "
        f"other and the dict model; round latency (median, fenced by the "
        f"response readback) pallas {med['pallas']:.3f} ms, combined "
        f"{med['combined']:.3f} ms; launches {launches}")
    return {"rounds": rounds, "round_ms": med, "launches": launches,
            "fused_rounds": sk["fused_rounds"]}


# ------------------------------------------------------- flat vspace


def vs_window(rng, W, inert=False):
    """A window of the long-log mix: MAP:UNMAP = 3:1, vpage in [-P, 2P),
    pframe in [1, 2^31), npages = 1 + pframe % 64 (UNMAP's span rides
    args[1], as in the bench). `inert` adds NOOP and unknown opcodes,
    vpages near 2^31 and spans of n <= 0."""
    opc = rng.choice(np.array([1, 1, 1, 2], np.int32), W)
    args = np.zeros((W, 3), np.int32)
    args[:, 0] = rng.integers(-VS_P, 2 * VS_P, W)
    args[:, 1] = rng.integers(1, 1 << 31, W)
    args[:, 2] = 1 + args[:, 1] % VS_SPAN
    if inert:
        at = rng.choice(W, W // 8, replace=False)
        k = len(at) // 4
        opc[at[:k]] = rng.choice(np.array([0, 3, -1], np.int32), k)
        args[at[k:2 * k], 0] = 2 ** 31 - 1 - rng.integers(0, VS_SPAN, k)
        args[at[2 * k:3 * k], 2] = rng.integers(-2, 1, k)
        args[at[3 * k:], 1] = 2 ** 31 - 1 - rng.integers(0, VS_SPAN,
                                                         len(at) - 3 * k)
    return opc, args


def vs_edge_window(rng, W, kind):
    """Windows that K4's per-tile lists must get right. `hot`: the
    long-log mix with every vpage in one 1024-page tile (pages
    1024-2047), so that tile's list is the whole window, across its scan
    chunks. `wrap`: a third of the vpages near 2^31 (the lanes whose
    int32 sum wraps negative act), a third of the pframes near 2^31 (the
    stored value wraps), a third of the vpages in [-64, 0) (the span
    wraps from page P - 1 through 0)."""
    opc, args = vs_window(rng, W)
    if kind == "hot":
        args[:, 0] = rng.integers(1024, 2048 - VS_SPAN, W)
        return opc, args
    near, val, neg = np.array_split(rng.permutation(W), 3)
    args[near, 0] = 2 ** 31 - 1 - rng.integers(0, VS_SPAN, len(near))
    args[val, 1] = 2 ** 31 - 1 - rng.integers(0, VS_SPAN, len(val))
    args[neg, 0] = -rng.integers(1, VS_SPAN + 1, len(neg))
    return opc, args


def vs_reads(call, empty, noop) -> dict:
    """The reads of a flat kernel: the event time of `call()`, the
    wrapper's host time, the device time (`torch.profiler`, by kernel:
    the decode and the replay); then the event and device times of
    `empty()`, the state copy alone, and of `noop()`, the copy and an
    all-NOOP window."""
    out = {"ms": cuda_ms(call, reps=10, warmup=2), "host_ms": host_ms(call),
           **device_time(call)}
    for key, fn in (("copy", empty), ("noop_window", noop)):
        out[f"{key}_ms"] = cuda_ms(fn, reps=10, warmup=2)
        out[f"{key}_device_ms"] = device_time(fn)["device_ms"]
    return out


def log_vs_reads(label: str, r: dict) -> None:
    """`vs_reads` as log lines."""
    fmt = lambda x: f"{x:.4f} ms" if x else "not measured"
    log(f"{label}: event time {r['ms']:.4f} ms (wrapper host time "
        f"{r['host_ms']:.4f} ms); state copy alone {r['copy_ms']:.4f} ms, "
        f"device {fmt(r['copy_device_ms'])}; all-NOOP window "
        f"{r['noop_window_ms']:.4f} ms, device "
        f"{fmt(r['noop_window_device_ms'])}")
    log_device(label, r)


def vs_bytes(R, W, extra=0):
    """Bytes K4/K7a/K5 must move: the int32 [R, P] state in and out, the
    window (opcode + 3 args) and the [W] responses, plus `extra`."""
    return 4 * (2 * R * VS_P + 4 * W + W) + extra


def vs_ops(args_np, opc_np, R):
    """Integer operations the window needs: about 4 per acting page
    (load, compare, count, store) on each replica."""
    is_un = opc_np == 2
    n = np.where(is_un, args_np[:, 1], args_np[:, 2]).clip(0, VS_SPAN)
    n = np.where((opc_np == 1) | is_un, n, 0)
    return 4 * int(n.sum()) * R


def random_frames(gen, dev, R):
    import torch

    vals = torch.randint(1, 1 << 30, (R, VS_P), generator=gen, device=dev,
                         dtype=torch.int32)
    keep = torch.randint(0, 2, (R, VS_P), generator=gen, device=dev,
                         dtype=torch.int32)
    return vals * keep


def phase_vspace_replay(dev, rng, gen) -> dict:
    """K4 against its plain version: one W = 4096 window over random
    frames (R = 256, P = 2^18, kernel layout [R, ROWS, 128]), then a
    hot-spot window and an int32-wrap window (their own numpy seed, so
    later phases' inputs stay as they were)."""
    import torch

    from node_replication_torch.ops import kernel_lib
    from node_replication_torch.ops.vspace import (
        grid_rows,
        vspace_replay,
        vspace_replay_plain,
    )

    W = VS_R * VS_BW
    opc_np, args_np = vs_window(rng, W, inert=True)
    frames = random_frames(gen, dev, VS_R).reshape(
        VS_R, grid_rows(VS_P), 128)
    edge = np.random.default_rng(SEED + 6)
    windows = {"long-log": (opc_np, args_np),
               "hot-spot": vs_edge_window(edge, W, "hot"),
               "int32-wrap": vs_edge_window(edge, W, "wrap")}
    err = 0
    for kind, (o, a) in windows.items():
        call = (torch.from_numpy(o).to(dev), torch.from_numpy(a).to(dev),
                frames, VS_P, VS_SPAN)
        got = vspace_replay(*call)
        want = vspace_replay_plain(*call)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"K4 disagrees with its plain version on "
                                 f"the {kind} window: {e}")
        err = max(err, e)
        if kind == "long-log":  # the one timed
            timed = call
        elif kind == "hot-spot":  # one warp replays the whole window
            hot = call
        del got, want
    opc, args = timed[:2]
    plain_ms = cuda_ms(lambda: vspace_replay_plain(*timed), reps=2)
    # where the kernel's time goes: the state copy alone (an empty
    # window), then the copy plus decoding and scanning an all-NOOP one
    empty = (opc[:0], args[:0], frames, VS_P, VS_SPAN)
    noop = (torch.zeros_like(opc), args, frames, VS_P, VS_SPAN)
    reads = vs_reads(lambda: vspace_replay(*timed),
                     lambda: vspace_replay(*empty),
                     lambda: vspace_replay(*noop))
    reads["hot_device_ms"] = device_time(
        lambda: vspace_replay(*hot))["device_ms"]
    n_bytes, n_ops = vs_bytes(VS_R, W), vs_ops(args_np, opc_np, VS_R)
    bound_ms, by = bound(n_bytes, n_ops)
    log(f"phase 6: K4 R={VS_R} P={VS_P} span={VS_SPAN} W={W}: "
        f"bit-identical (long-log, hot-spot and int32-wrap windows); "
        f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({n_bytes} "
        f"bytes, {n_ops} operations)")
    log_vs_reads("phase 6: K4", reads)
    log(f"phase 6: K4 on the hot-spot window: device time "
        + (f"{reads['hot_device_ms']:.4f} ms" if reads["hot_device_ms"]
           else "not measured"))
    build = kernel_lib.BUILD_LOG.get("vspace_replay.cu", "")
    ptxas = {k: ptxas_report(build, k) for k in VS_ENTRIES}
    for k, lines in ptxas.items():
        for line in lines:
            log(f"  ptxas {k}: {line}")
    return {"max_abs_err": err, **reads, "plain_ms": plain_ms,
            "bytes": n_bytes, "ops": n_ops, "bound_ms": bound_ms,
            "bound_by": by, "R": VS_R, "P": VS_P, "span": VS_SPAN, "W": W,
            "ptxas": ptxas}


def _vs_step_batches(rng, dev, steps):
    import torch

    out = []
    for _ in range(steps):
        opc, args = vs_window(rng, VS_R * VS_BW)
        rd_opc = rng.choice(np.array([1, 2], np.int32), (VS_R, 1))
        rd_args = np.zeros((VS_R, 1, 3), np.int32)
        rd_args[..., 0] = rng.integers(-VS_P, 2 * VS_P, (VS_R, 1))
        rd_args[..., 1] = rng.integers(1, VS_SPAN + 1, (VS_R, 1))
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (
            opc.reshape(VS_R, VS_BW), args.reshape(VS_R, VS_BW, 3),
            rd_opc, rd_args)))
    return out


def phase_vspace_step(dev, rng, card: str, steps: int = 24) -> dict:
    """The three flat vspace step paths at R = 256, P = 2^18: K4's step,
    K7a's plan step and the combined torch step, bit-identical; then
    K7a against its plain version."""
    import torch

    from node_replication_torch import LogSpec, log_init, make_step
    from node_replication_torch.core.replica import replicate_state
    from node_replication_torch.models import make_vspace
    from node_replication_torch.ops import vspace as vs

    d = make_vspace(VS_P, max_span=VS_SPAN)
    spec = LogSpec(n_replicas=VS_R, arg_width=3)
    paths = {
        "pallas": (vs.make_pallas_vspace_step(
            VS_P, spec, VS_BW, 1, VS_SPAN, radix=False),
            lambda: vs.pallas_vspace_state(VS_P, VS_R, False, device=dev)),
        "plan": (vs.make_pallas_vspace_plan_step(
            VS_P, spec, VS_BW, 1, VS_SPAN, radix=False, dispatch=d),
            lambda: replicate_state(d.init_state(dev), VS_R)),
        "combined": (make_step(d, spec, VS_BW, 1, combined=True),
                     lambda: replicate_state(d.init_state(dev), VS_R)),
    }
    batches = _vs_step_batches(rng, dev, steps)
    for step, init in paths.values():  # warm each path on throwaway state
        step(log_init(spec, dev), init(), *batches[0])
    torch.cuda.synchronize()
    out = {}
    for name, (step, init) in paths.items():
        lg, states, resps = log_init(spec, dev), init(), []
        vs.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            lg, states, wr, rd = step(lg, states, *b)
            resps.append((wr, rd))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in (
            vs.REPLAY_KERNEL, vs.PLAN_KERNEL, vs.FUSED_KERNEL)}
        if name == "pallas":
            states = vs.model_view(states, VS_P, False)
        out[name] = (lg, states, resps, secs, launches)
    if out["pallas"][4]["vspace_replay"] == 0:
        raise AssertionError("the K4 step path never launched K4")
    if out["plan"][4]["vspace_plan_replay"] == 0:
        raise AssertionError("the plan step path never launched K7a")
    lc, sc, rc = out["combined"][:3]
    for name in ("pallas", "plan"):
        lk, sk, rk = out[name][:3]
        for f in lk._fields:
            if not torch.equal(getattr(lk, f), getattr(lc, f)):
                raise AssertionError(f"{name} step: log field {f} differs")
        if not torch.equal(sk["frames"], sc["frames"]):
            raise AssertionError(f"{name} step: replica states differ")
        for i, (a, b) in enumerate(zip(rk, rc)):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name} step: responses of step {i} "
                                     f"differ")
    n_disp = steps * VS_R * (VS_BW + 1)
    rates = {k: n_disp / v[3] for k, v in out.items()}
    launches = {k: v[4] for k, v in out.items()}
    log(f"phase 7: vspace step paths R={VS_R} P={VS_P} span={VS_SPAN} "
        f"{VS_BW}w+1r x {steps} steps (ring {spec.capacity}, tail "
        f"{int(lc.tail)}): bit-identical; dispatches/s (fenced) K4 step "
        f"{rates['pallas']:.6g}, K7a plan step {rates['plan']:.6g}, "
        f"combined step {rates['combined']:.6g}, on {card}; launches "
        f"{launches}")
    del out, lc, sc, rc
    k4_step, k4_init = paths["pallas"]
    pace = step_pace(k4_step, batches, spec, dev, k4_init, "phase 7: K4",
                     VS_ENTRIES)
    # K7a alone against its plain version: one canonical row, W = 4096
    W = VS_R * VS_BW
    opc_np, args_np = vs_window(rng, W, inert=True)
    opc = torch.from_numpy(opc_np).to(dev)
    args = torch.from_numpy(args_np).to(dev)
    frames = random_frames(torch.Generator(device=dev).manual_seed(SEED),
                           dev, 1)
    touched = (frames % 7 == 0).to(torch.int32)
    call = (opc, args, frames, touched, VS_P, VS_SPAN)
    got = vs.vspace_plan_replay(*call)
    want = vs.vspace_plan_replay_plain(*call)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K7a disagrees with its plain version: {err}")
    del got, want
    plain_ms = cuda_ms(lambda: vs.vspace_plan_replay_plain(*call), reps=2)
    empty = (opc[:0], args[:0], *call[2:])
    noop = (torch.zeros_like(opc), *call[1:])
    reads = vs_reads(lambda: vs.vspace_plan_replay(*call),
                     lambda: vs.vspace_plan_replay(*empty),
                     lambda: vs.vspace_plan_replay(*noop))
    # one row of frames and of the touched plane, in and out
    n_bytes = 4 * (4 * VS_P + 4 * W + W)
    n_ops = vs_ops(args_np, opc_np, 1)
    bound_ms, by = bound(n_bytes, n_ops)
    log(f"phase 7: K7a R=1 P={VS_P} W={W}: bit-identical; plain "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({n_bytes} bytes)")
    log_vs_reads("phase 7: K7a", reads)
    return {"steps": steps, "dispatches": n_disp,
            "dispatches_per_s": rates, "launches": launches, "pace": pace,
            "plan_kernel": {"max_abs_err": err, **reads,
                            "plain_ms": plain_ms, "bytes": n_bytes,
                            "ops": n_ops, "bound_ms": bound_ms,
                            "bound_by": by, "W": W}}


def np_vspace_apply(frames, op) -> int:
    """The numpy page table: one write op, in place; its response."""
    lanes = np.arange(VS_SPAN, dtype=np.int64)
    is_map = op[0] == 1
    n = min(max(op[3] if is_map else op[2], 0), VS_SPAN)
    raw = (op[1] + lanes[:n] + 2 ** 31) % 2 ** 32 - 2 ** 31
    ok = raw < VS_P
    pages = raw[ok] % VS_P
    if is_map:
        resp = int((frames[pages] == 0).sum())
        frames[pages] = (op[2] + lanes[:n][ok] + 2 ** 31) % 2 ** 32 - 2 ** 31
    else:
        resp = int((frames[pages] != 0).sum())
        frames[pages] = 0
    return resp


def np_vspace_read(frames, op) -> int:
    if op[0] == 1:
        f = int(frames[op[1] % VS_P])
        return -1 if f == 0 else f
    lanes = np.arange(min(max(op[2], 0), VS_SPAN), dtype=np.int64)
    raw = (op[1] + lanes + 2 ** 31) % 2 ** 32 - 2 ** 31
    return int((frames[raw[raw < VS_P] % VS_P] != 0).sum())


def phase_vspace_replica(dev, rng, rounds: int = 72) -> dict:
    """`NodeReplicated` over the flat vspace at R = 256, P = 2^18: the
    fused tier (K5) against the combined tier and a numpy page table,
    with replica R/4 fenced for rounds 30-35; then K5 against its plain
    version."""
    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import make_vspace
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops import vspace as vs
    from node_replication_torch.ops.encoding import encode_ops

    reg = get_registry()
    reg.enable()
    fallback = reg.counter("nr.exec.engine.fused_fallback")

    def fleet(engine):
        return NodeReplicated(make_vspace(VS_P, max_span=VS_SPAN), VS_R,
                              engine=engine, device=dev)

    vs.reset_launch_counts()
    nk, nc = fleet("pallas"), fleet("combined")
    readers = [1, VS_R // 2 - 1, VS_R // 2, VS_R - 1]
    fenced_rid = VS_R // 4
    tk = [nk.register(r) for r in readers]
    tc = [nc.register(r) for r in readers]
    model = np.zeros(VS_P, np.int64)
    lat = {"pallas": [], "combined": []}
    fenced_rounds, fb0 = range(30, 36), fallback.value
    for rnd in range(rounds):
        if rnd == fenced_rounds[0]:
            for nr in (nk, nc):
                nr.fence_replica(fenced_rid)
        if rnd == fenced_rounds[-1] + 1:
            if fallback.value - fb0 < len(fenced_rounds):
                raise AssertionError("fenced rounds did not take the chain")
            for nr in (nk, nc):
                nr.clone_replica_from(fenced_rid, donor=0)
                nr.unfence_replica(fenced_rid)
        opc, args = vs_window(rng, VS_ROUND)
        ops = [(1, int(a[0]), int(a[1]), int(a[2])) if o == 1
               else (2, int(a[0]), int(a[1])) for o, a in zip(opc, args)]
        want = [np_vspace_apply(model, op) for op in ops]
        rid = int(rng.integers(VS_R))
        if rid == fenced_rid and rnd in fenced_rounds:
            rid = 0
        got = {}
        for name, nr in (("pallas", nk), ("combined", nc)):
            t0 = time.perf_counter()
            got[name] = nr.execute_mut_batch(ops, rid)
            lat[name].append(time.perf_counter() - t0)
        if not got["pallas"] == got["combined"] == want:
            raise AssertionError(f"round {rnd}: responses differ")
        want_tier = "combined" if rnd in fenced_rounds else "pallas_fused"
        if nk.last_round_tier != want_tier:
            raise AssertionError(f"round {rnd}: tier {nk.last_round_tier}")
        for i, r in enumerate(readers):
            a = args[(rnd + i) % VS_ROUND]
            op = (1, int(a[0])) if i % 2 else (2, int(a[0]), int(a[2]))
            x, y = nk.execute(op, tk[i]), nc.execute(op, tc[i])
            if not x == y == np_vspace_read(model, op):
                raise AssertionError(f"round {rnd}: read {op} on replica "
                                     f"{r} differs")
    launches = {k.name: k.launches for k in (
        vs.REPLAY_KERNEL, vs.PLAN_KERNEL, vs.FUSED_KERNEL)}
    nk.sync()
    nc.sync()
    if launches["vspace_fused_round"] == 0:
        raise AssertionError("NodeReplicated never launched K5")
    sk, sc = nk.stats(), nc.stats()
    if sk["fused_rounds"] != launches["vspace_fused_round"] \
            or sk["fused_rounds"] != rounds - len(fenced_rounds):
        raise AssertionError(f"{sk['fused_rounds']} fused rounds but "
                             f"{launches} launches")
    for f in ("appended", "head", "ctail", "min_ltail", "max_lag"):
        if sk[f] != sc[f]:
            raise AssertionError(f"stats field {f}: {sk[f]} != {sc[f]}")
    if not torch.equal(nk.log.ltails, nc.log.ltails):
        raise AssertionError("replica cursors differ")
    if not torch.equal(nk.states["frames"], nc.states["frames"]):
        raise AssertionError("replica states differ")
    if not (nk.replicas_equal() and nc.replicas_equal()):
        raise AssertionError("replicas did not converge")
    if not np.array_equal(nk.states["frames"][0].cpu().numpy(), model):
        raise AssertionError("final frames differ from the numpy model")
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in lat.items()}
    log(f"phase 8: NodeReplicated vspace R={VS_R} P={VS_P} span="
        f"{VS_SPAN}: {rounds} rounds of {VS_ROUND} ops + {len(readers)} "
        f"reads each (ring {nk.spec.capacity}, tail {sk['appended']}), "
        f"rounds {fenced_rounds[0]}-{fenced_rounds[-1]} fenced on the "
        f"chain; identical to each other and the numpy page table; round "
        f"latency (median, fenced by the response readback) pallas "
        f"{med['pallas']:.3f} ms, combined {med['combined']:.3f} ms; "
        f"launches {launches}")
    # K5 alone against its plain version, on the fleet's own log/state
    opc_np, args_np = vs_window(rng, VS_ROUND, inert=True)
    opcodes, args, count = encode_ops(
        [(int(o), *map(int, a)) for o, a in zip(opc_np, args_np)], 3,
        device=dev)
    lg, frames = nk.log, nk.states["frames"]
    call = (nk.spec, lg.tail, count, opcodes, args, lg.opcodes, lg.args,
            frames, VS_P, VS_SPAN)
    got = vs.vspace_fused_round(*call)
    want = vs.vspace_fused_round_plain(*call)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K5 disagrees with its plain version: {err}")
    del got, want
    plain_ms = cuda_ms(lambda: vs.vspace_fused_round_plain(*call), reps=2)
    # the copy alone: a one-entry NOOP window that appends nothing
    empty = (*call[:2], 0, torch.zeros_like(opcodes[:1]), args[:1],
             *call[5:])
    noop = (*call[:3], torch.zeros_like(opcodes), *call[4:])
    reads = vs_reads(lambda: vs.vspace_fused_round(*call),
                     lambda: vs.vspace_fused_round(*empty),
                     lambda: vs.vspace_fused_round(*noop))
    L = nk.spec.capacity
    n_bytes = vs_bytes(VS_R, VS_ROUND, extra=4 * 2 * L * 4)
    n_ops = vs_ops(args_np, opc_np, VS_R)
    bound_ms, by = bound(n_bytes, n_ops)
    log(f"phase 8: K5 R={VS_R} P={VS_P} W={VS_ROUND} ring={L}: "
        f"bit-identical; plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({n_bytes} bytes)")
    log_vs_reads("phase 8: K5", reads)
    return {"rounds": rounds, "round_ms": med, "launches": launches,
            "fused_rounds": sk["fused_rounds"],
            "fused_fallback": fallback.value - fb0,
            "fused_kernel": {"max_abs_err": err, **reads,
                             "plain_ms": plain_ms, "bytes": n_bytes,
                             "ops": n_ops, "bound_ms": bound_ms,
                             "bound_by": by, "W": VS_ROUND,
                             "capacity": L}}


# ------------------------------------------------------- radix vspace


def rx_window(rng, W, inert=False):
    """A window of the radix long-log mix (`benches/vspace.py:115`):
    MAP, MAP, MAP, MAP_DEVICE, UNMAP, UNMAP_TABLE uniform, vpage in
    [0, P), pframe in [0, 2^31), npages = 1 + pframe % 64 (UNMAP's span
    rides args[1]). `inert` adds NOOP and unknown opcodes, vpages below
    0 and past P, maps with n <= 0, spans crossing a PD boundary or
    passing P, and teardowns of regions never mapped."""
    opc = rng.choice(np.array([1, 1, 1, 2, 3, 4], np.int32), W)
    args = np.zeros((W, 3), np.int32)
    args[:, 0] = rng.integers(0, VS_P, W)
    args[:, 1] = rng.integers(0, 1 << 31, W)
    args[:, 2] = 1 + args[:, 1] % VS_SPAN
    if inert:
        at = np.array_split(rng.choice(W, W // 4, replace=False), 6)
        opc[at[0]] = rng.choice(np.array([0, 5, -1], np.int32), len(at[0]))
        args[at[1], 0] = rng.integers(-VS_P, 0, len(at[1])) + np.where(
            rng.random(len(at[1])) < 0.5, 0, 3 * VS_P)
        opc[at[2]] = 1
        args[at[2], 2] = rng.integers(-2, 1, len(at[2]))
        args[at[3], 0] = (512 * rng.integers(1, VS_P // 512, len(at[3]))
                          - rng.integers(1, VS_SPAN, len(at[3])))
        args[at[4], 0] = VS_P - rng.integers(1, VS_SPAN, len(at[4]))
        opc[at[5]] = 4  # mostly regions no MAP of this window touched
    return opc, args


def rx_edge_window(rng, W, kind):
    """Windows that K6's per-tile lists and first-MAP indices must get
    right. `hot`: the long-log mix with every vpage in one 1024-page tile
    (pages 1024-2047), so that tile's list is the whole window, across
    its scan chunks. `late`: UNMAPs, teardowns and MAPs of n <= 0 up to
    entry 3W/4, the window's first live MAP there, then the mix: from
    unset PDPT/PML4 no page walks before it."""
    opc, args = rx_window(rng, W)
    if kind == "hot":
        args[:, 0] = rng.integers(1024, 2048 - VS_SPAN, W)
    else:
        head = 3 * W // 4
        opc[:head] = rng.choice(np.array([1, 2, 3, 4], np.int32), head)
        args[:head, 2] = rng.integers(-2, 1, head)
        args[:head, 1] = np.where(opc[:head] == 3,
                                  rng.integers(1, VS_SPAN + 1, head),
                                  args[:head, 1])
        opc[head], args[head, 2] = 1, VS_SPAN
    return opc, args


def rx_ops(args_np, opc_np, R):
    """Integer operations the window needs: about 4 per acting page
    (load, walk, count, store) on each replica: a span's pages below P,
    a teardown's region."""
    vs = args_np[:, 0].astype(np.int64) % VS_P
    n = np.where(opc_np == 3, args_np[:, 1], args_np[:, 2]).clip(0, VS_SPAN)
    span = np.minimum(vs + n, VS_P) - vs
    pages = np.where((opc_np >= 1) & (opc_np <= 3), span, 0)
    pages = np.where(opc_np == 4, 512, pages)
    return 4 * int(pages.sum()) * R


def random_levels(gen, dev, upper: bool):
    """Random PD bits; PDPT and PML4 all set (`upper`) or all unset."""
    import torch

    from node_replication_torch.ops.vspace import levels

    l2, l3, _ = levels(VS_P)
    pd = torch.randint(0, 2, (l2,), generator=gen, device=dev,
                       dtype=torch.int32)
    fill = int(upper)
    return [pd, torch.full((l3,), fill, dtype=torch.int32, device=dev),
            torch.full((1,), fill, dtype=torch.int32, device=dev)]


def phase_radix_replay(dev, rng, gen) -> dict:
    """K6 against its plain version: a W = 4096 window over random pt
    (R = 256, P = 2^18, kernel layout [R, ROWS, 128]) and random PD bits,
    once with PDPT/PML4 set and once with them unset; then a hot-spot
    window (every entry on one tile) and a late-first-MAP window (their
    own numpy seed, so later phases' inputs stay as they were)."""
    import torch

    from node_replication_torch.ops import kernel_lib
    from node_replication_torch.ops.vspace import (
        grid_rows,
        vspace_radix_replay,
        vspace_radix_replay_plain,
    )

    W = VS_R * VS_BW
    pt = random_frames(gen, dev, VS_R).reshape(VS_R, grid_rows(VS_P), 128)
    edge = np.random.default_rng(SEED + 9)
    windows = [(rx_window(rng, W, inert=True), True),
               (rx_window(rng, W, inert=True), False),
               (rx_edge_window(edge, W, "hot"), True),
               (rx_edge_window(edge, W, "late"), False)]
    err = 0
    for at, ((opc_np, args_np), upper) in enumerate(windows):
        opc = torch.from_numpy(opc_np).to(dev)
        args = torch.from_numpy(args_np).to(dev)
        call = (opc, args, pt, *random_levels(gen, dev, upper), VS_P,
                VS_SPAN)
        got = vspace_radix_replay(*call)
        want = vspace_radix_replay_plain(*call)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"K6 disagrees with its plain version "
                                 f"(window {at} of the phase, PDPT/PML4 "
                                 f"set: {upper}): {e}")
        err = max(err, e)
        if at == 0:  # the long-log window is the one timed
            timed, timed_np = call, (opc_np, args_np)
    del got, want
    ms = cuda_ms(lambda: vspace_radix_replay(*timed), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: vspace_radix_replay_plain(*timed), reps=2)
    empty = (timed[0][:0], timed[1][:0], *timed[2:])
    copy_ms = cuda_ms(lambda: vspace_radix_replay(*empty), reps=10,
                      warmup=2)
    noop = (torch.zeros_like(timed[0]), *timed[1:])
    noop_ms = cuda_ms(lambda: vspace_radix_replay(*noop), reps=10,
                      warmup=2)

    dt = device_time(lambda: vspace_radix_replay(*timed))
    device_ms = dt["device_ms"]
    wrapper_ms = host_ms(lambda: vspace_radix_replay(*timed))
    n_bytes, n_ops = vs_bytes(VS_R, W), rx_ops(timed_np[1], timed_np[0],
                                               VS_R)
    bound_ms, by = bound(n_bytes, n_ops)
    build = kernel_lib.BUILD_LOG.get("vspace_radix_replay.cu", "")
    ptxas = {k: ptxas_report(build, k)
             for k in ("radix_kernel", "radix_decode_kernel")}
    log(f"phase 9: K6 R={VS_R} P={VS_P} span={VS_SPAN} W={W}: "
        f"bit-identical (PDPT/PML4 set and unset, a hot-spot window, a "
        f"late first MAP); kernel {ms:.4f} ms (state copy alone "
        f"{copy_ms:.4f} ms, all-NOOP window {noop_ms:.4f} ms), wrapper "
        f"host time {wrapper_ms:.4f} ms, device "
        + (f"{device_ms:.4f} ms" if device_ms else "time not measured")
        + f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({n_bytes} "
        f"bytes, {n_ops} operations)")
    log_device("phase 9: K6", dt)
    for k, lines in ptxas.items():
        for line in lines:
            log(f"  ptxas {k}: {line}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "copy_ms": copy_ms, "noop_window_ms": noop_ms,
            "host_ms": wrapper_ms, **dt, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": bound_ms, "bound_by": by, "R": VS_R, "P": VS_P,
            "span": VS_SPAN, "W": W, "ptxas": ptxas}


def np_radix_apply(st, op) -> int:
    """The numpy radix page table (`make_vspace_radix` semantics): one
    write op on `st` ({"pt", "pd", "pdpt", "pml4"} numpy), in place; its
    response."""
    kind, a0, a1, a2 = (int(x) for x in op)
    if kind not in (1, 2, 3, 4):
        return 0
    vs = a0 % VS_P
    pt, pd, pdpt, pml4 = st["pt"], st["pd"], st["pdpt"], st["pml4"]

    def walked(lo, hi):
        pages = np.arange(lo, hi)
        return (pml4[0] & pdpt[pages >> 18] & pd[pages >> 9]
                & (pt[lo:hi] != 0))

    if kind == 4:
        base = (vs >> 9) << 9
        hi = min(base + 512, VS_P)
        resp = int(walked(base, hi).sum())
        pt[base:hi] = 0
        pd[vs >> 9] = False
        return resp
    n = min(max(a1 if kind == 3 else a2, 0), VS_SPAN)
    hi = min(vs + n, VS_P)
    w = walked(vs, hi)
    if kind == 3:
        pt[vs:hi] = 0
        return int(w.sum())
    lanes = np.arange(hi - vs, dtype=np.int64)
    pt[vs:hi] = ((a1 + lanes + 1) & ((1 << 30) - 1)) | (
        (1 << 30) if kind == 2 else 0)
    if n > 0:
        last = vs + n - 1
        pd[vs >> 9] = True
        if (vs >> 9) + 1 < len(pd) and (vs >> 9) + 1 <= last >> 9:
            pd[(vs >> 9) + 1] = True
        for k in (vs >> 18, last >> 18):
            if k < len(pdpt):
                pdpt[k] = True
        pml4[0] = True
    return int((~w).sum())


def _rx_step_batches(rng, dev, steps):
    import torch

    out = []
    for _ in range(steps):
        opc, args = rx_window(rng, VS_R * VS_BW)
        rd_opc = rng.choice(np.array([1, 2, 3], np.int32), (VS_R, 1))
        rd_args = np.zeros((VS_R, 1, 3), np.int32)
        rd_args[..., 0] = rng.integers(0, VS_P, (VS_R, 1))
        rd_args[..., 1] = rng.integers(1, VS_SPAN + 1, (VS_R, 1))
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (
            opc.reshape(VS_R, VS_BW), args.reshape(VS_R, VS_BW, 3),
            rd_opc, rd_args)))
    return out


def phase_radix_step(dev, rng, card: str, steps: int = 24) -> dict:
    """The three radix step paths at R = 256, P = 2^18: K6's step, K7b's
    plan step and the combined torch step, bit-identical to each other,
    replica 0's final state equal to a numpy radix page table of the
    stream; then K7b against its plain version."""
    import torch

    from node_replication_torch import LogSpec, log_init, make_step
    from node_replication_torch.core.replica import replicate_state
    from node_replication_torch.models import make_vspace_radix
    from node_replication_torch.ops import vspace as vs

    d = make_vspace_radix(VS_P, max_span=VS_SPAN)
    spec = LogSpec(n_replicas=VS_R, arg_width=3)
    paths = {
        "pallas": (vs.make_pallas_vspace_step(
            VS_P, spec, VS_BW, 1, VS_SPAN, radix=True),
            lambda: vs.pallas_vspace_state(VS_P, VS_R, True, device=dev)),
        "plan": (vs.make_pallas_vspace_plan_step(
            VS_P, spec, VS_BW, 1, VS_SPAN, radix=True, dispatch=d),
            lambda: replicate_state(d.init_state(dev), VS_R)),
        "combined": (make_step(d, spec, VS_BW, 1, combined=True),
                     lambda: replicate_state(d.init_state(dev), VS_R)),
    }
    batches = _rx_step_batches(rng, dev, steps)
    for step, init in paths.values():  # warm each path on throwaway state
        step(log_init(spec, dev), init(), *batches[0])
    torch.cuda.synchronize()
    out = {}
    for name, (step, init) in paths.items():
        lg, states, resps = log_init(spec, dev), init(), []
        vs.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            lg, states, wr, rd = step(lg, states, *b)
            resps.append((wr, rd))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in vs.KERNELS}
        if name == "pallas":
            states = vs.model_view(states, VS_P, True)
        out[name] = (lg, states, resps, secs, launches)
    if out["pallas"][4]["vspace_radix_replay"] == 0:
        raise AssertionError("the K6 step path never launched K6")
    if out["plan"][4]["vspace_radix_plan_replay"] == 0:
        raise AssertionError("the plan step path never launched K7b")
    lc, sc, rc = out["combined"][:3]
    for name in ("pallas", "plan"):
        lk, sk, rk = out[name][:3]
        for f in lk._fields:
            if not torch.equal(getattr(lk, f), getattr(lc, f)):
                raise AssertionError(f"{name} step: log field {f} differs")
        for key in sc:
            if not torch.equal(sk[key], sc[key]):
                raise AssertionError(f"{name} step: replica {key} differs")
        for i, (a, b) in enumerate(zip(rk, rc)):
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{name} step: responses of step {i} "
                                     f"differ")
    # the numpy radix page table of the same stream
    l2, l3, _ = vs.levels(VS_P)
    st = {"pt": np.zeros(VS_P, np.int64), "pd": np.zeros(l2, bool),
          "pdpt": np.zeros(l3, bool), "pml4": np.zeros(1, bool)}
    want = []
    for b in batches:
        opc = b[0].reshape(-1).cpu().numpy()
        args = b[1].reshape(-1, 3).cpu().numpy()
        want.append([np_radix_apply(st, (o, *a)) for o, a in zip(opc, args)])
    got = [wr.reshape(-1).tolist() for wr, _ in rc]
    if got != want:
        raise AssertionError("write responses differ from the numpy table")
    for key in st:
        if not np.array_equal(sc[key][0].cpu().numpy(), st[key]):
            raise AssertionError(f"replica 0's {key} differs from the numpy "
                                 f"table")
    n_disp = steps * VS_R * (VS_BW + 1)
    rates = {k: n_disp / v[3] for k, v in out.items()}
    launches = {k: v[4] for k, v in out.items()}
    log(f"phase 10: radix step paths R={VS_R} P={VS_P} span={VS_SPAN} "
        f"{VS_BW}w+1r x {steps} steps (ring {spec.capacity}, tail "
        f"{int(lc.tail)}): bit-identical, replica 0 = the numpy radix "
        f"table; dispatches/s (fenced) K6 step {rates['pallas']:.6g}, "
        f"K7b plan step {rates['plan']:.6g}, combined step "
        f"{rates['combined']:.6g}, on {card}; launches {launches}")
    del out, lc, sc, rc
    k6_step, k6_init = paths["pallas"]
    pace = step_pace(k6_step, batches, spec, dev, k6_init, "phase 10: K6",
                     "radix_kernel")
    # K7b alone against its plain version: one canonical row, W = 4096
    W = VS_R * VS_BW
    opc_np, args_np = rx_window(rng, W, inert=True)
    opc = torch.from_numpy(opc_np).to(dev)
    args = torch.from_numpy(args_np).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    pt = random_frames(g, dev, 1)
    lv = random_levels(g, dev, False)
    planes = ((pt % 7 == 0).to(torch.int32), (pt % 11 == 0).to(torch.int32),
              torch.randint(0, 2, lv[0].shape, generator=g, device=dev,
                            dtype=torch.int32))
    call = (opc, args, pt, *lv, *planes, VS_P, VS_SPAN)
    got = vs.vspace_radix_plan_replay(*call)
    want = vs.vspace_radix_plan_replay_plain(*call)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K7b disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: vs.vspace_radix_plan_replay(*call), reps=20,
                 warmup=2)
    plain_ms = cuda_ms(lambda: vs.vspace_radix_plan_replay_plain(*call),
                       reps=2)
    device_ms = device_time(
        lambda: vs.vspace_radix_plan_replay(*call))["device_ms"]
    wrapper_ms = host_ms(lambda: vs.vspace_radix_plan_replay(*call))
    # one row of pt, wins and clr, each in and out
    n_bytes = 4 * (6 * VS_P + 4 * W + W)
    n_ops = rx_ops(args_np, opc_np, 1)
    bound_ms, by = bound(n_bytes, n_ops)
    log(f"phase 10: K7b R=1 P={VS_P} W={W}: bit-identical; kernel "
        f"{ms:.4f} ms, wrapper host time {wrapper_ms:.4f} ms, device "
        + (f"{device_ms:.4f} ms" if device_ms else "time not measured")
        + f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({n_bytes} bytes)")
    return {"steps": steps, "dispatches": n_disp,
            "dispatches_per_s": rates, "launches": launches, "pace": pace,
            "plan_kernel": {"max_abs_err": err, "ms": ms,
                            "host_ms": wrapper_ms, "device_ms": device_ms,
                            "plain_ms": plain_ms, "bytes": n_bytes,
                            "ops": n_ops, "bound_ms": bound_ms,
                            "bound_by": by, "W": W}}


# ------------------------------------------------ open-addressing map

_M32 = (1 << 32) - 1


def np_mix(x):
    """The model's uint32 mix, in numpy (uint64 held, masked)."""
    x = np.asarray(x).astype(np.int64).astype(np.uint64) & np.uint64(_M32)
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) \
        & np.uint64(_M32)
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) \
        & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


def np_unmix(h):
    """Keys (int32) whose mix is `h`: the mix inverted step by step."""
    inv = lambda c: pow(c, -1, 1 << 32)
    x = np.asarray(h, np.uint64) & np.uint64(_M32)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(inv(0x846CA68B))) & np.uint64(_M32)
    x ^= (x >> np.uint64(15)) ^ (x >> np.uint64(30))
    x = (x * np.uint64(inv(0x7FEB352D))) & np.uint64(_M32)
    x ^= x >> np.uint64(16)
    return x.astype(np.int64).astype(np.uint32).view(np.int32)


def oa_keys_with_homes(homes, per_home: int):
    """`per_home` distinct keys for each home slot of an OA_N table (a
    power of two, so the home is the mix's low bits), made by inverting
    the mix and checked by hashing them with numpy."""
    homes = np.asarray(homes, np.uint64)
    hi = np.arange(per_home, dtype=np.uint64) * np.uint64(OA_N)
    keys = np_unmix((homes[:, None] + hi[None, :]).reshape(-1))
    if not np.array_equal(np_mix(keys) % np.uint64(OA_N),
                          np.repeat(homes, per_home)):
        raise AssertionError("the inverted mix does not hit its homes")
    return keys


def oa_window(rng, W, present, values):
    """A window of the sparse mix (`benches/hashmap.py:130-134`): PUT and
    REMOVE 50/50 over keys of which half are present in the table."""
    opc = rng.choice(np.array([1, 2], np.int32), W)
    keys = np.where(rng.random(W) < 0.5, rng.choice(present, W),
                    rng.integers(0, OA_KEYS, W)).astype(np.int32)
    args = np.zeros((W, 3), np.int32)
    args[:, 0] = keys
    args[:, 1] = rng.choice(values, W)
    return opc, args


def phase_oahashmap(dev, rng, card: str, steps: int = 24) -> dict:
    """The open-addressing map at R = 16, N = 2^23 slots, probe 16:
    a pre-fill of 2^21 distinct keys through K3, every key read back;
    24 steps of K3's step against the scan step, bit-identical; then K3
    against its plain version at W = 4096."""
    import torch

    from node_replication_torch import LogSpec, log_init, make_step
    from node_replication_torch.models import make_oahashmap
    from node_replication_torch.ops import oahashmap as oa

    planes = oa.pallas_oahashmap_state(OA_N, OA_R, device=dev)
    names = ("keys", "vals", "flag")
    # pre-fill: 2^21 distinct keys of the 2^22-key space, large windows
    fill = rng.permutation(OA_KEYS)[:OA_FILL].astype(np.int32)
    fill_v = rng.integers(1, 1 << 31, OA_FILL).astype(np.int32)
    fill_resps = []
    t0 = time.perf_counter()
    for c in range(0, OA_FILL, OA_FILL_W):
        opc = torch.ones(OA_FILL_W, dtype=torch.int32, device=dev)
        args = torch.zeros((OA_FILL_W, 3), dtype=torch.int32, device=dev)
        args[:, 0] = torch.from_numpy(fill[c:c + OA_FILL_W]).to(dev)
        args[:, 1] = torch.from_numpy(fill_v[c:c + OA_FILL_W]).to(dev)
        *new, r = oa.oahashmap_replay(opc, args, *planes.values(), OA_N,
                                      OA_PROBE)
        planes = dict(zip(names, new))
        fill_resps.append(r)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    dropped = (torch.cat(fill_resps) == -2).cpu().numpy()
    for r in range(1, OA_R):
        for k in names:
            if not torch.equal(planes[k][r], planes[k][0]):
                raise AssertionError(f"pre-fill: replica {r}'s {k} differs")
    reads = oa.oahashmap_reads(OA_N, OA_PROBE)
    q = torch.from_numpy(fill).to(dev)
    got = reads({k: v[:1] for k, v in planes.items()},
                torch.ones((1, OA_FILL), dtype=torch.int32, device=dev),
                torch.stack([q, q, q], -1)[None])[0].cpu().numpy()
    if not np.array_equal(got, np.where(dropped, -1, fill_v)):
        raise AssertionError("pre-fill: a key reads back wrong")
    present = fill[~dropped]
    # the step paths from that state
    d = make_oahashmap(OA_N, probe=OA_PROBE)
    spec = LogSpec(n_replicas=OA_R, arg_width=3)
    k_step = oa.make_pallas_oahashmap_step(OA_N, OA_PROBE, spec, OA_BW,
                                           OA_BR)
    s_step = make_step(d, spec, OA_BW, OA_BR)
    batches = []
    for _ in range(steps):
        opc, args = oa_window(rng, OA_R * OA_BW, present, fill_v)
        rd = np.zeros((OA_R, OA_BR, 3), np.int32)
        rd[..., 0] = np.where(rng.random((OA_R, OA_BR)) < 0.5,
                              rng.choice(present, (OA_R, OA_BR)),
                              rng.integers(0, OA_KEYS, (OA_R, OA_BR)))
        batches.append(tuple(torch.from_numpy(a).to(dev) for a in (
            opc.reshape(OA_R, OA_BW), args.reshape(OA_R, OA_BW, 3),
            np.ones((OA_R, OA_BR), np.int32), rd)))
    model = {k: v.clone() for k, v in oa.oahashmap_model_view(
        planes, OA_N).items()}
    out = {}
    for name, step, states in (("pallas", k_step, planes),
                               ("scan", s_step, model)):
        lg, resps = log_init(spec, dev), []
        oa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            lg, states, wr, rdr = step(lg, states, *b)
            resps.append((wr, rdr))
        torch.cuda.synchronize()
        out[name] = (lg, states, resps, time.perf_counter() - t0,
                     oa.REPLAY_KERNEL.launches)
    launches = out["pallas"][4]
    if launches == 0:
        raise AssertionError("the K3 step path never launched K3")
    (lk, sk, rk), (ls, ss, rs) = out["pallas"][:3], out["scan"][:3]
    for f in lk._fields:
        if not torch.equal(getattr(lk, f), getattr(ls, f)):
            raise AssertionError(f"K3 step: log field {f} differs")
    view = oa.oahashmap_model_view(sk, OA_N)
    for k in names:
        if not torch.equal(view[k], ss[k]):
            raise AssertionError(f"K3 step: replica {k} differs")
    for i, (a, b) in enumerate(zip(rk, rs)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"K3 step: responses of step {i} differ")
    n_disp = steps * OA_R * (OA_BW + OA_BR)
    rates = {k: n_disp / v[3] for k, v in out.items()}
    log(f"phase 11: oahashmap R={OA_R} N={OA_N} probe={OA_PROBE}: "
        f"pre-fill of {OA_FILL} keys in {OA_FILL // OA_FILL_W} K3 launches "
        f"({fill_s:.2f} s, {int(dropped.sum())} dropped), every key read "
        f"back; {OA_BW}w+{OA_BR}r x {steps} steps from there: bit-identical;"
        f" dispatches/s (fenced) K3 step {rates['pallas']:.6g}, scan step "
        f"{rates['scan']:.6g}, on {card}; K3 launches {launches}")
    del out, model, ss, lk, ls
    # K3 alone against its plain version on that state, W = 4096: half
    # of the keys present, 17 keys sharing one home (a -2 at least) and
    # keys whose homes lie within `probe` of N (their windows wrap)
    W = OA_W
    opc_np, args_np = oa_window(rng, W, present, fill_v)
    crowd = oa_keys_with_homes([int(rng.integers(OA_N))], OA_PROBE + 1)
    wrap = oa_keys_with_homes(OA_N - 1 - np.arange(OA_PROBE // 2), 2)
    opc_np[:len(crowd)] = 1
    args_np[:len(crowd), 0] = crowd
    at = rng.choice(np.arange(len(crowd), W), len(wrap), replace=False)
    args_np[at, 0] = wrap
    opc = torch.from_numpy(opc_np).to(dev)
    args = torch.from_numpy(args_np).to(dev)
    call = (opc, args, *sk.values(), OA_N, OA_PROBE)
    got = oa.oahashmap_replay(*call)
    want = oa.oahashmap_replay_plain(*call)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    n_drop = int((want[3] == -2).sum())
    if n_drop == 0:
        raise AssertionError("the K3 window had no window-full drop")
    del got, want
    ms = cuda_ms(lambda: oa.oahashmap_replay(*call), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: oa.oahashmap_replay_plain(*call), reps=1)
    empty = (opc[:0], args[:0], *call[2:])
    copy_ms = cuda_ms(lambda: oa.oahashmap_replay(*empty), reps=5,
                      warmup=1)
    def k3_cost(w):
        """Bytes (the planes in and out, the window, the responses)
        and operations (per probe slot and replica: 2 loads, 2 tests)."""
        return 4 * (2 * 3 * OA_R * OA_N + 4 * w + w), 4 * OA_PROBE * OA_R * w

    n_bytes, n_ops = k3_cost(W)
    bound_ms, by = bound(n_bytes, n_ops)
    log(f"phase 11: K3 R={OA_R} N={OA_N} probe={OA_PROBE} W={W}: "
        f"bit-identical ({n_drop} window-full drops); kernel {ms:.4f} ms "
        f"(state copy alone {copy_ms:.4f} ms), plain {plain_ms:.2f} ms, "
        f"bound {bound_ms:.4f} ms ({n_bytes} bytes)")
    # at the step's window, W = 256: the shape the main path launches
    Ws = OA_R * OA_BW
    step_call = (opc[:Ws], args[:Ws], *call[2:])
    got = oa.oahashmap_replay(*step_call)
    want = oa.oahashmap_replay_plain(*step_call)
    torch.cuda.synchronize()
    err_s = max_abs_err(got, want)
    if err_s:
        raise AssertionError(f"K3 disagrees with its plain version at "
                             f"W={Ws}: {err_s}")
    del got, want
    ms_s = cuda_ms(lambda: oa.oahashmap_replay(*step_call), reps=10,
                   warmup=2)
    plain_ms_s = cuda_ms(lambda: oa.oahashmap_replay_plain(*step_call),
                         reps=1)
    dt = device_time(lambda: oa.oahashmap_replay(*step_call))
    bound_s, by_s = bound(*k3_cost(Ws))
    log(f"phase 11: K3 at the step's W={Ws}: bit-identical; kernel "
        f"{ms_s:.4f} ms, plain {plain_ms_s:.2f} ms, bound {bound_s:.4f} ms")
    log_device(f"phase 11: K3 at W={Ws}", dt)
    return {"fill_s": fill_s, "fill_dropped": int(dropped.sum()),
            "steps": steps, "dispatches": n_disp, "dispatches_per_s": rates,
            "launches": launches,
            "kernel": {"max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "copy_ms": copy_ms,
                       "drops": n_drop, "bytes": n_bytes, "ops": n_ops,
                       "bound_ms": bound_ms, "bound_by": by, "W": W,
                       "step_window": {"W": Ws, "ms": ms_s, **dt,
                                       "plain_ms": plain_ms_s,
                                       "bound_ms": bound_s,
                                       "bound_by": by_s}}}


# ------------------------------------------------------- serving path

SR_CLIENTS, SR_OPS = 8, 10_000   # `bench.py --serve` defaults
SV_RIDS, SV_CLIENTS, SV_PER = 8, 16, 1000   # the flagship served
SV_SLICE = K // SV_CLIENTS       # keys each client owns: 625
CRASH_KILL_AFTER = 2500          # the child's WAL fsyncs before SIGKILL
CRASH_SNAPSHOT_AT = 1500         # the child's acks before its snapshot
CRASH_DIR = Path(__file__).resolve().parent / ".chip_smoke_crash"


def child_cmd(flag: str, directory) -> list[str]:
    """The command line of this script's child `flag DIR`."""
    return [sys.executable, str(Path(__file__).resolve()), flag,
            str(directory)]


def serve_clients(fe, n_clients: int, per_client: int, op_of, check,
                  rid_of, retry=None, during=None, on_ack=None) -> dict:
    """Closed-loop client threads, as `bench.py --serve` drives them:
    each submits op i of its own, waits for the response, checks it and
    goes on (`call_with_retry` when `retry` is given). `during(c, i)`
    runs before op i, `on_ack(c, i, op, resp)` after its future
    resolved. Returns completions, attempts, errors, latencies, wall."""
    import random
    import threading

    from node_replication_torch.serve import ServeError, call_with_retry

    lock = threading.Lock()
    lat, errors, sheds = [], [], [0]
    done = [0] * n_clients

    def client(c):
        rng = random.Random(SEED + c)
        rid = rid_of(c)

        def on_shed(attempt, delay):
            with lock:
                sheds[0] += 1

        for i in range(per_client):
            if during is not None:
                during(c, i)
            op = op_of(c, i)
            t0 = time.perf_counter()
            try:
                if retry is None:
                    resp = fe.submit(op, rid=rid).result(timeout=300.0)
                else:
                    resp = call_with_retry(fe, op, rid=rid, policy=retry,
                                           rng=rng, on_shed=on_shed,
                                           timeout=300.0)
            except (ServeError, TimeoutError) as e:
                with lock:
                    errors.append(f"client {c} op {i}: "
                                  f"{type(e).__name__}: {e}")
                return
            dt = time.perf_counter() - t0
            err = check(c, i, resp)
            with lock:
                lat.append(dt)
                if err:
                    errors.append(err)
            if err:
                return
            done[c] += 1
            if on_ack is not None:
                on_ack(c, i, op, resp)

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"serve-client-{c}")
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("a client thread hung")
    completed = sum(done)
    ops = n_clients * per_client
    lat_ms = np.asarray(lat) * 1e3 if lat else np.zeros(1)
    return {"ops": ops, "completed": completed,
            "attempts": ops + sheds[0], "errors": errors[:10],
            "wall_s": wall, "acked_ops_per_s": completed / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99))}


def phase_seqreg_serve(dev) -> dict:
    """The seqreg serve verifier of `bench.py --serve`/`--chaos` on the
    card: 8 closed-loop clients, 10,000 fetch-and-set ops over 2
    replicas, every response the client's previous value; at pipeline
    depth 0 and 1, then under a serve-batch kill with failover and
    repair, then with a grow(1) mid-traffic."""
    from node_replication_torch import NodeReplicated
    from node_replication_torch.fault import (
        HEALTHY,
        FaultPlan,
        FaultSpec,
        ReplicaLifecycleManager,
        state_digest,
    )
    from node_replication_torch.models import SR_GET, SR_SET, make_seqreg
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import (
        RetryPolicy,
        ServeConfig,
        ServeFrontend,
    )

    per = SR_OPS // SR_CLIENTS

    def fleet():
        return NodeReplicated(make_seqreg(SR_CLIENTS), n_replicas=2,
                              log_entries=4096, gc_slack=256,
                              exec_window=256, device=dev)

    def cfg(**kw):
        return ServeConfig(queue_depth=256, batch_max_ops=64,
                           batch_linger_s=0.001, **kw)

    def op_of(c, i):
        return (SR_SET, c, i + 1)

    def check(c, i, resp):
        return (None if resp == i else
                f"client {c} op {i}: previous value {i} expected, got "
                f"{resp} (lost, duplicated or reordered)")

    def settle(name, fe, nr, r, extra=0):
        if r["errors"] or r["completed"] != r["ops"]:
            raise AssertionError(f"phase 12 {name}: {r['completed']} of "
                                 f"{r['ops']} ops; {r['errors']}")
        for c in range(SR_CLIENTS):
            for rid in fe.rids:
                got = fe.read((SR_GET, c), rid=rid)
                if got != per + extra:
                    raise AssertionError(f"phase 12 {name}: register {c} "
                                         f"reads {got} on replica {rid}")
        nr.sync()
        if not nr.replicas_equal():
            raise AssertionError(f"phase 12 {name}: replicas differ")

    out = {}
    reset_launch_counts()
    for depth in (0, 1):
        nr = fleet()
        with ServeFrontend(nr, cfg(pipeline_depth=depth)) as fe:
            r = serve_clients(fe, SR_CLIENTS, per, op_of, check,
                              lambda c: c % 2, retry=RetryPolicy())
            settle(f"depth {depth}", fe, nr, r)
        r["rounds"] = nr.stats()["exec_rounds"]
        out[f"depth{depth}"] = r
        log(f"phase 12: seqreg serve depth {depth}: {r['completed']} of "
            f"{r['ops']} ops, 0 lost/duplicated/reordered; "
            f"{r['acked_ops_per_s']:.1f} acked ops/s, p50 "
            f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms")
    # --chaos: replica 1's worker killed at its 21st batch, repaired
    nr = fleet()
    plan = FaultPlan([FaultSpec(site="serve-batch", action="raise", rid=1,
                                after=20, count=1)], seed=SEED)
    retry = RetryPolicy(max_attempts=16, base_backoff_s=0.001,
                        max_backoff_s=0.25)
    with ServeFrontend(nr, cfg(failover=True)) as fe:
        mgr = ReplicaLifecycleManager(nr, fe)
        with plan.armed():
            r = serve_clients(fe, SR_CLIENTS, per, op_of, check,
                              lambda c: c % 2, retry=retry)
        if not mgr.wait_idle(60):
            raise AssertionError("phase 12 chaos: repair did not settle")
        settle("chaos", fe, nr, r)
        states = mgr.health.states()
    availability = r["completed"] / r["attempts"]
    if not plan.fired or not mgr.repairs:
        raise AssertionError(f"phase 12 chaos: kill fired {plan.fired}, "
                             f"repairs {mgr.repairs}")
    if states.count(HEALTHY) != nr.n_replicas or availability != 1.0:
        raise AssertionError(f"phase 12 chaos: health {states}, "
                             f"availability {availability}")
    if state_digest(nr.states, 1) != state_digest(nr.states, 0):
        raise AssertionError("phase 12 chaos: the repaired replica is "
                             "not bit-identical")
    r.update(availability=availability,
             repair_ms=[x["duration_s"] * 1e3 for x in mgr.repairs],
             kills=len(plan.fired))
    out["chaos"] = r
    log(f"phase 12: seqreg chaos: serve-batch kill on replica 1 fired, "
        f"{len(mgr.repairs)} repair(s) in "
        f"{', '.join(f'{m:.1f}' for m in r['repair_ms'])} ms, availability "
        f"{availability}, repaired replica bit-identical; "
        f"{r['acked_ops_per_s']:.1f} acked ops/s, p99 {r['p99_ms']:.3f} ms")
    # grow(1) mid-traffic, then the newcomer serves every register
    nr = fleet()
    with ServeFrontend(nr, cfg()) as fe:
        def during(c, i):
            if c == 0 and i == per // 2:
                fe.grow(1)

        r = serve_clients(fe, SR_CLIENTS, per, op_of, check,
                          lambda c: c % 2, retry=RetryPolicy(),
                          during=during)
        if nr.n_replicas != 3:
            raise AssertionError("phase 12 grow: the fleet did not grow")
        for c in range(SR_CLIENTS):
            got = fe.call((SR_SET, c, per + 1), rid=2, timeout=60.0)
            if got != per:
                raise AssertionError(f"phase 12 grow: register {c} "
                                     f"answers {got} on the new replica")
        settle("grow", fe, nr, r, extra=1)
    out["grow"] = r
    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    log(f"phase 12: seqreg grow(1) mid-traffic: {r['completed']} of "
        f"{r['ops']} ops, nothing lost; the new replica serves every "
        f"register; kernel launches {out['launches']} (seqreg runs the "
        f"chain's torch ops)")
    return out


class HashmapModel:
    """One client's slice of the map: PUT answers 0, REMOVE 1 when the
    key was present (the floored `k % K`)."""

    def __init__(self):
        self.vals: dict[int, int] = {}

    def apply(self, op) -> int:
        slot = op[1] % K
        if op[0] == 1:
            self.vals[slot] = op[2]
            return 0
        return int(self.vals.pop(slot, None) is not None)


def hm_client_ops(rng, c: int, n: int) -> list[tuple]:
    """Client c's ops over its own 625 keys: 50/50 PUT/REMOVE, raw keys
    spread over [-2K, 3K) (disjoint under `k % K`)."""
    slots = c * SV_SLICE + rng.integers(0, SV_SLICE, n)
    raw = slots + K * rng.integers(-2, 3, n)
    kinds = rng.integers(1, 3, n)
    vals = rng.integers(1, 1 << 31, n)
    return [(1, int(k), int(v)) if o == 1 else (2, int(k))
            for o, k, v in zip(kinds, raw, vals)]


def read_back(fe, models, label: str, keys=None) -> int:
    """Every key of `keys` (default: all of every client's slice) read
    through `fe.read` against the models, key k from served rid k mod
    the rids' count: every rid's read path serves a share of the keys,
    and `check_fleet_state` holds every replica's whole state to the
    models (reading each key from every rid, 8x the reads, was cut for
    time)."""
    from node_replication_torch.models import HM_GET

    rids = list(fe.rids)
    n = 0
    for c, m in enumerate(models):
        for slot in (range(c * SV_SLICE, (c + 1) * SV_SLICE)
                     if keys is None else sorted(keys[c])):
            want = m.vals.get(slot, -1)
            rid = rids[slot % len(rids)]
            got = fe.read((HM_GET, slot), rid=rid)
            n += 1
            if got != want:
                raise AssertionError(f"{label}: key {slot} reads {got} "
                                     f"on replica {rid}, acked {want}")
    return n


def model_planes(models):
    values = np.zeros(K, np.int32)
    present = np.zeros(K, bool)
    for m in models:
        for slot, v in m.vals.items():
            values[slot] = v
            present[slot] = True
    return values, present


def check_fleet_state(nr, models, label: str) -> None:
    nr.sync()
    if not nr.replicas_equal():
        raise AssertionError(f"{label}: replicas differ")
    values, present = model_planes(models)
    if not (np.array_equal(nr.states["values"][0].cpu().numpy(), values)
            and np.array_equal(nr.states["present"][0].cpu().numpy(),
                               present)):
        raise AssertionError(f"{label}: state differs from the model")


def _acked_ops(directory: Path) -> list[list[tuple]]:
    """Each client's acked (op, response) pairs, whole lines only."""
    out = []
    for c in range(SV_CLIENTS):
        try:
            text = (directory / f"c{c}.txt").read_text()
        except FileNotFoundError:
            text = ""
        rows = [ln.split() for ln in text.split("\n")[:-1]]
        out.append([(tuple(int(x) for x in row[1:-1]), int(row[-1]))
                    for row in rows if len(row) >= 4])
    return out


def _chained(records, label: str) -> int:
    """The end of WAL records that chain from position 0; raises at a
    record applied twice or lost."""
    pos = 0
    for rec in records:
        if rec.pos != pos:
            raise AssertionError(f"{label}: WAL record at {rec.pos}, "
                                 f"expected {pos}: applied twice or lost")
        pos += rec.count
    return pos


def _replay_to(records, upto: int):
    """Phase 14's host model over WAL records up to position `upto` (a
    record boundary): per-client models, each client's (op, response)
    list, and per key the (record end, value after it) history."""
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    per_client = [[] for _ in range(SV_CLIENTS)]
    history: dict[int, list] = {}
    pos = 0
    for rec in records:
        if pos >= upto:
            break
        touched = set()
        for op in rec.ops():
            slot = op[1] % K
            c = slot // SV_SLICE
            op = (op[0], op[1], op[2]) if op[0] == 1 else op[:2]
            per_client[c].append((op, models[c].apply(op)))
            touched.add(slot)
        pos = rec.pos + rec.count
        for slot in touched:
            history.setdefault(slot, []).append(
                (pos, models[slot // SV_SLICE].vals.get(slot, -1)))
    if pos != upto:
        raise AssertionError(f"no WAL record boundary at {upto} "
                             f"(the WAL reaches {pos})")
    return models, per_client, history


def _value_at(history, slot: int, pos: int) -> int:
    """The value a GET of `slot` reads at record boundary `pos`."""
    import bisect

    h = history.get(slot, [])
    i = bisect.bisect_right([p for p, _ in h], pos) - 1
    return h[i][1] if i >= 0 else -1


def served_round_share(nr, models, rng, count) -> dict:
    """The device's share of a served round: 16 closed-loop clients, 24
    ops each, through a depth-0 frontend under `torch.profiler`; device
    time per round (all kernels, K1, the largest) against host wall, and
    K1's bound at the round's mean batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from node_replication_torch.serve import ServeConfig, ServeFrontend

    seg_ops = [hm_client_ops(rng, c, 24) for c in range(SV_CLIENTS)]

    def seg_check(c, i, resp):
        want = models[c].apply(seg_ops[c][i])
        return None if resp == want else f"profiled client {c} op {i}"

    with ServeFrontend(nr, ServeConfig(batch_max_ops=256,
                                       batch_linger_s=0.001),
                       rids=range(SV_RIDS)) as fe:
        c0 = count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)  # the tracer starts before the first launch
            seg = serve_clients(fe, SV_CLIENTS, 24,
                                lambda c, i: seg_ops[c][i], seg_check,
                                lambda c: c % SV_RIDS)
            torch.cuda.synchronize()
        rounds = max(1, count()["serve.batches"] - c0["serve.batches"])
    if seg["errors"]:
        raise AssertionError(f"phase 13 profiled run: {seg['errors']}")
    kernels = sorted(((e.self_device_time_total / 1e3 / rounds,
                       e.count / rounds, e.key[:60])
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    dev_ms = sum(k[0] for k in kernels)
    k1_ms = sum(k[0] for k in kernels if "hashmap_round" in k[2])
    wall_ms = seg["wall_s"] * 1e3 / rounds
    mean_batch = seg["completed"] / rounds
    k1_bound_ms, k1_bound_by = bound(
        k1_model_round_bytes(nr.n_replicas, mean_batch),
        4 * mean_batch * nr.n_replicas)
    share = {"R": nr.n_replicas, "rounds": rounds, "round_wall_ms": wall_ms,
             "mean_batch": mean_batch, "k1_bound_ms": k1_bound_ms,
             "k1_bound_by": k1_bound_by,
             "k1_ms": k1_ms or None, "device_ms": dev_ms or None,
             "device_busy": dev_ms / wall_ms if dev_ms else None,
             "kernels": [{"ms": m, "per_round": c, "name": n}
                         for m, c, n in kernels[:8]]}
    check_fleet_state(nr, models, "phase 13 profiled run")
    log(f"phase 13: a served round at R={nr.n_replicas} (profiled, "
        f"{rounds} rounds, mean batch {mean_batch:.2f}, K1 bound "
        f"{k1_bound_ms:.4f} ms): host wall {wall_ms:.4f} ms, device "
        + (f"{dev_ms:.4f} ms (K1 {k1_ms:.4f} ms), busy "
           f"{100 * share['device_busy']:.1f}%; per round "
           + ", ".join(f"{n[:40]} x{c:.2f} {m:.4f} ms"
                       for m, c, n in kernels[:6])
           if dev_ms else "not measured"))
    return share


def phase_hashmap_serve(dev, rng) -> dict:
    """The hashmap flagship (R = 4096, K = 10000, ring 2^16) served
    through `ServeFrontend` over 8 rids with the fused tier forced:
    every round one K1 launch. 16 closed-loop clients, 1000 ops each,
    at pipeline depth 0 and 1 (a grow(1) mid-run in the second)."""
    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    reg = get_registry()
    reg.enable()
    counters = ("nr.exec.engine.pallas_fused", "nr.exec.engine.fused_fallback",
                "serve.batches", "nr.exec.rounds")
    count = lambda: {n: reg.counter(n).value for n in counters}
    nr = NodeReplicated(make_hashmap(K), n_replicas=R, log_entries=1 << 16,
                        engine="pallas", device=dev)
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    out = {}
    reset_launch_counts()
    for depth in (0, 1):
        ops = [hm_client_ops(rng, c, SV_PER) for c in range(SV_CLIENTS)]
        touched = [set() for _ in range(SV_CLIENTS)]
        grown = {}

        def check(c, i, resp):
            want = models[c].apply(ops[c][i])
            touched[c].add(ops[c][i][1] % K)
            return (None if resp == want else
                    f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

        def during(c, i):
            if depth == 1 and c == 0 and i == SV_PER // 2:
                grown["launches"] = k1_launches()
                grown["rids"] = fe.grow(1)

        c0, l0 = count(), k1_launches()
        cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001,
                          pipeline_depth=depth)
        with ServeFrontend(nr, cfg, rids=range(SV_RIDS)) as fe:
            r = serve_clients(fe, SV_CLIENTS, SV_PER,
                              lambda c, i: ops[c][i], check,
                              lambda c: c % SV_RIDS, during=during)
            if r["errors"] or r["completed"] != r["ops"]:
                raise AssertionError(f"phase 13 depth {depth}: "
                                     f"{r['completed']} of {r['ops']} ops; "
                                     f"{r['errors']}")
            t0 = time.perf_counter()
            r["reads"] = read_back(fe, models, f"phase 13 depth {depth}",
                                   touched)
            r["read_s"] = time.perf_counter() - t0
            served = list(fe.rids)
        c1 = count()
        d = {n: c1[n] - c0[n] for n in counters}
        r.update(rounds=d["serve.batches"],
                 mean_batch=r["completed"] / max(1, d["serve.batches"]),
                 fused=d["nr.exec.engine.pallas_fused"],
                 fallback=d["nr.exec.engine.fused_fallback"],
                 chain_rounds=d["nr.exec.rounds"],
                 k1_launches=k1_launches() - l0, served=served)
        if not (r["fused"] == r["rounds"] == r["k1_launches"] > 0
                and r["fallback"] == 0):
            raise AssertionError(f"phase 13 depth {depth}: not every round "
                                 f"was K1: {d}, K1 launches "
                                 f"{r['k1_launches']}")
        check_fleet_state(nr, models, f"phase 13 depth {depth}")
        if depth == 1:
            if nr.n_replicas != R + 1 or nr._fused.spec.n_replicas != R + 1:
                raise AssertionError("phase 13: grow(1) did not rebuild K1 "
                                     "for R + 1")
            r["k1_after_grow"] = k1_launches() - grown["launches"]
            if r["k1_after_grow"] <= 0:
                raise AssertionError("phase 13: no K1 round after grow(1)")
        out[f"depth{depth}"] = r
        log(f"phase 13: hashmap served R={nr.n_replicas} K={K} rids "
            f"{SV_RIDS} depth {depth}: {r['completed']} ops acked, every "
            f"response equal to the client models; {r['rounds']} rounds "
            f"(mean batch {r['mean_batch']:.2f}), all K1 ({r['fused']} "
            f"fused, {r['fallback']} fallbacks, {r['k1_launches']} "
            f"launches" + (f", {r['k1_after_grow']} after grow(1) at "
                           f"R={R + 1}" if depth == 1 else "")
            + f"); {r['acked_ops_per_s']:.1f} acked ops/s, p50 "
            f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; "
            f"{r['reads']} reads from {len(served)} rids in "
            f"{r['read_s']:.1f} s; replicas equal and equal to the model")
        if depth == 0:
            out["round_share"] = served_round_share(nr, models, rng, count)
    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    if out["launches"]["hashmap_fused_round"] == 0:
        raise AssertionError("phase 13 never launched K1")
    log(f"phase 13: launches {out['launches']}")
    del nr
    torch.cuda.empty_cache()
    return out


def _crash_fleet_kwargs(dev) -> dict:
    return dict(n_replicas=R, log_entries=1 << 16, engine="pallas",
                device=dev)


def _crash_config(ServeConfig):
    return ServeConfig(batch_max_ops=256, batch_linger_s=0.001,
                       durability="batch")


def crash_child(directory: str) -> int:
    """`--crash-child DIR`: serve the phase-13 fleet with durable acks
    from `ServeFrontend.from_recovery(DIR)`, snapshot once mid-run, log
    every acked op to a side file after its future resolved, and die by
    SIGKILL at a WAL fsync (`FaultSpec(site="wal-fsync", action="kill")`)."""
    import threading

    import torch

    from node_replication_torch.durable import save_durable_snapshot
    from node_replication_torch.fault import FaultPlan, FaultSpec
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    acks = Path(directory) / "acks"
    acks.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 14)
    ops = [hm_client_ops(rng, c, 4 * SV_PER) for c in range(SV_CLIENTS)]
    files = [open(acks / f"c{c}.txt", "a") for c in range(SV_CLIENTS)]
    n_acked = [0]
    lock = threading.Lock()
    fe = ServeFrontend.from_recovery(
        directory, make_hashmap(K), _crash_config(ServeConfig),
        rids=range(SV_RIDS), nr_kwargs=_crash_fleet_kwargs("cuda"))

    def on_ack(c, i, op, resp):
        files[c].write(f"{i} {' '.join(map(str, op))} {resp}\n")
        files[c].flush()
        with lock:
            n_acked[0] += 1
            snap = n_acked[0] == CRASH_SNAPSHOT_AT
        if snap:
            save_durable_snapshot(fe.nr, directory)
            print(f"snapshot at tail {int(fe.nr.log.tail)}", flush=True)

    plan = FaultPlan([FaultSpec(site="wal-fsync", action="kill",
                                after=CRASH_KILL_AFTER)])
    with plan.armed():
        r = serve_clients(fe, SV_CLIENTS, 4 * SV_PER,
                          lambda c, i: ops[c][i], lambda c, i, resp: None,
                          lambda c: c % SV_RIDS, on_ack=on_ack)
    fe.close()
    for f in files:
        f.close()
    print(f"the kill never fired: {r['completed']} ops acked",
          file=sys.stderr)
    return 3


def phase_crash_recovery(dev) -> dict:
    """Phase 14: the child serves the flagship with durable acks and is
    SIGKILLed at a WAL fsync; the parent recovers the fleet on the card
    with `ServeFrontend.from_recovery` and holds it to the acks and to a
    numpy replay of the WAL."""
    import shutil
    import signal

    import torch

    from node_replication_torch.models import make_hashmap
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    shutil.rmtree(CRASH_DIR, ignore_errors=True)
    CRASH_DIR.mkdir()
    try:
        t0 = time.perf_counter()
        child = subprocess.run(child_cmd("--crash-child", CRASH_DIR),
                               capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"phase 14: the child exited {child.returncode}, not by "
                f"SIGKILL: {child.stdout[-2000:]} {child.stderr[-2000:]}")
        acked = _acked_ops(CRASH_DIR / "acks")
        n_acked = sum(map(len, acked))
        reset_launch_counts()
        t1 = time.perf_counter()
        fe = ServeFrontend.from_recovery(
            str(CRASH_DIR), make_hashmap(K), _crash_config(ServeConfig),
            rids=range(SV_RIDS), nr_kwargs=_crash_fleet_kwargs(dev))
        recover_s = time.perf_counter() - t1
        rep = fe.recovery_report
        nr = fe.nr
        launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                    "hashmap_fused_round": k1_launches()}
        if rep.snapshot is None or rep.wal_records == 0:
            raise AssertionError(f"phase 14: recovery used no snapshot or "
                                 f"replayed nothing: {rep}")
        if launches["hashmap_fused_round"] < rep.wal_records:
            raise AssertionError(f"phase 14: {rep.wal_records} records "
                                 f"replayed in {launches} K1 launches")
        # the WAL's records: they chain, and a numpy replay of them
        # from position 0 is the recovered state
        wal = nr.wal
        if wal.base != 0:
            raise AssertionError(f"phase 14: the WAL starts at {wal.base}")
        recs = list(wal.records(0))
        pos = _chained(recs, "phase 14")
        models, per_client, _ = _replay_to(recs, pos)
        if pos != rep.tail or int(nr.log.tail) != pos:
            raise AssertionError(f"phase 14: WAL ends at {pos}, the fleet "
                                 f"at {int(nr.log.tail)}")
        for c in range(SV_CLIENTS):
            n = len(acked[c])
            if per_client[c][:n] != acked[c] or len(per_client[c]) > n + 1:
                raise AssertionError(
                    f"phase 14: client {c}'s {n} acked ops are not the "
                    f"WAL's first {n} of its {len(per_client[c])}")
        check_fleet_state(nr, models, "phase 14")
        keys = [{op[1] % K for op, _ in acked[c]}
                for c in range(SV_CLIENTS)]
        t2 = time.perf_counter()
        reads = read_back(fe, models, "phase 14", keys)
        read_s = time.perf_counter() - t2
        fe.close()
        snap_bytes = os.path.getsize(rep.snapshot)
        out = {"child_s": child_s, "acked": n_acked, "tail": rep.tail,
               "snapshot_pos": rep.snapshot_pos,
               "snapshot_bytes": snap_bytes,
               "wal_records": rep.wal_records, "wal_ops": rep.wal_ops,
               "truncated_bytes": rep.wal_truncated_bytes,
               "recovery_s": rep.duration_s, "from_recovery_s": recover_s,
               "reads": reads, "read_s": read_s, "launches": launches}
        log(f"phase 14: child SIGKILLed at a WAL fsync after {n_acked} "
            f"acked ops ({child_s:.1f} s); recovered on the card from the "
            f"snapshot at {rep.snapshot_pos} ({snap_bytes} bytes) + "
            f"{rep.wal_records} WAL records ({rep.wal_ops} ops, "
            f"{rep.wal_truncated_bytes} torn bytes) in "
            f"{rep.duration_s:.3f} s (from_recovery {recover_s:.3f} s) to "
            f"tail {rep.tail}; every acked op in the WAL once and in "
            f"order, state equal to a numpy replay of the WAL, replicas "
            f"equal; {reads} reads of acked keys from {SV_RIDS} rids; "
            f"launches {launches}")
        del fe, nr
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(CRASH_DIR, ignore_errors=True)


# ------------------------------------------------------ CNR (multi-log)

CNR_L = 8              # logs: `benches/hashmap.py --cmp --logs` default
CNR_B = 512            # writes a log a step: 4096 a step, 1 per replica
CNR_STEPS = 16
CNR_ROUNDS, CNR_ROUND = 24, 256   # phase 16's batches
CNR_PROFILED = 4                  # phase 16's profiled batches
CNR_SV_PER = 250                  # phase 17's ops per client
# phase 18: `benches/stack.py`, `lockfree.py`, `nrfs.py --full` and
# `synthetic.py` widths at R = 16, batch 32 per replica
M_R, M_BW, M_STEPS = 16, 32, 8
M_CAP, M_KEYS = 1 << 16, 1 << 16
FS_FILES, FS_BLOCKS = 4096, 64
SYN = dict(n=200_000, cold_reads=20, cold_writes=5, hot_reads=2,
           hot_writes=1)


def cnr_mapper(opcode, args):
    """The flagship CNR LogMapper: key % 8. K is a multiple of 8, so the
    raw keys of one slot (`k % K`) share a log."""
    return args[0] % CNR_L


def _cnr_step_batches(rng, dev, steps):
    """`steps` LogMapper-partitioned flagship batches: 512 uniform keys
    of log l's congruence class a log, 50/50 PUT/REMOVE, and one GET a
    replica."""
    import torch

    out = []
    for _ in range(steps):
        keys = (np.arange(CNR_L)[:, None]
                + CNR_L * rng.integers(0, K // CNR_L, (CNR_L, CNR_B)))
        args = np.zeros((CNR_L, CNR_B, 3), np.int32)
        args[..., 0] = keys
        args[..., 1] = rng.integers(1, 1 << 31, (CNR_L, CNR_B))
        opc = rng.integers(1, 3, (CNR_L, CNR_B)).astype(np.int32)
        counts = np.full(CNR_L, CNR_B, np.int64)
        rd_opc = np.ones((R, 1), np.int32)
        rd_args = np.zeros((R, 1, 3), np.int32)
        rd_args[..., 0] = rng.integers(0, K, (R, 1))
        out.append(tuple(torch.from_numpy(a).to(dev) for a in
                         (opc, args, counts, rd_opc, rd_args)))
    return out


def phase_cnr_step(dev, rng) -> dict:
    """The CNR step path at the flagship widths: `make_multilog_step`
    over `make_partitioned_hashmap(10000, 8)` (every log's window one
    combined replay into its own partition) against the sequential fold
    on the monolithic `make_hashmap(10000)` and a numpy map; then what
    sets the partitioned step's pace. No kernel runs here."""
    import torch

    from node_replication_torch.core.multilog import (
        MultiLogSpec,
        make_multilog_step,
        multilog_init,
    )
    from node_replication_torch.core.replica import replicate_state
    from node_replication_torch.models import (
        make_hashmap,
        make_partitioned_hashmap,
    )

    pm = make_partitioned_hashmap(K, CNR_L)
    spec = MultiLogSpec(nlogs=CNR_L, capacity=1 << 12, n_replicas=R,
                        arg_width=3, gc_slack=512)
    steps = {"partitioned": make_multilog_step(pm.full, spec, CNR_B, 1,
                                               partitioned=pm),
             "fold": make_multilog_step(make_hashmap(K), spec, CNR_B, 1)}
    batches = _cnr_step_batches(rng, dev, CNR_STEPS)
    init = lambda: (multilog_init(spec, dev),  # noqa: E731
                    replicate_state(pm.full.init_state(dev), R))

    def run(step):
        ml, st = init()
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            ml, st, wr, rd = step(ml, st, *b)
            outs.append((wr, rd))
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return ml, st, outs, queued, time.perf_counter() - t0

    steps["partitioned"](*init(), *batches[0])  # warm the allocator
    res = {name: run(step) for name, step in steps.items()}
    (ml_p, st_p, out_p, q_p, t_p), (ml_f, st_f, out_f, _, t_f) = \
        res["partitioned"], res["fold"]
    for f in ml_p._fields:
        if not torch.equal(getattr(ml_p, f), getattr(ml_f, f)):
            raise AssertionError(f"phase 15: multilog field {f} differs")
    for f in ("values", "present"):
        if not torch.equal(st_p[f], st_f[f]):
            raise AssertionError(f"phase 15: states differ in {f}")
    values, present = np.zeros(K, np.int64), np.zeros(K, bool)
    for i, (b, (wr, rd), (wr_f, rd_f)) in enumerate(zip(batches, out_p,
                                                        out_f)):
        if not (torch.equal(wr, wr_f) and torch.equal(rd, rd_f)):
            raise AssertionError(f"phase 15: step {i} responses differ")
        opc, args = b[0].cpu().numpy(), b[1].cpu().numpy()
        want = np.zeros((CNR_L, CNR_B), np.int64)
        for l in range(CNR_L):
            for j in range(CNR_B):
                k = args[l, j, 0]
                if opc[l, j] == 1:
                    values[k], present[k] = args[l, j, 1], True
                else:
                    want[l, j] = present[k]
                    values[k], present[k] = 0, False
        wr_np = wr.cpu().numpy()
        if not (wr_np == want[:, None, :]).all():
            raise AssertionError(f"phase 15: step {i} write responses "
                                 f"differ from the numpy map")
        rk = b[4][:, 0, 0].cpu().numpy()
        if not np.array_equal(rd.cpu().numpy()[:, 0],
                              np.where(present[rk], values[rk], -1)):
            raise AssertionError(f"phase 15: step {i} reads differ from "
                                 f"the numpy map")
    if not (np.array_equal(st_p["values"][0].cpu().numpy(), values)
            and np.array_equal(st_p["present"][0].cpu().numpy(), present)
            and (st_p["values"] == st_p["values"][0:1]).all()):
        raise AssertionError("phase 15: final state differs from the "
                             "numpy map")
    n_disp = CNR_STEPS * (CNR_L * CNR_B + R)
    kernels = device_kernels(lambda: run(steps["partitioned"]), CNR_STEPS)
    dev_ms = sum(k[0] for k in kernels)
    wall_ms = t_p / CNR_STEPS * 1e3
    out = {"steps": CNR_STEPS, "L": CNR_L, "B": CNR_B, "R": R, "K": K,
           "dispatches": n_disp,
           "partitioned_dispatches_per_s": n_disp / t_p,
           "fold_dispatches_per_s": n_disp / t_f,
           "enqueue_ms": q_p / CNR_STEPS * 1e3, "wall_ms": wall_ms,
           "device_ms": dev_ms or None,
           "idle_share": 1 - dev_ms / wall_ms if dev_ms else None,
           "kernels": [{"ms": m, "per_step": c, "name": n[:80]}
                       for m, c, n in kernels[:8]],
           "tail": int(ml_p.tail[0]), "launches": {}}
    log(f"phase 15: CNR step R={R} K={K} L={CNR_L} {CNR_B} writes a log "
        f"+ 1 read a replica x {CNR_STEPS} steps (ring {spec.capacity}, "
        f"tail {out['tail']}): partitioned bit-identical to the fold and "
        f"to a numpy map; partitioned {n_disp / t_p:.6g} dispatches/s, "
        f"fold {n_disp / t_f:.6g} dispatches/s (fenced); partitioned "
        f"step: host enqueues it in {out['enqueue_ms']:.4f} ms, wall "
        f"{wall_ms:.4f} ms, device "
        + (f"{dev_ms:.4f} ms, idle {100 * out['idle_share']:.1f}%; top "
           + ", ".join(f"{n[:40]} x{c:g} {m:.4f} ms"
                       for m, c, n in kernels[:5])
           if dev_ms else "not measured")
        + "; no kernel of this package runs here (plain PyTorch ops)")
    del res, ml_p, st_p, ml_f, st_f, out_p, out_f
    return out


def _cnr_round_ops(rng, n):
    keys = rng.integers(0, K, n)
    kinds = rng.integers(1, 3, n)
    vals = rng.integers(1, 1 << 31, n)
    return [(1, int(k), int(v)) if o == 1 else (2, int(k))
            for o, k, v in zip(kinds, keys, vals)]


def _pads(ops):
    """The per-log windows K1 runs for one batch: its sub-batch sizes
    rounded up to a power of two."""
    sizes = np.bincount([cnr_mapper(o[0], o[1:]) % CNR_L for o in ops],
                        minlength=CNR_L)
    return [1 << (int(n) - 1).bit_length() for n in sizes if n]


def _apply_model(model, ops):
    want = []
    for op in ops:
        if op[0] == 1:
            model[op[1] % K] = op[2]
            want.append(0)
        else:
            want.append(int(model.pop(op[1] % K, None) is not None))
    return want


def _k1_at_cnr_windows(dev, rng) -> dict:
    """K1 over the states against its plain version at the per-log
    windows of phase 16 (W = 32 and 64, R = 4096, a ring of 2^16
    wrapping in the window)."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    kp = -(-K // 8) * 8
    spec = LogSpec(capacity=1 << 16, n_replicas=R, arg_width=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    states = planes_to_states(*random_planes(gen, dev, kp))
    ring = (torch.zeros(spec.capacity, dtype=torch.int32, device=dev),
            torch.zeros((spec.capacity, 3), dtype=torch.int32, device=dev))
    out = {}
    for W in (32, 64):
        count = W - 3
        opc = np.zeros(W, np.int32)
        opc[:count] = rng.integers(1, 3, count)
        args = np.zeros((W, 3), np.int32)
        args[:count, 0] = CNR_L * rng.integers(0, K // CNR_L, count) + 3
        args[:count, 1] = rng.integers(1, 1 << 31, count)
        inputs = (spec, torch.tensor(spec.capacity - 7, dtype=torch.int64,
                                     device=dev), count,
                  torch.from_numpy(opc).to(dev),
                  torch.from_numpy(args).to(dev), *ring, *states, K)
        err = max_abs_err(k1(*inputs), k1_plain(*inputs))
        if err:
            raise AssertionError(f"phase 16: K1 at W={W} disagrees with "
                                 f"its plain version: {err}")
        out[W] = {"max_abs_err": err,
                  "ms": cuda_ms(lambda: k1(*inputs), 10),
                  "plain_ms": cuda_ms(lambda: k1_plain(*inputs), 3)}
    log(f"phase 16: K1 at the per-log windows R={R}: " + ", ".join(
        f"W={W} bit-identical, kernel {c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.2f} ms" for W, c in out.items()))
    return out


def phase_cnr_rounds(dev, rng):
    """`MultiLogReplicated` over the flagship hashmap (L = 8, R = 4096,
    ring 2^16) with `engine="pallas"` against `engine="scan"`: batches
    of 256 ops from rotating rids, every per-log sub-batch one K1 launch
    on its log's row of the stacked ring, against a dict; the last few
    batches profiled. Returns the result and the K1 fleet, which phase
    17 serves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from node_replication_torch import MultiLogReplicated
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )

    check = _k1_at_cnr_windows(dev, rng)
    torch.cuda.empty_cache()

    def fleet(engine):
        return MultiLogReplicated(make_hashmap(K), cnr_mapper, nlogs=CNR_L,
                                  n_replicas=R, log_entries=1 << 16,
                                  engine=engine, device=dev)

    n = CNR_ROUNDS + 1 + CNR_PROFILED  # one batch warms the tracer up
    batches = [((i * 517) % R, _cnr_round_ops(rng, CNR_ROUND))
               for i in range(n)]
    model: dict[int, int] = {}
    reset_launch_counts()
    k1, scan = fleet("pallas"), fleet("scan")
    lat = {"pallas": [], "scan": []}
    for i, (rid, ops) in enumerate(batches[:CNR_ROUNDS]):
        want = _apply_model(model, ops)
        got = {}
        for name, f in (("pallas", k1), ("scan", scan)):
            t0 = time.perf_counter()
            got[name] = f.execute_mut_batch(ops, rid)
            lat[name].append(time.perf_counter() - t0)
        if not got["pallas"] == got["scan"] == want:
            raise AssertionError(f"phase 16: batch {i} responses differ")
    # the first profiled batch is the tracer's warm-up step, traced and
    # left out; the profiler records the CNR_PROFILED batches after it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        rid, ops = batches[CNR_ROUNDS]
        got_k = [k1.execute_mut_batch(ops, rid)]
        torch.cuda.synchronize()
        prof.step()
        # the active step starts before the first launch (a launch
        # right after the step can land in the warm-up's discard)
        time.sleep(0.05)
        f0 = k1.stats()["fused_rounds"]
        got_k += [k1.execute_mut_batch(ops, rid)
                  for rid, ops in batches[CNR_ROUNDS + 1:]]
        torch.cuda.synchronize()
    prof_rounds = k1.stats()["fused_rounds"] - f0
    for (rid, ops), g in zip(batches[CNR_ROUNDS:], got_k):
        want = _apply_model(model, ops)
        if not g == scan.execute_mut_batch(ops, rid) == want:
            raise AssertionError("phase 16: a profiled batch differs")
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    k1.sync()
    scan.sync()
    st, ss = k1.stats(), scan.stats()
    if not (st["exec_rounds"] == 0 and st["fused_rounds"]
            == sum(st["combine_rounds"])
            == launches["hashmap_fused_round"] > 0):
        raise AssertionError(f"phase 16: not every per-log sub-batch was "
                             f"one K1 launch: {st}, launches {launches}")
    if ss["fused_rounds"] != 0 or st["tails"] != ss["tails"]:
        raise AssertionError(f"phase 16: the scan fleet {ss}")
    for f in k1.ml._fields:
        if not torch.equal(getattr(k1.ml, f), getattr(scan.ml, f)):
            raise AssertionError(f"phase 16: multilog field {f} differs")
    for f in ("values", "present"):
        if not torch.equal(k1.states[f], scan.states[f]):
            raise AssertionError(f"phase 16: states differ in {f}")
    if not k1.replicas_equal():
        raise AssertionError("phase 16: replicas differ")
    values, present = np.zeros(K, np.int32), np.zeros(K, bool)
    for k, v in model.items():
        values[k], present[k] = v, True
    if not (np.array_equal(k1.states["values"][0].cpu().numpy(), values)
            and np.array_equal(k1.states["present"][0].cpu().numpy(),
                               present)):
        raise AssertionError("phase 16: state differs from the dict")
    # the profiled batches: K1 kernels counted by the tracer (exactly
    # one a per-log round), device time per per-log round, and the
    # bound at each round's window
    # (the schedule's `ProfilerStep#` range spans the kernels it holds:
    # it is no kernel and is left out)
    k1_ev = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("ProfilerStep")]
    k1_count = sum(e.count for e in k1_ev if "hashmap_round" in e.key)
    if k1_count != prof_rounds:
        raise AssertionError(f"phase 16: the profiler saw {k1_count} K1 "
                             f"launches in {prof_rounds} fused rounds")
    k1_ms = sum(e.self_device_time_total for e in k1_ev
                if "hashmap_round" in e.key) / 1e3 / k1_count
    dev_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3 / prof_rounds
    pads = [p for _, ops in batches[CNR_ROUNDS + 1:] for p in _pads(ops)]
    mean_w = statistics.mean(pads)
    bound_ms, by = bound(k1_model_round_bytes(R, mean_w), 4 * mean_w * R)
    top = sorted(((e.self_device_time_total / 1e3 / prof_rounds,
                   e.count / prof_rounds, e.key[:60]) for e in k1_ev),
                 reverse=True)[:6]
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in lat.items()}
    out = {"rounds": n, "ops_per_round": CNR_ROUND, "R": R, "K": K,
           "L": CNR_L, "per_log_rounds": st["fused_rounds"],
           "launches": launches, "round_ms": med, "k1_check": check,
           "profiled_rounds": prof_rounds, "profiled_k1": k1_count,
           "mean_window": mean_w,
           "k1_device_ms": k1_ms, "device_ms": dev_ms,
           "bound_ms": bound_ms, "bound_by": by,
           "kernels": [{"ms": m, "per_round": c, "name": k}
                       for m, c, k in top]}
    log(f"phase 16: MultiLogReplicated R={R} K={K} L={CNR_L} ring 2^16: "
        f"{n} batches of {CNR_ROUND} ops from rotating rids, pallas and "
        f"scan bit-identical (responses, rings, cursors, states) and "
        f"equal to a dict; {st['fused_rounds']} per-log rounds, each one "
        f"K1 launch ({launches['hashmap_fused_round']} launches, "
        f"0 exec rounds); batch latency (median, fenced by the response "
        f"readbacks) pallas {med['pallas']:.3f} ms, scan "
        f"{med['scan']:.3f} ms")
    log(f"phase 16: profiled {CNR_PROFILED} batches: {k1_count} K1 "
        f"kernels seen by the profiler for {prof_rounds} per-log rounds "
        f"(mean window {mean_w:.2f}); K1 {k1_ms:.4f} ms a launch against a "
        f"bound of {bound_ms:.4f} ms; all device time a per-log round "
        f"{dev_ms:.4f} ms: "
        + ", ".join(f"{k[:40]} x{c:.2f} {m:.4f} ms" for m, c, k in top))
    del scan
    torch.cuda.empty_cache()
    return out, k1


def phase_cnr_serve(dev, rng, k1) -> dict:
    """Phase 16's K1 fleet behind `ServeFrontend` on rids 0-7
    (batch_max_ops 256): 16 closed-loop clients of 250 ops, 50/50
    PUT/REMOVE, each on its own 625 keys; every answer against a dict
    seeded from the fleet, every touched key read back from every rid;
    then a profiled segment: device time per round against host wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    reg = get_registry()
    reg.enable()
    count = lambda: reg.counter("serve.batches").value  # noqa: E731
    values = k1.states["values"][0].cpu().numpy()
    present = k1.states["present"][0].cpu().numpy()
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    for c, m in enumerate(models):
        for slot in range(c * SV_SLICE, (c + 1) * SV_SLICE):
            if present[slot]:
                m.vals[slot] = int(values[slot])
    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001)
    out = {}
    reset_launch_counts()
    for seg, per in (("serve", CNR_SV_PER), ("profiled", 16)):
        ops = [hm_client_ops(rng, c, per) for c in range(SV_CLIENTS)]
        touched = [set() for _ in range(SV_CLIENTS)]

        def check(c, i, resp):
            want = models[c].apply(ops[c][i])
            touched[c].add(ops[c][i][1] % K)
            return (None if resp == want else
                    f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

        b0, l0, f0 = count(), k1_launches(), \
            k1.stats()["fused_rounds"]
        with ServeFrontend(k1, cfg, rids=range(SV_RIDS)) as fe:
            if seg == "profiled":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    time.sleep(0.05)
                    r = serve_clients(fe, SV_CLIENTS, per,
                                      lambda c, i: ops[c][i], check,
                                      lambda c: c % SV_RIDS)
                    torch.cuda.synchronize()
            else:
                r = serve_clients(fe, SV_CLIENTS, per,
                                  lambda c, i: ops[c][i], check,
                                  lambda c: c % SV_RIDS)
            if r["errors"] or r["completed"] != r["ops"]:
                raise AssertionError(f"phase 17 {seg}: {r['completed']} of "
                                     f"{r['ops']} ops; {r['errors']}")
            t0 = time.perf_counter()
            # each touched key from a rid the client did not write on:
            # the read syncs the key's own log only
            r["reads"] = 0
            for c, m in enumerate(models):
                rid = (c + 1) % SV_RIDS
                for slot in sorted(touched[c]):
                    got = fe.read((1, slot), rid=rid)
                    r["reads"] += 1
                    if got != m.vals.get(slot, -1):
                        raise AssertionError(
                            f"phase 17 {seg}: key {slot} reads {got} on "
                            f"replica {rid}, acked {m.vals.get(slot, -1)}")
            r["read_s"] = time.perf_counter() - t0
        st = k1.stats()
        r.update(rounds=count() - b0,
                 k1_launches=k1_launches() - l0,
                 fused=st["fused_rounds"] - f0,
                 exec_rounds=st["exec_rounds"])
        r["mean_batch"] = r["completed"] / max(1, r["rounds"])
        r["k1_per_round"] = r["k1_launches"] / max(1, r["rounds"])
        if not (r["k1_launches"] == r["fused"] > 0
                and r["exec_rounds"] == 0):
            raise AssertionError(f"phase 17 {seg}: not every per-log round "
                                 f"was K1: {r}")
        check_fleet_state(k1, models, f"phase 17 {seg}")
        out[seg] = r
    p = out["profiled"]
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rounds = max(1, p["rounds"])
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / rounds
    k1_ev = [e for e in ev if "hashmap_round" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3 / rounds
    k1_n = sum(e.count for e in k1_ev)
    # K1 a launch, and its bound at the mean per-log sub-batch (ops a
    # K1 launch, from the wrapper's count)
    k1_launch_ms = (sum(e.self_device_time_total for e in k1_ev) / 1e3
                    / k1_n if k1_n else None)
    sub_w = p["completed"] / max(1, p["k1_launches"])
    k1_bound_ms, k1_by = bound(k1_model_round_bytes(R, sub_w),
                               4 * sub_w * R)
    wall_ms = p["wall_s"] * 1e3 / rounds
    p.update(round_wall_ms=wall_ms, device_ms=dev_ms or None,
             k1_ms=k1_ms or None, k1_launch_ms=k1_launch_ms,
             k1_profiled=k1_n, mean_sub_batch=sub_w,
             k1_bound_ms=k1_bound_ms, k1_bound_by=k1_by,
             device_busy=dev_ms / wall_ms if dev_ms else None)
    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    s = out["serve"]
    log(f"phase 17: CNR served R={R} K={K} L={CNR_L} rids {SV_RIDS}: "
        f"{s['completed']} ops acked by {SV_CLIENTS} clients, every "
        f"response equal to the client dicts, 0 lost, duplicated or "
        f"reordered; {s['acked_ops_per_s']:.1f} acked ops/s, p50 "
        f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms; {s['rounds']} "
        f"rounds (mean batch {s['mean_batch']:.2f}), "
        f"{s['k1_per_round']:.2f} K1 launches a round, 0 exec rounds; "
        f"{s['reads']} reads of the touched keys from other rids in "
        f"{s['read_s']:.1f} s; replicas equal and equal to the dicts")
    log(f"phase 17: profiled segment, {p['rounds']} rounds "
        f"({p['k1_per_round']:.2f} K1 a round): host wall "
        f"{wall_ms:.4f} ms a round, device "
        + (f"{dev_ms:.4f} ms (K1 {k1_ms:.4f} ms), busy "
           f"{100 * p['device_busy']:.1f}%" if dev_ms else "not measured")
        + "; K1 "
        + (f"{k1_launch_ms:.4f} ms a launch ({k1_n} seen by the profiler)"
           if k1_n else "not measured")
        + f" against a bound of {k1_bound_ms:.4f} ms at the mean per-log "
        f"sub-batch of {sub_w:.2f} ops; launches {out['launches']}")
    return out


def _syn_mix(x):
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) \
        & np.uint64(0xFFFFFFFF)
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) \
        & np.uint64(0xFFFFFFFF)
    return x ^ (x >> np.uint64(16))


def _syn_lines(seed, count, n, salt):
    x = (np.uint64(seed & 0xFFFFFFFF)
         + np.uint64((salt * 0x9E3779B9) & 0xFFFFFFFF)
         + np.arange(count, dtype=np.uint64)) & np.uint64(0xFFFFFFFF)
    return (_syn_mix(x) % np.uint64(n)).astype(np.int64)


class SyntheticModel:
    """numpy twin of `models/synthetic.py` (one replica)."""

    def __init__(self, n, cold_reads, cold_writes, hot_reads, hot_writes,
                 hot_set=1024):
        self.lines = np.zeros(n, np.int64)
        self.n, self.hot = n, min(hot_set, n)
        self.cr, self.cw, self.hr, self.hw = (cold_reads, cold_writes,
                                              hot_reads, hot_writes)

    def _sum(self, seed):
        idx = np.concatenate([_syn_lines(seed, self.cr, self.n, 1),
                              _syn_lines(seed, self.hr, self.hot, 2)])
        return int(self.lines[idx].sum())

    @staticmethod
    def _i32(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    def write(self, seed):
        s = self._sum(seed)
        idx = np.concatenate([_syn_lines(seed, self.cw, self.n, 3),
                              _syn_lines(seed, self.hw, self.hot, 4)])
        np.add.at(self.lines, idx, self._i32(seed + s))
        self.lines = self._i32(self.lines)
        return self._i32(s)

    def read(self, seed):
        return self._i32(self._sum(seed))


def _m_batches(rng, dev, wr_of, rd_of):
    import torch

    out = []
    for _ in range(M_STEPS):
        wo, wa = wr_of(rng, (M_R, M_BW))
        ro, ra = rd_of(rng, (M_R, 1))
        out.append(tuple(torch.from_numpy(a).to(dev)
                         for a in (wo, wa, ro, ra)))
    return out


def _args(*cols):
    a = np.zeros(cols[0].shape + (3,), np.int32)
    for i, c in enumerate(cols):
        a[..., i] = c
    return a


def _run_steps(step, spec, d, dev, batches):
    import torch

    from node_replication_torch import log_init
    from node_replication_torch.core.replica import replicate_state

    lg, st = log_init(spec, dev), replicate_state(d.init_state(dev), M_R)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        lg, st, wr, rd = step(lg, st, *b)
        outs.append((wr, rd))
    torch.cuda.synchronize()
    return lg, st, outs, time.perf_counter() - t0


def _combined_vs_scan(name, d, dev, batches, model_check) -> dict:
    """`make_step(combined=True)` against `make_step(combined=False)` on
    the same batches: logs, states and every response equal; then
    `model_check(batches, outs, state0)` against a host model."""
    import torch

    from node_replication_torch import LogSpec, make_step

    spec = LogSpec(capacity=1 << 14, n_replicas=M_R, arg_width=3,
                   gc_slack=M_R * M_BW)
    res = {c: _run_steps(make_step(d, spec, M_BW, 1, combined=c), spec, d,
                         dev, batches) for c in (True, False)}
    (lc, sc, oc, tc), (ls, ss, os_, ts) = res[True], res[False]
    for f in lc._fields:
        if not torch.equal(getattr(lc, f), getattr(ls, f)):
            raise AssertionError(f"phase 18 {name}: log field {f} differs")
    for f in sc:
        if not torch.equal(sc[f], ss[f]):
            raise AssertionError(f"phase 18 {name}: states differ in {f}")
        if not (sc[f] == sc[f][0:1]).all():
            raise AssertionError(f"phase 18 {name}: replicas differ")
    for i, (a, b) in enumerate(zip(oc, os_)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"phase 18 {name}: step {i} responses "
                                 f"differ")
    model_check(batches, oc, {f: v[0].cpu().numpy() for f, v in sc.items()})
    n_disp = len(batches) * M_R * (M_BW + 1)
    return {"combined_dispatches_per_s": n_disp / tc,
            "scan_dispatches_per_s": n_disp / ts, "steps": len(batches)}


def _fold_check(name, apply, read, final):
    """A host-model check of a step path: the window is the [R, Bw]
    batch in replica-major order, every replica answers its own ops."""
    def check(batches, outs, state0):
        for i, (b, (wr, rd)) in enumerate(zip(batches, outs)):
            wo, wa = b[0].cpu().numpy(), b[1].cpu().numpy()
            want = np.array([[apply(int(wo[r, j]), wa[r, j])
                              for j in range(M_BW)] for r in range(M_R)])
            if not np.array_equal(wr.cpu().numpy(), want):
                raise AssertionError(f"phase 18 {name}: step {i} write "
                                     f"responses differ from the model")
            ro, ra = b[2].cpu().numpy(), b[3].cpu().numpy()
            want = np.array([[read(int(ro[r, 0]), ra[r, 0])]
                             for r in range(M_R)])
            if not np.array_equal(rd.cpu().numpy(), want):
                raise AssertionError(f"phase 18 {name}: step {i} reads "
                                     f"differ from the model")
        final(state0)
    return check


def phase_models(dev, rng) -> dict:
    """The other models on the card, no kernel among them: the stack and
    the queue at `benches/stack.py`'s capacity 2^16, the sorted set at
    2^16 keys and synthetic at `benches/synthetic.py`'s costs, each
    combined step (or, for synthetic, its only step, the scan) against
    the scan step and a host model; memfs at `benches/nrfs.py --full`
    widths through the CNR step (`make_partitioned_memfs(4096, 64, 8)`)
    against the sequential fold. R = 16, 32 writes a replica a step."""
    import torch

    from node_replication_torch import LogSpec, make_step
    from node_replication_torch.core.multilog import (
        MultiLogSpec,
        make_multilog_step,
        multilog_init,
        partition_ops,
    )
    from node_replication_torch.core.replica import replicate_state
    from node_replication_torch.models import (
        make_memfs,
        make_partitioned_memfs,
        make_queue,
        make_sortedset,
        make_stack,
        make_synthetic,
    )

    out = {}
    t0 = time.perf_counter()
    push_pop = lambda r, s: (r.integers(1, 3, s).astype(np.int32),  # noqa
                             _args(r.integers(1, 1 << 31, s)))
    peek_len = lambda r, s: (r.integers(1, 3, s).astype(np.int32),  # noqa
                             _args(np.zeros(s)))

    # stack: a Python list
    stack: list[int] = []

    def st_apply(o, a):
        if o == 1:
            if len(stack) >= M_CAP:
                return -1
            stack.append(int(a[0]))
            return len(stack)
        return stack.pop() if stack else -1

    def st_read(o, a):
        return (stack[-1] if stack else -1) if o == 1 else len(stack)

    def st_final(s):
        if int(s["top"]) != len(stack) or list(
                s["buf"][:len(stack)]) != stack:
            raise AssertionError("phase 18 stack: state differs")

    out["stack"] = _combined_vs_scan(
        "stack", make_stack(M_CAP), dev, _m_batches(rng, dev, push_pop,
                                                    peek_len),
        _fold_check("stack", st_apply, st_read, st_final))

    # queue: a deque
    from collections import deque

    q: deque = deque()

    def q_apply(o, a):
        if o == 1:
            if len(q) >= M_CAP:
                return -1
            q.append(int(a[0]))
            return len(q)
        return q.popleft() if q else -1

    def q_read(o, a):
        return (q[0] if q else -1) if o == 1 else len(q)

    def q_final(s):
        n = int(s["tail"]) - int(s["head"])
        idx = (int(s["head"]) + np.arange(n)) % M_CAP
        if n != len(q) or list(s["buf"][idx]) != list(q):
            raise AssertionError("phase 18 queue: state differs")

    out["queue"] = _combined_vs_scan(
        "queue", make_queue(M_CAP), dev, _m_batches(rng, dev, push_pop,
                                                    peek_len),
        _fold_check("queue", q_apply, q_read, q_final))

    # sorted set: a Python set, 80% writes as `benches/lockfree.py`
    present: set[int] = set()

    def ss_apply(o, a):
        k = int(a[0]) % M_KEYS
        was = k in present
        if o == 1:
            present.add(k)
            return int(not was)
        present.discard(k)
        return int(was)

    def ss_read(o, a):
        if o == 1:
            return int(int(a[0]) % M_KEYS in present)
        if o == 2:
            return sum(1 for k in present if a[0] <= k < a[1])
        return sum(1 for k in present if k < a[0])

    def ss_final(s):
        if set(np.nonzero(s["present"])[0].tolist()) != present:
            raise AssertionError("phase 18 sortedset: state differs")

    ss_wr = lambda r, s: (r.integers(1, 3, s).astype(np.int32),  # noqa
                          _args(r.integers(0, M_KEYS, s)))
    ss_rd = lambda r, s: (r.integers(1, 4, s).astype(np.int32),  # noqa
                          _args(r.integers(0, M_KEYS, s),
                                r.integers(0, M_KEYS, s)))
    out["sortedset"] = _combined_vs_scan(
        "sortedset", make_sortedset(M_KEYS), dev,
        _m_batches(rng, dev, ss_wr, ss_rd),
        _fold_check("sortedset", ss_apply, ss_read, ss_final))

    # synthetic: the scan step (its only tier) against a numpy twin
    syn = make_synthetic(**SYN)
    sm = SyntheticModel(**SYN)
    spec = LogSpec(capacity=1 << 14, n_replicas=M_R, arg_width=3,
                   gc_slack=M_R * M_BW)
    seeds = lambda r, s: (np.ones(s, np.int32),  # noqa: E731
                          _args(r.integers(-(1 << 31), 1 << 31, s)))
    batches = _m_batches(rng, dev, seeds, seeds)
    _, st, outs, ts = _run_steps(make_step(syn, spec, M_BW, 1), spec, syn,
                                 dev, batches)

    def syn_final(s):
        if not np.array_equal(s["lines"].astype(np.int64), sm.lines):
            raise AssertionError("phase 18 synthetic: state differs")

    _fold_check("synthetic", lambda o, a: sm.write(int(a[0])),
                lambda o, a: sm.read(int(a[0])), syn_final)(
        batches, outs, {f: v[0].cpu().numpy() for f, v in st.items()})
    if not (st["lines"] == st["lines"][0:1]).all():
        raise AssertionError("phase 18 synthetic: replicas differ")
    out["synthetic"] = {"scan_dispatches_per_s":
                        len(batches) * M_R * (M_BW + 1) / ts}

    # memfs through the CNR step: partitioned against the fold
    L = CNR_L
    pm = make_partitioned_memfs(FS_FILES, FS_BLOCKS, L)
    mspec = MultiLogSpec(nlogs=L, capacity=1 << 12, n_replicas=M_R,
                         arg_width=3, gc_slack=512)
    step_ops = []
    for _ in range(M_STEPS):
        n = M_R * M_BW
        fd = rng.integers(0, FS_FILES, n)
        blk = rng.integers(0, FS_BLOCKS, n)
        kinds = rng.choice([1, 3], n)  # nrfs: WRITE, READ_LOGGED
        step_ops.append([(int(o), (int(f), int(b), int(b) + 1))
                         for o, f, b in zip(kinds, fd, blk)])
    # the step's static per-log batch: the busiest log's bucket
    B = max(int(np.bincount([o[1][0] % L for o in ops], minlength=L).max())
            for ops in step_ops)
    steps = {"partitioned": make_multilog_step(pm.full, mspec, B, 1,
                                               partitioned=pm),
             "fold": make_multilog_step(make_memfs(FS_FILES, FS_BLOCKS),
                                        mspec, B, 1)}
    fs_batches = []
    for ops in step_ops:
        opc, args, counts, _ = partition_ops(cnr_mapper, L, ops, 3,
                                             pad_to=B, device=dev)
        rd = np.zeros((M_R, 1, 3), np.int32)
        rd[..., 0] = rng.integers(0, FS_FILES, (M_R, 1))
        rd[..., 1] = rng.integers(0, FS_BLOCKS, (M_R, 1))
        fs_batches.append((opc, args, counts,
                           torch.full((M_R, 1), 2, dtype=torch.int32,
                                      device=dev),  # FS_SIZE, as nrfs
                           torch.from_numpy(rd).to(dev)))
    res = {}
    for name, step in steps.items():
        ml = multilog_init(mspec, dev)
        st = replicate_state(pm.full.init_state(dev), M_R)
        outs = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in fs_batches:
            ml, st, wr, rd = step(ml, st, *b)
            outs.append((wr, rd))
        torch.cuda.synchronize()
        res[name] = (ml, st, outs, time.perf_counter() - t1)
    (mp, sp, op_, tp), (mf, sf, of, tf) = res["partitioned"], res["fold"]
    for f in mp._fields:
        if not torch.equal(getattr(mp, f), getattr(mf, f)):
            raise AssertionError(f"phase 18 memfs: multilog field {f} "
                                 f"differs")
    for f in sp:
        if not (torch.equal(sp[f], sf[f]) and (sp[f] == sp[f][0:1]).all()):
            raise AssertionError(f"phase 18 memfs: states differ in {f}")
    for i, (a, b) in enumerate(zip(op_, of)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"phase 18 memfs: step {i} responses "
                                 f"differ")
    n_disp = M_STEPS * (M_R * M_BW + M_R)
    out["memfs"] = {"partitioned_dispatches_per_s": n_disp / tp,
                    "fold_dispatches_per_s": n_disp / tf, "B": B}
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {}
    log(f"phase 18: other models at R={M_R}, {M_BW} writes + 1 read a "
        f"replica x {M_STEPS} steps, no kernel of this package runs here "
        f"(plain PyTorch ops): stack and queue (capacity {M_CAP}), sorted "
        f"set ({M_KEYS} keys) combined = scan = host model; synthetic "
        f"(n={SYN['n']}, 20/5/2/1) scan = numpy twin; memfs "
        f"({FS_FILES} files x {FS_BLOCKS} blocks, L={L}) CNR step "
        f"partitioned = fold; dispatches/s: " + ", ".join(
            f"{m} " + "/".join(f"{k.split('_')[0]} {v:.6g}"
                               for k, v in r.items()
                               if k.endswith("per_s"))
            for m, r in out.items() if isinstance(r, dict) and r)
        + f"; {out['seconds']:.1f} s")
    return out


# ------------------------------------------------- the mesh (parallel/)

MESH_SHARDS = 4        # phases 19-22: R = 4096 on 4 shards of 1024
MESH_PROFILED = 4      # phase 19's profiled rounds (after a warm-up)
MESH_CHAIN_ROUNDS = 4  # phase 20's rounds a tier
MESH_BACKLOG = 1024    # phase 20's ring backlog: 4 chunks of 256
MESH_VS_ROUNDS = 24    # phase 21's rounds of VS_ROUND
MESH_SV_PER = 250      # phase 22's ops a client (phase 17's)
MESH_CNR_BATCHES = 8   # phase 22's CNR batches of CNR_ROUND


def queued_ms(call, n: int = 20) -> float:
    """Device time of one call of `call()` in ms from CUDA events around
    `n` calls queued behind a ~20 ms spin kernel: the host has enqueued
    them all before the device reaches the first, so the events span
    device work only. Late in a full run `torch.profiler` has seen none
    of a lone kernel call's launches, so the mesh phases' per-shard
    checks time them this way."""
    import torch

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def mesh_devices(n: int):
    """N shards: one a card while there are cards, then round robin."""
    import torch

    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def _same_fleets(a, b, label: str) -> None:
    """Two fleets' rings, int64 cursors and states bit-identical."""
    import torch

    for f in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        if not torch.equal(getattr(a.log, f), getattr(b.log, f)):
            raise AssertionError(f"{label}: log field {f} differs")
    for f in a.states:
        if not torch.equal(a.states[f], b.states[f]):
            raise AssertionError(f"{label}: states differ in {f}")


def _k1_shard_check(dev, rng, Rl: int) -> dict:
    """K1 over the states against its plain version at a shard's shape
    (R / shards replicas, W = 256, a 2^16 ring wrapping in the window),
    unfenced and fenced, with its event and device time and its
    bound."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    kp = -(-K // 8) * 8
    spec = LogSpec(capacity=1 << 16, n_replicas=Rl, arg_width=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    vals = torch.randint(-(1 << 30), 1 << 30, (kp, Rl), generator=gen,
                         device=dev, dtype=torch.int32)
    pres = torch.randint(0, 2, (kp, Rl), generator=gen, device=dev,
                         dtype=torch.int32)
    ring = (torch.zeros(spec.capacity, dtype=torch.int32, device=dev),
            torch.zeros((spec.capacity, 3), dtype=torch.int32, device=dev))
    W = W_ROUND
    opc = rng.integers(1, 3, W).astype(np.int32)
    args = np.zeros((W, 3), np.int32)
    args[:, 0] = rng.integers(-K, 2 * K, W)
    args[:, 1] = rng.integers(1, 1 << 31, W)
    fen = torch.zeros(Rl, dtype=torch.int32, device=dev)
    fen[[1, 127, 128, Rl // 2, Rl - 1]] = 1
    states = planes_to_states(vals, pres)
    err = 0
    for f in (None, fen):
        inputs = (spec, torch.tensor(spec.capacity - 100, dtype=torch.int64,
                                     device=dev), W - 5,
                  torch.from_numpy(opc).to(dev),
                  torch.from_numpy(args).to(dev), *ring, *states, K, f)
        err = max(err, max_abs_err(k1(*inputs), k1_plain(*inputs)))
    if err:
        raise AssertionError(f"phase 19: K1 at R={Rl} disagrees with its "
                             f"plain version: {err}")
    inputs = inputs[:-1] + (None,)
    ms = cuda_ms(lambda: k1(*inputs), 10)
    plain_ms = cuda_ms(lambda: k1_plain(*inputs), 2)
    dt = {"device_ms": queued_ms(lambda: k1(*inputs))}
    n_bytes = k1_model_round_bytes(Rl, W)
    bound_ms, by = bound(n_bytes, 4 * W * Rl)
    log(f"phase 19: K1 at a shard's shape R={Rl} K={K} W={W} ring 2^16 "
        f"(wrapping), fenced and not: bit-identical; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({n_bytes:.0f} "
        f"bytes)")
    log(f"phase 19: K1 per shard device time {dt['device_ms']:.4f} ms "
        f"(CUDA events over queued calls)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **dt,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": by,
            "R": Rl, "W": W}


def phase_mesh_fused(dev, rng):
    """The mesh-fused hashmap flagship: `NodeReplicated(make_hashmap(K),
    R, log_entries=2^16, engine="pallas", mesh=replica_mesh(4))` against
    un-meshed `"pallas"` and `"combined"` fleets and a dict, phase 5's
    rounds plus a fenced stretch on shard 2; every round 4 K1 launches
    (the wrapper's count, `stats()`, `torch.profiler`). Returns the
    result and the meshed fleet, which phase 22 serves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import HM_GET, HM_PUT, make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.parallel import replica_mesh

    Rl = R // MESH_SHARDS
    check = _k1_shard_check(dev, rng, Rl)
    torch.cuda.empty_cache()
    devs = mesh_devices(MESH_SHARDS)
    log(f"phase 19: {MESH_SHARDS} shards on " + ", ".join(
        f"shard {s}: {d}" for s, d in enumerate(devs)))
    reg = get_registry()
    reg.enable()
    mesh_rounds = reg.counter("nr.exec.mesh.mesh_fused")

    def fleet(engine, mesh=None):
        return NodeReplicated(make_hashmap(K), R, log_entries=1 << 16,
                              engine=engine, mesh=mesh,
                              **({} if mesh else {"device": dev}))

    reset_launch_counts()
    nm = fleet("pallas", replica_mesh(MESH_SHARDS, devices=devs))
    nk, nc = fleet("pallas"), fleet("combined")
    fleets = {"mesh": nm, "pallas": nk, "combined": nc}
    readers = [1, Rl + 7, 2 * Rl + 3, R - 1]  # one on each shard
    toks = {n: [f.register(r) for r in readers] for n, f in fleets.items()}
    fenced_rid = 2 * Rl + 5               # on shard 2
    fenced_rounds = range(24, 30)
    model: dict[int, int] = {}
    lat = {n: [] for n in fleets}
    mesh_launches = 0
    m0 = mesh_rounds.value
    n_rounds = 36 + 1 + MESH_PROFILED
    batches = []
    for rnd in range(n_rounds):
        rid = int(rng.integers(R))
        if rid == fenced_rid:
            rid = 0
        opc = rng.choice(np.array([1, 2]), W_ROUND)
        keys = rng.integers(0, K, W_ROUND)
        vals = rng.integers(1, 1 << 31, W_ROUND)
        batches.append((rid, keys, [
            (int(o), int(k), int(v)) if o == HM_PUT else (int(o), int(k))
            for o, k, v in zip(opc, keys, vals)]))

    def drive(rnd, rid, ops, timed=True):
        got = {}
        for name, f in fleets.items():
            before = k1_launches()
            t0 = time.perf_counter()
            got[name] = f.execute_mut_batch(ops, rid)
            if timed:
                lat[name].append(time.perf_counter() - t0)
            if name == "mesh":
                n = k1_launches() - before
                if n != MESH_SHARDS or f.last_round_tier != "mesh_fused":
                    raise AssertionError(
                        f"phase 19: round {rnd}: {n} K1 launches, tier "
                        f"{f.last_round_tier}")
        return got

    for rnd, (rid, keys, ops) in enumerate(batches[:36]):
        if rnd == fenced_rounds[0]:
            for f in fleets.values():
                f.fence_replica(fenced_rid)
        if rnd == fenced_rounds[-1] + 1:
            for f in fleets.values():
                f.clone_replica_from(fenced_rid, donor=0)
                f.unfence_replica(fenced_rid)
        want = _apply_model(model, ops)
        l0 = k1_launches()
        got = drive(rnd, rid, ops)
        mesh_launches += MESH_SHARDS
        del l0
        if not got["mesh"] == got["pallas"] == got["combined"] == want:
            raise AssertionError(f"phase 19: round {rnd}: responses differ")
        for i, r in enumerate(readers):
            k = int(keys[(rnd + i) % W_ROUND])
            outs = {f.execute((HM_GET, k), toks[n][i])
                    for n, f in fleets.items()}
            if outs != {model.get(k, -1)}:
                raise AssertionError(f"phase 19: round {rnd}: read of {k} "
                                     f"on replica {r}: {outs}")
    # profiled rounds: the first is the tracer's warm-up step, traced
    # and left out; the tracer counts K1 kernels in the others
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        rid, _, ops = batches[36]
        got_m = [nm.execute_mut_batch(ops, rid)]
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)  # as phase 16: the active step starts first
        f0 = nm.stats()["fused_rounds"]
        for rid, _, ops in batches[37:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got_m.append(nm.execute_mut_batch(ops, rid))
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    prof_rounds = nm.stats()["fused_rounds"] - f0
    mesh_launches += MESH_SHARDS * (1 + MESH_PROFILED)
    for (rid, _, ops), g in zip(batches[36:], got_m):
        want = _apply_model(model, ops)
        outs = [nk.execute_mut_batch(ops, rid),
                nc.execute_mut_batch(ops, rid)]
        if not g == outs[0] == outs[1] == want:
            raise AssertionError("phase 19: a profiled round differs")
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    for f in fleets.values():
        f.sync()
    sm = nm.stats()
    if not (sm["fused_rounds"] == n_rounds and sm["exec_rounds"] == 0
            and mesh_rounds.value - m0 == n_rounds
            and sm["mesh_devices"] == MESH_SHARDS):
        raise AssertionError(f"phase 19: not every round was one meshed "
                             f"round: {sm}")
    if nk.stats()["fused_rounds"] + mesh_launches != \
            launches["hashmap_fused_round"]:
        raise AssertionError(f"phase 19: K1 launches {launches} against "
                             f"{mesh_launches} meshed")
    _same_fleets(nm, nk, "phase 19 (mesh against pallas)")
    _same_fleets(nm, nc, "phase 19 (mesh against combined)")
    if not nm.replicas_equal():
        raise AssertionError("phase 19: replicas differ")
    values = nm.states["values"][0].cpu().numpy()
    present = nm.states["present"][0].cpu().numpy()
    if set(np.nonzero(present)[0].tolist()) != set(model) or any(
            int(values[k]) != v for k, v in model.items()):
        raise AssertionError("phase 19: state differs from the dict")
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and not e.key.startswith("ProfilerStep")]
    k1_ev = [e for e in ev if "hashmap_round" in e.key]
    k1_count = sum(e.count for e in k1_ev)
    if k1_count != MESH_SHARDS * prof_rounds:
        raise AssertionError(f"phase 19: the profiler saw {k1_count} K1 "
                             f"launches in {prof_rounds} meshed rounds")
    k1_ms = sum(e.self_device_time_total for e in k1_ev) / 1e3 / k1_count
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / prof_rounds
    wall_ms = statistics.mean(walls) * 1e3
    top = sorted(((e.self_device_time_total / 1e3 / prof_rounds,
                   e.count / prof_rounds, e.key[:60]) for e in ev),
                 reverse=True)[:6]
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in lat.items()}
    out = {"rounds": n_rounds, "shards": MESH_SHARDS,
           "devices": [str(d) for d in devs], "R_per_shard": Rl,
           "launches": launches, "mesh_launches": mesh_launches,
           "round_ms": med, "k1_check": check,
           "profiled_rounds": prof_rounds, "profiled_k1": k1_count,
           "k1_device_ms": k1_ms, "device_ms": dev_ms,
           "round_wall_ms": wall_ms, "device_busy": dev_ms / wall_ms,
           "kernels": [{"ms": m, "per_round": c, "name": k}
                       for m, c, k in top]}
    log(f"phase 19: mesh-fused NodeReplicated R={R} K={K} over "
        f"{MESH_SHARDS} shards of {Rl}: {n_rounds} rounds of {W_ROUND} ops "
        f"+ {len(readers)} reads (one a shard), rounds {fenced_rounds[0]}-"
        f"{fenced_rounds[-1]} with replica {fenced_rid} (shard 2) fenced; "
        f"meshed = pallas = combined = the dict (responses, rings, "
        f"cursors, states); every round mesh_fused with {MESH_SHARDS} K1 "
        f"launches (wrapper {mesh_launches}, stats {sm['fused_rounds']} "
        f"rounds); round latency (median) mesh {med['mesh']:.3f} ms, "
        f"pallas {med['pallas']:.3f} ms, combined {med['combined']:.3f} ms")
    log(f"phase 19: profiled {prof_rounds} meshed rounds: {k1_count} K1 "
        f"kernels seen by the profiler; K1 {k1_ms:.4f} ms a shard launch "
        f"against a bound of {check['bound_ms']:.4f} ms; a round's host "
        f"wall {wall_ms:.4f} ms, device {dev_ms:.4f} ms (busy "
        f"{100 * dev_ms / wall_ms:.1f}%): "
        + ", ".join(f"{k[:40]} x{c:.2f} {m:.4f} ms" for m, c, k in top))
    del nk, nc, fleets
    torch.cuda.empty_cache()
    return out, nm


def phase_mesh_chain(dev, rng) -> dict:
    """The chain tiers on the mesh at the flagship widths: a `"scan"`
    fleet (collectives `auto` -> `shmap`) and a `"combined"` fleet (->
    `gspmd`) on 4 shards, each against its un-meshed twin; then a
    backlog of 1024 entries appended with every cursor equal, which
    `sync()` replays through the ring tier (chunk 256, W = 1024), equal
    to an un-meshed `sync()`."""
    import torch

    from node_replication_torch import NodeReplicated, log_append
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.parallel import replica_mesh

    reg = get_registry()
    reg.enable()
    ring = reg.counter("nr.exec.engine.ring")
    devs = mesh_devices(MESH_SHARDS)
    mesh = replica_mesh(MESH_SHARDS, devices=devs)
    out = {}
    reset_launch_counts()
    for engine, tier in (("scan", "shmap"), ("combined", "gspmd")):
        nm = NodeReplicated(make_hashmap(K), R, log_entries=1 << 16,
                            engine=engine, mesh=mesh)
        nu = NodeReplicated(make_hashmap(K), R, log_entries=1 << 16,
                            engine=engine, device=dev)
        if nm._mesh_tier != tier:
            raise AssertionError(f"phase 20: {engine} took "
                                 f"{nm._mesh_tier}, not {tier}")
        model: dict[int, int] = {}
        lat = {"mesh": [], "unmeshed": []}
        for rnd in range(MESH_CHAIN_ROUNDS):
            ops = _cnr_round_ops(rng, W_ROUND)
            want = _apply_model(model, ops)
            rid = int(rng.integers(R))
            got = []
            for name, f in (("mesh", nm), ("unmeshed", nu)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got.append(f.execute_mut_batch(ops, rid))
                lat[name].append(time.perf_counter() - t0)
            if not got[0] == got[1] == want:
                raise AssertionError(f"phase 20 {tier}: round {rnd} "
                                     f"responses differ")
        _same_fleets(nm, nu, f"phase 20 {tier}")
        r = {"tier": tier, "round_ms": {k: statistics.median(v) * 1e3
                                        for k, v in lat.items()},
             "stats": {k: nm.stats()[k] for k in ("exec_rounds",
                                                  "mesh_devices")}}
        if engine == "scan":
            # the ring tier: a backlog appended with every cursor equal
            opc = rng.integers(1, 3, MESH_BACKLOG).astype(np.int32)
            args = np.zeros((MESH_BACKLOG, 3), np.int32)
            args[:, 0] = rng.integers(0, K, MESH_BACKLOG)
            args[:, 1] = rng.integers(1, 1 << 31, MESH_BACKLOG)
            for f in (nm, nu):
                f.log = log_append(f.spec, f.log,
                                   torch.from_numpy(opc).to(dev),
                                   torch.from_numpy(args).to(dev),
                                   MESH_BACKLOG)
            r0 = ring.value
            secs = {}
            for name, f in (("ring", nm), ("scan", nu)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f.sync()
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
            if not (ring.value - r0 >= 1 and nm._ring_rounds >= 1
                    and nu._ring_rounds == 0):
                raise AssertionError(f"phase 20: the ring tier did not "
                                     f"run ({ring.value - r0} passes)")
            _same_fleets(nm, nu, "phase 20 after the ring pass")
            r.update(ring_passes=nm._ring_rounds, chunk=min(
                nm.exec_window, MESH_BACKLOG // MESH_SHARDS),
                backlog=MESH_BACKLOG, ring_s=secs["ring"],
                scan_s=secs["scan"])
            log(f"phase 20: ring catch-up of a {MESH_BACKLOG}-entry backlog "
                f"on {MESH_SHARDS} shards (chunk {r['chunk']}, "
                f"{nm._ring_rounds} pass): {secs['ring']:.3f} s, the "
                f"un-meshed scan sync {secs['scan']:.3f} s; bit-identical")
        log(f"phase 20: {engine} fleet on {MESH_SHARDS} shards ({tier}) vs "
            f"un-meshed: {MESH_CHAIN_ROUNDS} rounds of {W_ROUND} ops "
            f"bit-identical and equal to a dict; round latency (median) "
            f"mesh {r['round_ms']['mesh']:.3f} ms, un-meshed "
            f"{r['round_ms']['unmeshed']:.3f} ms")
        out[tier] = r
        del nm, nu
        torch.cuda.empty_cache()
    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    if any(out["launches"].values()):
        raise AssertionError(f"phase 20: a chain tier launched a kernel: "
                             f"{out['launches']}")
    return out


def phase_mesh_vspace(dev, rng) -> dict:
    """The mesh-fused flat vspace: phase 8's fleet on 4 shards of 64,
    against un-meshed `"pallas"` and `"combined"` fleets and the numpy
    page table; every unfenced round 4 K5 launches, a fenced stretch on
    the chain; then K5 against its plain version at a shard's shape."""
    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import make_vspace
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops import vspace as vs
    from node_replication_torch.ops.encoding import encode_ops
    from node_replication_torch.parallel import replica_mesh

    reg = get_registry()
    reg.enable()
    fallback = reg.counter("nr.exec.engine.fused_fallback")
    devs = mesh_devices(MESH_SHARDS)
    Rl = VS_R // MESH_SHARDS

    def fleet(engine, mesh=None):
        return NodeReplicated(make_vspace(VS_P, max_span=VS_SPAN), VS_R,
                              engine=engine, mesh=mesh,
                              **({} if mesh else {"device": dev}))

    vs.reset_launch_counts()
    nm = fleet("pallas", replica_mesh(MESH_SHARDS, devices=devs))
    nk, nc = fleet("pallas"), fleet("combined")
    fleets = {"mesh": nm, "pallas": nk, "combined": nc}
    readers = [1, Rl + 2, 2 * Rl + 3, VS_R - 1]
    toks = {n: [f.register(r) for r in readers] for n, f in fleets.items()}
    fenced_rid = 2 * Rl + Rl // 2
    fenced_rounds = range(16, 20)
    model = np.zeros(VS_P, np.int64)
    lat = {n: [] for n in fleets}
    mesh_launches, fb0 = 0, fallback.value
    for rnd in range(MESH_VS_ROUNDS):
        if rnd == fenced_rounds[0]:
            for f in fleets.values():
                f.fence_replica(fenced_rid)
        if rnd == fenced_rounds[-1] + 1:
            for f in fleets.values():
                f.clone_replica_from(fenced_rid, donor=0)
                f.unfence_replica(fenced_rid)
        opc, args = vs_window(rng, VS_ROUND)
        ops = [(1, int(a[0]), int(a[1]), int(a[2])) if o == 1
               else (2, int(a[0]), int(a[1])) for o, a in zip(opc, args)]
        want = [np_vspace_apply(model, op) for op in ops]
        rid = int(rng.integers(VS_R))
        if rid == fenced_rid:
            rid = 0
        got = {}
        for name, f in fleets.items():
            before = vs.FUSED_KERNEL.launches
            t0 = time.perf_counter()
            got[name] = f.execute_mut_batch(ops, rid)
            lat[name].append(time.perf_counter() - t0)
            if name == "mesh":
                n = vs.FUSED_KERNEL.launches - before
                fenced = rnd in fenced_rounds
                if n != (0 if fenced else MESH_SHARDS) or \
                        f.last_round_tier != ("combined" if fenced
                                              else "mesh_fused"):
                    raise AssertionError(
                        f"phase 21: round {rnd}: {n} K5 launches, tier "
                        f"{f.last_round_tier}")
                mesh_launches += n
        if not got["mesh"] == got["pallas"] == got["combined"] == want:
            raise AssertionError(f"phase 21: round {rnd}: responses differ")
        for i, r in enumerate(readers):
            a = args[(rnd + i) % VS_ROUND]
            op = (1, int(a[0])) if i % 2 else (2, int(a[0]), int(a[2]))
            outs = {f.execute(op, toks[n][i]) for n, f in fleets.items()}
            if outs != {np_vspace_read(model, op)}:
                raise AssertionError(f"phase 21: round {rnd}: read {op} "
                                     f"on replica {r}: {outs}")
    launches = {k.name: k.launches for k in (
        vs.REPLAY_KERNEL, vs.PLAN_KERNEL, vs.FUSED_KERNEL)}
    if fallback.value - fb0 < 2 * len(fenced_rounds):
        raise AssertionError("phase 21: fenced rounds did not fall back")
    for f in fleets.values():
        f.sync()
    sm = nm.stats()
    if sm["fused_rounds"] != MESH_VS_ROUNDS - len(fenced_rounds) or \
            mesh_launches != MESH_SHARDS * sm["fused_rounds"]:
        raise AssertionError(f"phase 21: {sm['fused_rounds']} meshed "
                             f"rounds, {mesh_launches} K5 launches")
    _same_fleets(nm, nk, "phase 21 (mesh against pallas)")
    _same_fleets(nm, nc, "phase 21 (mesh against combined)")
    if not nm.replicas_equal():
        raise AssertionError("phase 21: replicas differ")
    if not np.array_equal(nm.states["frames"][0].cpu().numpy(), model):
        raise AssertionError("phase 21: frames differ from the numpy model")
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in lat.items()}
    log(f"phase 21: mesh-fused vspace R={VS_R} P={VS_P} on {MESH_SHARDS} "
        f"shards of {Rl} ({', '.join(str(d) for d in devs)}): "
        f"{MESH_VS_ROUNDS} rounds of {VS_ROUND} ops + reads, rounds "
        f"{fenced_rounds[0]}-{fenced_rounds[-1]} fenced (replica "
        f"{fenced_rid}, shard 2) on the chain; meshed = pallas = combined "
        f"= the numpy table; {mesh_launches} K5 launches, {MESH_SHARDS} a "
        f"meshed round; round latency (median) mesh {med['mesh']:.3f} ms, "
        f"pallas {med['pallas']:.3f} ms, combined {med['combined']:.3f} ms")
    # K5 alone at a shard's shape, on shard 0's own log and rows
    sh = nm._placed.shards[0]
    opc_np, args_np = vs_window(rng, VS_ROUND, inert=True)
    opcodes, args, count = encode_ops(
        [(int(o), *map(int, a)) for o, a in zip(opc_np, args_np)], 3,
        device=sh.device)
    lg, frames = sh.log, sh.states["frames"]
    spec = nm._shard_spec()
    call = (spec, lg.tail, count, opcodes, args, lg.opcodes, lg.args,
            frames, VS_P, VS_SPAN)
    err = max_abs_err(vs.vspace_fused_round(*call),
                      vs.vspace_fused_round_plain(*call))
    if err:
        raise AssertionError(f"phase 21: K5 at R={Rl} disagrees with its "
                             f"plain version: {err}")
    ms = cuda_ms(lambda: vs.vspace_fused_round(*call), 10)
    plain_ms = cuda_ms(lambda: vs.vspace_fused_round_plain(*call), 2)
    dt = {"device_ms": queued_ms(lambda: vs.vspace_fused_round(*call))}
    L = nm.spec.capacity
    n_bytes = vs_bytes(Rl, VS_ROUND, extra=4 * 2 * L * 4)
    bound_ms, by = bound(n_bytes, vs_ops(args_np, opc_np, Rl))
    log(f"phase 21: K5 at a shard's shape R={Rl} W={VS_ROUND}: "
        f"bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {bound_ms:.4f} ms ({n_bytes} bytes)")
    log(f"phase 21: K5 per shard device time {dt['device_ms']:.4f} ms "
        f"(CUDA events over queued calls)")
    return {"rounds": MESH_VS_ROUNDS, "round_ms": med,
            "launches": launches, "mesh_launches": mesh_launches,
            "fused_rounds": sm["fused_rounds"],
            "k5_check": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **dt, "bytes": n_bytes, "bound_ms": bound_ms,
                         "bound_by": by, "R": Rl, "W": VS_ROUND}}


def phase_mesh_serve(dev, rng, nm) -> dict:
    """Phase 19's meshed fleet behind `ServeFrontend(rids=range(8),
    batch_max_ops=256)`: 16 closed-loop clients of 250 ops against
    per-client dicts, every round mesh-fused, the frontend's device map
    equal to `replica_device`; then CNR on a 2 x 2 mesh
    (`engine="scan"`) against the un-meshed fleet and a dict."""
    import torch

    from node_replication_torch import MultiLogReplicated
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.parallel import make_mesh
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    reg = get_registry()
    reg.enable()
    count = lambda: reg.counter("serve.batches").value  # noqa: E731
    values = nm.states["values"][0].cpu().numpy()
    present = nm.states["present"][0].cpu().numpy()
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    for c, m in enumerate(models):
        for slot in range(c * SV_SLICE, (c + 1) * SV_SLICE):
            if present[slot]:
                m.vals[slot] = int(values[slot])
    ops = [hm_client_ops(rng, c, MESH_SV_PER) for c in range(SV_CLIENTS)]
    touched = [set() for _ in range(SV_CLIENTS)]

    def check(c, i, resp):
        want = models[c].apply(ops[c][i])
        touched[c].add(ops[c][i][1] % K)
        return (None if resp == want else
                f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

    reset_launch_counts()
    b0, f0 = count(), nm.stats()["fused_rounds"]
    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001)
    with ServeFrontend(nm, cfg, rids=range(SV_RIDS)) as fe:
        dev_map = dict(fe.device_of_rid)
        want_map = {r: str(nm.replica_device(r)) for r in range(SV_RIDS)}
        r = serve_clients(fe, SV_CLIENTS, MESH_SV_PER,
                          lambda c, i: ops[c][i], check,
                          lambda c: c % SV_RIDS)
        if r["errors"] or r["completed"] != r["ops"]:
            raise AssertionError(f"phase 22: {r['completed']} of "
                                 f"{r['ops']} ops; {r['errors']}")
        r["reads"] = 0
        for c, m in enumerate(models):
            rid = (c + 1) % SV_RIDS
            for slot in sorted(touched[c]):
                got = fe.read((1, slot), rid=rid)
                r["reads"] += 1
                if got != m.vals.get(slot, -1):
                    raise AssertionError(f"phase 22: key {slot} reads {got} "
                                         f"on replica {rid}")
        st_fe = fe.stats()
    st = nm.stats()
    r.update(rounds=count() - b0, fused=st["fused_rounds"] - f0,
             k1_launches=k1_launches())
    r["mean_batch"] = r["completed"] / max(1, r["rounds"])
    if dev_map != want_map or st_fe["mesh"]["device_of_rid"] != want_map \
            or sum(st_fe["mesh"]["replicas_per_device"].values()) != SV_RIDS:
        raise AssertionError(f"phase 22: device map {st_fe.get('mesh')} "
                             f"against {want_map}")
    if not (r["fused"] == r["rounds"] > 0
            and r["k1_launches"] == MESH_SHARDS * r["fused"]
            and nm.last_round_tier == "mesh_fused"):
        raise AssertionError(f"phase 22: not every served round was "
                             f"mesh-fused: {r}")
    check_fleet_state(nm, models, "phase 22 served")
    log(f"phase 22: the meshed flagship served (rids {SV_RIDS}, "
        f"{MESH_SHARDS} shards, device map {sorted(set(dev_map.values()))}):"
        f" {r['completed']} ops acked by {SV_CLIENTS} clients, every "
        f"response equal to the client dicts; {r['acked_ops_per_s']:.1f} "
        f"acked ops/s, p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms; "
        f"{r['rounds']} rounds (mean batch {r['mean_batch']:.2f}), every "
        f"one mesh-fused, {r['k1_launches']} K1 launches; {r['reads']} "
        f"reads from other rids; replicas equal the dicts")
    out = {"serve": r, "launches": {
        "hashmap_replay": REPLAY_KERNEL.launches,
        "hashmap_fused_round": k1_launches()}}
    del nm
    torch.cuda.empty_cache()
    # CNR on a ('replica', 'log') = (2, 2) mesh, the scan engine
    devs = mesh_devices(4)
    mesh = make_mesh(2, 2, devices=devs)

    def cnr(mesh=None):
        return MultiLogReplicated(
            make_hashmap(K), cnr_mapper, nlogs=CNR_L, n_replicas=R,
            log_entries=1 << 16, engine="scan", mesh=mesh,
            **({} if mesh else {"device": dev}))

    cm, cu = cnr(mesh), cnr()
    model: dict[int, int] = {}
    t = {"mesh": 0.0, "unmeshed": 0.0}
    for i in range(MESH_CNR_BATCHES):
        ops_b = _cnr_round_ops(rng, CNR_ROUND)
        want = _apply_model(model, ops_b)
        rid = (i * 517) % R
        got = []
        for name, f in (("mesh", cm), ("unmeshed", cu)):
            t0 = time.perf_counter()
            got.append(f.execute_mut_batch(ops_b, rid))
            t[name] += time.perf_counter() - t0
        if not got[0] == got[1] == want:
            raise AssertionError(f"phase 22 CNR: batch {i} differs")
    for f in (cm, cu):
        f.sync()
    for fld in cm.ml._fields:
        if not torch.equal(getattr(cm.ml, fld), getattr(cu.ml, fld)):
            raise AssertionError(f"phase 22 CNR: field {fld} differs")
    for fld in ("values", "present"):
        if not torch.equal(cm.states[fld], cu.states[fld]):
            raise AssertionError(f"phase 22 CNR: states differ in {fld}")
    rows = [row.flat[0] for row in mesh.devices]
    for rid in (0, R // 2 - 1, R // 2, R - 1):
        if cm.replica_device(rid) != rows[rid // (R // 2)]:
            raise AssertionError(f"phase 22 CNR: replica {rid} on "
                                 f"{cm.replica_device(rid)}")
    snap = cm.snapshot()["mesh"]
    if snap != {"devices": 4, "tier": "gspmd",
                "shape": {"replica": 2, "log": 2}}:
        raise AssertionError(f"phase 22 CNR: snapshot mesh {snap}")
    out["cnr"] = {"batches": MESH_CNR_BATCHES,
                  "batch_ms": {k: v / MESH_CNR_BATCHES * 1e3
                               for k, v in t.items()},
                  "exec_rounds": cm.stats()["exec_rounds"]}
    log(f"phase 22: CNR R={R} K={K} L={CNR_L} on a 2 x 2 mesh "
        f"({', '.join(str(d) for d in devs)}), engine scan: "
        f"{MESH_CNR_BATCHES} batches of {CNR_ROUND} equal to the un-meshed "
        f"fleet and a dict (rings, cursors, states); replica_device by "
        f"mesh row; batch latency mesh "
        f"{out['cnr']['batch_ms']['mesh']:.1f} ms, un-meshed "
        f"{out['cnr']['batch_ms']['unmeshed']:.1f} ms")
    return out


# ------------------------------------------- replication (`repl/`)

REPL_DIR = Path(__file__).resolve().parent / ".chip_smoke_repl"
REPL_KILL_NEAR = 2000    # the seeded ack count of the SIGKILL: about this
REPL_MAX_LAG = 64        # the follower's bounded reads: `max_lag_pos`
REPL_HB_TIMEOUT = 0.5    # the promotion watch's heartbeat timeout, s
REPL_POST = 250          # ops a client through the promoted follower
REPL_PROFILED = 64       # records applied under the profiler


def repl_counts() -> tuple[int, int]:
    """(acks at the SIGKILL, acks at the child's snapshot): seeded, the
    snapshot halfway to the kill."""
    rng = np.random.default_rng(SEED + 23)
    kill = int(rng.integers(REPL_KILL_NEAR - 100, REPL_KILL_NEAR + 101))
    return kill, kill // 2


def repl_primary(directory: str) -> int:
    """`--repl-primary DIR`: the replicated flagship's primary. Serves
    the phase-13 fleet from `ServeFrontend.from_recovery(DIR/primary,
    durability="batch")` with ship-before-ack (`ack_barrier =
    ReplicationShipper.barrier` into `DirectoryFeed(DIR/feed)`), runs a
    `FeedServer` with snapshot serving on 127.0.0.1 (its port written
    to DIR/port), snapshots once halfway to the kill, and logs every
    acked op after its future resolved, until the parent SIGKILLs it."""
    import threading

    import torch

    from node_replication_torch.durable import save_durable_snapshot
    from node_replication_torch.durable.wal import durable_publish
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.repl import (
        DirectoryFeed,
        FeedServer,
        ReplicationShipper,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    d = Path(directory)
    acks = d / "acks"
    acks.mkdir(parents=True, exist_ok=True)
    _, snap_at = repl_counts()
    rng = np.random.default_rng(SEED + 23)
    ops = [hm_client_ops(rng, c, 4 * SV_PER) for c in range(SV_CLIENTS)]
    files = [open(acks / f"c{c}.txt", "a") for c in range(SV_CLIENTS)]
    n_acked = [0]
    lock = threading.Lock()
    primary = str(d / "primary")
    fe = ServeFrontend.from_recovery(
        primary, make_hashmap(K), _crash_config(ServeConfig),
        rids=range(SV_RIDS), nr_kwargs=_crash_fleet_kwargs("cuda"))
    feed = DirectoryFeed(str(d / "feed"), arg_width=3)
    shipper = ReplicationShipper(fe.nr.wal, feed)
    fe.ack_barrier = shipper.barrier
    srv = FeedServer(feed, snapshot_dir=primary, wal=fe.nr.wal)
    durable_publish(str(d / "port"), str(srv.address[1]).encode(),
                    fsync=False)

    def on_ack(c, i, op, resp):
        files[c].write(f"{i} {' '.join(map(str, op))} {resp}\n")
        files[c].flush()
        with lock:
            n_acked[0] += 1
            snap = n_acked[0] == snap_at
        if snap:
            save_durable_snapshot(fe.nr, primary)
            print(f"snapshot at tail {int(fe.nr.log.tail)}", flush=True)

    r = serve_clients(fe, SV_CLIENTS, 4 * SV_PER, lambda c, i: ops[c][i],
                      lambda c, i, resp: None, lambda c: c % SV_RIDS,
                      on_ack=on_ack)
    srv.close()
    shipper.stop()
    fe.close()
    for f in files:
        f.close()
    print(f"the kill never came: {r['completed']} ops acked",
          file=sys.stderr)
    return 3


def _k1_record_check(dev, counts, mean_record: float,
                     label: str = "phase 23",
                     shape: str = "the follower's record shape") -> dict:
    """K1 over the states against its plain version at the follower's
    record shape: R = 4096 and the window a record of `n` ops gets (the
    next power of two), for each record size in `counts`, from a tail a
    few entries below 2^16 so that the rounds cross the ring's wrap,
    unfenced and fenced in turn; then its event, profiler and plain time
    and its bound at the mean record."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    kp = -(-K // 8) * 8
    spec = LogSpec(capacity=1 << 16, n_replicas=R, arg_width=3)
    L = spec.capacity
    rng = np.random.default_rng(SEED + 231)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 231)
    vals, pres = random_planes(gen, dev, kp)
    ring = (torch.zeros(L, dtype=torch.int32, device=dev),
            torch.zeros((L, 3), dtype=torch.int32, device=dev))
    fen = torch.zeros(R, dtype=torch.int32, device=dev)
    fen[[0, 127, 128, R // 2, R - 1]] = 1
    kern = plain = (*ring, *planes_to_states(vals, pres))
    tail, err = L - 2 * sum(counts) // 3, 0

    def inputs(n, tail):
        W = 1 << (n - 1).bit_length()
        opc = np.zeros(W, np.int32)
        opc[:n] = rng.choice(np.array([1, 2], np.int32), n)
        args = np.zeros((W, 3), np.int32)
        args[:n, 0] = rng.integers(-2 * K, 3 * K, n)
        args[:n, 1] = rng.integers(1, 1 << 31, n)
        return (spec, torch.tensor(tail, dtype=torch.int64, device=dev), n,
                torch.from_numpy(opc).to(dev), torch.from_numpy(args).to(dev))

    for rnd, n in enumerate(counts):
        x = inputs(n, tail)
        f = fen if rnd % 2 else None
        out_k = k1(*x, *kern, K, f)
        out_p = k1_plain(*x, *plain, K, f)
        e = max_abs_err(out_k, out_p)
        if e:
            raise AssertionError(
                f"{label}: K1 at a record of {n} disagrees with its plain "
                f"version in round {rnd} (fenced={f is not None}): {e}")
        err = max(err, e)
        kern, plain = out_k[:4], out_p[:4]
        tail += n
    if tail <= L:
        raise AssertionError(f"{label}: the record rounds never wrapped")
    n = max(1, round(mean_record))
    x = (*inputs(n, tail), *kern, K, None)
    ms = cuda_ms(lambda: k1(*x), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: k1_plain(*x), reps=2)
    dt = device_time(lambda: k1(*x))
    bound_ms, by = bound(k1_model_round_bytes(R, mean_record),
                         4 * mean_record * R)
    log(f"{label}: K1 at {shape} (R={R}, "
        f"{len(counts)} records of {min(counts)}-{max(counts)} ops across "
        f"the wrap, fenced and not): bit-identical to its plain version; "
        f"at {n} ops kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{bound_ms:.4f} ms at the mean record {mean_record:.3f}")
    log_device(f"{label}: K1 at a record", dt)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **dt,
            "bound_ms": bound_ms, "bound_by": by, "W": n,
            "records_checked": len(counts)}


def phase_repl(dev) -> dict:
    """Phase 23: the replicated flagship. A `--repl-primary` child serves
    the phase-13 fleet with ship-before-ack; follower F1 (in this
    process, the same fleet on the card) applies the shipped WAL, one
    K1 launch a record, and serves bounded reads under load; a cold
    leaf follows over SocketFeed -> RelayNode -> SocketFeed, booting
    from the child's snapshot; the child is SIGKILLed near a seeded ack
    count, `PromotionManager` detects the silence and promotes F1, which
    serves 16 clients on. Every check is exact."""
    import bisect
    import shutil
    import signal

    import torch

    from node_replication_torch.durable import WriteAheadLog, list_snapshots
    from node_replication_torch.models import HM_GET, make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.repl import (
        DirectoryFeed,
        EpochFencedError,
        Follower,
        PromotionManager,
        RelayNode,
        SocketFeed,
    )
    from node_replication_torch.serve import ServeConfig, StaleRead

    reg = get_registry()
    reg.enable()
    counters = ("nr.exec.engine.pallas_fused", "nr.exec.engine.fused_fallback",
                "serve.batches", "repl.applied_records",
                "repl.snapshot.bootstraps")
    count = lambda: {n: reg.counter(n).value for n in counters}
    kill_at, snap_at = repl_counts()
    kw = _crash_fleet_kwargs(dev)
    shutil.rmtree(REPL_DIR, ignore_errors=True)
    REPL_DIR.mkdir()
    primary = REPL_DIR / "primary"
    feed = DirectoryFeed(str(REPL_DIR / "feed"), arg_width=3)
    child = relay = leaf = f1 = fp = mgr = None
    child_log = open(REPL_DIR / "child.log", "w")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    c0 = count()
    t_phase = time.perf_counter()
    try:
        f1 = Follower(make_hashmap(K), feed, str(REPL_DIR / "f1"),
                      config=_crash_config(ServeConfig), nr_kwargs=kw,
                      name="f1", rids=range(SV_RIDS))
        mgr = PromotionManager(feed, [f1],
                               heartbeat_timeout_s=REPL_HB_TIMEOUT,
                               check_interval_s=0.03)
        child = subprocess.Popen(child_cmd("--repl-primary", REPL_DIR),
                                 stdout=child_log, stderr=subprocess.STDOUT)
        rrng = np.random.default_rng(SEED + 232)
        reads, lat, lags, stale = [], [], [], 0
        samples = []  # (s, feed tail, F1 applied)
        t_end = time.perf_counter() + 600
        n_acked, leaf_s, it = 0, None, 0
        while True:
            if mgr.report is not None:
                raise AssertionError("phase 23: F1 was promoted while the "
                                     "primary was alive")
            if child.poll() is not None:
                raise AssertionError(
                    f"phase 23: the primary exited {child.returncode} "
                    f"before the kill: "
                    f"{(REPL_DIR / 'child.log').read_text()[-3000:]}")
            if time.perf_counter() > t_end or (
                    leaf is None and n_acked > kill_at + 4000):
                raise AssertionError(f"phase 23: {n_acked} acks, leaf "
                                     f"{'not ' * (leaf is None)}built")
            if f1.error is not None:
                raise AssertionError(f"phase 23: F1 failed: {f1.error!r}")
            if it % 8 == 0:
                n_acked = sum(map(len, _acked_ops(REPL_DIR / "acks")))
            it += 1
            if leaf is None and list_snapshots(str(primary)):
                # the cold leaf: relay on the child's server, leaf on
                # the relay; its bootstrap fetches the snapshot through
                # the relay before the kill can cut the stream
                port = int((REPL_DIR / "port").read_text())
                t0 = time.perf_counter()
                relay = RelayNode(SocketFeed("127.0.0.1", port, arg_width=3),
                                  str(REPL_DIR / "relay"), arg_width=3,
                                  name="relay")
                leaf = Follower(make_hashmap(K),
                                SocketFeed(*relay.address, arg_width=3),
                                str(REPL_DIR / "leaf"), nr_kwargs=kw,
                                name="leaf", rids=range(SV_RIDS))
                leaf_s = time.perf_counter() - t0
                if leaf.bootstrap_report is None:
                    raise AssertionError("phase 23: the leaf did not boot "
                                         "from the snapshot")
                mgr.start()
            if leaf is not None and n_acked >= kill_at:
                os.kill(child.pid, signal.SIGKILL)
                t_kill = time.perf_counter()
                break
            key = int(rrng.integers(0, K))
            rid = int(rrng.integers(0, SV_RIDS))
            lo = f1.nr.ltail(rid)
            t0 = time.perf_counter()
            try:
                v, applied, bnd = f1.read_result(
                    (HM_GET, key), rid=rid, max_lag_pos=REPL_MAX_LAG,
                    wait_s=0.25)
            except StaleRead:
                stale += 1
                continue
            lat.append(time.perf_counter() - t0)
            hi = max(applied, f1.nr.ltail(rid))
            reads.append((key, v, max(lo, bnd), hi, applied, bnd))
            tail = feed.tail_pos()
            ap = f1.applied_pos()
            lags.append(max(0, tail - ap))
            samples.append((time.perf_counter() - t_phase, tail, ap))
        child.wait(timeout=60)
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"phase 23: the child exited "
                                 f"{child.returncode}, not by SIGKILL")
        report = mgr.wait(timeout=120)
        if report is None or not f1.promoted or f1.frontend.read_only:
            raise AssertionError(f"phase 23: no promotion: {report}, "
                                 f"{f1.stats()}")
        rto_wall = time.perf_counter() - t_kill
        try:
            feed.publish(report.new_epoch - 1, f1.applied_pos(),
                         np.zeros(1, np.int32), np.zeros((1, 3), np.int32))
            raise AssertionError("phase 23: the feed took a publish of the "
                                 "dead primary's epoch")
        except EpochFencedError:
            pass
        c_pro = count()
        k1_pre = k1_launches()
        applied_recs = c_pro["repl.applied_records"] - \
            c0["repl.applied_records"]
        if c_pro["nr.exec.engine.fused_fallback"] \
                != c0["nr.exec.engine.fused_fallback"]:
            raise AssertionError("phase 23: a fused round fell back")
        if not k1_pre >= applied_recs > 0:
            raise AssertionError(f"phase 23: {applied_recs} records applied "
                                 f"in {k1_pre} K1 launches")

        # the child's WAL: it chains from 0; F1's WAL holds the same
        # records, byte for byte, up to the common position, once each
        cw = WriteAheadLog(str(primary / "wal"), policy="batch",
                           arg_width=3)
        crecs = list(cw.records(0))
        cw.close()
        pos = _chained(crecs, "phase 23: the child's")
        if not crecs:
            raise AssertionError("phase 23: the child's WAL is empty")
        p1 = report.applied_pos
        common = min(pos, p1)
        frecs = [r for r in f1.nr.wal.records(0) if r.pos < common]
        crecs_c = [r for r in crecs if r.pos < common]
        if len(frecs) != len(crecs_c) or any(
                (a.pos, a.count, a.opcodes.tobytes(), a.args.tobytes())
                != (b.pos, b.count, b.opcodes.tobytes(), b.args.tobytes())
                for a, b in zip(frecs, crecs_c)):
            raise AssertionError("phase 23: F1's WAL differs from the "
                                 "child's below the common position "
                                 f"{common}: applied twice or lost")
        if common != p1:
            raise AssertionError(f"phase 23: F1 applied to {p1}, past the "
                                 f"child's WAL end {pos}")

        # no acked write lost; F1's state is the numpy replay at p1
        acked = _acked_ops(REPL_DIR / "acks")
        n_acked = sum(map(len, acked))
        models, per_client, history = _replay_to(crecs, p1)
        for c in range(SV_CLIENTS):
            n = len(acked[c])
            if per_client[c][:n] != acked[c] or len(per_client[c]) > n + 1:
                raise AssertionError(
                    f"phase 23: client {c}'s {n} acked ops are not the "
                    f"first {n} of its {len(per_client[c])} in F1's history")
            amodel = HashmapModel()
            for op, _ in acked[c]:
                amodel.apply(op)
            later = {op[1] % K for op, _ in per_client[c][n:]}
            for slot in range(c * SV_SLICE, (c + 1) * SV_SLICE):
                if (amodel.vals.get(slot, -1)
                        != models[c].vals.get(slot, -1)
                        and slot not in later):
                    raise AssertionError(f"phase 23: key {slot}'s acked "
                                         f"value is not in F1's fleet")
        check_fleet_state(f1.nr, models, "phase 23 F1 at promotion")

        # every bounded read: applied >= bound, and the value the replay
        # gives at a record boundary the read's replica could have held
        ends = sorted({r.pos + r.count for r in crecs} | {0})
        exact = 0
        for key, v, lo, hi, applied, bnd in reads:
            if applied < bnd or hi < bnd:
                raise AssertionError(f"phase 23: a read applied {applied} "
                                     f"below its bound {bnd}")
            cands = [q for q in ends[bisect.bisect_left(ends, lo):
                                     bisect.bisect_right(ends, hi)]]
            exact += lo == hi
            if v not in {_value_at(history, key, q) for q in cands}:
                raise AssertionError(
                    f"phase 23: key {key} read {v} at a position in "
                    f"[{lo}, {hi}], the replay gives "
                    f"{[_value_at(history, key, q) for q in cands]}")

        # the leaf: stop it where the relay's journal ends; its fleet is
        # the replay at its applied position, past the snapshot
        relay.stop()
        time.sleep(0.2)
        leaf_end = relay.local.tail_pos()
        if not leaf.wait_applied(leaf_end, timeout=60):
            raise AssertionError(f"phase 23: the leaf stopped at "
                                 f"{leaf.applied_pos()} of {leaf_end}")
        leaf.stop_apply()
        pl_ = leaf.applied_pos()
        snap_pos = leaf.bootstrap_report[0]
        if not (leaf.recovery_report.snapshot_pos == snap_pos < pl_ <= pos):
            raise AssertionError(f"phase 23: the leaf booted at "
                                 f"{leaf.recovery_report.snapshot_pos}, "
                                 f"snapshot {snap_pos}, applied {pl_}")
        lmodels, _, _ = _replay_to(crecs, pl_)
        check_fleet_state(leaf.nr, lmodels, "phase 23 leaf")
        leaf_recs = sum(1 for r in crecs if snap_pos <= r.pos < pl_)
        leaf.close()
        relay.close()
        del leaf
        leaf = relay = None
        torch.cuda.empty_cache()

        # the promoted F1 serves on: durable acks, one K1 a round
        l0, c1 = k1_launches(), count()
        post = [hm_client_ops(rrng, c, REPL_POST) for c in range(SV_CLIENTS)]

        def check(c, i, resp):
            want = models[c].apply(post[c][i])
            return (None if resp == want else
                    f"promoted client {c} op {i} {post[c][i]}: {resp}, "
                    f"model {want}")

        served = serve_clients(f1.frontend, SV_CLIENTS, REPL_POST,
                               lambda c, i: post[c][i], check,
                               lambda c: c % SV_RIDS)
        if served["errors"] or served["completed"] != served["ops"]:
            raise AssertionError(f"phase 23 promoted: {served['completed']} "
                                 f"of {served['ops']} ops; "
                                 f"{served['errors']}")
        c2 = count()
        rounds = c2["serve.batches"] - c1["serve.batches"]
        k1_post = k1_launches() - l0
        fused = (c2["nr.exec.engine.pallas_fused"]
                 - c1["nr.exec.engine.pallas_fused"])
        if not (rounds == k1_post == fused > 0):
            raise AssertionError(f"phase 23 promoted: {rounds} rounds, "
                                 f"{k1_post} K1 launches, {fused} fused")
        check_fleet_state(f1.nr, models, "phase 23 F1 after serving")
        if f1.nr.wal.durable_tail != int(f1.nr.log.tail):
            raise AssertionError("phase 23: F1's acks outran its fsync")
        f1.close()
        f1 = None
        torch.cuda.empty_cache()

        # K1's device time per applied record: a cold follower of the
        # dead feed, one record as the tracer's warm-up step, then
        # REPL_PROFILED records profiled, then the rest as a catch-up
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        pfeed = DirectoryFeed(feed.dir, arg_width=3)
        fp = Follower(make_hashmap(K), pfeed, str(REPL_DIR / "fp"),
                      nr_kwargs=kw, name="fp", auto_start=False,
                      rids=range(SV_RIDS))
        recs = pfeed.poll(0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fp._apply_record(recs[0])
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.05)  # as phase 16: the active step starts first
            for rec in recs[1:1 + REPL_PROFILED]:
                fp._apply_record(rec)
            torch.cuda.synchronize()
        prof_k1 = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "hashmap_round" in e.key]
        prof_n = sum(e.count for e in prof_k1)
        k1_dev = (sum(e.self_device_time_total for e in prof_k1) / 1e3
                  / prof_n if prof_n else None)
        rec_kernels = sorted(
            ((e.self_device_time_total / 1e3 / REPL_PROFILED,
              e.count / REPL_PROFILED, e.key[:60])
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("ProfilerStep")), reverse=True)
        prof_all = sum(k[0] for k in rec_kernels) * REPL_PROFILED
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_rest = fp._apply_once()
        torch.cuda.synchronize()
        catch_s = time.perf_counter() - t0
        fmodels, _, _ = _replay_to(crecs, fp.applied_pos())
        check_fleet_state(fp.nr, fmodels, "phase 23 catch-up follower")
        fp.close()
        fp = None
        launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                    "hashmap_fused_round": k1_launches()}
        peak = torch.cuda.max_memory_allocated()
        phase_s = time.perf_counter() - t_phase
        torch.cuda.empty_cache()

        sizes = [r.count for r in crecs]
        mean_record = float(np.mean(sizes))
        k1 = _k1_record_check(dev, sizes[:8] + [max(sizes)] * 2,
                              mean_record)
        k1_bound_ms, k1_by = bound(k1_model_round_bytes(R, mean_record),
                                   4 * mean_record * R)
        t_first = next((s for s, tail, _ in samples if tail > 0), None)
        window = (t_kill - t_phase - t_first) if t_first is not None else 0
        f1_recs = sum(1 for r in crecs if r.pos < samples[-1][2]) \
            if samples else 0
        lat_ms = np.asarray(lat) * 1e3 if lat else np.zeros(1)
        lag = np.asarray(lags) if lags else np.zeros(1)
        out = {
            "kill_at": kill_at, "snapshot_at": snap_at, "acked": n_acked,
            "child_wal_records": len(crecs), "child_wal_tail": pos,
            "mean_record": mean_record,
            "primary_records_per_s": (
                sum(1 for r in crecs if r.pos < samples[-1][1]) / window
                if window > 0 else None),
            "f1_records_per_s": f1_recs / window if window > 0 else None,
            "f1_ops_per_s": samples[-1][2] / window if window > 0 else None,
            "catchup_records": n_rest, "catchup_s": catch_s,
            "catchup_records_per_s": n_rest / catch_s if catch_s else None,
            "lag_p50": float(np.percentile(lag, 50)),
            "lag_p99": float(np.percentile(lag, 99)),
            "lag_max": int(lag.max()),
            "reads": len(reads), "exact_reads": exact, "stale_reads": stale,
            "read_p50_ms": float(np.percentile(lat_ms, 50)),
            "read_p99_ms": float(np.percentile(lat_ms, 99)),
            "report": report.as_dict(), "rto_wall_s": rto_wall,
            "applied_records": applied_recs, "k1_before_promotion": k1_pre,
            "leaf_boot_s": leaf_s, "leaf_snapshot_pos": snap_pos,
            "leaf_applied": pl_, "leaf_records": leaf_recs,
            "promoted": served, "promoted_rounds": rounds,
            "promoted_k1": k1_post,
            "k1_profiled_records": REPL_PROFILED,
            "k1_profiled_launches": prof_n,
            "k1_device_ms_per_record": k1_dev,
            "device_ms_per_record": prof_all / REPL_PROFILED,
            "record_kernels": [{"ms": m, "per_record": c, "name": n}
                               for m, c, n in rec_kernels[:8]],
            "k1_bound_ms": k1_bound_ms, "k1_bound_by": k1_by,
            "k1_check": k1, "launches": launches,
            "peak_mem_bytes": peak, "seconds": phase_s,
        }
        rep = report
        log(f"phase 23: replicated flagship R={R} K={K}: child SIGKILLed at "
            f"{n_acked} acks (seeded {kill_at}, snapshot at {snap_at}); "
            f"its WAL {len(crecs)} records to {pos} (mean record "
            f"{mean_record:.3f} ops); F1 applied {p1} positions, its WAL "
            f"equal to the child's, every acked op in it once and in order, "
            f"state equal to the numpy replay; follower "
            f"{out['f1_records_per_s'] or 0:.1f} records/s "
            f"({out['f1_ops_per_s'] or 0:.1f} ops/s) under load against the "
            f"primary's {out['primary_records_per_s'] or 0:.1f} records/s; "
            f"catch-up {out['catchup_records_per_s'] or 0:.1f} records/s "
            f"({n_rest} records); apply lag p50/p99/max "
            f"{out['lag_p50']:.0f}/{out['lag_p99']:.0f}/{out['lag_max']} "
            f"positions; {len(reads)} bounded reads (max_lag_pos "
            f"{REPL_MAX_LAG}, {exact} at an exact position) p50 "
            f"{out['read_p50_ms']:.3f} ms p99 {out['read_p99_ms']:.3f} ms, "
            f"{stale} stale; RTO {rep.rto_s:.3f} s (detect "
            f"{rep.detect_s:.3f} + promote {rep.promote_s:.3f}, "
            f"{rep.drained_records} drained, epoch {rep.new_epoch}; "
            f"{rto_wall:.3f} s from the kill), the dead epoch fenced")
        log(f"phase 23: leaf (SocketFeed -> RelayNode -> SocketFeed) booted "
            f"from the snapshot at {snap_pos} in {leaf_s:.2f} s, replayed "
            f"{leaf_recs} records to {pl_}, equal to the numpy replay; "
            f"promoted F1 served {served['completed']} ops at "
            f"{served['acked_ops_per_s']:.1f} acked ops/s (p50 "
            f"{served['p50_ms']:.3f} ms, p99 {served['p99_ms']:.3f} ms), "
            f"{rounds} rounds, each one K1; K1 per applied record "
            + (f"{k1_dev:.4f} ms of device ({prof_n} launches profiled, "
               f"all kernels {out['device_ms_per_record']:.4f} ms a record: "
               + ", ".join(f"{n[:40]} x{c:.2f} {m:.4f} ms"
                           for m, c, n in rec_kernels[:5]) + ")"
               if k1_dev else "not measured")
            + f" against a {k1_bound_ms:.4f} ms bound; {applied_recs} "
            f"records applied in {k1_pre} K1 launches before the "
            f"promotion; launches {launches}; peak device memory {peak} "
            f"bytes; {phase_s:.1f} s")
        return out
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        child_log.close()
        for f in (fp, leaf, f1):
            if f is not None:
                f.close()
        if relay is not None:
            relay.close()
        if mgr is not None:
            mgr.stop()
        shutil.rmtree(REPL_DIR, ignore_errors=True)


# ---------------------------------------------- the shard plane (`shard/`)

SHARD_DIR = Path(__file__).resolve().parent / ".chip_smoke_shard"
TXN_DIR = Path(__file__).resolve().parent / ".chip_smoke_txn"
SH_N = 3              # `bench.py --sharded-shards`'s default
SH_HB_TIMEOUT = 0.5   # `--sharded-heartbeat-timeout`'s default, s
SH_HOLD_MIN = 0.9     # `--sharded-hold-min`: printed beside, not a gate
SH_VICTIM = 1         # the shard whose primary is killed
SH_PER = 250          # ops a client
SH_BATCHES, SH_BATCH = 8, 256   # cross-shard router batches
SH_PROFILED = 16      # ops a client in the profiled segment
SH_FENCE = -7         # a value only the fences' refused writes carry
RS_KEYS = (0, 3, 6, 9, 1, 2, 4, 5)   # `--reshard-clients` 8 writers
RS_WARMUP, RS_WINDOW = 0.5, 1.5      # `--reshard-warmup`, `-window`, s
RS_UNAVAIL_MAX = 5.0  # `--reshard-unavail-max`: printed beside
TX_COUNT = 64         # phase 24's transactions
TX_VAL_BASE = 1_000_000   # `bench.py`'s `_TXN_VAL_BASE`
TX_KEY0 = 1000        # phase 24's transactions write keys from here
TX_SITES = ("txn-prepare", "txn-commit", "txn-decide")
TX_CHILD_TXNS = 24    # `--txn-count`'s default
# fault hook hits per transaction of 2 shards (`bench.py --txn`)
TX_HITS = {"txn-prepare": 4, "txn-commit": 2, "txn-decide": 1}
TX_PARITY_S, TX_PARITY_MIN = 1.5, 0.9   # `--txn-parity-seconds`, `-min`


def sh_client_ops(rng, c: int, n: int) -> list[tuple]:
    """Client c's ops over its own 625 keys as `hm_client_ops`, with
    each key its own slot (`k % K == k`): the shard map routes a key by
    `k % N`, so two keys of one slot could land on two shards."""
    slots = c * SV_SLICE + rng.integers(0, SV_SLICE, n)
    kinds = rng.integers(1, 3, n)
    vals = rng.integers(1, 1 << 31, n)
    return [(1, int(k), int(v)) if o == 1 else (2, int(k))
            for o, k, v in zip(kinds, slots, vals)]


def _padded(op) -> tuple:
    """An op as a WAL record holds it: args zero-padded to width 3."""
    return tuple(op) + (0,) * (4 - len(op))


def check_classes(nr, classes, n: int, models, label: str,
                  others_absent: bool) -> None:
    """A shard's fleet: replicas equal, every key of `classes` (mod
    `n`) equal to the models and, with `others_absent`, every other key
    absent."""
    nr.sync()
    if not nr.replicas_equal():
        raise AssertionError(f"{label}: replicas differ")
    values, present = model_planes(models)
    mine = np.isin(np.arange(K) % n, list(classes))
    got_v = nr.states["values"][0].cpu().numpy()
    got_p = nr.states["present"][0].cpu().numpy()
    if not (np.array_equal(got_p[mine], present[mine]) and np.array_equal(
            np.where(present, got_v, 0)[mine],
            np.where(present, values, 0)[mine])):
        raise AssertionError(f"{label}: its classes differ from the models")
    if others_absent and got_p[~mine].any():
        raise AssertionError(f"{label}: holds {int(got_p[~mine].sum())} "
                             f"keys of other classes")


def _match_history(expect, wal_ops, label: str) -> None:
    """A client's ops on one shard against that shard's WAL ops of the
    client's keys, in order: every acked op once, an in-doubt op once
    or never, nothing else (a match over both sequences: an in-doubt
    op may equal the acked op after it)."""
    n, m = len(expect), len(wal_ops)
    want = [_padded(op) for op, _ in expect]
    # ok[j]: expect[i:] matches wal_ops[j:], row i computed from i + 1
    ok = [False] * m + [True]
    for i in range(n - 1, -1, -1):
        doubt = expect[i][1] == "doubt"
        ok = [(doubt and ok[j]) or (j < m and want[i] == wal_ops[j]
                                    and ok[j + 1]) for j in range(m + 1)]
    if not ok[0]:
        acked = [op for op, st in expect if st == "acked"]
        raise AssertionError(f"{label}: its {len(acked)} acked ops (and "
                             f"{n - len(acked)} in doubt) are not its "
                             f"{m} WAL ops in order, once each")


def phase_shard(dev, rng, serve13) -> dict:
    """Phase 24: the keyspace-sharded flagship, `bench.py --sharded`'s
    layout (3 shards) with each shard phase 13's fleet and a follower,
    in one process on one card: routed closed-loop load with a kill and
    promotion of shard 1's primary in the middle of it, the socket
    path, an online split of class 0 under per-key writers, and
    cross-shard 2PC over the refined map. Every check is exact."""
    import random
    import shutil
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from node_replication_torch.fault.health import QUARANTINED
    from node_replication_torch.models import HM_GET, make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import (
        RetryPolicy,
        ServeConfig,
        ShardUnavailable,
        TxnAborted,
        WrongShard,
        call_with_retry,
    )
    from node_replication_torch.shard import (
        LocalBackend,
        ReshardPlan,
        ShardGroup,
        ShardRouter,
        ShardServer,
        SocketShardClient,
    )

    reg = get_registry()
    reg.enable()
    counters = ("nr.exec.engine.pallas_fused", "nr.exec.engine.fused_fallback",
                "serve.batches", "repl.applied_records",
                "serve.retry.shard_unavailable", "serve.retry.wrong_shard",
                "serve.retry.txn_conflict")
    count = lambda: {n: reg.counter(n).value for n in counters}  # noqa: E731
    retry = RetryPolicy(max_attempts=4000, base_backoff_s=0.002,
                        max_backoff_s=0.05)
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_phase = time.perf_counter()
    g = server = router2 = None
    threads: list = []
    stop = threading.Event()
    out: dict = {}
    try:
        g = ShardGroup(SH_N, make_hashmap(K), str(SHARD_DIR),
                       config=ServeConfig(durability="batch",
                                          batch_max_ops=256),
                       nr_kwargs=_crash_fleet_kwargs(dev),
                       rids=range(SV_RIDS),
                       heartbeat_timeout_s=SH_HB_TIMEOUT)
        out["build_s"] = time.perf_counter() - t_phase
        fleets = [p.nr for p in g.primaries] + \
            [p.follower.nr for p in g.primaries]

        def totals():
            st = [nr.stats() for nr in fleets]
            return {k: sum(s[k] for s in st)
                    for k in ("fused_rounds", "exec_rounds")}

        def settle():
            # every standby holds its primary's journal: the counts
            # below then cover each shipped record's apply
            for p in g.primaries:
                f = p.follower
                if f is not None and not f.promoted and not p._primary_dead:
                    if not f.wait_applied(p.wal.tail, timeout=120):
                        raise AssertionError(
                            f"phase 24: shard {p.shard}'s follower stopped "
                            f"at {f.applied_pos()} of {p.wal.tail}: "
                            f"{f.error!r}")

        def snap():
            settle()
            return count(), k1_launches(), totals()

        def k1_leg(label, s0, refused=0):
            # `refused`: ops whose round ran on the killed primary but
            # whose acks its stopped shipper refused (in doubt); such a
            # round launched K1 and counts in no frontend's batches
            c0, l0, t0 = s0
            c1, l1, t1 = snap()
            d = {n: c1[n] - c0[n] for n in counters}
            leg = {"k1_launches": l1 - l0,
                   "fused_rounds": t1["fused_rounds"] - t0["fused_rounds"],
                   "exec_rounds": t1["exec_rounds"] - t0["exec_rounds"],
                   "rounds": d["serve.batches"],
                   "applied_records": d["repl.applied_records"],
                   "fused": d["nr.exec.engine.pallas_fused"],
                   "fallback": d["nr.exec.engine.fused_fallback"],
                   "retries": {n.rsplit(".", 1)[1]: d[n] for n in counters
                               if n.startswith("serve.retry")}}
            leg["refused_rounds"] = (leg["k1_launches"] - leg["rounds"]
                                     - leg["applied_records"])
            if not (leg["k1_launches"] == leg["fused_rounds"] == leg["fused"]
                    > 0 and 0 <= leg["refused_rounds"] <= refused
                    and leg["fallback"] == 0 and leg["exec_rounds"] == 0):
                raise AssertionError(f"phase 24 {label}: not every shard "
                                     f"round and applied record was one K1 "
                                     f"launch: {leg}")
            return leg

        # (a) routed load: 8 cross-shard batches, then 16 clients
        s_a = snap()
        batch_log = []
        t0 = time.perf_counter()
        for _ in range(SH_BATCHES):
            bops = sh_client_ops(rng, 0, SH_BATCH)
            slots = rng.integers(0, K, SH_BATCH)
            bops = [(op[0], int(k)) + op[2:] for op, k in zip(bops, slots)]
            resp = g.router.execute_batch(bops, timeout=300.0)
            for op, r in zip(bops, resp):
                want = models[op[1] // SV_SLICE].apply(op)
                if int(r) != want:
                    raise AssertionError(f"phase 24: batch op {op} answered "
                                         f"{r}, model {want}")
            batch_log.extend(bops)
        out["batches_s"] = time.perf_counter() - t0

        ops = [sh_client_ops(rng, c, SH_PER) for c in range(SV_CLIENTS)]
        total = SV_CLIENTS * SH_PER
        kill_at = int(np.random.default_rng(SEED + 24).integers(
            total // 2 - 200, total // 2 + 201))
        lock = threading.Lock()
        acks, lat, errors, doubts = [], [], [], []
        hist = [[] for _ in range(SV_CLIENTS)]   # (op, "acked"|"doubt")
        finished = [None] * SV_CLIENTS
        killed, promoted = threading.Event(), threading.Event()

        def client(c):
            crng = random.Random(SEED + 240 + c)
            rid = c % SV_RIDS
            for i, op in enumerate(ops[c]):
                s = op[1] % SH_N
                t0 = time.perf_counter()
                try:
                    resp = call_with_retry(g.router, op, rid=rid,
                                           policy=retry, rng=crng,
                                           timeout=300.0, deadline_s=120.0)
                except Exception as e:  # noqa: BLE001 - classified below
                    doubt = (s == SH_VICTIM and killed.is_set() and not (
                        isinstance(e, ShardUnavailable)
                        and not e.maybe_executed))
                    if not doubt or not promoted.wait(120):
                        with lock:
                            errors.append(f"client {c} op {i} {op}: "
                                          f"{type(e).__name__}: {e}")
                        return
                    # the op's round reached the victim's log or not:
                    # its new home answers which
                    got = g.primaries[SH_VICTIM].live_frontend.read(
                        (HM_GET, op[1]), rid=rid)
                    before = models[c].vals.get(op[1], -1)
                    applied = got == (op[2] if op[0] == 1 else -1)
                    if not (applied or got == before):
                        with lock:
                            errors.append(f"client {c} op {i} {op} in "
                                          f"doubt reads {got}, acked {before}")
                        return
                    if applied:
                        models[c].apply(op)
                    with lock:
                        hist[c].append((op, "doubt"))
                        doubts.append(f"client {c} op {i}: "
                                      f"{type(e).__name__}")
                    continue
                want = models[c].apply(op)
                now = time.perf_counter()
                if resp != want:
                    with lock:
                        errors.append(f"client {c} op {i} {op}: {resp}, "
                                      f"model {want}")
                    return
                with lock:
                    acks.append((now, s))
                    lat.append(now - t0)
                    hist[c].append((op, "acked"))
            finished[c] = time.perf_counter()

        p1 = g.primaries[SH_VICTIM]
        mgr = p1.manager
        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"chip-shard-client-{c}")
                   for c in range(SV_CLIENTS)]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        t_kill = t_prom = detect_s = report = None
        t_end = t_load + 600
        while True:
            state = mgr.check()
            now = time.perf_counter()
            with lock:
                n_acked = len(acks)
            if t_kill is None and n_acked >= kill_at:
                killed.set()
                g.kill_primary(SH_VICTIM)
                t_kill = time.perf_counter()
            elif t_kill is not None and state == QUARANTINED:
                detect_s = now - t_kill
                report = g.promote(SH_VICTIM, detect_s=detect_s)
                t_prom = time.perf_counter()
                promoted.set()
                break
            if now > t_end or (t_kill is None and not any(
                    t.is_alive() for t in threads)):
                raise AssertionError(f"phase 24: {n_acked} acks, kill at "
                                     f"{kill_at}, killed {t_kill is not None}"
                                     f", state {state}; {errors[:3]}")
            time.sleep(0.03)
        # a survivor fences a submit under the old map version
        old = g.map.version - 1
        try:
            g.router.backend(0).submit_batch([(1, 0, SH_FENCE)], old)
            raise AssertionError("phase 24: shard 0 took a submit under the "
                                 "old map version")
        except WrongShard as e:
            if e.peer_version != old or e.map_version != g.map.version:
                raise AssertionError(f"phase 24: the stale submit's fence "
                                     f"says {e}")
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("phase 24: a client thread hung")
        threads = []
        t_done = time.perf_counter()
        if errors:
            raise AssertionError(f"phase 24: {errors[:5]}")
        if len(acks) + len(doubts) != total:
            raise AssertionError(f"phase 24: {len(acks)} acks and "
                                 f"{len(doubts)} in doubt of {total}")
        leg_ab = k1_leg("routed load and failover", s_a, len(doubts))

        # the victim's history: the promoted follower's WAL equals the
        # dead primary's below the promotion point, and holds every
        # acked op of the slice once, in each client's order
        fol = p1.follower
        frecs = list(fol.nr.wal.records(0))
        pos = _chained(frecs, "phase 24: the promoted follower's")
        drecs = [r for r in p1.wal.records(0) if r.pos < report.applied_pos]
        if [(r.pos, r.count, r.opcodes.tobytes(), r.args.tobytes())
                for r in drecs] != [
                (r.pos, r.count, r.opcodes.tobytes(), r.args.tobytes())
                for r in frecs if r.pos < report.applied_pos]:
            raise AssertionError("phase 24: the promoted follower's WAL "
                                 "differs from the dead primary's below "
                                 f"{report.applied_pos}")
        wal_ops = [[] for _ in range(SV_CLIENTS)]
        for rec in frecs:
            for op in rec.ops():
                if op[1] % SH_N != SH_VICTIM:
                    raise AssertionError(f"phase 24: shard {SH_VICTIM}'s WAL "
                                         f"holds {op}, of another class")
                wal_ops[op[1] // SV_SLICE].append(tuple(op))
        for c in range(SV_CLIENTS):
            expect = [(op, "acked") for op in batch_log
                      if op[1] // SV_SLICE == c and op[1] % SH_N == SH_VICTIM]
            expect += [h for h in hist[c] if h[0][1] % SH_N == SH_VICTIM]
            _match_history(expect, wal_ops[c], f"phase 24 client {c}")
        for s, p in enumerate(g.primaries):
            check_classes(p.live_frontend.nr, (s,), SH_N, models,
                          f"phase 24 shard {s}", others_absent=True)
            if not p.follower.promoted:
                check_classes(p.follower.nr, (s,), SH_N, models,
                              f"phase 24 shard {s}'s follower",
                              others_absent=True)

        def rate(t0, t1, shards):
            n = sum(1 for t, s in acks if t0 <= t < t1 and s in shards)
            return n / (t1 - t0) if t1 > t0 else None

        t_first = min(t for t, _ in acks)
        t_post = min(finished)
        surv = tuple(s for s in range(SH_N) if s != SH_VICTIM)
        pre = rate(t_first, t_kill, surv)
        post = rate(t_kill, t_post, surv)
        lat_ms = np.asarray(lat) * 1e3
        load = {
            "ops": total, "acked": len(acks), "in_doubt": len(doubts),
            "doubts": doubts[:8], "kill_at": kill_at,
            "wall_s": t_done - t_load,
            "acked_ops_per_s": len(acks) / (t_done - t_load),
            "pre_kill_ops_per_s": rate(t_first, t_kill, range(SH_N)),
            "per_shard_pre_kill": [rate(t_first, t_kill, (s,))
                                   for s in range(SH_N)],
            "survivors_pre_ops_per_s": pre, "survivors_post_ops_per_s": post,
            "survivor_hold": post / pre if pre and post else None,
            "post_window_s": t_post - t_kill,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "rto_s": report.rto_s, "detect_s": detect_s,
            "promote_s": report.promote_s,
            "kill_to_serving_s": t_prom - t_kill,
            "drained_records": report.drained_records,
            "promoted_at": report.applied_pos, "victim_wal_end": pos,
            "k1": leg_ab}
        out["load"] = load
        log(f"phase 24: sharded flagship, {SH_N} shards x (R={R} K={K} "
            f"ring 2^16 primary + follower, rids {SV_RIDS}): {SH_BATCHES} "
            f"cross-shard batches of {SH_BATCH} in {out['batches_s']:.2f} s, "
            f"then {SV_CLIENTS} clients x {SH_PER} ops: {len(acks)} acked, "
            f"{len(doubts)} in doubt at the kill (resolved by a read on the "
            f"new home), every response equal to the client models; "
            f"{load['acked_ops_per_s']:.1f} acked ops/s over the run "
            f"({load['pre_kill_ops_per_s']:.1f} before the kill: per shard "
            + ", ".join(f"{x:.1f}" for x in load["per_shard_pre_kill"])
            + f"; phase 13 depth 0 {serve13['depth0']['acked_ops_per_s']:.1f}"
            f" in this run), p50 {load['p50_ms']:.3f} ms, p99 "
            f"{load['p99_ms']:.3f} ms; {leg_ab['rounds']} shard rounds and "
            f"{leg_ab['applied_records']} applied records, "
            f"{leg_ab['k1_launches']} K1 launches (wrapper count = stats() "
            f"fused rounds = registry), 0 chain rounds")
        log(f"phase 24: shard {SH_VICTIM}'s primary killed at {kill_at} acks;"
            f" RTO {report.rto_s:.3f} s (detect {detect_s:.3f} + promote "
            f"{report.promote_s:.3f}, {report.drained_records} drained; "
            f"{load['kill_to_serving_s']:.3f} s from the kill); shards "
            f"{surv} {pre:.1f} acked ops/s before the kill, "
            f"{post:.1f} from the kill through the post window "
            f"({load['post_window_s']:.2f} s): hold "
            f"{load['survivor_hold']:.3f} (the reference's --sharded-hold-min"
            f" {SH_HOLD_MIN}, not a gate here: one process and one stream for "
            f"all shards); retries {leg_ab['retries']}; the promoted WAL "
            f"equals the dead primary's below {report.applied_pos} and holds "
            f"every acked op once; each shard's fleet holds only its class; "
            f"a stale-version submit to shard 0 was fenced")

        # (c) the socket path: shard 2 behind a ShardServer
        s_c = snap()
        p2 = g.primaries[2]
        server = ShardServer(2, p2.live_frontend, g.map, host="127.0.0.1",
                             port=0, name="chip")
        backends = {s: LocalBackend(s, g.primaries[s].live_frontend, g.map)
                    for s in range(SH_N) if s != 2}
        backends[2] = SocketShardClient(2, (server.host, server.port),
                                        g.map.version)
        router2 = ShardRouter(g.map, backends, map_path=str(SHARD_DIR))
        cops = sh_client_ops(rng, 0, SH_PER)
        t0 = time.perf_counter()
        for i, op in enumerate(cops):
            resp = call_with_retry(router2, op, rid=0, policy=retry,
                                   timeout=300.0)
            want = models[0].apply(op)
            if resp != want:
                raise AssertionError(f"phase 24 socket: op {i} {op}: {resp}, "
                                     f"model {want}")
        sock_s = time.perf_counter() - t0
        n_wire = sum(1 for op in cops if op[1] % SH_N == 2)
        try:
            backends[2].submit_batch([(1, 1, SH_FENCE)], g.map.version)
            raise AssertionError("phase 24: shard 2's server took key 1")
        except WrongShard as e:
            if (e.key, e.shard, e.expected_shard) != (1, 2, 1):
                raise AssertionError(f"phase 24: the misroute says {e}")
        server.set_map(g.map.with_address(2, (server.host, server.port)))
        stale = SocketShardClient(2, (server.host, server.port),
                                  g.map.version)
        try:
            stale.submit_batch([(1, 2, SH_FENCE)], g.map.version)
            raise AssertionError("phase 24: a stale HELLO was not fenced")
        except WrongShard as e:
            if e.peer_version != g.map.version:
                raise AssertionError(f"phase 24: the stale HELLO says {e}")
        finally:
            stale.close()
        router2.close()
        server.close()
        router2 = server = None
        leg_c = k1_leg("socket path", s_c)
        out["socket"] = {"ops": SH_PER, "over_the_wire": n_wire,
                         "seconds": sock_s, "ops_per_s": SH_PER / sock_s,
                         "k1": leg_c}
        log(f"phase 24: socket path: {SH_PER} ops of one client through a "
            f"second router ({n_wire} to shard 2 over ShardServer on "
            f"127.0.0.1) in {sock_s:.2f} s ({SH_PER / sock_s:.1f} ops/s), "
            f"every response equal to the model; a misrouted op came back "
            f"as a typed WrongShard, and a HELLO under the stale version was "
            f"fenced after the server's map bump")

        # (d) online split of class 0 under 8 per-key writers
        s_d = snap()
        p0 = g.primaries[0]
        recipient = p0.follower
        f_recip0 = recipient.nr.stats()["fused_rounds"]
        tail0 = p0.wal.tail
        wacked = {k: 0 for k in RS_KEYS}
        wt = {k: [] for k in RS_KEYS}
        werrs = []

        def writer(k):
            v = 0
            while not stop.is_set():
                v += 1
                try:
                    call_with_retry(g.router, (1, k, v), rid=k % SV_RIDS,
                                    policy=retry, deadline_s=30.0,
                                    timeout=60.0)
                except Exception as e:  # noqa: BLE001 - reported
                    werrs.append(f"key {k} value {v}: "
                                 f"{type(e).__name__}: {e}")
                    return
                wacked[k] = v
                wt[k].append(time.perf_counter())
                time.sleep(0.001)

        threads = [threading.Thread(target=writer, args=(k,),
                                    name=f"chip-reshard-w{k}")
                   for k in RS_KEYS]
        for t in threads:
            t.start()
        time.sleep(RS_WARMUP)
        plan = ReshardPlan(g, donor=0)
        t_split = time.perf_counter()
        rep = plan.split(catchup_timeout_s=60.0, drain_timeout_s=60.0)
        time.sleep(RS_WINDOW)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        if any(t.is_alive() for t in threads):
            raise AssertionError("phase 24: a split writer hung")
        threads = []
        t_end_d = time.perf_counter()
        if werrs:
            raise AssertionError(f"phase 24 split: {werrs[:3]}")
        if not (g.map.n_shards == 2 * SH_N and rep.moved == SH_N
                and rep.new_version == rep.old_version + 1):
            raise AssertionError(f"phase 24: the split gave {rep}, map "
                                 f"{g.map}")
        moved = [k for k in RS_KEYS if k % (2 * SH_N) == SH_N]
        for k in RS_KEYS:
            models[k // SV_SLICE].vals[k] = wacked[k]

        def home(k):
            s = g.map.shard_of(k)
            return (recipient.frontend if s == rep.moved
                    else g.primaries[s % SH_N].live_frontend)

        for k in RS_KEYS:
            got = home(k).read((HM_GET, k))
            if got != wacked[k]:
                raise AssertionError(f"phase 24 split: key {k} reads {got}, "
                                     f"last acked {wacked[k]}")

        def seq(wal, keys):
            out_ = {}
            for rec in wal.records(wal.base):
                if rec.pos < tail0:
                    continue
                for op in rec.ops():
                    if op[0] == 1 and op[1] in keys:
                        out_.setdefault(op[1], []).append(op[2])
            return out_

        dseq, rseq = seq(p0.wal, moved), seq(recipient.nr.wal, moved)
        for k in moved:
            rs = rseq.get(k, [])
            if any(b <= a for a, b in zip(rs, rs[1:])):
                raise AssertionError(f"phase 24 split: moved key {k} applied "
                                     f"out of order or twice: {rs[:20]}")
            if set(dseq.get(k, [])) - set(rs):
                raise AssertionError(f"phase 24 split: moved key {k}'s donor "
                                     f"writes never reached the recipient")
        unavail = 0.0
        for k in moved:
            prev = [t for t in wt[k] if t <= t_split]
            post_t = [t for t in wt[k] if t > t_split]
            anchor = prev[-1] if prev else t_split
            gaps = ([post_t[0] - anchor]
                    + [b - a for a, b in zip(post_t, post_t[1:])]
                    if post_t else [t_end_d - anchor])
            unavail = max(unavail, max(gaps))
        recip_rounds = recipient.nr.stats()["fused_rounds"] - f_recip0
        if recip_rounds <= 0:
            raise AssertionError("phase 24: the recipient served no K1 round")
        leg_d = k1_leg("split", s_d)
        out["split"] = {"report": rep.as_dict(), "moved_keys": moved,
                        "writes": sum(map(len, wt.values())),
                        "moved_writes": sum(len(v) for v in rseq.values()),
                        "moved_unavail_s": unavail,
                        "recipient_k1_rounds": recip_rounds, "k1": leg_d}
        log(f"phase 24: online split of class 0 under {len(RS_KEYS)} per-key "
            f"writers ({RS_WARMUP} s warm-up, {RS_WINDOW} s window): map "
            f"{SH_N} -> {g.map.n_shards} classes (v{rep.old_version} -> "
            f"v{rep.new_version}), class {rep.moved} re-homed onto shard 0's "
            f"promoted follower ({recip_rounds} K1 rounds there); catch-up "
            f"{rep.catchup_s:.3f} s, fence {rep.fence_s:.3f} s (the "
            f"reference's --reshard-unavail-max {RS_UNAVAIL_MAX} s, not a "
            f"gate), {rep.drained_records} drained, worst moved-key gap "
            f"{unavail:.3f} s; {out['split']['writes']} acked writes, none "
            f"lost, moved keys {moved} applied once each and in order")

        # (e) presumed-abort 2PC over the refined map
        s_e = snap()
        coord = g.coordinator()
        k = TX_KEY0
        t0 = time.perf_counter()
        for i in range(TX_COUNT):
            tops = [(1, k, TX_VAL_BASE + k), (1, k + 1, TX_VAL_BASE + k + 1)]
            if i % 3 == 0:
                tops.append((1, k + 2, TX_VAL_BASE + k + 2))
            k += len(tops)
            got = coord.execute_txn(tops, timeout=300.0)
            if got != [0] * len(tops):
                raise AssertionError(f"phase 24 txn {i}: {got}")
            for op in tops:
                models[op[1] // SV_SLICE].apply(op)
        tx_s = time.perf_counter() - t0
        decided = [d for d in g.decisions.decisions()
                   if d["outcome"] == "commit"]
        if len(decided) != TX_COUNT:
            raise AssertionError(f"phase 24: {len(decided)} commit decisions "
                                 f"for {TX_COUNT} transactions")
        for key in range(TX_KEY0, k):
            got = home(key).read((HM_GET, key))
            if got != TX_VAL_BASE + key:
                raise AssertionError(f"phase 24: committed key {key} reads "
                                     f"{got}")
        x, y = k, k + 1
        sx = g.map.shard_of(x)
        before = [home(x).read((HM_GET, x)), home(y).read((HM_GET, y))]
        foreign = f"foreign.g{coord.gen}.1"
        g.router.txn_call(sx, "prepare", foreign, coord.gen,
                          ops=[(1, x, SH_FENCE)])
        try:
            coord.execute_txn([(1, x, TX_VAL_BASE), (1, y, TX_VAL_BASE)],
                              timeout=300.0)
            raise AssertionError("phase 24: a txn over a held intent "
                                 "committed")
        except TxnAborted as e:
            aborted = e.txn
        g.router.txn_call(sx, "abort", foreign, coord.gen)
        after = [home(x).read((HM_GET, x)), home(y).read((HM_GET, y))]
        if after != before or g.decisions.outcome(aborted) != "abort":
            raise AssertionError(f"phase 24: the aborted txn left {before} -> "
                                 f"{after}, decision "
                                 f"{g.decisions.outcome(aborted)}")
        leg_e = k1_leg("2PC", s_e)
        out["txn"] = {"txns": TX_COUNT, "seconds": tx_s,
                      "txns_per_s": TX_COUNT / tx_s, "keys": k - TX_KEY0,
                      "aborted": aborted, "k1": leg_e}
        log(f"phase 24: 2PC over the {g.map.n_shards}-class map: {TX_COUNT} "
            f"cross-shard transactions of 2-3 PUTs ({k - TX_KEY0} keys), "
            f"each visible on read-back, {TX_COUNT / tx_s:.1f} txns/s; a "
            f"transaction over a held intent aborted ({aborted}) with zero "
            f"effect")

        # a profiled segment of shard rounds after a traced warm-up
        s_p = snap()
        pops = [sh_client_ops(rng, c, 2 * SH_PROFILED)
                for c in range(SV_CLIENTS)]

        def run_segment(lo, hi):
            def one(c):
                for op in pops[c][lo:hi]:
                    resp = call_with_retry(g.router, op, rid=c % SV_RIDS,
                                           policy=retry, timeout=300.0)
                    if resp != models[c].apply(op):
                        errors.append(f"profiled client {c} {op}: {resp}")
                        return
            ts = [threading.Thread(target=one, args=(c,),
                                   name=f"chip-shard-prof-{c}")
                  for c in range(SV_CLIENTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            if errors or any(t.is_alive() for t in ts):
                raise AssertionError(f"phase 24 profiled: {errors[:3]}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            run_segment(0, SH_PROFILED)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.05)
            c0 = count()
            l0 = k1_launches()
            t0 = time.perf_counter()
            run_segment(SH_PROFILED, 2 * SH_PROFILED)
            torch.cuda.synchronize()
            seg_s = time.perf_counter() - t0
            c1 = count()
            l1 = k1_launches()
        leg_p = k1_leg("profiled segment", s_p)
        rounds = c1["serve.batches"] - c0["serve.batches"]
        seg_k1 = l1 - l0
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        k1_ev = [e for e in ev if "hashmap_round" in e.key]
        k1_n = sum(e.count for e in k1_ev)
        k1_ms = (sum(e.self_device_time_total for e in k1_ev) / 1e3 / k1_n
                 if k1_n else None)
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        mean_batch = SV_CLIENTS * SH_PROFILED / max(1, rounds)
        k1_bound_ms, k1_by = bound(k1_model_round_bytes(R, mean_batch),
                                   4 * mean_batch * R)
        out["profiled"] = {
            "ops": SV_CLIENTS * SH_PROFILED, "rounds": rounds,
            "k1_launches": seg_k1, "k1_profiled": k1_n,
            "mean_batch": mean_batch, "k1_device_ms": k1_ms,
            "device_ms_per_k1": dev_ms / seg_k1 if seg_k1 and dev_ms
            else None,
            "wall_ms_per_round": seg_s * 1e3 / max(1, rounds),
            "k1_bound_ms": k1_bound_ms, "k1_bound_by": k1_by,
            "kernels": [{"name": e.key[:60], "count": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]],
            "k1": leg_p}
        log(f"phase 24: profiled segment ({SV_CLIENTS} clients x "
            f"{SH_PROFILED} ops after a traced warm-up): {rounds} shard rounds "
            f"(mean batch {mean_batch:.2f}), {seg_k1} K1 launches with the "
            f"standby's applies, {k1_n} seen by the profiler; K1 "
            + (f"{k1_ms:.4f} ms of device a launch" if k1_ms
               else "not measured")
            + f" against a {k1_bound_ms:.4f} ms bound at the mean batch; "
            f"{out['profiled']['wall_ms_per_round']:.3f} ms of host wall a "
            f"round")

        # the fleets after every leg: each live fleet's classes equal the
        # models; no refused write reached any journal
        n2 = g.map.n_shards
        check_classes(recipient.nr, (rep.moved,), n2, models,
                      "phase 24 recipient", others_absent=False)
        for s, p in enumerate(g.primaries):
            classes = (s,) if s == 0 else (s, s + SH_N)
            check_classes(p.live_frontend.nr, classes, n2, models,
                          f"phase 24 shard {s} after the split",
                          others_absent=False)
        wals = [p.wal for p in g.primaries] + [
            p.follower.nr.wal for p in g.primaries if p.follower is not None]
        wals += [recipient.nr.wal]
        for wal in wals:
            for rec in wal.records(wal.base):
                if (rec.args[:, 1] == SH_FENCE).any():
                    raise AssertionError("phase 24: a fenced write reached "
                                         "a journal")
        # the profiled segment's rounds, as shard 2's last records
        sizes = [r.count for r in list(g.primaries[2].wal.records(
            g.primaries[2].wal.base))[-8:]]
        launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                    "hashmap_fused_round": k1_launches()}
        k1chk = _k1_record_check(dev, sizes + [max(sizes)] * 2, mean_batch,
                                 label="phase 24",
                                 shape="the sharded rounds' batches")
        out.update(launches=launches, k1_check=k1chk,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   seconds=time.perf_counter() - t_phase)
        log(f"phase 24: K1 bit-identical to its plain version at the sharded "
            f"rounds' batches; launches {launches}; peak device memory "
            f"{out['peak_mem_bytes']} bytes; {out['seconds']:.1f} s")
        return out
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        for x in (router2, server):
            if x is not None:
                x.close()
        if g is not None:
            g.close()
        torch.cuda.empty_cache()
        shutil.rmtree(SHARD_DIR, ignore_errors=True)


def _txn_group(base: str, dev, recover: bool = False,
               with_txn: bool = True):
    """`bench.py --txn`'s `_txn_group` (2 shards, no followers, a
    sequential router) with phase 13's fleet a shard."""
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.shard import ShardGroup

    return ShardGroup(2, make_hashmap(K), base,
                      nr_kwargs=_crash_fleet_kwargs(dev),
                      with_followers=False, with_txn=with_txn,
                      recover=recover, concurrent_router=False,
                      rids=range(SV_RIDS))


def txn_child(directory: str) -> int:
    """`--txn-child DIR`: one kill round's victim. Builds `_txn_group`
    in DIR, arms a SIGKILL at the fault site and hit that DIR/kill.json
    names, and drives cross-shard transactions, fsyncing each acked one
    to DIR/acked.jsonl, until the kill."""
    import torch

    from node_replication_torch.fault import FaultPlan, FaultSpec

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    d = Path(directory)
    kill = json.loads((d / "kill.json").read_text())
    g = _txn_group(str(d), "cuda")
    coord = g.coordinator(name="bench")
    FaultPlan([FaultSpec(site=kill["site"], action="kill", rid=-1,
                         after=kill["after"])], seed=SEED).arm()
    with open(d / "acked.jsonl", "a") as acked:
        k = 0
        for i in range(TX_CHILD_TXNS):
            # k and k+1 differ mod 2, so every txn spans both shards;
            # keys only grow, so an aborted txn's keys read absent
            ops = [(1, k, TX_VAL_BASE + k), (1, k + 1, TX_VAL_BASE + k + 1)]
            if i % 3 == 0:
                ops.append((1, k + 2, TX_VAL_BASE + k + 2))
            k += len(ops)
            coord.execute_txn(ops)
            acked.write(json.dumps({"ops": [list(o) for o in ops]}) + "\n")
            acked.flush()
            os.fsync(acked.fileno())
    g.close()
    print(f"the kill at {kill} never came", file=sys.stderr)
    return 3


def phase_txn(dev) -> dict:
    """Phase 25: `bench.py --txn`'s SIGKILL matrix at the flagship widths.
    One `--txn-child` round per crash window (prepare, commit, decide),
    each SIGKILLed at a seeded hit in the middle half of its 24
    transactions; the parent recovers the group in place on the card
    (the WAL replayed through K1), bumps the coordinator epoch, re-drives
    published commits and resolves every in-doubt intent, then holds
    the result to the acks, the decisions and the WAL. Then the parity
    leg: non-transactional throughput with and without `with_txn`."""
    import random
    import shutil
    import signal

    import torch

    from node_replication_torch.models import HM_GET
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )

    rng = random.Random(SEED + 25)
    shutil.rmtree(TXN_DIR, ignore_errors=True)
    TXN_DIR.mkdir()
    torch.cuda.empty_cache()
    reset_launch_counts()
    t_phase = time.perf_counter()
    rounds = []
    try:
        for r, site in enumerate(TX_SITES):
            rdir = TXN_DIR / f"round{r}"
            rdir.mkdir()
            T, hits = TX_CHILD_TXNS, TX_HITS[site]
            after = rng.randrange(hits * (T // 4), hits * (3 * T // 4))
            (rdir / "kill.json").write_text(json.dumps(
                {"site": site, "after": after}))
            t0 = time.perf_counter()
            child = subprocess.run(child_cmd("--txn-child", rdir),
                                   capture_output=True, text=True,
                                   timeout=600)
            child_s = time.perf_counter() - t0
            if child.returncode != -signal.SIGKILL:
                raise AssertionError(
                    f"phase 25 round {r}: the child exited "
                    f"{child.returncode}, not by SIGKILL at {site} hit "
                    f"{after}: {child.stdout[-2000:]} {child.stderr[-2000:]}")
            l0 = k1_launches()
            t1 = time.perf_counter()
            g = _txn_group(str(rdir), dev, recover=True)
            try:
                recover_s = time.perf_counter() - t1
                replayed = sum(p.recovery.wal_records for p in g.primaries)
                k1 = k1_launches() - l0
                if k1 < replayed:
                    raise AssertionError(f"phase 25 round {r}: {replayed} WAL "
                                         f"records replayed in {k1} K1 "
                                         f"launches")
                pre: dict = {}
                for p in g.primaries:
                    for txn, info in p.txn.log.unresolved().items():
                        pre.setdefault(txn, {})[p.txn.shard] = [
                            tuple(op) for op in info["ops"]]
                coord = g.coordinator(name="recover")
                redrive = coord.recover()
                g.resolve_in_doubt()
                for p in g.primaries:
                    if p.txn.log.unresolved() or p.txn.has_locks():
                        raise AssertionError(
                            f"phase 25 round {r}: shard {p.txn.shard} still "
                            f"in doubt: {sorted(p.txn.log.unresolved())}")

                def read(k):
                    s = g.map.shard_of(k)
                    return g.primaries[s].live_frontend.read((HM_GET, k))

                acked = [json.loads(ln)["ops"] for ln in
                         (rdir / "acked.jsonl").read_text().splitlines()
                         if ln.strip()]
                half = 0
                for ops in acked:
                    half += any(read(k) != v for _c, k, v in ops)
                if not acked:
                    raise AssertionError(f"phase 25 round {r}: no txn acked "
                                         f"before the kill at {site}")
                outcomes = {}
                for txn, per_shard in sorted(pre.items()):
                    outcome = g.decisions.outcome(txn) or "abort"
                    outcomes[txn] = outcome
                    flat = [op for s in sorted(per_shard)
                            for op in per_shard[s]]
                    vis = sum(1 for _c, k, v in flat if read(k) == v)
                    half += (vis != len(flat)) if outcome == "commit" \
                        else vis > 0
                dup = 0
                for p in g.primaries:
                    seen = set()
                    for rec in p.wal.records(p.wal.base):
                        for op in rec.ops():
                            if op[0] != 1 or op[2] < TX_VAL_BASE:
                                continue
                            dup += (op[1], op[2]) in seen
                            seen.add((op[1], op[2]))
                if half or dup:
                    raise AssertionError(f"phase 25 round {r} ({site}): "
                                         f"{half} half-committed, {dup} "
                                         f"applied twice")
                rounds.append({
                    "site": site, "after": after, "child_s": child_s,
                    "acked": len(acked), "in_doubt": len(pre),
                    "outcomes": outcomes, "redriven": redrive["redriven"],
                    "recover_s": recover_s, "wal_records": replayed,
                    "k1_launches": k1, "half_committed": half,
                    "duplicated": dup})
            finally:
                g.close()
            log(f"phase 25 round {r}: child SIGKILLed at {site} hit {after} "
                f"after {len(acked)} acked txns ({child_s:.1f} s); recovered "
                f"in place on the card in {recover_s:.2f} s ({replayed} WAL "
                f"records, {k1} K1 launches), {len(pre)} in-doubt intents "
                f"resolved {sorted(set(outcomes.values()))}, "
                f"{redrive['redriven']} commits re-driven; every acked txn "
                f"visible, 0 half-committed, 0 applied twice")
        # parity: non-txn single-shard writes, with and without 2PC
        groups = {}
        done = {True: 0, False: 0}
        try:
            for cfg in (True, False):
                groups[cfg] = _txn_group(str(TXN_DIR / f"parity-{int(cfg)}"),
                                         dev, with_txn=cfg)
            for _ in range(3):
                for cfg in (True, False):
                    n, end = done[cfg], time.perf_counter() + TX_PARITY_S / 6
                    while time.perf_counter() < end:
                        # even keys: one shard, never the txn path
                        groups[cfg].router.call((1, (n % 64) * 2, n))
                        n += 1
                    done[cfg] = n
        finally:
            for grp in groups.values():
                grp.close()
        parity = done[True] / done[False]
        launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                    "hashmap_fused_round": k1_launches()}
        out = {"rounds": rounds, "parity": parity,
               "parity_ops": {"with_txn": done[True],
                              "without": done[False]},
               "half_committed": 0, "duplicated": 0, "launches": launches,
               "seconds": time.perf_counter() - t_phase}
        log(f"phase 25: {len(rounds)} SIGKILL rounds (prepare, commit, "
            f"decide), {sum(x['acked'] for x in rounds)} acked txns intact, "
            f"{sum(x['in_doubt'] for x in rounds)} in-doubt intents "
            f"resolved, 0 half-committed, 0 applied twice; parity "
            f"{parity:.3f} ({done[True]} non-txn ops with with_txn, "
            f"{done[False]} without; the reference's --txn-parity-min "
            f"{TX_PARITY_MIN}, not a gate); launches {launches}; "
            f"{out['seconds']:.1f} s")
        return out
    finally:
        shutil.rmtree(TXN_DIR, ignore_errors=True)


OBS_DIR = Path(__file__).resolve().parent / ".chip_smoke_obs"
OBS_PAIRS = 3         # `bench.py --serve --profile`: up to 3 off/on pairs
OBS_PER = 250         # ops a client (phase 13's 1000, cut for time)
OBS_HZ = 97.0         # `--profile-hz`'s default
OBS_RATIO_MIN = 0.95  # the reference's overhead gate: printed beside
OBS_ATTR_MIN = 0.9    # the reference's attributed-share floor: printed
OBS_TRACE_S = 1.0     # the exporter's device capture, s
OBS_TREE_CLIENTS = 8  # leg B's closed-loop clients
OBS_SAMPLE = 4        # leg B's per-record trace sampling, every process
OBS_RING = 1 << 16    # each process's ring tracer, events
OBS_HOPS = ("submit", "append", "wal-sync", "ship", "wire", "relay-forward",
            "apply")
K1_KERNEL = "hashmap_round_kernel"


def _wait_file(path: Path, what: str, timeout: float = 300.0,
               procs=()) -> str:
    """`path`'s text once it exists; raises when a child in `procs` died
    first or `timeout` ran out."""
    t_end = time.monotonic() + timeout
    while not path.exists():
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"phase 26: {what}: a child exited "
                                     f"{p.returncode} first")
        if time.monotonic() > t_end:
            raise AssertionError(f"phase 26: {what}: no {path.name} after "
                                 f"{timeout:.0f} s")
        # an Event wait: a Python-level wait the sampler reads as one
        threading.Event().wait(0.02)
    return path.read_text()


def _obs_tracer():
    """This process's tracer in ring mode with leg B's sampling."""
    from node_replication_torch.obs.recorder import get_tracer, set_trace_sample

    t = get_tracer()
    t.enable(None, ring=OBS_RING)
    set_trace_sample(OBS_SAMPLE)
    return t


def obs_primary(directory: str) -> int:
    """`--obs-primary DIR`: phase 26's primary. Serves phase 13's fleet
    from `ServeFrontend.from_recovery(DIR/primary, durability="batch")`
    with ship-before-ack into `DirectoryFeed(DIR/feed)`, a `FeedServer`
    (port to DIR/port), a ring tracer sampling 1 record in OBS_SAMPLE and
    its exporter (`obs_port=0`, port to DIR/obs_port). On DIR/go, 8
    closed-loop clients of OBS_PER ops each, every ack logged; then the
    feed tail and K1 launches to DIR/done; exits at DIR/stop."""
    import torch

    from node_replication_torch.durable.wal import durable_publish
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.repl import (
        DirectoryFeed,
        FeedServer,
        ReplicationShipper,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    d = Path(directory)
    get_registry().enable()
    _obs_tracer()
    acks = d / "acks"
    acks.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 26)
    ops = [hm_client_ops(rng, c, OBS_PER) for c in range(OBS_TREE_CLIENTS)]
    files = [open(acks / f"c{c}.txt", "a") for c in range(OBS_TREE_CLIENTS)]
    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001,
                      durability="batch", obs_port=0, obs_node_id="primary")
    fe = ServeFrontend.from_recovery(
        str(d / "primary"), make_hashmap(K), cfg, rids=range(SV_RIDS),
        nr_kwargs=_crash_fleet_kwargs("cuda"))
    feed = DirectoryFeed(str(d / "feed"), arg_width=3)
    shipper = ReplicationShipper(fe.nr.wal, feed)
    fe.ack_barrier = shipper.barrier
    srv = FeedServer(feed, wal=fe.nr.wal)
    durable_publish(str(d / "port"), str(srv.address[1]).encode(),
                    fsync=False)
    durable_publish(str(d / "obs_port"),
                    str(fe.exporter.address[1]).encode(), fsync=False)
    _wait_file(d / "go", "the primary's go")

    def on_ack(c, i, op, resp):
        files[c].write(f"{i} {' '.join(map(str, op))} {resp}\n")
        files[c].flush()

    r = serve_clients(fe, OBS_TREE_CLIENTS, OBS_PER, lambda c, i: ops[c][i],
                      lambda c, i, resp: None, lambda c: c % SV_RIDS,
                      on_ack=on_ack)
    for f in files:
        f.close()
    durable_publish(str(d / "done"), json.dumps({
        "tail": feed.tail_pos(), "k1_launches": k1_launches(),
        "serve": r}).encode(), fsync=False)
    _wait_file(d / "stop", "the primary's stop", timeout=600)
    srv.close()
    shipper.stop()
    fe.close()
    return 0 if not r["errors"] and r["completed"] == r["ops"] else 1


def obs_leaf(directory: str) -> int:
    """`--obs-leaf DIR`: phase 26's leaf. A `Follower` of phase 13's
    fleet (rids 0-7) over `SocketFeed` to the relay (port from
    DIR/relay_port), with its exporter (port to DIR/leaf_obs_port) and
    a ring tracer sampling as the primary does; applies each record with
    one K1 launch. Once the primary's DIR/done names the feed tail, it
    waits to apply it and checks its fleet against every acked op
    (DIR/leaf_check); exits at DIR/stop."""
    import torch

    from node_replication_torch.durable.wal import durable_publish
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.repl import Follower, SocketFeed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    d = Path(directory)
    get_registry().enable()
    _obs_tracer()
    port = int(_wait_file(d / "relay_port", "the relay's port"))
    leaf = Follower(make_hashmap(K), SocketFeed("127.0.0.1", port,
                                                arg_width=3),
                    str(d / "leaf"), nr_kwargs=_crash_fleet_kwargs("cuda"),
                    name="leaf", rids=range(SV_RIDS), obs_port=0)
    durable_publish(str(d / "leaf_obs_port"),
                    str(leaf.frontend.exporter.address[1]).encode(),
                    fsync=False)
    done = json.loads(_wait_file(d / "done", "the primary's done",
                                 timeout=600))
    check = {"applied_to": done["tail"]}
    try:
        if not leaf.wait_applied(done["tail"], timeout=300.0):
            raise AssertionError(f"the leaf applied {leaf.applied_pos()} "
                                 f"of {done['tail']}: {leaf.error!r}")
        models = [HashmapModel() for _ in range(SV_CLIENTS)]
        acked = _acked_ops(d / "acks")
        for c in range(OBS_TREE_CLIENTS):
            for op, resp in acked[c]:
                if models[c].apply(op) != resp:
                    raise AssertionError(f"client {c}'s acked {op} -> "
                                         f"{resp} disagrees with its model")
        check["acked"] = sum(map(len, acked))
        check_fleet_state(leaf.nr, models, "phase 26 leaf")
        check["ok"] = True
    except AssertionError as e:
        check["ok"], check["error"] = False, str(e)
    check["k1_launches"] = k1_launches()
    check["records"] = get_registry().counter("repl.applied_records").value
    durable_publish(str(d / "leaf_check"), json.dumps(check).encode(),
                    fsync=False)
    _wait_file(d / "stop", "the leaf's stop", timeout=600)
    leaf.close()
    return 0 if check["ok"] else 1


def _trace_kernels(path: Path, name: str) -> list[float]:
    """Durations (ms) of the chrome trace's kernel events named `name`."""
    doc = json.loads(path.read_text())
    return [float(e.get("dur", 0.0)) / 1e3 for e in doc["traceEvents"]
            if e.get("cat") == "kernel" and name in str(e.get("name", ""))]


def _prometheus_parses(text: str) -> int:
    """Series lines of a Prometheus text exposition; raises at a line
    that is neither a comment nor `name{labels} value`."""
    import re

    series = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*\{([a-z_]+="[^"]*",?)+\} '
                        r'(\S+)$')
    n = 0
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = series.match(ln)
        if m is None:
            raise AssertionError(f"phase 26: Prometheus line {ln!r}")
        float(m.group(2))
        n += 1
    return n


def _hot_stacks(snap: dict, n: int = 5) -> list[str]:
    """The `n` hottest busy (not waiting) stacks of a profile snapshot:
    count, stage, role and the four leafmost frames."""
    busy = [s for s in snap["stacks"] if not s["wait"]]
    busy.sort(key=lambda s: -s["count"])
    return [f"{s['count']} {s['stage']} {s['role']}: "
            + ";".join(s["frames"][-4:]) for s in busy[:n]]


def _obs_profiled_pairs(nr, models, rng) -> dict:
    """Leg A.1: up to OBS_PAIRS pairs of closed-loop runs, profiler off
    then on (`bench.py --serve --profile`), each side measured anew, the
    best ratio kept; every acked response against the client models."""
    from node_replication_torch.obs.profile import (
        STAGES,
        folded_from_snapshot,
        host_budget,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    best = None
    for pair in range(OBS_PAIRS):
        runs = {}
        for side, hz in (("off", None), ("on", OBS_HZ)):
            ops = [hm_client_ops(rng, c, OBS_PER) for c in range(SV_CLIENTS)]

            def check(c, i, resp, ops=ops):
                want = models[c].apply(ops[c][i])
                return (None if resp == want else
                        f"client {c} op {i} {ops[c][i]}: {resp}, model "
                        f"{want}")

            cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001,
                              profile_hz=hz)
            with ServeFrontend(nr, cfg, rids=range(SV_RIDS)) as fe:
                r = serve_clients(fe, SV_CLIENTS, OBS_PER,
                                  lambda c, i: ops[c][i], check,
                                  lambda c: c % SV_RIDS)
                if fe.profiler is not None:
                    fe.profiler.stop()
                    r["snapshot"] = fe.profiler.snapshot()
            if r["errors"] or r["completed"] != r["ops"]:
                raise AssertionError(f"phase 26 pair {pair} {side}: "
                                     f"{r['completed']} of {r['ops']}; "
                                     f"{r['errors']}")
            runs[side] = r
        ratio = runs["on"]["acked_ops_per_s"] / runs["off"]["acked_ops_per_s"]
        log(f"phase 26: pair {pair}: profiler off "
            f"{runs['off']['acked_ops_per_s']:.1f}, on "
            f"{runs['on']['acked_ops_per_s']:.1f} acked ops/s: ratio "
            f"{ratio:.4f}")
        if best is None or ratio > best["overhead_ratio"]:
            best = {"overhead_ratio": ratio, "pair": pair,
                    "off": runs["off"], "on": runs["on"]}
        if ratio >= OBS_RATIO_MIN:
            break
    snap = best["on"].pop("snapshot")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase26_served.folded").write_text(folded_from_snapshot(snap))
    budget = host_budget(snap)
    fracs = sum(s["frac"] for s in budget["stages"].values())
    if abs(fracs - 1.0) > 1e-9:
        raise AssertionError(f"phase 26: stage shares sum to {fracs}")
    best.update(pairs=pair + 1, hz=OBS_HZ,
                thread_samples=budget["thread_samples"],
                duty_cycle=budget["duty_cycle"],
                busy_frac=budget["busy_frac"],
                attributed_frac=budget["attributed_frac"],
                stages={k: v["frac"] for k, v in budget["stages"].items()},
                roles={k: v["samples"] for k, v in snap["roles"].items()},
                hot=_hot_stacks(snap))
    log(f"phase 26: profiler at {OBS_HZ:g} Hz: overhead_ratio "
        f"{best['overhead_ratio']:.4f} (the reference's gate "
        f"{OBS_RATIO_MIN}; pair {best['pair']} of {best['pairs']}), "
        f"attributed_frac {best['attributed_frac']:.4f} (its floor "
        f"{OBS_ATTR_MIN}), duty cycle {best['duty_cycle']:.6f}, busy "
        f"{best['busy_frac']:.4f}, {best['thread_samples']} thread samples; "
        "host budget: " + ", ".join(
            f"{s} {100 * best['stages'][s]:.1f}%"
            for s in STAGES if s in best["stages"])
        + f"; samples by role {best['roles']}; hottest busy stacks: "
        + " | ".join(best["hot"]))
    return best


def _obs_scrape_and_trace(nr, models, rng, c0: dict) -> dict:
    """Leg A.2: the frontend with `obs_port=0` and the profiler, 16
    clients; `device-trace` over the socket while they drive, a second
    request during the capture; then a socket scrape held against
    `stats()`, the registry and K1's launch count."""
    from node_replication_torch.obs import export
    from node_replication_torch.obs.profile import KNOWN_ROLES
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    tracer = _obs_tracer()
    trace_dir = OBS_DIR / "device_trace"
    ops = [hm_client_ops(rng, c, OBS_PER) for c in range(SV_CLIENTS)]
    answers = {}

    def check(c, i, resp):
        want = models[c].apply(ops[c][i])
        return (None if resp == want else
                f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

    def during(c, i):
        if c == 0 and i == OBS_PER // 4:
            answers["first"] = export.device_trace(
                host, port, str(trace_dir), duration_s=OBS_TRACE_S)
            answers["second"] = export.device_trace(
                host, port, str(trace_dir), duration_s=OBS_TRACE_S)

    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001, obs_port=0,
                      obs_node_id="flagship", profile_hz=OBS_HZ)
    with ServeFrontend(nr, cfg, rids=range(SV_RIDS)) as fe:
        host, port = fe.exporter.address
        threads = fe.threads()
        r = serve_clients(fe, SV_CLIENTS, OBS_PER, lambda c, i: ops[c][i],
                          check, lambda c: c % SV_RIDS, during=during)
        if r["errors"] or r["completed"] != r["ops"]:
            raise AssertionError(f"phase 26 scrape run: {r['completed']} of "
                                 f"{r['ops']}; {r['errors']}")
        first = answers["first"]
        if not (first.get("ok") and first.get("backend") == "cuda"):
            raise AssertionError(f"phase 26: device-trace answered {first}")
        if answers["second"].get("skipped") != "capture in progress":
            raise AssertionError(f"phase 26: a second device-trace during "
                                 f"the capture answered {answers['second']}")
        path = Path(first["path"])
        t_end = time.monotonic() + 120
        while not path.exists():
            failed = [e for e in tracer.events()
                      if e["event"] == "obs-device-trace" and not e["ok"]]
            if failed or time.monotonic() > t_end:
                raise AssertionError(f"phase 26: no device trace: {failed}")
            time.sleep(0.05)
        doc = export.scrape(host, port)
        stats = json.loads(json.dumps(fe.stats()))
        k1 = k1_launches()
    tracer.disable()
    if doc["stats"]["serve"] != stats:
        raise AssertionError("phase 26: the scrape's serve stats differ from "
                             "frontend.stats()")
    fused = doc["metrics"]["nr.exec.engine.pallas_fused"]
    n_series = _prometheus_parses(export.to_prometheus(doc))
    # the capture's window, from its `obs-device-trace` event
    done = [e for e in doc["events"] if e["event"] == "obs-device-trace"]
    if not (done and done[-1]["ok"]):
        raise AssertionError(f"phase 26: the capture ended with {done}")
    launch_events = sum(
        1 for e in doc["events"] if e["event"] == "kernel-launch"
        and done[-1]["mono_start"] <= e["mono"] <= done[-1]["mono_stop"])
    lock_wait = doc["metrics"].get("nr.lock.wait_s", {})
    durs = _trace_kernels(path, K1_KERNEL)
    if not durs:
        raise AssertionError(f"phase 26: no {K1_KERNEL} in the device trace")
    if set(threads) - KNOWN_ROLES or "other" in threads or not (
            len(threads.get("serve-worker", ())) == SV_RIDS
            and len(threads.get("obs-export", ())) == 1
            and threads.get("obs-profiler") == ["obs-profiler"]):
        raise AssertionError(f"phase 26: threads() {threads}")
    rounds = doc["metrics"]["serve.batches"] - c0["serve.batches"]
    if fused - c0["fused"] != k1 - c0["k1"]:
        raise AssertionError(f"phase 26: the scrape's pallas_fused rose by "
                             f"{fused - c0['fused']}, K1 launched "
                             f"{k1 - c0['k1']} times")
    mean_batch = r["completed"] / max(1, rounds)
    k1_bound_ms, k1_bound_by = bound(
        k1_model_round_bytes(R, mean_batch), 4 * mean_batch * R)
    out = {"serve": r, "rounds": rounds, "mean_batch": mean_batch,
           "k1_launches": k1 - c0["k1"], "series": n_series,
           "lock_wait_s": lock_wait,
           "threads": threads, "trace_k1": len(durs),
           "trace_k1_mean_ms": statistics.mean(durs),
           "kernel_launch_events": launch_events,
           "k1_bound_ms": k1_bound_ms, "k1_bound_by": k1_bound_by,
           "trace": str(path.relative_to(OBS_DIR.parent))}
    log(f"phase 26: exporter scrape over the socket: serve stats equal to "
        f"stats(), pallas_fused +{fused - c0['fused']} = K1 launches, "
        f"{n_series} Prometheus series parse; threads() "
        + ", ".join(f"{k} x{len(v)}" for k, v in sorted(threads.items()))
        + f"; device-trace {OBS_TRACE_S:g} s (backend cuda, a second "
        f"request: capture in progress): {len(durs)} {K1_KERNEL} in the "
        f"trace beside {launch_events} kernel-launch events in its window; "
        f"K1 mean {out['trace_k1_mean_ms']:.4f} ms of device time at mean "
        f"batch {mean_batch:.2f} (bound {k1_bound_ms:.4f} ms, "
        f"{k1_bound_by}); {r['acked_ops_per_s']:.1f} acked ops/s with the "
        f"exporter, profiler and tracer on; the combiner lock's contended "
        f"waits (nr.lock.wait_s, process-wide): {lock_wait}")
    return out


def _obs_tree() -> dict:
    """Leg B, `bench.py --tree --tree-obs`: an `--obs-primary` child, a
    `RelayNode` here over `SocketFeed`, an `--obs-leaf` child on the
    relay, each with its exporter and a ring tracer sampling 1 record in
    OBS_SAMPLE; a `FleetCollector` scrapes all three into fleet.jsonl
    while 8 clients drive the primary. The report's Fleet section must
    hold every node, a complete record across 3 processes and a
    submit->ack edge; the leaf must hold every acked write."""
    import shutil

    from node_replication_torch.durable.wal import durable_publish
    from node_replication_torch.obs import report
    from node_replication_torch.obs.collect import FleetCollector
    from node_replication_torch.obs.recorder import set_trace_sample
    from node_replication_torch.repl import RelayNode, SocketFeed

    want = {"primary": "primary", "relay": "relay", "leaf": "follower"}
    tree = OBS_DIR / "tree"
    shutil.rmtree(tree, ignore_errors=True)
    tree.mkdir(parents=True)
    logs = {n: open(tree / f"{n}.log", "w") for n in ("primary", "leaf")}
    procs, relay, coll = {}, None, None
    tracer = _obs_tracer()
    t0 = time.perf_counter()
    try:
        procs["primary"] = subprocess.Popen(
            child_cmd("--obs-primary", tree), stdout=logs["primary"],
            stderr=subprocess.STDOUT)
        port = int(_wait_file(tree / "port", "the primary's feed port",
                              procs=procs.values()))
        relay = RelayNode(SocketFeed("127.0.0.1", port, arg_width=3),
                          str(tree / "relay"), arg_width=3, name="relay",
                          obs_port=0)
        durable_publish(str(tree / "relay_port"),
                        str(relay.address[1]).encode(), fsync=False)
        procs["leaf"] = subprocess.Popen(
            child_cmd("--obs-leaf", tree), stdout=logs["leaf"],
            stderr=subprocess.STDOUT)
        targets = [
            "127.0.0.1:" + _wait_file(tree / "obs_port", "the primary's "
                                      "exporter", procs=procs.values()),
            relay.exporter,
            "127.0.0.1:" + _wait_file(tree / "leaf_obs_port", "the leaf's "
                                      "exporter", procs=procs.values())]
        coll = FleetCollector(targets, interval_s=0.2,
                              out_path=str(tree / "fleet.jsonl"))
        coll.start()
        # every node's sampling profiler, started over the exporters
        started = coll.start_profiles(hz=OBS_HZ)
        if sorted(started) != sorted(want) or not all(
                d.get("ok") for d in started.values()):
            raise AssertionError(f"phase 26: profile-start {started}")
        boot_s = time.perf_counter() - t0
        (tree / "go").write_text("")
        done = json.loads(_wait_file(tree / "done", "the primary's run",
                                     timeout=600, procs=procs.values()))
        check = json.loads(_wait_file(tree / "leaf_check", "the leaf's "
                                      "check", timeout=600,
                                      procs=procs.values()))
        profiles = coll.fetch_profiles(stop=True)
        coll.stop()
        (tree / "stop").write_text("")
        for n, p in procs.items():
            if p.wait(timeout=120) != 0:
                raise AssertionError(
                    f"phase 26: the {n} exited {p.returncode}: "
                    f"{(tree / f'{n}.log').read_text()[-3000:]}")
        cstats = coll.stats()
    finally:
        if coll is not None:
            coll.close()
        if relay is not None:
            relay.close()
        (tree / "stop").write_text("")
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        tracer.disable()
        set_trace_sample(1)
    srv = done["serve"]
    if srv["errors"] or srv["completed"] != srv["ops"]:
        raise AssertionError(f"phase 26: the primary acked "
                             f"{srv['completed']} of {srv['ops']}: "
                             f"{srv['errors']}")
    if not check["ok"]:
        raise AssertionError(f"phase 26 leaf: {check['error']}")
    fleet = report.analyze(report.load_events(
        str(tree / "fleet.jsonl")))["fleet"] or {}
    nodes = {n["node_id"]: n["role"] for n in fleet.get("nodes", ())}
    if any(nodes.get(k) != v for k, v in want.items()):
        raise AssertionError(f"phase 26: the fleet section's nodes {nodes}")
    edges = fleet.get("edges") or {}
    if fleet.get("complete_multiprocess_records", 0) < 1 \
            or "submit->ack" not in edges:
        raise AssertionError(
            f"phase 26: {fleet.get('complete_multiprocess_records')} "
            f"complete records across 3 processes, edges {sorted(edges)}")
    budgets = {}
    for node in want:
        doc = profiles.get(node, {})
        b = doc.get("budget")
        if not (b and b["thread_samples"] > 0 and abs(sum(
                v["frac"] for v in b["stages"].values()) - 1.0) < 1e-9):
            raise AssertionError(f"phase 26: {node}'s profile {doc}")
        budgets[node] = {"stages": {k: v["frac"]
                                    for k, v in b["stages"].items()},
                         "busy_frac": b["busy_frac"],
                         "duty_cycle": b["duty_cycle"],
                         "thread_samples": b["thread_samples"],
                         "hot": _hot_stacks(doc["profile"])}
        (OUT_DIR / f"phase26_{node}.folded").write_text(doc["folded"])
    chain = [f"{a}->{b}" for a, b in zip(OBS_HOPS, OBS_HOPS[1:])] + \
        ["submit->ack"]
    out = {"boot_s": boot_s, "serve": srv, "leaf": check,
           "collector": cstats, "nodes": nodes,
           "records": fleet["records"],
           "complete_records": fleet["complete_records"],
           "complete_multiprocess_records":
               fleet["complete_multiprocess_records"],
           "edges": edges, "budgets": budgets, "child_k1_launches": {
               "primary": done["k1_launches"],
               "leaf": check["k1_launches"]}}
    log(f"phase 26: observed tree (primary child, relay here, leaf child; "
        f"sampling 1/{OBS_SAMPLE}): {srv['completed']} ops acked by "
        f"{OBS_TREE_CLIENTS} clients at {srv['acked_ops_per_s']:.1f} "
        f"acked ops/s (p50 {srv['p50_ms']:.3f} ms, p99 {srv['p99_ms']:.3f} "
        f"ms); the leaf applied {check['records']} records to "
        f"{check['applied_to']} in {check['k1_launches']} K1 launches and "
        f"holds all {check['acked']} acked writes; the collector merged "
        f"{cstats['merged_events']} events in {cstats['cycles']} cycles; "
        f"fleet: nodes {nodes}, {fleet['records']} records, "
        f"{fleet['complete_records']} complete, "
        f"{fleet['complete_multiprocess_records']} across 3 processes")
    for node, b in budgets.items():
        log(f"phase 26: {node}'s host budget at {OBS_HZ:g} Hz "
            f"({b['thread_samples']} thread samples, busy "
            f"{b['busy_frac']:.4f}, duty {b['duty_cycle']:.6f}): "
            + ", ".join(f"{k} {100 * v:.1f}%" for k, v in b["stages"].items())
            + "; hottest busy stacks: " + " | ".join(b["hot"]))
    log("phase 26: edge p50/p95 ms: " + "; ".join(
        f"{e} {1e3 * edges[e]['p50_s']:.3f}/{1e3 * edges[e]['p95_s']:.3f} "
        f"(n={edges[e]['count']})" if e in edges else f"{e} none"
        for e in chain))
    return out


def phase_obs(dev, rng) -> dict:
    """Phase 26: the observed flagship. Leg A on phase 13's fleet in
    this process: the sampling profiler off and on in pairs, then the
    exporter's socket scrape and `device-trace` capture of K1. Leg B:
    the observed tree across three processes."""
    import shutil

    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )

    t_phase = time.perf_counter()
    reg = get_registry()
    reg.enable()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir()
    nr = NodeReplicated(make_hashmap(K), n_replicas=R, log_entries=1 << 16,
                        engine="pallas", device=dev)
    models = [HashmapModel() for _ in range(SV_CLIENTS)]
    reset_launch_counts()
    out = {"profiler": _obs_profiled_pairs(nr, models, rng)}
    c0 = {"serve.batches": reg.counter("serve.batches").value,
          "fused": reg.counter("nr.exec.engine.pallas_fused").value,
          "k1": k1_launches()}
    out["scrape"] = _obs_scrape_and_trace(nr, models, rng, c0)
    check_fleet_state(nr, models, "phase 26")
    del nr
    torch.cuda.empty_cache()
    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    out["tree"] = _obs_tree()
    out["launches"]["hashmap_fused_round"] += sum(
        out["tree"]["child_k1_launches"].values())
    if out["launches"]["hashmap_fused_round"] == 0:
        raise AssertionError("phase 26 never launched K1")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 26: launches {out['launches']} (the children's "
        f"{out['tree']['child_k1_launches']} included) in "
        f"{out['seconds']:.1f} s")
    return out


# ------------------------------------------------ the harness (phase 27)

# the sweep's window a system, s (cut from 1 s). The concurrent fold is
# out of the sweep (cut for time): its warm-up and first chunk, 11 steps
# of 4096 serial `apply_write`s, took ~25 s; its one step in the state
# check below is timed
HN_SWEEP_S = 0.5
HN_CHECK_STEPS = 1      # steps of the nr-vs-concurrent state check
HN_MESH_VERIFY = 2      # the mesh tiers' verify rounds (shmap ~0.8 s each)
HN_KERNEL_S = 0.5       # measure_kernel's timed rounds a tier, s
HN_MESH_S = 0.25        # measure_mesh's window a point, s
HN_CLIENTS, HN_PER = 8, 250   # measure_serve's closed-loop clients
HN_NATIVE_S = 0.5       # measure_native's window, s
HN_DIR = OUT_DIR / "phase27"  # the harness's CSVs


def _np_fold(gen, steps: int):
    """A numpy replay of the writes of `steps` steps of a `[S, R, B]`
    stream in log order (replica-major): `(values, present)`."""
    values, present = np.zeros(K, np.int32), np.zeros(K, bool)
    for s in range(steps):
        for o, a in zip(gen[0][s].reshape(-1), gen[1][s].reshape(-1, 3)):
            k = int(a[0]) % K
            if o in (1, 2):  # PUT sets the key, REMOVE clears it
                values[k], present[k] = (a[1], True) if o == 1 else (0, False)
    return values, present


def phase_harness(dev, rng) -> dict:
    """Phase 27: the port's harness on the card at the flagship width
    (`bench.py`'s default config: R = 4096, K = 10000, uniform keys,
    50/50): a `ScaleBenchBuilder` sweep of nr and partitioned, one
    timed step of the concurrent fold; `measure_kernel` at W = 256 on
    one device (K1 a `pallas_fused` round, under `torch.profiler` once)
    and on 4 shards (`mesh_fused`, K1 a shard); `measure_mesh` at 1 and
    4 shards; `measure_serve` on phase 13's served fleet;
    `measure_native`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from node_replication_torch import NodeReplicated
    from node_replication_torch.harness import (
        ConcurrentDsRunner,
        NativeRunner,
        ReplicatedRunner,
        ScaleBenchBuilder,
        WorkloadSpec,
        generate_batches,
    )
    from node_replication_torch.harness import mkbench as mk
    from node_replication_torch.models import make_hashmap
    from node_replication_torch.native import MODEL_HASHMAP
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    t_phase = time.perf_counter()
    HN_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    hm = lambda: make_hashmap(K)  # noqa: E731
    wl = WorkloadSpec(keyspace=K, write_ratio=50, seed=SEED)
    reset_launch_counts()

    # 1. the sweep, then NR's final state against the concurrent fold's
    t0 = time.perf_counter()
    sweep = (ScaleBenchBuilder(hm, "flagship", wl, device=dev)
             .replicas([R]).batches([2])
             .systems(["nr", "partitioned"])
             .duration(HN_SWEEP_S).out_dir(str(HN_DIR)).run())
    out["sweep"] = {r.name: {"client_mops": r.client_mops,
                             "replay_mops": r.mops,
                             "duration_s": r.duration_s,
                             "per_second": r.per_second} for r in sweep}
    out["sweep_s"] = time.perf_counter() - t0
    gen = generate_batches(wl, HN_CHECK_STEPS, R, 1, 1)
    nr = ReplicatedRunner(hm(), R, 1, 1, device=dev)
    cc = ConcurrentDsRunner(hm(), R, 1, 1, device=dev)
    for r in (nr, cc):
        r.prepare(*gen)
        t1 = time.perf_counter()
        for s in range(HN_CHECK_STEPS):
            r.run_step(s)
        r.block()
    out["concurrent_step_s"] = (time.perf_counter() - t1) / HN_CHECK_STEPS
    a, b = nr.state_dump(0), cc.state_dump()
    values, present = _np_fold(gen, HN_CHECK_STEPS)
    if not (nr.replicas_equal()
            and np.array_equal(a["values"], b["values"])
            and np.array_equal(a["present"], b["present"])
            and np.array_equal(b["values"], values)
            and np.array_equal(b["present"], present)):
        raise AssertionError("phase 27: the nr runner's state differs from "
                             "the concurrent fold's or the numpy map's")
    del nr, cc
    torch.cuda.empty_cache()
    log("phase 27: sweep R={} K={} 1w+1r: ".format(R, K) + ", ".join(
        f"{n} {v['client_mops']:.4f} Mops client ({v['replay_mops']:.2f} "
        f"replayed)" for n, v in out["sweep"].items())
        + f" in {out['sweep_s']:.1f} s; nr after {HN_CHECK_STEPS} step(s) "
        f"equal to the concurrent fold and a numpy map, replicas equal; "
        f"the concurrent fold {out['concurrent_step_s']:.1f} s a step "
        f"({R} serial writes; out of the sweep, cut for time)")

    # 2. measure_kernel on one device: K1 once a pallas_fused round
    bound_ms = k1_model_round_bytes(R, W_ROUND) / HBM_BYTES_PER_S * 1e3
    pts = mk.measure_kernel(K, R, W_ROUND, duration_s=HN_KERNEL_S,
                            device=dev)
    want = {"pallas_fused": 1, "combined": 2, "scan": 2}
    got = {p.tier: p.launches_per_round for p in pts}
    if (got != want or not all(p.bit_identical for p in pts)
            or any(p.interpret for p in pts)):
        raise AssertionError(f"phase 27: measure_kernel {pts}")
    mk.append_kernel_csv(str(HN_DIR), mk.kernel_rows("flagship", pts))
    # the profiler over a short pallas_fused call: verify, warm-up and
    # three timed rounds, each a hashmap_round_kernel (the scan chain
    # it is held against runs first and warms the tracer up)
    l0 = k1_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        short = mk.measure_kernel(K, R, W_ROUND, duration_s=0.0,
                                  tiers=("pallas_fused",), verify_rounds=2,
                                  device=dev)
        torch.cuda.synchronize()
    launched = k1_launches() - l0
    k1_ev = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and "hashmap_round" in e.key]
    k1_seen = sum(e.count for e in k1_ev)
    if not (short[0].bit_identical and short[0].rounds <= k1_seen
            <= launched):
        raise AssertionError(f"phase 27: the profiler saw {k1_seen} K1 "
                             f"kernels for {launched} launches "
                             f"({short[0].rounds} timed rounds)")
    k1_ms = (sum(e.self_device_time_total for e in k1_ev) / 1e3 / k1_seen)
    out["kernel"] = {"points": [dataclasses.asdict(p) for p in pts],
                     "bound_ms": bound_ms, "profiled_launches": launched,
                     "profiled_k1": k1_seen, "k1_device_ms": k1_ms}
    fused = next(p for p in pts if p.tier == "pallas_fused")
    log(f"phase 27: measure_kernel R={R} K={K} W={W_ROUND}: " + ", ".join(
        f"{p.tier} p50 {p.p50_ms:.4f} ms p95 {p.p95_ms:.4f} ms "
        f"({p.rounds} rounds, {p.launches_per_round} launches a round)"
        for p in pts) + f"; all bit-identical to the scan chain; a "
        f"fenced pallas_fused round's p50 {fused.p50_ms:.4f} ms beside "
        f"K1's bound {bound_ms:.4f} ms; the profiler saw {k1_seen} "
        f"hashmap_round_kernel for {launched} launches, {k1_ms:.4f} ms "
        f"of device time each")

    # 3. four shards on this card: mesh_fused (K1 a shard) and shmap,
    # then the mesh curve at 1 and 4 shards
    shards = mesh_devices(MESH_SHARDS)
    mpts = mk.measure_kernel(K, R, W_ROUND, duration_s=HN_KERNEL_S,
                             verify_rounds=HN_MESH_VERIFY, devices=shards)
    got = {p.tier: p.launches_per_round for p in mpts}
    if (got != {"mesh_fused": MESH_SHARDS, "shmap": 2}
            or not all(p.bit_identical for p in mpts)):
        raise AssertionError(f"phase 27: mesh measure_kernel {mpts}")
    mk.append_kernel_csv(str(HN_DIR), mk.kernel_rows("flagship", mpts))
    curve = mk.measure_mesh(hm, [1, shards], R, keyspace=K,
                            duration_s=HN_MESH_S, repeats=1, device=dev)
    if not all(p.bit_identical for p in curve):
        raise AssertionError("phase 27: a mesh point differs from the "
                             "1-device fleet")
    mk.append_mesh_csv(str(HN_DIR), mk.mesh_rows("flagship", curve, 2, K,
                                                 R)
                       + mk.mesh_tier_rows("flagship", W_ROUND, mpts))
    out["mesh_kernel"] = [dataclasses.asdict(p) for p in mpts]
    out["mesh_curve"] = [{"devices": p.devices, "mops": p.result.mops,
                          "bit_identical": p.bit_identical} for p in curve]
    log(f"phase 27: {MESH_SHARDS} shards on {sorted(set(map(str, shards)))}"
        ": " + ", ".join(f"{p.tier} p50 {p.p50_ms:.4f} ms p95 "
                         f"{p.p95_ms:.4f} ms ({p.launches_per_round} "
                         f"launches a round)" for p in mpts)
        + "; measure_mesh " + ", ".join(
            f"{p.devices} device(s) {p.result.mops:.2f} Mdisp/s"
            for p in curve) + ", every point bit-identical")

    # 4. measure_serve on phase 13's served fleet
    reg = get_registry()
    reg.enable()
    counters = ("serve.batches", "nr.exec.engine.pallas_fused",
                "nr.exec.engine.fused_fallback")
    fleet = NodeReplicated(make_hashmap(K), n_replicas=R,
                           log_entries=1 << 16, engine="pallas", device=dev)
    models = [HashmapModel() for _ in range(HN_CLIENTS)]
    ops = [hm_client_ops(rng, c, HN_PER) for c in range(HN_CLIENTS)]

    def check(c, i, resp):
        want = models[c].apply(ops[c][i])
        return (None if resp == want else
                f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

    c0 = {n: reg.counter(n).value for n in counters}
    k0 = k1_launches()
    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001)
    with ServeFrontend(fleet, cfg, rids=range(SV_RIDS)) as fe:
        sres = mk.measure_serve(fe, lambda c, i: ops[c][i],
                                HN_CLIENTS * HN_PER, HN_CLIENTS,
                                rid_of=lambda c: c % SV_RIDS, check=check,
                                name="flagship")
    d = {n: reg.counter(n).value - c0[n] for n in counters}
    k1 = k1_launches() - k0
    if (sres.errors or sres.transport_errors
            or sres.completed != HN_CLIENTS * HN_PER
            or not d["serve.batches"] == d["nr.exec.engine.pallas_fused"]
            == k1 > 0 or d["nr.exec.engine.fused_fallback"]):
        raise AssertionError(f"phase 27: measure_serve {sres.completed} "
                             f"acked, errors {sres.errors[:3]} "
                             f"{sres.transport_errors[:3]}, rounds {d}, "
                             f"K1 launches {k1}")
    check_fleet_state(fleet, models, "phase 27 serve")
    del fleet
    torch.cuda.empty_cache()
    mk.append_serve_csv(str(HN_DIR), mk.serve_rows("flagship", sres))
    out["serve"] = {"acked_ops_per_s": sres.throughput,
                    "p50_ms": sres.percentile_ms(50),
                    "p99_ms": sres.percentile_ms(99),
                    "rounds": d["serve.batches"], "k1_launches": k1}
    log(f"phase 27: measure_serve {HN_CLIENTS} clients x {HN_PER} ops on "
        f"rids 0-{SV_RIDS - 1}: {sres.completed} acked, every response "
        f"equal to the client models; {sres.throughput:.1f} acked ops/s, "
        f"p50 {sres.percentile_ms(50):.3f} ms, p99 "
        f"{sres.percentile_ms(99):.3f} ms; {k1} K1 launches for "
        f"{d['serve.batches']} rounds; the fleet equal to the models")

    # 5. the native C++ engine (built in phase 1 with this host's g++)
    nat = NativeRunner(MODEL_HASHMAP, K, n_replicas=2,
                       threads_per_replica=2, write_pct=50, keyspace=K)
    try:
        nres = mk.measure_native(nat, duration_s=HN_NATIVE_S)
        if not (nres.total_client_ops > 0 and nat.replicas_equal()
                and int(nat.last_per_sec.sum()) == nres.total_client_ops):
            raise AssertionError(f"phase 27: native {nres}")
        mk._append_csv(str(HN_DIR / mk.SCALEOUT_CSV), mk._CSV_FIELDS,
                       mk.native_rows(nat, nres, "flagship", 32,
                                      wr_eff=50))
    finally:
        nat.close()
    out["native"] = {"client_mops": nres.client_mops,
                     "threads": int(nat.last_per_sec.shape[0])}
    log(f"phase 27: measure_native 2 replicas x 2 threads, "
        f"{HN_NATIVE_S} s: {nres.client_mops:.3f} Mops, replicas equal")

    out["launches"] = {"hashmap_replay": REPLAY_KERNEL.launches,
                       "hashmap_fused_round": k1_launches()}
    if out["launches"]["hashmap_fused_round"] == 0:
        raise AssertionError("phase 27 never launched K1")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 27: launches {out['launches']} in {out['seconds']:.1f} s; "
        f"CSVs in {HN_DIR}")
    return out


# ------------------------------------------------------ the sim (sim/)

SIM_SEEDS = 500        # leg A's sweep, `explore --seeds`: ~40 s on the card
SIM_PROCS = 4          # `explore --procs`: the CI sim-smoke job's children
SIM_PARITY = 24        # leg B's seeds run on the card and on the CPU
SIM_CANARY_SEEDS = 200
SIM_KEYS, SIM_RING, SIM_SLACK = 32, 256, 32   # the sim's hashmap fleets
SIM_K1_R = (1, 2, 3)   # their replica counts
SIM_K1_W = (1, 16)     # a 1-op round, and a burst
SIM_QUANTA = 120       # leg C's scheduler quanta
SIM_BATCH = 256        # leg C's write quantum: one 256-op round
SIM_SNAPSHOTS = 2      # leg C's snapshots, at most
SIM_OUT = OUT_DIR / "sim"   # leg A's artifacts: must stay empty
SIM_DIR = Path(__file__).resolve().parent / ".chip_smoke_sim"


def sim_explore_cmd(*args: str) -> list[str]:
    """The command line of `python -m node_replication_torch.sim.explore`
    from this checkout (no `--device`: the card)."""
    return [sys.executable, "-m", "node_replication_torch.sim.explore",
            *args]


def _sim_sweep() -> dict:
    """Leg A: the CI sim-smoke sweep, `explore --seeds N --procs 4` in a
    subprocess with the default filters, every case on the card."""
    import re
    import shutil

    shutil.rmtree(SIM_OUT, ignore_errors=True)
    t0 = time.perf_counter()
    p = subprocess.run(
        sim_explore_cmd("--seeds", str(SIM_SEEDS), "--procs",
                        str(SIM_PROCS), "--out", str(SIM_OUT)),
        cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=900)
    secs = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "phase28_sweep.txt").write_text(p.stdout + p.stderr)
    artifacts = sorted(SIM_OUT.glob("*.json")) if SIM_OUT.exists() else []
    if p.returncode != 0 or artifacts:
        raise AssertionError(
            f"phase 28 A: the sweep exited {p.returncode} with "
            f"{len(artifacts)} artifact(s): {p.stdout[-3000:]} "
            f"{p.stderr[-2000:]}")
    matrix: dict = {}
    for m, w, f, ok, bad in re.findall(
            r"^\s*(\w+) x\s+(\w+) x\s+(\w+): (\d+) ok(?:, (\d+) FAIL)?$",
            p.stdout, re.M):
        key = f"{m}/{w}/{f}"
        matrix[key] = matrix.get(key, 0) + int(ok)
    swept = [(int(n), float(s)) for n, s in re.findall(
        r"swept (\d+) seed\(s\) in ([\d.]+)s", p.stdout)]
    if sum(matrix.values()) != SIM_SEEDS or sum(n for n, _ in swept) \
            != SIM_SEEDS:
        raise AssertionError(f"phase 28 A: {matrix} and {swept} do not "
                             f"add up to {SIM_SEEDS} clean seeds")
    out = {"seeds": SIM_SEEDS, "procs": SIM_PROCS, "wall_s": secs,
           "seeds_per_s": SIM_SEEDS / secs,
           "child_seeds_per_s": [n / max(s, 1e-9) for n, s in swept],
           "child_sweep_s": [s for _, s in swept], "matrix": matrix}
    log(f"phase 28 A: explore --seeds {SIM_SEEDS} --procs {SIM_PROCS} on "
        f"the card: exit 0, no artifact, {secs:.1f} s of wall "
        f"({out['seeds_per_s']:.2f} seeds/s, the children's sweeps "
        + ", ".join(f"{s:.1f}" for _, s in swept) + " s)")
    log("phase 28 A: coverage " + ", ".join(
        f"{k} {v}" for k, v in sorted(matrix.items())))
    return out


def _sim_covering_seeds() -> list[int]:
    """The first SIM_PARITY seeds, then more until every flavor and both
    wrappers appear."""
    from node_replication_torch.sim.properties import (
        FLAVORS,
        WRAPPERS,
        generate_case,
    )

    seeds = list(range(SIM_PARITY))
    seen = {x for s in map(generate_case, seeds) for x in (s.flavor,
                                                          s.wrapper)}
    for seed in range(SIM_PARITY, 50 * SIM_PARITY):
        if seen >= set(FLAVORS) | set(WRAPPERS):
            return seeds
        spec = generate_case(seed)
        if {spec.flavor, spec.wrapper} - seen:
            seeds.append(seed)
            seen |= {spec.flavor, spec.wrapper}
    raise AssertionError(f"phase 28 B1: seeds 0-{seed} cover only {seen}")


def _sim_parity(dev) -> dict:
    """Leg B1: each seed's case on the card and on the CPU, both clean,
    with equal digests; the card's K1 launches and rounds per tier."""
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.sim import generate_case, run_case

    seeds = _sim_covering_seeds()
    reg = get_registry()
    reg.enable()
    tiers = {"pallas_fused": ("nr.exec.engine.pallas_fused",
                              "cnr.exec.engine.pallas_fused"),
             "chain": ("nr.exec.rounds", "cnr.exec.rounds"),
             "fused_fallback": ("nr.exec.engine.fused_fallback",
                                "cnr.exec.engine.fused_fallback")}
    count = lambda: {t: sum(reg.counter(n).value for n in ns)  # noqa: E731
                     for t, ns in tiers.items()}
    c0 = count()
    reset_launch_counts()
    t0 = time.perf_counter()
    on_card = {s: run_case(generate_case(s), dev) for s in seeds}
    card_s = time.perf_counter() - t0
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    c1 = count()
    t1 = time.perf_counter()
    on_cpu = {s: run_case(generate_case(s), "cpu") for s in seeds}
    cpu_s = time.perf_counter() - t1
    cases = []
    for s in seeds:
        a, b = on_card[s], on_cpu[s]
        if not (a.ok and b.ok and a.digest == b.digest
                and a.events == b.events):
            bad = next((i, x, y) for i, (x, y) in enumerate(
                zip(a.events, b.events)) if x != y) \
                if a.events != b.events else None
            raise AssertionError(
                f"phase 28 B1: seed {s} ({a.spec.flavor}/{a.spec.wrapper}) "
                f"card ok={a.ok} cpu ok={b.ok}, digests {a.digest} / "
                f"{b.digest}; first differing event {bad}; violations "
                f"{[v.as_dict() for v in a.violations + b.violations]}")
        cases.append([s, a.spec.model, a.spec.wrapper, a.spec.flavor,
                      a.digest])
    if launches["hashmap_fused_round"] <= 0:
        raise AssertionError("phase 28 B1: no K1 launch over the card's "
                             "cases")
    rounds = {t: c1[t] - c0[t] for t in tiers}
    out = {"seeds": seeds, "cases": cases, "card_s": card_s,
           "cpu_s": cpu_s, "launches": launches, "rounds": rounds,
           "flavors": sorted({c[3] for c in cases}),
           "wrappers": sorted({c[2] for c in cases})}
    log(f"phase 28 B1: {len(seeds)} seeds ({', '.join(out['flavors'])}; "
        f"{', '.join(out['wrappers'])}) clean on the card and on the CPU, "
        f"equal digests and events; card {card_s:.1f} s, CPU {cpu_s:.1f} "
        f"s; K1 launches {launches['hashmap_fused_round']}; rounds "
        f"pallas_fused {rounds['pallas_fused']}, chain {rounds['chain']} "
        f"({rounds['fused_fallback']} fused fallbacks)")
    return out


def _k1_sim_check(dev) -> dict:
    """Leg B2: K1 over the states against its plain version at the sim's
    fleets (R = 1-3, K = 32, a 256-slot ring with gc_slack 32), W = 1
    and 16, fenced and unfenced, over rounds across the ring's wrap; its
    time a launch from CUDA events over queued calls (launch latency at
    these sizes)."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    rng = np.random.default_rng(SEED + 28)
    err, shapes = 0, {}
    for Rs in SIM_K1_R:
        spec = LogSpec(capacity=SIM_RING, n_replicas=Rs, arg_width=3,
                       gc_slack=SIM_SLACK)
        for W in SIM_K1_W:
            kp = -(-SIM_KEYS // 8) * 8
            vals = torch.from_numpy(rng.integers(
                -50, 50, (kp, Rs)).astype(np.int32)).to(dev)
            pres = torch.from_numpy(rng.integers(
                0, 2, (kp, Rs)).astype(np.int32)).to(dev)
            ring = (torch.zeros(SIM_RING, dtype=torch.int32, device=dev),
                    torch.zeros((SIM_RING, 3), dtype=torch.int32,
                                device=dev))
            fen = torch.zeros(Rs, dtype=torch.int32, device=dev)
            fen[Rs - 1] = 1
            kern = plain = (*ring, *planes_to_states(vals, pres, SIM_KEYS))
            tail = SIM_RING - 3 * W - 2
            rnd = 0
            while tail <= SIM_RING + W:
                count = W if W == 1 else int(rng.integers(1, W + 1))
                opc = np.zeros(W, np.int32)
                opc[:count] = rng.choice(np.array([1, 1, 1, 2], np.int32),
                                         count)
                args = np.zeros((W, 3), np.int32)
                args[:count, 0] = rng.integers(0, SIM_KEYS, count)
                args[:count, 1] = rng.integers(1, 1 << 20, count)
                inputs = (spec, torch.tensor(tail, dtype=torch.int64,
                                             device=dev),
                          count, torch.from_numpy(opc).to(dev),
                          torch.from_numpy(args).to(dev))
                f = fen if rnd % 2 else None
                out_k = k1(*inputs, *kern, SIM_KEYS, f)
                out_p = k1_plain(*inputs, *plain, SIM_KEYS, f)
                e = max_abs_err(out_k, out_p)
                if e:
                    raise AssertionError(
                        f"phase 28 B2: K1 at R={Rs} W={W} disagrees with "
                        f"its plain version in round {rnd} (fenced="
                        f"{f is not None}): {e}")
                err = max(err, e)
                kern, plain = out_k[:4], out_p[:4]
                tail += count
                rnd += 1
            call = (*inputs, *kern, SIM_KEYS, None)
            ms = queued_ms(lambda: k1(*call))
            plain_ms = cuda_ms(lambda: k1_plain(*call), reps=10, warmup=2)
            n_bytes = k1_model_round_bytes(Rs, W, SIM_RING, SIM_KEYS)
            bound_ms, by = bound(n_bytes, 4 * W * Rs)
            shapes[f"R{Rs}_W{W}"] = {
                "R": Rs, "W": W, "rounds": rnd, "ms": ms,
                "plain_ms": plain_ms, "bytes": n_bytes,
                "bound_ms": bound_ms, "bound_by": by}
    log("phase 28 B2: K1 at the sim's shapes (K=32, ring 256, gc_slack "
        "32), fenced and not, across the wrap, bit-identical; a launch "
        "(events over queued calls; launch latency at this size) / plain "
        "/ bound ms: " + ", ".join(
            f"R={v['R']} W={v['W']} {v['ms']:.4f} / {v['plain_ms']:.3f} / "
            f"{v['bound_ms']:.6f}" for v in shapes.values()))
    return {"max_abs_err": err, "shapes": shapes}


def _sim_canaries(dev) -> dict:
    """Leg B3: each canary caught by a bounded sweep on the card and
    replayed byte-identically (`explore --canary NAME --no-shrink`;
    shrinking is host-only ddmin, held by the CPU tests)."""
    import contextlib
    import io

    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.sim import canary, explore

    out, texts = {}, []
    reset_launch_counts()
    for name in sorted(canary.CANARIES):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = explore.main(["--canary", name, "--seeds",
                               str(SIM_CANARY_SEEDS), "--no-shrink",
                               "--device", str(dev)])
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        texts.append(f"== {name} (exit {rc})\n{text}")
        caught = [ln for ln in text.splitlines() if " FAILED " in ln]
        if rc != 0 or not caught or "IDENTICAL" not in text:
            raise AssertionError(f"phase 28 B3: canary {name} exited {rc}: "
                                 f"{text[-2000:]}")
        out[name] = {"rc": rc, "s": secs, "caught": caught[0]}
    (OUT_DIR / "phase28_canaries.txt").write_text("\n".join(texts))
    launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                "hashmap_fused_round": k1_launches()}
    log("phase 28 B3: every canary caught on the card and replayed "
        "byte-identically: " + "; ".join(
            f"{n} ({v['caught'].split(' [')[0]}, {v['s']:.1f} s)"
            for n, v in out.items()) + f"; launches {launches}")
    return {"canaries": out, "launches": launches}


def _sim_flagship_crash(dev) -> dict:
    """Leg C: the crash flavor's checks on phase 13's flagship fleet
    (`engine="pallas"`, a WAL attached, under a SimClock): a seeded
    SimScheduler steps write (a 256-op round from the sim's write
    vocabulary at K = 10000, unique payloads), read, wal-sync and
    snapshot quanta, each response and read held to the numpy oracle;
    then a simulated kill -9 as the crash flavor makes it (flush, the
    active segment cut to its last fsynced size plus a torn remainder)
    and `recover_fleet` on the card: durable-ack-survival, log-content,
    bit-identity and state-diff."""
    import random
    import shutil

    import torch

    from node_replication_torch import NodeReplicated
    from node_replication_torch.core.log import ring_slice
    from node_replication_torch.durable import (
        WAL_SUBDIR,
        WriteAheadLog,
        recover_fleet,
        save_durable_snapshot,
    )
    from node_replication_torch.models import HM_GET, make_hashmap
    from node_replication_torch.ops.replay import (
        REPLAY_KERNEL,
        reset_launch_counts,
    )
    from node_replication_torch.sim import SimScheduler, make_oracle
    from node_replication_torch.sim.properties import _gen_write
    from node_replication_torch.utils.clock import SimClock, installed

    shutil.rmtree(SIM_DIR, ignore_errors=True)
    SIM_DIR.mkdir()
    rng = random.Random(SEED + 28)
    oracle = make_oracle("hashmap", K)
    acked: list = []   # every write's ops, in log order
    synced: dict = {}  # segment path -> size at its last fsync
    st = {"uniq": 1, "snapshots": 0, "reads": 0}
    kw = _crash_fleet_kwargs(dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        with installed(SimClock()):
            nr = NodeReplicated(make_hashmap(K), **kw)
            wal = WriteAheadLog(str(SIM_DIR / WAL_SUBDIR), policy="batch",
                                arg_width=nr.dispatch.arg_width)
            nr.attach_wal(wal)
            tokens: dict = {}

            def write():
                rid = rng.randrange(R)
                ops = []
                for _ in range(SIM_BATCH):
                    ops.append(tuple(_gen_write(rng, "hashmap", K,
                                                st["uniq"])))
                    st["uniq"] += 1
                resps = nr.execute_mut_batch(ops, rid)
                for op, r in zip(ops, resps):
                    want = oracle.apply(op)
                    if int(r) != want:
                        raise AssertionError(
                            f"phase 28 C: resp-diff: {op} -> {int(r)}, "
                            f"oracle {want}")
                acked.extend(ops)
                return True

            def read():
                rid, k = rng.randrange(R), rng.randrange(K)
                if rid not in tokens:
                    tokens[rid] = nr.register(rid)
                val = int(nr.execute((HM_GET, k), tokens[rid]))
                if val != oracle.read((HM_GET, k)):
                    raise AssertionError(f"phase 28 C: read-diff: key {k} "
                                         f"on r{rid} -> {val}")
                st["reads"] += 1
                return True

            def wal_sync():
                nr.wal_sync()
                if wal._segments:
                    path = wal._segments[-1][1]
                    synced[path] = os.path.getsize(path)
                return True

            def snapshot():
                if st["snapshots"] >= SIM_SNAPSHOTS:
                    return False
                save_durable_snapshot(nr, str(SIM_DIR))
                st["snapshots"] += 1
                return True

            sched = SimScheduler(SEED + 28)
            sched.add("write", write, weight=3.0)
            sched.add("read", read, weight=1.0)
            sched.add("wal-sync", wal_sync, weight=1.2)
            sched.add("snapshot", snapshot, weight=0.3)
            reset_launch_counts()
            t0 = time.perf_counter()
            sched.run(SIM_QUANTA)
            # the kill lands right after a write round: its record is
            # journaled, not fsynced
            write()
            run_s = time.perf_counter() - t0
            writes = 1 + sum(1 for _, n, _ in sched.trace if n == "write")
            launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                        "hashmap_fused_round": k1_launches()}
            sk = nr.stats()
            if not (launches["hashmap_fused_round"] == writes
                    == sk["fused_rounds"] > 0 and sk["exec_rounds"] == 0):
                raise AssertionError(
                    f"phase 28 C: {writes} write quanta but K1 launches "
                    f"{launches}, fused rounds {sk['fused_rounds']}, chain "
                    f"rounds {sk['exec_rounds']}")
            # the simulated kill -9: what the page cache held survives,
            # the active segment loses all past its last fsync but a
            # torn remainder that the recovery scan must chop
            durable = int(wal.durable_tail)
            with wal._lock:
                if wal._fh is not None:
                    wal._fh.flush()
            path = wal._segments[-1][1]
            cur = os.path.getsize(path)
            torn = rng.randrange(64)
            keep = min(cur, synced.get(path, 0) + torn)
            os.truncate(path, keep)
            with wal._lock:
                if wal._fh is not None:
                    wal._fh.close()
                    wal._fh = None
            del nr, wal, tokens
            torch.cuda.empty_cache()
            reset_launch_counts()
            t1 = time.perf_counter()
            nr2, rep = recover_fleet(str(SIM_DIR), make_hashmap(K),
                                     policy="batch", attach=True,
                                     nr_kwargs=kw)
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t1
            rec_launches = {"hashmap_replay": REPLAY_KERNEL.launches,
                            "hashmap_fused_round": k1_launches()}
        T = int(rep.tail)
        if T < durable:
            raise AssertionError(f"phase 28 C: durable-ack-survival: "
                                 f"recovered tail {T} < fsync-acked "
                                 f"{durable}")
        if T > len(acked) or int(nr2.log.tail) != T:
            raise AssertionError(f"phase 28 C: log-content: recovered tail "
                                 f"{T} (fleet {int(nr2.log.tail)}) of "
                                 f"{len(acked)} acked ops")
        want = np.asarray(acked[:T], np.int32).reshape(T, 3)
        opcodes, args = ring_slice(nr2.spec, nr2.log, 0, T)
        if not (np.array_equal(opcodes, want[:, 0])
                and np.array_equal(args[:, :2], want[:, 1:])
                and not args[:, 2:].any()):
            raise AssertionError("phase 28 C: log-content: the ring's "
                                 "[0, T) is not the acked ops")
        if not nr2.replicas_equal():
            raise AssertionError("phase 28 C: bit-identity: replicas "
                                 "differ after recovery")
        fold = make_oracle("hashmap", K)
        for op in acked[:T]:
            fold.apply(op)
        state = nr2.verify(lambda s: s)
        for name, arr in fold.arrays().items():
            if not np.array_equal(state[name], arr):
                raise AssertionError(f"phase 28 C: state-diff: leaf {name} "
                                     f"differs from the oracle at {T}")
        peak = torch.cuda.max_memory_allocated()
        quanta = {n: sum(1 for _, m, _ in sched.trace if m == n)
                  for n in ("write", "read", "wal-sync", "snapshot")}
        out = {"quanta": quanta, "writes": writes, "reads": st["reads"],
               "snapshots": st["snapshots"], "acked_ops": len(acked),
               "durable": durable, "torn_bytes": keep - synced.get(path, 0),
               "recovered_tail": T, "snapshot_pos": rep.snapshot_pos,
               "wal_records": rep.wal_records, "run_s": run_s,
               "recover_s": recover_s, "peak_mem_bytes": peak,
               "launches": launches, "recovery_launches": rec_launches}
        log(f"phase 28 C: flagship R={R} K={K} engine=pallas with a WAL "
            f"under a SimClock: {SIM_QUANTA} quanta ({writes} writes of "
            f"{SIM_BATCH} with the last after them, each one K1 launch and "
            f"no chain round; "
            f"{st['reads']} reads; {st['snapshots']} snapshots) in "
            f"{run_s:.1f} s, every response and read equal to the oracle; "
            f"kill -9 at fsync-acked {durable} of {len(acked)} "
            f"({out['torn_bytes']} torn bytes kept); recovered on the card "
            f"to tail {T} from the snapshot at {rep.snapshot_pos} + "
            f"{rep.wal_records} WAL records in {recover_s:.2f} s "
            f"({rec_launches['hashmap_fused_round']} K1 launches); "
            f"durable-ack-survival, log-content, bit-identity and "
            f"state-diff hold; peak device memory {peak} bytes")
        del nr2
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(SIM_DIR, ignore_errors=True)


def phase_sim(dev) -> dict:
    """Phase 28: the ported simulation plane on the card. A, the CI
    sweep (`explore --procs 4`, every model, wrapper and flavor); B, in
    process: the same seeds on the card and the CPU with equal digests
    (B1), K1 at the sim's fleet shapes against its plain version (B2),
    the three canaries caught and replayed (B3); C, the crash flavor's
    checks on the flagship fleet."""
    t0 = time.perf_counter()
    out = {"sweep": _sim_sweep(), "parity": _sim_parity(dev),
           "k1_check": _k1_sim_check(dev), "canaries": _sim_canaries(dev),
           "crash": _sim_flagship_crash(dev)}
    c = out["crash"]
    out["launches"] = {k: out["parity"]["launches"][k]
                       + out["canaries"]["launches"][k] + c["launches"][k]
                       + c["recovery_launches"][k]
                       for k in c["launches"]}
    out["s"] = time.perf_counter() - t0
    log(f"phase 28: {out['s']:.1f} s; launches {out['launches']}")
    return out


# ------------------------------------------------- the lock-checked flagship

LC_DIR = Path(__file__).resolve().parent / ".chip_smoke_lockcheck"
LC_CLIENTS, LC_PER = 8, 250   # phase 29's closed-loop clients and ops each
LC_TXNS = 16                  # phase 29's cross-shard transactions
LC_READS = 64                 # read-backs through `Follower.read`
#: subsystem locks that must show up in the child's dynamic graph, so
#: the phase cannot pass with nothing checked
LC_NODES = ("ServeFrontend._lock", "WriteAheadLog._lock",
            "ReplicationShipper._cond", "Follower._cond",
            "MetricsExporter._lock", "TxnParticipant._lock")


def lint_cmd(*args: str) -> list[str]:
    """The port's nrlint CLI over its own package."""
    return [sys.executable, "-m", "node_replication_torch.analysis.lint",
            "node_replication_torch", *args]


def lockcheck_child(directory: str) -> int:
    """`--lockcheck-child DIR`: phase 29's checked run. Started with
    `NR_TPU_LOCKCHECK=1` and `NR_TPU_LOCKGRAPH=DIR/lockgraph.json`, so
    every factory lock of the package, module-level ones included, is
    the order-checking kind and the observed graph is dumped at exit.
    Drives phase 13's fleet (a WAL attached, engine="pallas": one K1 a
    round) with ship-before-ack into a `DirectoryFeed` that an
    in-process `Follower` applies, the exporter (`obs_port=0`) and the
    sampling profiler on, 8 clients x 250 ops checked against the
    client models, a socket scrape, every acked write read back from
    the follower; then a 2-shard `ShardGroup` (phase 25's) with 16
    cross-shard transactions. Prints one JSON line: K1's launches, the
    acked ops/s and the `LockOrderError`s seen."""
    import threading

    import torch

    from node_replication_torch.analysis import locks

    if not (locks.lockcheck_enabled()
            and os.environ.get("NR_TPU_LOCKGRAPH")):
        print("chip_smoke: --lockcheck-child needs NR_TPU_LOCKCHECK=1 and "
              "NR_TPU_LOCKGRAPH", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from node_replication_torch.models import HM_GET, make_hashmap
    from node_replication_torch.obs import export
    from node_replication_torch.obs.metrics import get_registry
    from node_replication_torch.repl import (
        DirectoryFeed,
        Follower,
        ReplicationShipper,
    )
    from node_replication_torch.serve import ServeConfig, ServeFrontend

    # a module-level lock, built at import: checked too
    if not isinstance(export._capture_lock, locks._CheckedLock):
        print("chip_smoke: module-level locks are not checked",
              file=sys.stderr)
        return 2
    escaped = []
    hook = threading.excepthook

    def count_escapes(args):
        if isinstance(args.exc_value, locks.LockOrderError):
            escaped.append(f"{args.thread.name}: {args.exc_value}")
        hook(args)

    threading.excepthook = count_escapes
    # the instruments' locks nest under the subsystems': checked too
    get_registry().enable()
    t_start = time.perf_counter()
    d = Path(directory)
    kw = _crash_fleet_kwargs("cuda")
    rng = np.random.default_rng(SEED + 29)
    ops = [hm_client_ops(rng, c, LC_PER) for c in range(LC_CLIENTS)]
    models = [HashmapModel() for _ in range(LC_CLIENTS)]
    touched = [set() for _ in range(LC_CLIENTS)]
    scrapes = []

    def check(c, i, resp):
        want = models[c].apply(ops[c][i])
        touched[c].add(ops[c][i][1] % K)
        return (None if resp == want else
                f"client {c} op {i} {ops[c][i]}: {resp}, model {want}")

    def during(c, i):
        if c == 0 and i == LC_PER // 2:
            scrapes.append(export.scrape(*fe.exporter.address))

    cfg = ServeConfig(batch_max_ops=256, batch_linger_s=0.001,
                      durability="batch", obs_port=0,
                      obs_node_id="lockcheck", profile_hz=OBS_HZ)
    fe = ServeFrontend.from_recovery(str(d / "primary"), make_hashmap(K),
                                     cfg, rids=range(SV_RIDS),
                                     nr_kwargs=kw)
    feed = DirectoryFeed(str(d / "feed"), arg_width=3)
    shipper = ReplicationShipper(fe.nr.wal, feed)
    fe.ack_barrier = shipper.barrier
    fol = Follower(make_hashmap(K), feed, str(d / "f1"),
                   config=_crash_config(ServeConfig), nr_kwargs=kw,
                   name="f1", rids=range(SV_RIDS))
    errors = []
    times = {"setup_s": time.perf_counter() - t_start}
    try:
        r = serve_clients(fe, LC_CLIENTS, LC_PER, lambda c, i: ops[c][i],
                          check, lambda c: c % SV_RIDS, during=during)
        if r["errors"] or r["completed"] != r["ops"]:
            errors.append(f"served: {r['completed']} of {r['ops']} ops; "
                          f"{r['errors']}")
        scrapes.append(export.scrape(*fe.exporter.address))
        fused = scrapes[-1]["metrics"].get("nr.exec.engine.pallas_fused")
        if not fused:
            errors.append(f"the scrape counts no K1 round: {fused}")
        times["serve_s"] = r["wall_s"]
        t1 = time.perf_counter()
        tail = feed.tail_pos()
        if not fol.wait_applied(tail, timeout=300.0):
            errors.append(f"the follower never applied {tail}: "
                          f"{fol.stats()}")
        # the first LC_READS keys through `Follower.read` (its staleness
        # gauge scans the feed directory once a read), the rest through
        # the follower's read-only frontend: the same replicas
        reads, t_fol = 0, 0.0
        for c, m in enumerate(models):
            for slot in sorted(touched[c]):
                t_read = time.perf_counter()
                if reads < LC_READS:
                    got = fol.read((HM_GET, slot), rid=c % SV_RIDS,
                                   min_pos=tail, wait_s=30.0)
                    t_fol += time.perf_counter() - t_read
                else:
                    got = fol.frontend.read((HM_GET, slot),
                                            rid=c % SV_RIDS, min_pos=tail,
                                            wait_s=30.0)
                reads += 1
                if got != m.vals.get(slot, -1):
                    errors.append(f"follower key {slot} reads {got}, acked "
                                  f"{m.vals.get(slot, -1)}")
                    break
        times["read_s"] = time.perf_counter() - t1
        n_fol = min(reads, LC_READS)
        times["follower_read_ms"] = 1e3 * t_fol / max(1, n_fol)
        times["frontend_read_ms"] = 1e3 * (
            times["read_s"] - t_fol) / max(1, reads - n_fol)
    finally:
        t1 = time.perf_counter()
        shipper.stop()
        fol.close()
        fe.close()
        times["close_s"] = time.perf_counter() - t1
    t0 = time.perf_counter()
    g = _txn_group(str(d / "shard"), "cuda")
    try:
        coord = g.coordinator(name="lockcheck")
        k = 0
        for i in range(LC_TXNS):
            tops = [(1, k, TX_VAL_BASE + k), (1, k + 1, TX_VAL_BASE + k + 1)]
            if i % 3 == 0:
                tops.append((1, k + 2, TX_VAL_BASE + k + 2))
            k += len(tops)
            got = coord.execute_txn(tops, timeout=300.0)
            if got != [0] * len(tops):
                errors.append(f"txn {i}: {got}")
        for key in range(k):
            got = g.primaries[g.map.shard_of(key)].live_frontend.read(
                (HM_GET, key))
            if got != TX_VAL_BASE + key:
                errors.append(f"committed key {key} reads {got}")
                break
    finally:
        g.close()
    times["shard_s"] = tx_s = time.perf_counter() - t0
    times["child_s"] = time.perf_counter() - t_start
    seen = locks.current_violations() + len(escaped)
    nodes = locks.current_nodes()
    out = {"k1_launches": k1_launches(),
           "acked_ops_per_s": r["acked_ops_per_s"], "completed":
           r["completed"], "p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"],
           "scrapes": len(scrapes), "scraped_fused": fused,
           "follower_reads": reads, "txns": LC_TXNS,
           "txns_per_s": LC_TXNS / tx_s, "lock_order_errors": seen,
           "escaped": escaped[:5], "errors": errors[:10],
           "edges": len(locks.current_edges()), "nodes": nodes, **times}
    print(json.dumps(out), flush=True)
    return 1 if errors or seen or not k1_launches() else 0


def phase_lockcheck(dev, serve13) -> dict:
    """Phase 29: the lock-checked flagship. The `--lockcheck-child`
    subprocess serves, replicates, observes and shards under the
    checked factory; its dynamic lock graph must be a subgraph of the
    port's static one (`analysis.lint --check-dynamic`), with the whole
    package lint-clean and every suppression live and justified."""
    import shutil

    from node_replication_torch.ops.replay import reset_launch_counts

    del dev
    shutil.rmtree(LC_DIR, ignore_errors=True)
    LC_DIR.mkdir()
    root = Path(__file__).resolve().parent
    graph = LC_DIR / "lockgraph.json"
    env = dict(os.environ, NR_TPU_LOCKCHECK="1",
               NR_TPU_LOCKGRAPH=str(graph))
    t0 = time.perf_counter()
    reset_launch_counts()
    # the suppression audit reads only the sources: it runs beside the
    # child
    audit = subprocess.Popen(lint_cmd("--suppressions"), cwd=root,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        child = subprocess.run(child_cmd("--lockcheck-child", LC_DIR),
                               env=env, capture_output=True, text=True,
                               timeout=600)
        audit_out, _ = audit.communicate(timeout=600)
    finally:
        if audit.poll() is None:
            audit.kill()
            audit.wait()
    (LC_DIR / "child.log").write_text(child.stdout + child.stderr)
    lines = [ln for ln in child.stdout.splitlines() if ln.startswith("{")]
    if child.returncode != 0 or not lines:
        raise AssertionError(f"phase 29: the checked child exited "
                             f"{child.returncode}: "
                             f"{(child.stdout + child.stderr)[-3000:]}")
    c = json.loads(lines[-1])
    if c["lock_order_errors"] or not c["k1_launches"]:
        raise AssertionError(f"phase 29: {c}")
    child_s = time.perf_counter() - t0
    lint = subprocess.run(
        lint_cmd("--check-dynamic", str(graph), "--lockgraph-out",
                 str(LC_DIR / "static.json")),
        cwd=root, capture_output=True, text=True, timeout=600)
    (LC_DIR / "lint.txt").write_text(lint.stdout + lint.stderr)
    (LC_DIR / "audit.txt").write_text(audit_out)
    if lint.returncode != 0:
        raise AssertionError(f"phase 29: nrlint --check-dynamic exited "
                             f"{lint.returncode}: {lint.stdout[-3000:]}")
    if audit.returncode != 0:
        raise AssertionError(f"phase 29: nrlint --suppressions exited "
                             f"{audit.returncode}: {audit_out[-3000:]}")
    dyn = json.loads(graph.read_text())
    static = json.loads((LC_DIR / "static.json").read_text())
    s_edges = {tuple(e) for e in static["edges"]}
    missing = [e for e in dyn["edges"] if tuple(e) not in s_edges]
    absent = [n for n in LC_NODES if n not in dyn["nodes"]]
    if missing or static["cycles"] or absent:
        raise AssertionError(f"phase 29: missing {missing}, static cycles "
                             f"{static['cycles']}, unseen locks {absent}")
    out = {**c, "dynamic_edges": len(dyn["edges"]),
           "dynamic_nodes": len(dyn["nodes"]),
           "static_edges": len(s_edges), "missing": len(missing),
           "static_cycles": len(static["cycles"]),
           "audit": audit_out.strip().splitlines()[-1],
           "lint": lint.stdout.strip().splitlines()[-1],
           "child_s": child_s, "s": time.perf_counter() - t0,
           "phase13_acked_ops_per_s": serve13["depth0"]["acked_ops_per_s"],
           "launches": {"hashmap_fused_round": c["k1_launches"],
                        "hashmap_replay": 0}}
    log(f"phase 29: checked child (NR_TPU_LOCKCHECK=1) exited 0 in "
        f"{child_s:.1f} s: {c['completed']} ops acked, every response "
        f"equal to the client models, {c['follower_reads']} follower "
        f"read-backs equal, {c['scrapes']} scrapes, {c['txns']} cross-shard "
        f"txns committed and read back; K1 launches {c['k1_launches']}; "
        f"{c['lock_order_errors']} LockOrderErrors; in the child: setup "
        f"{c['setup_s']:.1f} s, serve {c['serve_s']:.1f}, read-back "
        f"{c['read_s']:.1f} ({c['follower_read_ms']:.2f} ms a "
        f"`Follower.read`, {c['frontend_read_ms']:.2f} through its "
        f"frontend), close {c['close_s']:.1f}, shards "
        f"{c['shard_s']:.1f} (of {c['child_s']:.1f} after the imports)")
    log(f"phase 29: dynamic graph {out['dynamic_edges']} edges over "
        f"{out['dynamic_nodes']} locks, static {out['static_edges']} edges; "
        f"{out['missing']} edges missing from the static graph, "
        f"{out['static_cycles']} static cycles; {', '.join(LC_NODES)} seen; "
        f"{out['lint']}; {out['audit']}")
    log(f"phase 29: checked-lock acked ops/s {c['acked_ops_per_s']:.1f} "
        f"(8 clients, WAL + shipped acks + exporter + profiler) beside "
        f"phase 13's {out['phase13_acked_ops_per_s']:.1f} (16 clients, "
        f"unchecked; printed, not gated); {out['s']:.1f} s")
    shutil.rmtree(LC_DIR / "primary", ignore_errors=True)
    shutil.rmtree(LC_DIR / "f1", ignore_errors=True)
    shutil.rmtree(LC_DIR / "shard", ignore_errors=True)
    shutil.rmtree(LC_DIR / "feed", ignore_errors=True)
    return out


# --------------------------------------------------- the examples (phase 30)

EX_NAMES = ("nr_hashmap", "nr_stack", "nr_elastic", "serve_hashmap",
            "cnr_hashmap", "cnr_stack", "follower_reads", "tree_replication",
            "fleet_dashboard", "sharded_hashmap")
# the hashmap examples whose auto tier finishes its calibration (3 chain
# rounds at a window, then K1 for 3): each must launch K1
EX_K1 = ("nr_hashmap", "nr_elastic", "serve_hashmap")
# the examples' hashmap fleets, as each file builds them: (K, ring,
# gc_slack, R at the start); a `grow_fleet` event in the trace sets R
# from then on (`nr_elastic` grows 2 -> 3, and restores that fleet).
# `sharded_hashmap`'s shards launch no K1 on the card (none of its
# fleets sees a window often enough to finish the calibration), but a
# launch there would be of this shape
EX_FLEETS = {"nr_hashmap": (1 << 10, 2048, 64, 2),
             "nr_elastic": (256, 512, 32, 2),
             "serve_hashmap": (1 << 10, 2048, 64, 2),
             "sharded_hashmap": (64, 1 << 10, 32, 1)}
# K1 is checked at every (R, K, ring, gc_slack, W) the traces show, and
# at these besides: `nr_elastic` before and after its join (one op a
# round), the other two at one op a round and `serve_hashmap`'s batches
# of 2 and 4 (4 clients, a 1 ms linger)
EX_SHAPES = ((2, 256, 512, 32, 1), (3, 256, 512, 32, 1),
             (2, 1 << 10, 2048, 64, 1), (2, 1 << 10, 2048, 64, 2),
             (2, 1 << 10, 2048, 64, 4))
# installs its own ring tracer over NR_TPU_TRACE's file (seqreg, no kernel)
EX_UNTRACED = ("fleet_dashboard",)
EX_TIMEOUT = 60.0     # s, each example
# examples at a time: on the card's host a process took 9-15 s, most of
# it python, torch and CUDA start-up; ten in a row took ~103 s
EX_PARALLEL = 3
EX_DIR = Path(__file__).resolve().parent / ".chip_smoke_examples"


def _trace_launches(name: str, path: Path) -> dict:
    """The fused tier's launches in an `NR_TPU_TRACE` file, from its
    `kernel-launch` events (`ops/ring.py:FusedEngineHost.note_round`),
    split by K1's shape: the event's window and the example's fleet
    (`EX_FLEETS`, R raised by `grow_fleet` events). The examples' only
    fused-capable model is the hashmap, so they are K1's."""
    n_events = launches = 0
    by_shape: dict = {}
    fleet = EX_FLEETS.get(name)
    r = fleet[3] if fleet else None
    for ln in path.read_text().splitlines():
        e = json.loads(ln)
        n_events += 1
        if e.get("event") == "grow_fleet":
            r = int(e["n_replicas"])
        elif e.get("event") == "kernel-launch":
            if fleet is None:
                raise AssertionError(
                    f"phase 30: {name} launched K1, at a fleet phase 30 "
                    f"does not know (add it to EX_FLEETS)")
            n = int(e["launches"])
            launches += n
            shape = (r, fleet[0], fleet[1], fleet[2], int(e["window"]))
            by_shape[shape] = by_shape.get(shape, 0) + n
    return {"events": n_events, "launches": launches, "by_shape": by_shape}


def _run_example(name: str) -> dict:
    """`python3 examples/torch/<name>.py` from the checkout's root, as a
    user runs it: no `--device`, so the card."""
    root = Path(__file__).resolve().parent
    rel = EX_DIR.relative_to(root)
    env = dict(os.environ)
    traced = name not in EX_UNTRACED
    if traced:
        env["NR_TPU_TRACE"] = str(rel / f"{name}.jsonl")
    else:
        env.pop("NR_TPU_TRACE", None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, f"examples/torch/{name}.py"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=EX_TIMEOUT)
    wall = time.perf_counter() - t0
    (OUT_DIR / "phase30").mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "phase30" / f"{name}.log").write_text(p.stdout + p.stderr)
    ok = [ln for ln in p.stdout.splitlines() if ln.startswith(f"{name} OK: ")]
    if p.returncode != 0 or not ok:
        raise AssertionError(f"phase 30: {name} exited {p.returncode}: "
                             f"{(p.stdout + p.stderr)[-3000:]}")
    out = {"wall_s": wall, "ok": ok[-1], "traced": traced}
    if traced:
        out.update(_trace_launches(name, EX_DIR / f"{name}.jsonl"))
    else:
        out.update(events=None, launches=None, by_shape={})
    return out


def _k1_examples_check(dev, shape, rng) -> dict:
    """K1 over the states against its plain version at one of the
    examples' fleets, `shape` = (R, K, ring, gc_slack, W), fenced (the
    last replica) and unfenced, over rounds across the ring's wrap; its
    time a launch from CUDA events over 20 queued calls (launch latency
    at these sizes)."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round_model as k1,
        hashmap_fused_round_model_plain as k1_plain,
    )

    r, k, ring_n, slack, w = shape
    spec = LogSpec(capacity=ring_n, n_replicas=r, arg_width=3,
                   gc_slack=slack)
    kp = -(-k // 8) * 8
    vals = torch.from_numpy(rng.integers(
        -50, 50, (kp, r)).astype(np.int32)).to(dev)
    pres = torch.from_numpy(rng.integers(
        0, 2, (kp, r)).astype(np.int32)).to(dev)
    ring = (torch.zeros(ring_n, dtype=torch.int32, device=dev),
            torch.zeros((ring_n, 3), dtype=torch.int32, device=dev))
    fen = torch.zeros(r, dtype=torch.int32, device=dev)
    fen[r - 1] = 1
    kern = plain = (*ring, *planes_to_states(vals, pres, k))
    err, rnd = 0, 0
    tail = ring_n - 8
    while tail <= ring_n + 8:
        opc = rng.choice(np.array([1, 1, 1, 2], np.int32), w)
        args = np.zeros((w, 3), np.int32)
        args[:, 0] = rng.integers(0, k, w)
        args[:, 1] = rng.integers(1, 1 << 20, w)
        inputs = (spec, torch.tensor(tail, dtype=torch.int64, device=dev),
                  w, torch.from_numpy(opc).to(dev),
                  torch.from_numpy(args).to(dev))
        f = fen if rnd % 2 else None
        out_k = k1(*inputs, *kern, k, f)
        out_p = k1_plain(*inputs, *plain, k, f)
        e = max_abs_err(out_k, out_p)
        if e:
            raise AssertionError(
                f"phase 30: K1 at R={r} K={k} ring {ring_n} W={w} "
                f"disagrees with its plain version in round {rnd} "
                f"(fenced={f is not None}): {e}")
        err = max(err, e)
        kern, plain = out_k[:4], out_p[:4]
        tail += w
        rnd += 1
    call = (*inputs, *kern, k, None)
    ms = queued_ms(lambda: k1(*call))
    plain_ms = cuda_ms(lambda: k1_plain(*call), reps=10, warmup=2)
    n_bytes = k1_model_round_bytes(r, w, ring_n, k)
    bound_ms, by = bound(n_bytes, 4 * w * r)
    return {"R": r, "K": k, "ring": ring_n, "gc_slack": slack, "W": w,
            "rounds": rnd, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": by}


def phase_examples(dev, shard_k1: int) -> dict:
    """Phase 30: the port's ten examples on the card, each as a user runs
    it (`python3 examples/torch/<name>.py`, a process of its own, the
    card by default), traced by `NR_TPU_TRACE`; exit 0 and the OK line
    required, K1's launches read from each trace and split by shape.
    Then K1 against its plain version, with its time and bound, at every
    shape the traces show and at `EX_SHAPES`. `shard_k1` is phase 24's
    sharded K1 launches, cited beside `sharded_hashmap`."""
    import shutil

    shutil.rmtree(EX_DIR, ignore_errors=True)
    EX_DIR.mkdir()
    t0 = time.perf_counter()
    # a failed example raises out of the pool once the running ones end
    # (each within its own timeout)
    with ThreadPoolExecutor(EX_PARALLEL) as pool:
        runs = dict(zip(EX_NAMES, pool.map(_run_example, EX_NAMES)))
    for name, r in runs.items():
        how = (f"K1 launches {r['launches']} ({r['events']} trace events)"
               if r["traced"] else
               "untraced (it installs its own ring tracer; seqreg, no "
               "kernel)")
        if name == "sharded_hashmap":
            how += (f"; the auto tier stays on the chain at these fleets, "
                    f"sharded K1 ran in phase 24 ({shard_k1} launches)")
        log(f"phase 30: {name} {r['wall_s']:.2f} s ({EX_PARALLEL} examples "
            f"at a time); {how}; {r['ok']}")
    short = [n for n in EX_K1 if not runs[n]["launches"]]
    if short:
        raise AssertionError(f"phase 30: no K1 launch in {short}")
    examples_s = time.perf_counter() - t0
    traced: dict = {}
    for r in runs.values():
        for shape, n in r["by_shape"].items():
            traced[shape] = traced.get(shape, 0) + n
    rng = np.random.default_rng(SEED + 30)
    shapes = []
    for shape in sorted(set(traced) | set(EX_SHAPES)):
        chk = _k1_examples_check(dev, shape, rng)
        chk["launches"] = traced.get(shape, 0)
        shapes.append(chk)
        log(f"phase 30: K1 at R={chk['R']}, K={chk['K']}, ring "
            f"{chk['ring']}, gc_slack {chk['gc_slack']}, W={chk['W']}: "
            f"{chk['launches']} launches in the examples; fenced and not, "
            f"across the wrap, bit-identical over {chk['rounds']} rounds; "
            f"a launch (events over queued calls) {chk['ms']:.6f} ms, "
            f"plain {chk['plain_ms']:.3f} ms, bound {chk['bound_ms']:.9f} "
            f"ms ({chk['bound_by']})")
    for r in runs.values():
        r["by_shape"] = [{"R": s[0], "K": s[1], "ring": s[2],
                          "gc_slack": s[3], "W": s[4], "launches": n}
                         for s, n in sorted(r["by_shape"].items())]
    out = {"runs": runs, "k1_shapes": shapes, "examples_s": examples_s,
           "launches": {"hashmap_fused_round": sum(
               r["launches"] or 0 for r in runs.values())},
           "loss_ms": sum(c["launches"] * (c["ms"] - c["bound_ms"])
                          for c in shapes),
           "s": time.perf_counter() - t0}
    log(f"phase 30: ten examples in {examples_s:.1f} s, {EX_PARALLEL} at a "
        f"time; K1 launches "
        f"{out['launches']['hashmap_fused_round']} (from their traces), "
        f"loss {out['loss_ms']:.3f} ms; {out['s']:.1f} s")
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--crash-child"]:
        return crash_child(sys.argv[2])
    if sys.argv[1:2] == ["--repl-primary"]:
        return repl_primary(sys.argv[2])
    if sys.argv[1:2] == ["--txn-child"]:
        return txn_child(sys.argv[2])
    if sys.argv[1:2] == ["--obs-primary"]:
        return obs_primary(sys.argv[2])
    if sys.argv[1:2] == ["--obs-leaf"]:
        return obs_leaf(sys.argv[2])
    if sys.argv[1:2] == ["--lockcheck-child"]:
        return lockcheck_child(sys.argv[2])

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    try:
        import node_replication_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    try:
        t0 = time.perf_counter()
        res = {"card": smi, "build": phase_build()}
        res["replay"] = phase_replay(dev, rng, gen)
        res["fused"] = phase_fused(dev, rng, gen)
        torch.cuda.empty_cache()
        res["step"] = phase_step(dev, rng, smi)
        torch.cuda.empty_cache()
        res["replica"] = phase_replica(dev, rng)
        torch.cuda.empty_cache()
        res["vspace_replay"] = phase_vspace_replay(dev, rng, gen)
        torch.cuda.empty_cache()
        res["vspace_step"] = phase_vspace_step(dev, rng, smi)
        torch.cuda.empty_cache()
        res["vspace_replica"] = phase_vspace_replica(dev, rng)
        torch.cuda.empty_cache()
        res["radix_replay"] = phase_radix_replay(dev, rng, gen)
        torch.cuda.empty_cache()
        res["radix_step"] = phase_radix_step(dev, rng, smi)
        torch.cuda.empty_cache()
        res["oahashmap"] = phase_oahashmap(dev, rng, smi)
        torch.cuda.empty_cache()
        res["seqreg_serve"] = phase_seqreg_serve(dev)
        torch.cuda.empty_cache()
        res["hashmap_serve"] = phase_hashmap_serve(dev, rng)
        res["crash"] = phase_crash_recovery(dev)
        torch.cuda.empty_cache()
        res["cnr_step"] = phase_cnr_step(dev, rng)
        torch.cuda.empty_cache()
        res["cnr_rounds"], k1_fleet = phase_cnr_rounds(dev, rng)
        res["cnr_serve"] = phase_cnr_serve(dev, rng, k1_fleet)
        del k1_fleet
        torch.cuda.empty_cache()
        res["models"] = phase_models(dev, rng)
        torch.cuda.empty_cache()
        res["mesh_fused"], mesh_fleet = phase_mesh_fused(dev, rng)
        res["mesh_chain"] = phase_mesh_chain(dev, rng)
        res["mesh_vspace"] = phase_mesh_vspace(dev, rng)
        res["mesh_serve"] = phase_mesh_serve(dev, rng, mesh_fleet)
        del mesh_fleet
        torch.cuda.empty_cache()
        res["repl"] = phase_repl(dev)
        torch.cuda.empty_cache()
        res["shard"] = phase_shard(dev, rng, res["hashmap_serve"])
        res["txn"] = phase_txn(dev)
        torch.cuda.empty_cache()
        res["obs"] = phase_obs(dev, rng)
        torch.cuda.empty_cache()
        res["harness"] = phase_harness(dev, rng)
        torch.cuda.empty_cache()
        res["sim"] = phase_sim(dev)
        torch.cuda.empty_cache()
        res["lockcheck"] = phase_lockcheck(dev, res["hashmap_serve"])
        torch.cuda.empty_cache()
        res["examples"] = phase_examples(
            dev, res["shard"]["launches"]["hashmap_fused_round"])
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        res["seconds"] = time.perf_counter() - t0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    hm_src = "node_replication_torch/csrc/hashmap_replay.cu"
    hm_ref = "node_replication_tpu/ops/pallas_replay.py"
    vs_src = "node_replication_torch/csrc/vspace_replay.cu"
    vs_ref = "node_replication_tpu/ops/pallas_vspace.py"
    rx_src = "node_replication_torch/csrc/vspace_radix_replay.cu"
    oa_src = "node_replication_torch/csrc/oahashmap_replay.cu"
    oa_ref = "node_replication_tpu/ops/pallas_oahashmap.py"
    # the meshed paths' K1 launches: phase 19's meshed fleet (not its
    # un-meshed twins) and phase 22's served rounds
    mf, mv = res["mesh_fused"], res["mesh_vspace"]
    k1_mesh = mf["mesh_launches"] + \
        res["mesh_serve"]["launches"]["hashmap_fused_round"]
    hm_launches = lambda k: sum(res[p]["launches"][k] for p in (
        "step", "replica", "seqreg_serve", "hashmap_serve", "crash",
        "cnr_rounds", "cnr_serve", "mesh_chain", "repl", "shard",
        "txn", "obs", "harness", "sim", "lockcheck")) + (
        k1_mesh if k == "hashmap_fused_round" else 0)
    table = [
        ("hashmap_replay", hm_src, f"{hm_ref}:79", res["replay"],
         hm_launches("hashmap_replay")),
        ("hashmap_fused_round", hm_src, f"{hm_ref}:284", res["fused"],
         hm_launches("hashmap_fused_round")),
        ("vspace_replay", vs_src, f"{vs_ref}:114", res["vspace_replay"],
         res["vspace_step"]["launches"]["pallas"]["vspace_replay"]),
        ("vspace_plan_replay", vs_src, f"{vs_ref}:126",
         res["vspace_step"]["plan_kernel"],
         res["vspace_step"]["launches"]["plan"]["vspace_plan_replay"]),
        ("vspace_fused_round", vs_src, f"{vs_ref}:901",
         res["vspace_replica"]["fused_kernel"],
         res["vspace_replica"]["launches"]["vspace_fused_round"]
         + mv["mesh_launches"]),
        ("vspace_radix_replay", rx_src, f"{vs_ref}:217",
         res["radix_replay"],
         res["radix_step"]["launches"]["pallas"]["vspace_radix_replay"]),
        ("vspace_radix_plan_replay", rx_src, f"{vs_ref}:230",
         res["radix_step"]["plan_kernel"],
         res["radix_step"]["launches"]["plan"]["vspace_radix_plan_replay"]),
        ("oahashmap_replay", oa_src, f"{oa_ref}:95",
         res["oahashmap"]["kernel"], res["oahashmap"]["launches"]),
    ]
    # K1 runs at two shapes on the main path: phase 5's rounds of
    # W = 256, and the served rounds of phases 13-14 (a batch of ~2);
    # the second gets its own device time, bound and launches
    share = res["hashmap_serve"]["round_share"]
    res["fused"]["served"] = {
        "R": share["R"], "mean_batch": share["mean_batch"],
        "device_ms": share["k1_ms"], "bound_ms": share["k1_bound_ms"],
        "bound_by": share["k1_bound_by"],
        "launches": sum(res[p]["launches"]["hashmap_fused_round"]
                        for p in ("hashmap_serve", "crash")),
    }
    # and a third: CNR's per-log rounds (phases 16-17), one
    # launch per per-log sub-batch, at phase 16's mean per-log window
    cr = res["cnr_rounds"]
    res["fused"]["max_abs_err"] = max(
        [res["fused"]["max_abs_err"]]
        + [c["max_abs_err"] for c in cr["k1_check"].values()])
    res["fused"]["cnr"] = {
        "R": R, "L": CNR_L, "mean_window": cr["mean_window"],
        "device_ms": cr["k1_device_ms"], "bound_ms": cr["bound_ms"],
        "bound_by": cr["bound_by"],
        "ms": {W: c["ms"] for W, c in cr["k1_check"].items()},
        "plain_ms": {W: c["plain_ms"] for W, c in cr["k1_check"].items()},
        "launches": sum(res[p]["launches"]["hashmap_fused_round"]
                        for p in ("cnr_rounds", "cnr_serve")),
    }
    # and a fourth: the follower's applied records (phase 23), one
    # launch a record at the mean record's window, plus the replicated
    # flagship's boot replays and the promoted follower's served rounds
    rp = res["repl"]
    res["fused"]["max_abs_err"] = max(res["fused"]["max_abs_err"],
                                      rp["k1_check"]["max_abs_err"])
    res["fused"]["repl"] = {
        "R": R, "mean_record": rp["mean_record"],
        "launches": rp["launches"]["hashmap_fused_round"],
        "records_applied_before_promotion": rp["applied_records"],
        "device_ms": rp["k1_device_ms_per_record"],
        "bound_ms": rp["k1_bound_ms"], "bound_by": rp["k1_bound_by"],
        "max_abs_err": rp["k1_check"]["max_abs_err"],
        "ms": rp["k1_check"]["ms"], "plain_ms": rp["k1_check"]["plain_ms"],
        "checked_device_ms": rp["k1_check"]["device_ms"],
        "W": rp["k1_check"]["W"]}
    # and a fifth: the sharded flagship's rounds (phase 24: every shard
    # round, applied record, promoted and re-homed round) at the
    # profiled segment's mean batch, plus phase 25's recovery replays
    # and parity rounds
    sh, tx = res["shard"], res["txn"]
    res["fused"]["max_abs_err"] = max(res["fused"]["max_abs_err"],
                                      sh["k1_check"]["max_abs_err"])
    pf = sh["profiled"]
    res["fused"]["sharded"] = {
        "R": R, "shards": SH_N, "mean_batch": pf["mean_batch"],
        "launches": sh["launches"]["hashmap_fused_round"],
        "txn_launches": tx["launches"]["hashmap_fused_round"],
        "device_ms": pf["k1_device_ms"], "bound_ms": pf["k1_bound_ms"],
        "bound_by": pf["k1_bound_by"], "profiled_launches": pf["k1_profiled"],
        "max_abs_err": sh["k1_check"]["max_abs_err"],
        "ms": sh["k1_check"]["ms"], "plain_ms": sh["k1_check"]["plain_ms"],
        "checked_device_ms": sh["k1_check"]["device_ms"],
        "W": sh["k1_check"]["W"]}
    # and phase 26's observed flagship: the exporter's device trace of
    # K1 (its kernel count and mean device time) beside the tracer's
    # kernel-launch events of the capture's window and the served bound
    ob = res["obs"]["scrape"]
    res["fused"]["obs"] = {
        "R": R, "mean_batch": ob["mean_batch"],
        "launches": res["obs"]["launches"]["hashmap_fused_round"],
        "trace_k1": ob["trace_k1"], "trace_k1_mean_ms": ob["trace_k1_mean_ms"],
        "kernel_launch_events": ob["kernel_launch_events"],
        "bound_ms": ob["k1_bound_ms"], "bound_by": ob["k1_bound_by"]}
    # and phase 27's harness: measure_kernel's pallas_fused rounds (one
    # launch each, W = 256) and mesh_fused rounds (one a shard), the
    # sweep's and the served rounds, with the profiled device time
    hn = res["harness"]
    pk = {p["tier"]: p for p in hn["kernel"]["points"]
          + hn["mesh_kernel"]}
    res["fused"]["harness"] = {
        "R": R, "W": W_ROUND, "launches":
            hn["launches"]["hashmap_fused_round"],
        "launches_per_round": {t: pk[t]["launches_per_round"]
                               for t in ("pallas_fused", "mesh_fused")},
        "p50_ms": {t: pk[t]["p50_ms"] for t in ("pallas_fused",
                                                 "mesh_fused")},
        "p95_ms": {t: pk[t]["p95_ms"] for t in ("pallas_fused",
                                                 "mesh_fused")},
        "device_ms": hn["kernel"]["k1_device_ms"],
        "profiled_k1": hn["kernel"]["profiled_k1"],
        "bound_ms": hn["kernel"]["bound_ms"], "bound_by": "bytes",
        "served_launches": hn["serve"]["k1_launches"]}
    # and phase 28's sim: the sim's fleets (R = 1-3, K = 32, ring 256)
    # launch K1 through the auto tier's calibration (legs B1 and B3),
    # checked and timed at those shapes (B2), and the flagship's write
    # rounds and recovery replays (leg C)
    sm = res["sim"]
    res["fused"]["max_abs_err"] = max(res["fused"]["max_abs_err"],
                                      sm["k1_check"]["max_abs_err"])
    res["fused"]["sim"] = {
        "K": SIM_KEYS, "ring": SIM_RING, "gc_slack": SIM_SLACK,
        "launches": sm["launches"]["hashmap_fused_round"],
        "parity_launches": sm["parity"]["launches"]["hashmap_fused_round"],
        "canary_launches":
            sm["canaries"]["launches"]["hashmap_fused_round"],
        "flagship_launches":
            sm["crash"]["launches"]["hashmap_fused_round"],
        "recovery_launches":
            sm["crash"]["recovery_launches"]["hashmap_fused_round"],
        "max_abs_err": sm["k1_check"]["max_abs_err"],
        "shapes": sm["k1_check"]["shapes"]}
    # and phase 29's lock-checked flagship: the checked child's rounds
    # (served, follower-applied, sharded), one K1 a round
    lc = res["lockcheck"]
    res["fused"]["lockcheck"] = {
        "R": R, "launches": lc["launches"]["hashmap_fused_round"],
        "acked_ops_per_s": lc["acked_ops_per_s"],
        "lock_order_errors": lc["lock_order_errors"],
        "dynamic_edges": lc["dynamic_edges"],
        "static_edges": lc["static_edges"], "missing": lc["missing"]}
    # and phase 30's examples: the hashmap examples' fleets (R = 2-3,
    # K = 256 with a 512-slot ring, K = 1024 with a 2048-slot ring, W =
    # 1-4), their launches read from each example's trace (processes of
    # their own) and split by shape, K1 checked and timed at each shape
    ex = res["examples"]
    res["fused"]["max_abs_err"] = max(
        [res["fused"]["max_abs_err"]]
        + [c["max_abs_err"] for c in ex["k1_shapes"]])
    res["fused"]["examples"] = {
        "shapes": ex["k1_shapes"], "loss_ms": ex["loss_ms"],
        "launches": ex["launches"]["hashmap_fused_round"],
        "launches_by_example": {n: r["launches"]
                                for n, r in ex["runs"].items()}}
    # and both fused kernels once per mesh shard (phases 19-22): the
    # per-shard shape's checks and times, and the in-path device time
    for p, chk, n, extra in (
            (res["fused"], mf["k1_check"], k1_mesh,
             {"in_path_device_ms": mf["k1_device_ms"],
              "profiled_launches": mf["profiled_k1"]}),
            (res["vspace_replica"]["fused_kernel"], mv["k5_check"],
             mv["mesh_launches"], {})):
        p["max_abs_err"] = max(p["max_abs_err"], chk["max_abs_err"])
        p["mesh"] = {
            "shards": MESH_SHARDS, "devices": mf["devices"],
            "R_per_shard": chk["R"], "W": chk["W"],
            "launches_per_round": MESH_SHARDS, "launches": n,
            "max_abs_err": chk["max_abs_err"], "ms": chk["ms"],
            "plain_ms": chk["plain_ms"], "device_ms": chk["device_ms"],
            "bound_ms": chk["bound_ms"], "bound_by": chk["bound_by"],
            **extra}
    kernels = [{
        "name": kname, "route": "cuda", "source": src, "replaces": ref,
        "launches": launches, "max_abs_err": p["max_abs_err"],
        "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None,
        # K3: also at the window its main path launches it with
        **({"step_window": p["step_window"]} if "step_window" in p else {}),
        # torch.profiler's device time of one call (K3's is at the
        # step's window, under step_window)
        **({"device_ms": p["device_ms"]} if "device_ms" in p else {}),
        **({"served": p["served"]} if "served" in p else {}),
        **({"cnr": p["cnr"]} if "cnr" in p else {}),
        **({"repl": p["repl"]} if "repl" in p else {}),
        **({"sharded": p["sharded"]} if "sharded" in p else {}),
        **({"obs": p["obs"]} if "obs" in p else {}),
        **({"harness": p["harness"]} if "harness" in p else {}),
        **({"sim": p["sim"]} if "sim" in p else {}),
        **({"lockcheck": p["lockcheck"]} if "lockcheck" in p else {}),
        **({"examples": p["examples"]} if "examples" in p else {}),
        **({"mesh": p["mesh"]} if "mesh" in p else {}),
        **({"shapes": p["shapes"]} if "shapes" in p else {}),
    } for kname, src, ref, p, launches in table]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(
        json.dumps({"kernels": kernels, **res}, indent=1))
    log(f"all phases passed in {res['seconds']:.1f} s; peak device "
        f"memory {res['peak_mem_bytes']} bytes")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
