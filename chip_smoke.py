#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # needs one CUDA card; a few minutes

Four models, end to end, from numpy seeds. The replicated hashmap at the
flagship width (R = 4096 replicas, K = 10000 keys):

1. build every CUDA source under `node_replication_torch/csrc/` (one
   nvcc per source, all at once);
2. the replay kernel (K2) against its plain PyTorch version, W = 4096,
   then on windows with inert opcodes (0, 7), keys in [-3K, 3K) and half
   of the entries on 8 hot keys, over the flagship planes and over
   R - 2 columns (not 16-byte aligned); logs K2's tile, its device time
   (`torch.profiler`) and its ptxas registers and spills;
3. the fused combiner-round kernel (K1), fenced and unfenced, against
   its plain version over rounds of W = 256 that wrap a 2^16 ring; its
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

Every comparison is exact (integer data, tolerance 0). Launch counts
are zeroed just before each main-path phase (4, 5, 7, 8, 10, 11) and
read just after; a kernel that its path never launched fails the run.
The last
two lines are a `{"kernels": [...]}` summary and `{"ok": true,
"device": ...}`; any failure exits non-zero before them. Without a
CUDA device, or without the package beside this script, it exits
non-zero at once. Details of the run go to
`chiprun_out/chip_smoke.json`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

SEED = 20261016
R, K = 4096, 10000
W_STEP = R          # K2's window on the step path: one write per replica
W_ROUND = 256       # K1's window: one combiner round of 256 ops
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


def random_planes(gen, dev, kp: int):
    import torch

    vals = torch.randint(-(1 << 30), 1 << 30, (kp, R), generator=gen,
                         device=dev, dtype=torch.int32)
    pres = torch.randint(0, 2, (kp, R), generator=gen, device=dev,
                         dtype=torch.int32)
    return vals, pres


def phase_build() -> dict:
    from node_replication_torch.ops import kernel_lib

    t0 = time.perf_counter()
    kernel_lib.build_all(force=True)
    secs = time.perf_counter() - t0
    names = [p.name for p in kernel_lib.sources()]
    log(f"phase 1: built {', '.join(names)} in {secs:.2f} s")
    for name in names:
        for line in kernel_lib.BUILD_LOG[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return {"build_s": secs, "ptxas": dict(kernel_lib.BUILD_LOG)}


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
    """K1 (unfenced and fenced) against its plain version, W = 256, over
    enough rounds to wrap a 2^16-slot ring."""
    import torch

    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops.replay import (
        hashmap_fused_round,
        hashmap_fused_round_plain,
    )

    kp = -(-K // 8) * 8
    W = W_ROUND
    spec = LogSpec(capacity=1 << 16, n_replicas=R, arg_width=3)
    L = spec.capacity
    ring_opc = torch.zeros(L, dtype=torch.int32, device=dev)
    ring_args = torch.zeros((L, 3), dtype=torch.int32, device=dev)
    vals, pres = random_planes(gen, dev, kp)
    fen = torch.zeros(R, dtype=torch.int32, device=dev)
    fen[[0, 31, 32, R // 2 - 1, R - 1]] = 1
    kern = plain = (ring_opc, ring_args, vals, pres)
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
        out_k = hashmap_fused_round(spec, tail_t, count, opc_t, args_t,
                                    *kern, K, f)
        ev[1].record()
        ev[2].record()
        out_p = hashmap_fused_round_plain(spec, tail_t, count, opc_t,
                                          args_t, *plain, K, f)
        ev[3].record()
        ev[3].synchronize()
        times[fenced][0].append(ev[0].elapsed_time(ev[1]))
        times[fenced][1].append(ev[2].elapsed_time(ev[3]))
        e = max_abs_err(out_k, out_p)
        if e:
            raise AssertionError(
                f"K1 disagrees with its plain version in round {rnd} "
                f"(fenced={fenced}): {e}")
        err = max(err, e)
        kern, plain = out_k[:4], out_p[:4]
        tail += count
        rnd += 1
    rounds = rnd
    # one standalone unfenced call on the last round's inputs
    dt = device_time(lambda: hashmap_fused_round(
        spec, tail_t, count, opc_t, args_t, *kern, K, None))
    n_bytes = 4 * (4 * kp * R + W * R + 2 * L * 4 + W * 4)
    bound_ms, by = bound(n_bytes, 4 * W * R)
    ms = statistics.median(times[False][0][1:])
    ms_f = statistics.median(times[True][0])
    plain_ms = statistics.median(times[False][1][1:])
    plain_ms_f = statistics.median(times[True][1])
    log(f"phase 3: K1 R={R} K={K} W={W} ring={L}: {rounds} rounds to tail "
        f"{tail}, bit-identical; kernel {ms:.4f} ms (fenced {ms_f:.4f}), "
        f"plain {plain_ms:.2f} ms (fenced {plain_ms_f:.2f}), bound "
        f"{bound_ms:.4f} ms ({n_bytes} bytes)")
    log_device("phase 3: K1", dt)
    return {"max_abs_err": err, "ms": ms, "ms_fenced": ms_f, **dt,
            "plain_ms": plain_ms, "plain_ms_fenced": plain_ms_f,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": by,
            "rounds": rounds, "tail": tail, "R": R, "K": K, "W": W,
            "capacity": L}


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
        FUSED_KERNEL,
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
                "hashmap_fused_round": FUSED_KERNEL.launches}
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
        FUSED_KERNEL,
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
                "hashmap_fused_round": FUSED_KERNEL.launches}
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


def main() -> int:
    import torch

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
    hm_launches = lambda k: (res["step"]["launches"][k]
                             + res["replica"]["launches"][k])
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
         res["vspace_replica"]["launches"]["vspace_fused_round"]),
        ("vspace_radix_replay", rx_src, f"{vs_ref}:217",
         res["radix_replay"],
         res["radix_step"]["launches"]["pallas"]["vspace_radix_replay"]),
        ("vspace_radix_plan_replay", rx_src, f"{vs_ref}:230",
         res["radix_step"]["plan_kernel"],
         res["radix_step"]["launches"]["plan"]["vspace_radix_plan_replay"]),
        ("oahashmap_replay", oa_src, f"{oa_ref}:95",
         res["oahashmap"]["kernel"], res["oahashmap"]["launches"]),
    ]
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
