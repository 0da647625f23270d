#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # needs one CUDA card; about a minute

The replicated hashmap at the flagship width (R = 4096 replicas, K =
10000 keys, random ops from a numpy seed), end to end:

1. build the CUDA kernels from `node_replication_torch/csrc/`;
2. the replay kernel (K2) against its plain PyTorch version, W = 4096;
3. the fused combiner-round kernel (K1), fenced and unfenced, against
   its plain version over rounds of W = 256 that wrap a 2^16 ring;
4. the lock-step step path: 64 steps of `make_pallas_step` (K2) and of
   `make_step(combined=True)` (PyTorch ops), bit-identical;
5. `NodeReplicated` with `engine='pallas'` (K1) and `'combined'`: 36
   batched rounds of 256 writes plus cross-replica reads, identical to
   each other and to a plain dict model of the map.

Every comparison is exact (integer data, tolerance 0). Launch counts
are zeroed just before each main-path phase (4, 5) and read just
after; a kernel that path never launched fails the run. The last two
lines are a `{"kernels": [...]}` summary and `{"ok": true, "device":
...}`; any failure exits non-zero before them. Without a CUDA device,
or without the package beside this script, it exits non-zero at once.
Details of the run go to `chiprun_out/chip_smoke.json`.
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


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
    from node_replication_torch.ops import replay

    t0 = time.perf_counter()
    replay.build_library(force=True)
    secs = time.perf_counter() - t0
    log(f"phase 1: built {replay.SOURCE.name} in {secs:.2f} s")
    for line in replay.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return {"build_s": secs, "ptxas": replay.BUILD_LOG}


def phase_replay(dev, rng, gen) -> dict:
    """K2 against its plain version at W = 4096."""
    import torch

    from node_replication_torch.ops.replay import (
        hashmap_replay,
        hashmap_replay_plain,
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
    n_bytes = 4 * (4 * kp * R + W * R + 3 * W)
    bound_ms, by = bound(n_bytes, 4 * W * R)
    log(f"phase 2: K2 R={R} K={K} W={W}: bit-identical; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({n_bytes} bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": by,
            "R": R, "K": K, "W": W}


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
    return {"max_abs_err": err, "ms": ms, "ms_fenced": ms_f,
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
    return {"steps": steps, "dispatches": n_disp,
            "pallas_dispatches_per_s": n_disp / tk,
            "combined_dispatches_per_s": n_disp / tc,
            "pallas_s": tk, "combined_s": tc, "launches": launches}


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
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        res["seconds"] = time.perf_counter() - t0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    src = "node_replication_torch/csrc/hashmap_replay.cu"
    ref = "node_replication_tpu/ops/pallas_replay.py"
    kernels = []
    for kname, phase, line in (("hashmap_replay", "replay", 79),
                               ("hashmap_fused_round", "fused", 284)):
        p = res[phase]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"{ref}:{line}",
            "launches": (res["step"]["launches"][kname]
                         + res["replica"]["launches"][kname]),
            "max_abs_err": p["max_abs_err"], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": None,
        })
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
