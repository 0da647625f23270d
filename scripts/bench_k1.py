#!/usr/bin/env python3
"""Time the hashmap kernels K1 and K2 at every shape their paths give
them, for the port package found under `--root` (default: this repo).

    python3 scripts/bench_k1.py [--root DIR] [--out FILE]

Needs one CUDA card. Builds `DIR/node_replication_torch/csrc/*.cu` anew,
then for each shape times one call three ways, on random planes made
from a fixed seed: CUDA events around each call (median), CUDA events
over 20 calls queued behind a spin kernel (the device's time alone),
and `torch.profiler`'s device time. Each shape is checked against its
plain version once, bit for bit. Prints one JSON object, and writes it
to `--out` when given.

K1 over the model's `[R, K]` states (`hashmap_fused_round_model`, what
`round_fn` launches) at its shapes (K = 10000 keys, a 2^16 ring
wrapping in the window): phases 3 and 5's flagship rounds (R = 4096,
W = 256, fenced and not), a served round (W = 2, the served mean batch
of ~1.9 padded), a CNR per-log round (W = 64, 46 entries), a mesh shard
(R = 1024, W = 256 and 2) and a fleet grown by one (R = 4097, a last
tile of one replica row). K2 over the `[Kp, R]` planes at phase 2's
W = 4096, R = 4096. The timing helpers and the bounds (bytes over
3.35 TB/s) are `chip_smoke.py`'s.

To compare two trees, run this once per tree in one call on one
card, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
SEED = 20261017
K = 10000
# name: (R, W, count, fenced)
K1_SHAPES = {
    "flagship": (4096, 256, 256, False),
    "flagship_fenced": (4096, 256, 256, True),
    "served": (4096, 2, 2, False),
    "cnr": (4096, 64, 46, False),
    "shard": (1024, 256, 256, False),
    "shard_served": (1024, 2, 2, False),
    "grown": (4097, 256, 256, False),
}
K2_SHAPE = (4096, 4096)  # R, W


def _smoke():
    """This repo's chip_smoke.py, loaded by path (its helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _times(cs, call) -> dict:
    return {"event_ms": cs.cuda_ms(call, reps=20, warmup=3),
            "queued_ms": cs.queued_ms(call),
            "device_ms": cs.device_time(call)["device_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.root).resolve()))
    from node_replication_torch.core.log import LogSpec
    from node_replication_torch.ops import kernel_lib, replay

    cs = _smoke()
    dev = torch.device("cuda")
    kernel_lib.build_all(force=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kp = -(-K // 8) * 8
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {"root": str(Path(a.root).resolve()), "card": card, "k1": {}}
    for name, (R, W, count, fenced) in K1_SHAPES.items():
        spec = LogSpec(capacity=1 << 16, n_replicas=R, arg_width=3)
        vals = torch.randint(-(1 << 30), 1 << 30, (R, K), generator=gen,
                             device=dev, dtype=torch.int32)
        pres = torch.randint(0, 2, (R, K), generator=gen, device=dev,
                             dtype=torch.int32) > 0
        ring = (torch.zeros(spec.capacity, dtype=torch.int32, device=dev),
                torch.zeros((spec.capacity, 3), dtype=torch.int32,
                            device=dev))
        opc = np.zeros(W, np.int32)
        opc[:count] = rng.integers(1, 3, count)
        args = np.zeros((W, 3), np.int32)
        args[:count, 0] = rng.integers(-K, 2 * K, count)
        args[:count, 1] = rng.integers(1, 1 << 31, count)
        fen = None
        if fenced:
            fen = torch.zeros(R, dtype=torch.int32, device=dev)
            fen[[0, 511, 512, R - 1]] = 1
        inputs = (spec, torch.tensor(spec.capacity - count // 2,
                                     dtype=torch.int64, device=dev),
                  count, torch.from_numpy(opc).to(dev),
                  torch.from_numpy(args).to(dev), *ring, vals, pres, K, fen)
        err = cs.max_abs_err(replay.hashmap_fused_round_model(*inputs),
                             replay.hashmap_fused_round_model_plain(*inputs))
        if err:
            raise AssertionError(f"K1 {name} disagrees with plain: {err}")
        bound_ms, _ = cs.bound(cs.k1_model_round_bytes(R, W), 4 * W * R)
        out["k1"][name] = {
            "R": R, "W": W, "count": count, "fenced": fenced,
            "bound_ms": bound_ms,
            **_times(cs, lambda: replay.hashmap_fused_round_model(*inputs))}
        del vals, pres, ring, inputs
        torch.cuda.empty_cache()
    R, W = K2_SHAPE
    vals = torch.randint(-(1 << 30), 1 << 30, (kp, R), generator=gen,
                         device=dev, dtype=torch.int32)
    pres = torch.randint(0, 2, (kp, R), generator=gen, device=dev,
                         dtype=torch.int32)
    opc = torch.from_numpy(rng.integers(1, 3, W).astype(np.int32)).to(dev)
    key = torch.from_numpy(rng.integers(0, K, W).astype(np.int32)).to(dev)
    val = torch.from_numpy(
        rng.integers(1, 1 << 31, W).astype(np.int32)).to(dev)
    k2 = (opc, key, val, vals, pres, K)
    err = cs.max_abs_err(replay.hashmap_replay(*k2),
                         replay.hashmap_replay_plain(*k2))
    if err:
        raise AssertionError(f"K2 disagrees with plain: {err}")
    n_bytes = 4 * (4 * kp * R + W * R + 3 * W)
    out["k2"] = {"R": R, "W": W, "bound_ms": cs.bound(n_bytes, 4 * W * R)[0],
                 **_times(cs, lambda: replay.hashmap_replay(*k2))}
    text = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
