"""Seed-sweep CLI: the `sim-smoke` gate (the port's copy of
`node_replication_tpu/sim/explore.py`).

    python -m node_replication_torch.sim.explore --seeds 1000 [--device cpu]

generates and runs one `CaseSpec` per seed (models x wrappers x
flavors per the filters), reports the coverage matrix, and exits
nonzero on any property violation — writing each failing seed's full
artifact (spec + events + violations + shrunk schedule + digest) as
JSON under `--out` so CI can upload it and a human can replay it:

    python -m node_replication_torch.sim.replay <seed>

Canary mode (`--canary <name>`) inverts the contract: it re-injects a
known bug (`sim/canary.py`), narrows the sweep to the flavor that
must catch it, and exits 0 only when (1) some seed catches the bug,
(2) that seed REPLAYS byte-identically (same digest twice), and
(3) the shrinker reduces the schedule — the harness proving, in CI,
that it can catch what it claims to catch.

`--device` picks the device every case runs on: the card by default
(the sweep raises without one), `cpu` on request. `--procs N` children
inherit it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from node_replication_torch.sim import canary as canary_mod
from node_replication_torch.sim.properties import (
    FLAVORS,
    MODELS,
    WRAPPERS,
    generate_case,
    run_case,
)
from node_replication_torch.sim.shrink import shrink_case
from node_replication_torch.utils.device import resolve_device


def _csv(value: str, allowed) -> tuple:
    parts = tuple(p.strip() for p in value.split(",") if p.strip())
    bad = [p for p in parts if p not in allowed]
    if bad:
        raise argparse.ArgumentTypeError(
            f"unknown {bad} (allowed: {', '.join(allowed)})"
        )
    return parts


def _artifact(out_dir: str, seed: int, payload: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"failing-seed-{seed}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def _sharded(args) -> int:
    """Split the seed range over `--procs` child sweeps (same seed ->
    same case; sharding is pure parallelism). Children stream their
    output through; the parent fails if any child fails."""
    import subprocess

    procs = max(1, int(args.procs))
    total = args.seeds
    base = args.seed_start
    chunks = []
    for i in range(procs):
        lo = base + (total * i) // procs
        hi = base + (total * (i + 1)) // procs
        if hi > lo:
            chunks.append((lo, hi - lo))
    children = []
    for lo, n in chunks:
        cmd = [
            sys.executable, "-m", "node_replication_torch.sim.explore",
            "--seeds", str(n), "--seed-start", str(lo),
            "--procs", "1",
            "--models", ",".join(args.models),
            "--wrappers", ",".join(args.wrappers),
            "--flavors", ",".join(args.flavors),
            "--max-failures", str(args.max_failures),
            "--progress", str(args.progress),
        ]
        if args.out:
            cmd += ["--out", args.out]
        if args.no_shrink:
            cmd += ["--no-shrink"]
        if args.device is not None:
            cmd += ["--device", args.device]
        children.append(subprocess.Popen(cmd))
    rc = 0
    for (lo, n), p in zip(chunks, children):
        code = p.wait()
        if code != 0:
            print(f"shard [{lo}, {lo + n}) exited {code}")
            rc = 1
    print(f"{len(chunks)} shard(s) done; "
          + ("FAILURES found" if rc else "all clean"))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m node_replication_torch.sim.explore",
        description="seeded property sweep over the sim harness",
    )
    ap.add_argument("--seeds", type=int, default=200,
                    help="number of seeds to sweep (default 200)")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--models", default=",".join(MODELS),
                    type=lambda v: _csv(v, MODELS))
    ap.add_argument("--wrappers", default=",".join(WRAPPERS),
                    type=lambda v: _csv(v, WRAPPERS))
    ap.add_argument("--flavors", default=",".join(FLAVORS),
                    type=lambda v: _csv(v, FLAVORS))
    ap.add_argument("--canary", default=None,
                    choices=sorted(canary_mod.CANARIES),
                    help="re-inject a known bug; exit 0 iff the sweep "
                         "catches it, replays it byte-identically, "
                         "and shrinks it")
    ap.add_argument("--out", default=None,
                    help="directory for failing-seed JSON artifacts")
    ap.add_argument("--max-failures", type=int, default=5,
                    help="stop after this many failing seeds")
    ap.add_argument("--no-shrink", action="store_true")
    ap.add_argument("--progress", type=int, default=200,
                    help="print a progress line every N seeds")
    ap.add_argument("--procs", type=int, default=1,
                    help="shard the seed range over N worker "
                         "processes (seed->case mapping is "
                         "unchanged; this only parallelizes)")
    ap.add_argument("--device", default=None,
                    help="the device every case runs on (default: the "
                         "card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    # the card unless asked otherwise: raise here, before any child
    # starts, when there is none
    device = resolve_device(args.device)

    if args.procs > 1:
        if args.canary:
            # a canary sweep stops at the first catch and then runs
            # the replay/shrink verification in-context — sharding
            # would race shards past the catch; run serial, loudly
            print("--canary runs single-process (--procs ignored)")
        else:
            return _sharded(args)

    models, wrappers, flavors = args.models, args.wrappers, args.flavors
    if args.canary:
        flavors = (canary_mod.CANARY_FLAVOR[args.canary],)
        print(f"canary {args.canary!r}: sweeping flavor "
              f"{flavors[0]!r} until caught")

    import contextlib

    ctx = (canary_mod.armed(args.canary) if args.canary
           else contextlib.nullcontext())
    t0 = time.monotonic()
    matrix: dict = {}
    failures: list = []
    ran = 0
    with ctx:
        for seed in range(args.seed_start,
                          args.seed_start + args.seeds):
            spec = generate_case(seed, models=models,
                                 wrappers=wrappers, flavors=flavors)
            res = run_case(spec, device)
            ran += 1
            key = (spec.model, spec.wrapper, spec.flavor)
            ok, bad = matrix.get(key, (0, 0))
            matrix[key] = (ok + (1 if res.ok else 0),
                           bad + (0 if res.ok else 1))
            if args.progress and ran % args.progress == 0:
                print(f"  ... {ran}/{args.seeds} seeds, "
                      f"{len(failures)} failing, "
                      f"{time.monotonic() - t0:.1f}s", flush=True)
            if res.ok:
                continue
            failures.append((seed, spec, res))
            print(f"seed {seed} FAILED "
                  f"[{spec.model}/{spec.wrapper}/{spec.flavor}] "
                  f"digest {res.digest}:")
            for v in res.violations:
                print(f"  - {v.prop} @ step {v.step}: {v.detail}")
            if args.canary or len(failures) >= args.max_failures:
                break

        # post-process failures INSIDE the canary context (the bug
        # must stay re-injected for the replay and the shrink runs):
        # replay-determinism check + shrink + artifact. Canary mode
        # REQUIRES all three to succeed.
        verdict_ok = not failures
        for seed, spec, res in failures:
            replay = run_case(generate_case(
                seed, models=models, wrappers=wrappers,
                flavors=flavors), device)
            identical = replay.digest == res.digest
            print(f"\nseed {seed}: replay digest "
                  f"{'IDENTICAL' if identical else 'DIVERGED'} "
                  f"({res.digest})")
            payload = {
                "seed": seed,
                "filters": {"models": list(models),
                            "wrappers": list(wrappers),
                            "flavors": list(flavors)},
                "canary": args.canary,
                "spec": spec.as_dict(),
                "violations": [v.as_dict() for v in res.violations],
                "digest": res.digest,
                "replay_identical": identical,
            }
            shrunk_ok = True
            if not args.no_shrink:
                rep = shrink_case(spec, device=device)
                shrunk_ok = rep.shrunk_steps < rep.original_steps
                print(f"seed {seed}: shrunk {rep.original_steps} -> "
                      f"{rep.shrunk_steps} step(s) in "
                      f"{rep.runs} run(s):")
                for s in rep.spec.steps:
                    print(f"    {s}")
                for v in rep.result.violations:
                    print(f"  still: {v.prop}: {v.detail}")
                payload["shrunk"] = rep.as_dict()
            if args.out:
                path = _artifact(args.out, seed, payload)
                print(f"seed {seed}: artifact written to {path}")
            if args.canary:
                verdict_ok = identical and shrunk_ok

    dur = time.monotonic() - t0
    print(f"\nswept {ran} seed(s) in {dur:.1f}s "
          f"({ran / max(dur, 1e-9):.1f}/s), "
          f"{len(failures)} failing")
    for (m, w, f), (ok, bad) in sorted(matrix.items()):
        print(f"  {m:>8s} x {w:>3s} x {f:>7s}: {ok} ok"
              + (f", {bad} FAIL" if bad else ""))

    if args.canary:
        if not failures:
            print(f"\ncanary {args.canary!r} SURVIVED the sweep — "
                  f"the harness missed a known bug")
            return 1
        if not verdict_ok:
            print(f"\ncanary {args.canary!r} caught, but replay/"
                  f"shrink verification failed")
            return 1
        print(f"\ncanary {args.canary!r} caught, replayed "
              f"byte-identically, and shrunk — harness verified")
        return 0
    return 0 if verdict_ok else 1


if __name__ == "__main__":
    sys.exit(main())
