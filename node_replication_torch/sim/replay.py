"""Byte-identical single-seed reproduction (the port's copy of
`node_replication_tpu/sim/replay.py`).

    python -m node_replication_torch.sim.replay <seed> [filters] [--device cpu]

regenerates the seed's `CaseSpec` (pass the SAME --models/--wrappers/
--flavors filters the sweep used, if any), runs it, and prints the
step-by-step event log, every violation, and the run digest. Running
it twice prints the same bytes — the whole point of the sim plane: a
failure seen once in a 1000-seed sweep is a unit test forever.

`--spec <artifact.json>` replays a schedule directly from an
`explore.py` artifact instead (e.g. the SHRUNK schedule), bypassing
generation. An artifact written by either package's `explore.py`
replays here with the same digest. `--device` picks the device the
case runs on (default: the card, which the command needs unless it is
given `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys

from node_replication_torch.sim.properties import (
    FLAVORS,
    MODELS,
    WRAPPERS,
    CaseSpec,
    generate_case,
    run_case,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m node_replication_torch.sim.replay",
        description="replay one sim seed byte-identically",
    )
    ap.add_argument("seed", type=int, nargs="?", default=None)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--wrappers", default=",".join(WRAPPERS))
    ap.add_argument("--flavors", default=",".join(FLAVORS))
    ap.add_argument("--spec", default=None,
                    help="replay the spec inside an explore.py "
                         "artifact JSON (field 'spec' or "
                         "'shrunk.spec') instead of regenerating")
    ap.add_argument("--json", action="store_true",
                    help="emit the result as JSON")
    ap.add_argument("--device", default=None,
                    help="the device the case runs on (default: the "
                         "card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    if args.spec is not None:
        with open(args.spec) as f:
            payload = json.load(f)
        d = payload.get("shrunk", {}).get("spec") or payload["spec"]
        spec = CaseSpec.from_dict(d)
    elif args.seed is not None:
        split = lambda v: tuple(p for p in v.split(",") if p)  # noqa: E731
        spec = generate_case(
            args.seed, models=split(args.models),
            wrappers=split(args.wrappers),
            flavors=split(args.flavors),
        )
    else:
        ap.error("need a seed or --spec")
        return 2

    res = run_case(spec, args.device)
    if args.json:
        print(json.dumps({
            "spec": spec.as_dict(),
            "events": res.events,
            "violations": [v.as_dict() for v in res.violations],
            "digest": res.digest,
        }, indent=2))
        return 0 if res.ok else 1

    print(f"case seed={spec.seed} {spec.model}/{spec.wrapper}/"
          f"{spec.flavor} R={spec.n_replicas} nlogs={spec.nlogs} "
          f"({len(spec.steps)} step(s))")
    for i, step in enumerate(spec.steps):
        evs = [e for e in res.events if e[0] == i]
        out = "; ".join(
            f"{kind} {kv}" if kv else kind for _, kind, kv in evs
        )
        print(f"  [{i:3d}] {step!r:<48s} -> {out}")
    tailevs = [e for e in res.events if e[0] == -1]
    if tailevs:
        print(f"  [end] " + "; ".join(
            f"{kind} {kv}" if kv else kind for _, kind, kv in tailevs))
    if res.violations:
        print("VIOLATIONS:")
        for v in res.violations:
            print(f"  - {v.prop} @ step {v.step}: {v.detail}")
    else:
        print("all properties held")
    print(f"digest {res.digest}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
