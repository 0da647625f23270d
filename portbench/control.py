"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with its store narrowed to int16,
the nearest type below the int32 the configurations state, judged by
the same comparison as a run. It has to come out as not correct.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--ops N]

It draws the cell's own traffic at the cell's own sizes: for a served
cell `--ops` ops a client (drawn as the served loop draws them), for a
round cell `--ops` rounds of the cell's window, through its pool as a
run goes. It prints, a seed a line, each number compared beside its
limit. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, reference
from portbench.drivers import rounds
from portbench.drivers.served import CHUNK
from portbench.traffic import Stream

NARROW = torch.int16


def control_ops(model, spec: dict, seed: int, n: int) -> list:
    """The ops a run of the cell would send: `n` a client for a served
    mix, `n` rounds for a round mix."""
    if spec["driver"] == "served":
        out = []
        for c in range(int(spec["clients"])):
            s = Stream(spec, model, seed, c)
            opc, args, write = s.draw(max(n, CHUNK))
            out.append((opc[:n], args[:n], write[:n]))
        return out
    pool = rounds.draw_pool(spec, model, seed)
    return [pool[i % len(pool)] for i in range(n)]


def run_control(name: str, seed: int, n: int, device,
                overrides: dict | None = None) -> dict:
    """The checks of the int16 reference in the program's place."""
    _, _, cfg, spec = harness.load_cell(name, overrides=overrides)
    model = harness.load_model(cfg)
    planes = harness.initial_planes(model, seed, device)
    ops = control_ops(model, spec, seed, n)
    narrow = reference.narrow(planes, NARROW)
    resps = []
    for opc, args, write in ops:
        resps.append(reference.replay(
            model, narrow, torch.from_numpy(opc), torch.from_numpy(args),
            torch.from_numpy(write), store=NARROW).cpu().numpy())
    r = model.n_replicas
    state = {k: v.expand(r, v.shape[0]) for k, v in narrow.items()}
    checks = harness.compare(model, planes, ops, resps, state)
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--ops", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    failed_all = True
    for seed in a.seeds:
        checks = run_control(a.workload, seed, a.ops, a.device)
        bad = any(c["value"] > c["limit"] for c in checks.values())
        failed_all &= bad
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_correct": not bad, "checks": checks}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
