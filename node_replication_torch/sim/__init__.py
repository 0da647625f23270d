"""Deterministic chaos: virtual time + seeded schedules + an
oracle-differential property harness over serve + fault + durable +
repl + shard (the port's copy of `node_replication_tpu/sim/`).

A robustness gate that runs on the wall clock explores exactly ONE
interleaving per run. This package is the other half of the
FoundationDB simulation-testing idea: make time injectable
(`utils/clock.py` + `SimClock`), drive every background loop —
serve workers, fault medics, the WAL shipper, the follower apply
loop, the promotion watcher — one quantum at a time on a seeded
cooperative schedule, and check every run against a pure-Python
oracle. A single seed then fully determines the interleaving, so

    python -m node_replication_torch.sim.explore --seeds 1000

sweeps a thousand adversarial schedules, any failure replays
byte-identically from its seed

    python -m node_replication_torch.sim.replay <seed>

and the delta-debugging shrinker (`sim/shrink.py`) minimizes the
op/fault schedule before a human ever looks at it.

Modules:

- `scheduler.py` — the seeded cooperative step-scheduler.
- `oracle.py`    — pure-numpy twins of the bundled models.
- `properties.py`— case generation + the step interpreter + the
  property catalog (response differential, log-content exactness,
  maybe-executed honesty, bit-identity, durable-ack survival,
  bounded staleness, zombie fencing).
- `explore.py`   — the seed-sweep CLI (the `sim-smoke` CI gate).
- `replay.py`    — byte-identical single-seed reproduction.
- `shrink.py`    — ddmin over a failing schedule.
- `canary.py`    — deliberately re-injectable bugs that prove the
  harness can catch what it claims to catch.

Every fleet a case builds runs on the card unless the caller passes
`device="cpu"` (`run_case(spec, device=)`, `--device` on the CLIs). One
seed gives one digest on either device, and the same digest as the
reference package's `sim/`.
"""

from node_replication_torch.sim.oracle import make_oracle
from node_replication_torch.sim.properties import (
    CaseResult,
    CaseSpec,
    Violation,
    generate_case,
    run_case,
)
from node_replication_torch.sim.scheduler import SimScheduler

__all__ = [
    "CaseResult",
    "CaseSpec",
    "SimScheduler",
    "Violation",
    "generate_case",
    "make_oracle",
    "run_case",
]
