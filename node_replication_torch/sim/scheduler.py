"""Seeded cooperative step-scheduler (the port's copy of
`node_replication_tpu/sim/scheduler.py`: pure Python, the same picks and
the same trace for the same seed).

The determinism backbone of `sim/`: instead of letting the OS
interleave the runtime's background loops (serve workers, fault
medics, the WAL ship loop, the follower apply loop, the promotion
watcher), the simulation runs each loop body as an ACTOR — a callable
that performs one quantum of that loop's work and returns whether it
made progress — and this scheduler picks which actor runs next with a
seeded RNG. One seed => one interleaving => one byte-identical run,
which is what lets `explore.py` treat "which thread won the race" as
a search dimension instead of an accident of the GIL.

Actors are registered with a weight (relative pick probability) and
can be enabled/disabled as the simulated scenario evolves (a killed
primary's ship actor is disabled, a promoted follower's apply actor
too). The schedule — the exact sequence of actor names — is recorded
in `trace`, so a failing case's interleaving is part of its artifact.

`SimScheduler` is used in two places: `properties.py` uses one at
GENERATION time to weave per-lane step streams (client ops, ship
quanta, apply quanta, fault events) into a single schedule, and tests
use one at RUN time to step live actors directly.
"""

from __future__ import annotations

import random


class SimScheduler:
    """Weighted, seeded round-robin-by-chance over named actors."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        # name -> (fn, weight); insertion-ordered, and picks sort by
        # name, so registration order cannot perturb the schedule
        self._actors: dict[str, tuple] = {}
        self._enabled: set[str] = set()
        #: every quantum, in order: (step_index, actor_name, result)
        self.trace: list[tuple] = []

    # ---------------------------------------------------------- registry

    def add(self, name: str, fn, weight: float = 1.0,
            enabled: bool = True) -> None:
        if name in self._actors:
            raise ValueError(f"actor {name!r} already registered")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self._actors[name] = (fn, float(weight))
        if enabled:
            self._enabled.add(name)

    def enable(self, name: str) -> None:
        if name not in self._actors:
            raise KeyError(name)
        self._enabled.add(name)

    def disable(self, name: str) -> None:
        self._enabled.discard(name)

    def enabled(self) -> list[str]:
        return sorted(self._enabled)

    # ---------------------------------------------------------- stepping

    def pick(self) -> str | None:
        """Seeded weighted choice among enabled actors (None when none
        is enabled). Deterministic: candidates are sorted by name."""
        names = sorted(self._enabled)
        if not names:
            return None
        weights = [self._actors[n][1] for n in names]
        return self.rng.choices(names, weights=weights, k=1)[0]

    def step(self):
        """Run one quantum of one seeded-chosen actor; returns
        `(name, result)` (or None when nothing is enabled). The
        actor's return value is recorded verbatim in `trace` — by
        convention actors return a bool ("made progress") or a small
        JSON-able summary."""
        name = self.pick()
        if name is None:
            return None
        fn, _ = self._actors[name]
        result = fn()
        self.trace.append((len(self.trace), name, result))
        return name, result

    def run(self, max_steps: int, idle_limit: int | None = None) -> int:
        """Step up to `max_steps` quanta; with `idle_limit`, stop after
        that many CONSECUTIVE no-progress quanta (an actor result that
        is falsy counts as idle). Returns quanta run."""
        idle = 0
        for i in range(int(max_steps)):
            out = self.step()
            if out is None:
                return i
            if idle_limit is not None:
                idle = 0 if out[1] else idle + 1
                if idle >= idle_limit:
                    return i + 1
        return int(max_steps)
