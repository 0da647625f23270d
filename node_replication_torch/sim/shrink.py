"""Delta-debugging shrinker: minimize a failing schedule (the port's
copy of `node_replication_tpu/sim/shrink.py`; every candidate runs on
the failing case's `device`).

A sweep failure arrives as a 30-60 step schedule; most steps are
noise. `shrink_case` runs the classic ddmin loop over `spec.steps`:
repeatedly try removing chunks (halving granularity down to single
steps), keep any candidate that still reproduces a violation of the
SAME property, and stop at a 1-minimal schedule — every remaining
step is load-bearing. The step vocabulary is closed under
subsequences by construction (`properties.py` interprets any step
defensively: a `promote` without a `kill` promotes anyway, an `apply`
with nothing shipped is a no-op), so every candidate is a valid case.

Determinism makes this sound: a candidate either reproduces or it
does not — there is no flaky middle, so no retries and no
probability calculus. Cost is bounded by `max_runs` interpreter runs.
"""

from __future__ import annotations

import dataclasses

from node_replication_torch.sim.properties import (
    CaseResult,
    CaseSpec,
    run_case,
)


@dataclasses.dataclass
class ShrinkReport:
    original_steps: int
    shrunk_steps: int
    runs: int
    spec: CaseSpec
    result: CaseResult  # the shrunk spec's (still-failing) result

    def as_dict(self) -> dict:
        return {
            "original_steps": self.original_steps,
            "shrunk_steps": self.shrunk_steps,
            "runs": self.runs,
            "spec": self.spec.as_dict(),
            "violations": [v.as_dict()
                           for v in self.result.violations],
            "digest": self.result.digest,
        }


def _with_steps(spec: CaseSpec, steps: list) -> CaseSpec:
    return dataclasses.replace(spec, steps=list(steps))


def shrink_case(spec: CaseSpec, max_runs: int = 250,
                device=None) -> ShrinkReport:
    """ddmin over `spec.steps`, preserving at least one violation of
    the original run's property set, each run on `device` (None: the
    card). Returns the minimal spec plus its (failing) result."""
    base = run_case(spec, device)
    runs = 1
    if base.ok:
        raise ValueError("shrink_case needs a FAILING spec")
    props = {v.prop for v in base.violations}

    def fails(steps: list):
        nonlocal runs
        runs += 1
        res = run_case(_with_steps(spec, steps), device)
        if any(v.prop in props for v in res.violations):
            return res
        return None

    steps = list(spec.steps)
    best = base
    chunk = max(1, len(steps) // 2)
    while chunk >= 1 and runs < max_runs:
        i = 0
        shrunk_this_pass = False
        while i < len(steps) and runs < max_runs:
            candidate = steps[:i] + steps[i + chunk:]
            if not candidate:
                i += chunk
                continue
            res = fails(candidate)
            if res is not None:
                steps = candidate
                best = res
                shrunk_this_pass = True
                # retry the same offset: the next chunk slid into it
            else:
                i += chunk
        if chunk == 1 and not shrunk_this_pass:
            break
        if not shrunk_this_pass or chunk > 1:
            chunk = max(1, chunk // 2) if chunk > 1 else 0
    final = _with_steps(spec, steps)
    return ShrinkReport(
        original_steps=len(spec.steps),
        shrunk_steps=len(steps),
        runs=runs,
        spec=final,
        result=best,
    )
