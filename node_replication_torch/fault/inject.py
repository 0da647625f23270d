"""Fault injection plane: deterministic, seedable fault schedules.

The port's copy of `node_replication_tpu/fault/inject.py`; its
`corrupt_states` works on dicts of tensors. The sites and the
schedule matcher are the reference's, unchanged.

The reference has no fault story at runtime — its recovery model is
structural (replay the log from a deterministic base, SURVEY.md §5,
`core/checkpoint.py`). This module supplies the OTHER half of a live
high-availability loop: a way to make replicas fail on purpose, on a
reproducible schedule, so the detect/quarantine/repair machinery
(`fault/health.py`, `fault/repair.py`) has something real to exercise
in tests and in the chaos bench (`bench.py --chaos`).

Design (the `obs/metrics.py` discipline applied to faults):

- **Sites** are host-side choke points named by string — `replay`
  (`NodeReplicated._exec_round` / `MultiLogReplicated._exec_round`),
  `append` (`_FusedTier._begin_round`, the combiner round of both),
  `read-sync` (`execute`), `serve-batch` (`ServeFrontend._run_batch`
  and the pipelined assembly stage's `_assemble`, BEFORE the batch
  touches the wrapper, so an injected kill is guaranteed pre-append
  and therefore safely retryable in BOTH worker shapes), and
  `serve-complete` (the pipelined completion stage, AFTER
  `begin_mut_batch` appended the round — a kill there is post-append
  by construction, the `maybe_executed=True` class). Each site is one
  `fault_hook(site, rid, owner)` call.
- **Disarmed is free**: `fault_hook` loads one module global and
  branches; no allocation, no lock, no clock — the same one-branch
  contract the metrics registry keeps, so the hooks stay compiled into
  the hot host loops unconditionally.
- **Armed is deterministic**: a `FaultPlan` fires specs by counting
  hook hits per site under a lock. Same seed + same call sequence =>
  same fault schedule (`tests/test_fault.py` pins this).

Actions:

- ``raise``   — raise `FaultError` out of the site (a wedged/killed
  replica as the caller observes it).
- ``stall``   — sleep `stall_s` seconds, clamped to `MAX_STALL_S` so an
  injected stall is always bounded and watchdog/health-visible without
  ever wedging a run.
- ``corrupt`` — perturb one replica's slice of the owner's state pytree
  (`corrupt_states`), giving divergence detection
  (`fault/health.py:divergence_vote`) something real to catch.
- ``corrupt-bytes`` — flip one byte of the owner's last on-disk WAL
  record (`durable/wal.py:_corrupt_tail_bytes`), giving the CRC
  validation on reopen something real to catch. Ignored at owners
  without that hook.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading

from node_replication_torch.analysis.locks import make_lock

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

# Every armable site, in hook order of the write path; the `wal-*`
# sites are the durability plane's choke points (`durable/wal.py`:
# segment open/scan, record append, fsync barrier); `ship` and
# `repl-apply` are the replication plane's (`repl/shipper.py` ship
# loop, `repl/follower.py` apply loop — a raise there exercises the
# worker-failure reporting the follower-fleet gates depend on).
SITES = ("replay", "append", "read-sync", "serve-batch",
         "serve-complete",
         "wal-append", "wal-fsync", "wal-open",
         "ship", "repl-apply",
         # the 2PC plane (`shard/txn.py`): after a participant's
         # durable yes-vote / after the coordinator's durable decision
         # publish / between a participant's apply and its resolved
         # record — the three windows the txn recovery story must
         # survive (bench.py --txn kills processes at exactly these)
         "txn-prepare", "txn-decide", "txn-commit")
ACTIONS = ("raise", "stall", "corrupt", "corrupt-bytes", "kill")

#: what `FaultPlan.chaos` samples from — the ORIGINAL in-process-safe
#: subsets, pinned: existing seeds keep their schedules, and a random
#: schedule can never draw `kill` (which would SIGKILL the host
#: process) or a txn site the armed workload does not exercise.
CHAOS_SITES = SITES[:10]
CHAOS_ACTIONS = ACTIONS[:4]

# Upper bound on an injected stall: stalls must stay bounded so a
# chaos run can never wedge — long enough for the watchdog/health
# layer to notice, short enough to keep CI budgets honest.
MAX_STALL_S = 2.0


class FaultError(RuntimeError):
    """The injected failure. Carries its site/rid so handlers (serve
    failover, tests) can route on where the fault fired."""

    def __init__(self, site: str, rid: int, detail: str = ""):
        super().__init__(
            f"injected fault at site {site!r} (rid={rid})"
            + (f": {detail}" if detail else "")
        )
        self.site = site
        self.rid = rid


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault.

    Fires on the `(after+1)`-th hook hit at `site` that matches `rid`,
    then `count-1` more times on subsequent matching hits; a spent
    spec never fires again. `rid=-1` matches any replica and counts
    hits site-wide; a rid-filtered spec counts hits per `(site, rid)`
    — so in a multi-replica fleet the fire position is pinned to the
    VICTIM's own hit sequence, not to whichever thread interleaving
    the other replicas' hits happened to produce. `stall_s` is clamped
    to `MAX_STALL_S` at fire time.
    """

    site: str
    action: str
    rid: int = -1
    after: int = 0
    count: int = 1
    stall_s: float = 0.05

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(sites: {', '.join(SITES)})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(actions: {', '.join(ACTIONS)})")
        if self.after < 0 or self.count < 1:
            raise ValueError("after must be >= 0 and count >= 1")

    @property
    def effective_stall_s(self) -> float:
        return min(float(self.stall_s), MAX_STALL_S)


def corrupt_states(states, rid: int, seed: int = 0):
    """Deterministically perturb replica `rid`'s slice of an `[R, ...]`
    state dict of tensors (returns a NEW dict; callers assign it back).

    Perturbs the first leaf in sorted-key order (the leaf `jax.tree`
    flattens first): flips the low bit of every element of an integer
    leaf, adds 1.0 to a float leaf, and sets a bool leaf (the
    reference's `bool + True`) — a real divergence `states_equal`
    catches, while shapes/dtypes stay intact.
    """
    import torch

    del seed  # reserved: perturbation site selection, kept stable now
    if not states:
        return states
    first = sorted(states)[0]
    leaf = states[first].clone()
    if leaf.dtype == torch.bool:
        leaf[rid] = True
    elif leaf.dtype.is_floating_point:
        leaf[rid] += 1.0
    else:
        leaf[rid] ^= 1
    return {**states, first: leaf}


class FaultPlan:
    """A deterministic schedule of `FaultSpec`s plus arming state.

    Construct explicitly (`FaultPlan([spec, ...], seed=7)`) or sample a
    reproducible random schedule with `FaultPlan.chaos(seed, ...)`.
    Arm with `arm()`/`disarm()` or the `armed()` context manager; while
    armed, the module-level `fault_hook` routes every site hit through
    `_fire`. Every fired fault is recorded in `self.fired` (host
    truth for tests), counted in the `fault.injected` metric, and
    emitted as a `fault-inject` trace event.
    """

    def __init__(self, specs=(), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = make_lock("FaultPlan._lock")
        self._hits = {site: 0 for site in SITES}
        self._rid_hits: dict[tuple[str, int], int] = {}
        self._fired_counts = [0] * len(self.specs)
        self.fired: list[dict] = []
        self._m_injected = get_registry().counter("fault.injected")

    # ------------------------------------------------------------ schedule

    @classmethod
    def chaos(cls, seed: int, n_faults: int = 3, n_replicas: int = 2,
              sites=CHAOS_SITES, actions=CHAOS_ACTIONS,
              max_after: int = 64) -> "FaultPlan":
        """Sample a reproducible random schedule: `n_faults` specs drawn
        from `sites` x `actions` x `[0, n_replicas)` x `[0, max_after]`
        with `random.Random(seed)` — same seed, same schedule."""
        rng = random.Random(seed)
        specs = [
            FaultSpec(
                site=rng.choice(tuple(sites)),
                action=rng.choice(tuple(actions)),
                rid=rng.randrange(n_replicas),
                after=rng.randrange(max_after + 1),
                stall_s=round(rng.uniform(0.01, MAX_STALL_S), 3),
            )
            for _ in range(n_faults)
        ]
        return cls(specs, seed=seed)

    def schedule(self) -> tuple:
        """The plan as a comparable value (the determinism contract)."""
        return tuple(dataclasses.astuple(s) for s in self.specs)

    # -------------------------------------------------------------- arming

    def arm(self) -> "FaultPlan":
        global _armed_plan
        _armed_plan = self
        return self

    def disarm(self) -> None:
        global _armed_plan
        if _armed_plan is self:
            _armed_plan = None

    def armed(self):
        """Context manager: arm on enter, disarm on exit."""
        return _Armed(self)

    # -------------------------------------------------------------- firing

    def _fire(self, site: str, rid: int, owner) -> None:
        """One hook hit: match specs, perform at most one action."""
        with self._lock:
            hit = self._hits[site]
            self._hits[site] = hit + 1
            rid_hit = self._rid_hits.get((site, rid), 0)
            self._rid_hits[(site, rid)] = rid_hit + 1
            spec = None
            fired_hit = 0
            for i, s in enumerate(self.specs):
                if s.site != site:
                    continue
                if s.rid != -1 and rid != -1 and s.rid != rid:
                    continue
                # rid-filtered specs trigger on the victim's OWN hit
                # count (deterministic under concurrent workers);
                # wildcard specs trigger on the site-wide count
                eff = hit if s.rid == -1 else rid_hit
                if eff < s.after or self._fired_counts[i] >= s.count:
                    continue
                spec = s
                fired_hit = eff
                self._fired_counts[i] += 1
                break
            if spec is None:
                return
            self.fired.append({
                "site": site, "rid": rid, "action": spec.action,
                "hit": fired_hit,
            })
        self._m_injected.inc()
        get_tracer().emit("fault-inject", site=site, rid=rid,
                          action=spec.action, hit=hit)
        target = spec.rid if spec.rid != -1 else (rid if rid != -1 else 0)
        if spec.action == "raise":
            raise FaultError(site, target)
        if spec.action == "kill":
            # a REAL SIGKILL of this process — no atexit, no flushes,
            # no unwinding: the crash the durability planes' fsync-
            # before-ack contracts are written against. Only the txn
            # bench's child processes arm this (`bench.py --txn`);
            # never sample it into an in-process chaos schedule.
            os.kill(os.getpid(), signal.SIGKILL)
            return  # pragma: no cover — unreachable after SIGKILL
        if spec.action == "stall":
            # injected clock: under `SimClock` a stall is a virtual-
            # time event (instant in wall time, visible in timelines)
            get_clock().sleep(spec.effective_stall_s)
            return
        if spec.action == "corrupt-bytes":
            # flip a byte of the owner's last on-disk record (the
            # owner is the WAL whose operation hit the hook)
            if owner is not None and hasattr(owner,
                                             "_corrupt_tail_bytes"):
                owner._corrupt_tail_bytes()
            return
        # corrupt: perturb the owner's state pytree in place (the owner
        # is the wrapper whose host loop hit the hook)
        if owner is not None and hasattr(owner, "states"):
            owner.states = corrupt_states(owner.states, target,
                                          seed=self.seed)


class _Armed:
    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return self.plan.arm()

    def __exit__(self, *exc) -> None:
        self.plan.disarm()


_armed_plan: FaultPlan | None = None


def fault_hook(site: str, rid: int = -1, owner=None) -> None:
    """The per-site choke point compiled into the host hot loops.

    Disarmed (the default, and the only state benchmarks run in) this
    is one global load and one branch — the `obs/metrics.py` cost
    contract. Armed, it defers to the plan's deterministic matcher.
    """
    plan = _armed_plan
    if plan is None:
        return
    plan._fire(site, rid, owner)


def armed_plan() -> FaultPlan | None:
    """The currently armed plan (None when disarmed)."""
    return _armed_plan
