"""Case generation + step interpreter + the property catalog (the
port's copy of `node_replication_tpu/sim/properties.py`: the same
generator, the same steps, the same events and the same digest for the
same seed, over the port's fleets on `device`).

A **case** is one fully-seeded simulated scenario: a model, a wrapper
(`NodeReplicated` or `MultiLogReplicated`), a flavor (which subsystem
stack is under test), and a flat list of **steps** — the seeded
schedule. The interpreter (`run_case`) executes the steps one quantum
at a time on a single stepping thread under an installed `SimClock`
(background loops are stepped cooperatively: the WAL shipper's
`_ship_once`, the follower's `_apply_once`, the promotion watcher's
`check()`), records every observable outcome into an event log, and
checks the run against a pure-numpy oracle (`sim/oracle.py`). The
same seed always produces the same spec, the same events, and the
same digest — `replay.py` rests on exactly this.

Flavors:

- ``wrapper`` — ops straight into the wrapper (`execute_mut_batch` /
  `execute`), faults at the replay/append/read-sync sites, silent
  corruption + divergence probe + repair-by-replay (NR, R=3).
- ``serve``   — closed-loop ops through a `ServeFrontend`; NR runs
  failover + the `ReplicaLifecycleManager` medic pipeline under
  serve-batch/append kills; CNR runs the same fault plans with
  failover off (typed rejections, worker survives).
- ``crash``   — NR + attached WAL; seeded kill -9 (flush-to-OS, then
  truncate the active segment to its last-fsynced size, plus an
  optional torn-tail remainder) followed by `recover_fleet`.
- ``repl``    — NR primary + WAL + `DirectoryFeed` + shipper +
  follower + promotion watcher, all stepped as scheduler quanta;
  seeded primary kill, heartbeat-silence detection in virtual time,
  election, epoch fence, promotion, post-failover serving.
- ``sharded`` — a 2-shard keyspace fleet: per shard an NR
  primary + WAL + feed + shipper + follower, fronted by the REAL
  `ShardRouter` (`concurrent=False` — sequential shard-ordered
  fan-out, so thread interleaving is not schedule noise). Routed
  writes/batches/reads, per-shard ship/apply lanes, and a seeded
  kill → typed-unavailability window → promotion → router re-home
  tail. Generated entirely from a FRESH rng stream, so every other
  flavor's schedule (and the canary-seed expectations) stays
  byte-identical. More fresh streams add ``stxn``
  steps, which drive atomic cross-shard transactions through the REAL
  `TxnCoordinator` (optionally killing the coordinator right after
  its durable decision publish and simulating the restart recovery),
  and no-kill runs may end in an ``sreshard`` step — a live split of
  one congruence class onto the donor's promoted standby, with
  post-split traffic across the refined topology.

Property catalog (each violation carries the property name):

- ``resp-diff``          — an acked response differs from the oracle's
  at the same logical position.
- ``read-diff`` / ``fread-diff`` — a (bounded-staleness) read differs
  from the oracle at the replica's applied position.
- ``maybe-executed-honesty`` — a rejection that promised
  `maybe_executed=False` for an op the log provably holds.
- ``log-content``        — the ring's `[0, tail)` is not exactly the
  acked op sequence (lost, duplicated, or reordered entries).
- ``state-diff``         — final replica state is not bit-identical to
  the oracle's arrays.
- ``bit-identity``       — unfenced replicas disagree after sync.
- ``divergence-detect``  — an injected corruption the digest vote
  failed to name.
- ``durable-ack-survival`` — a crash/promotion lost an op that was
  fsync-acked (crash) or shipped-acked (repl).
- ``staleness-bound``    — a bounded read served below its bound.
- ``replication-gap``    — the follower observed a feed gap/corruption
  (the reclaim-vs-ship protection failing).
- ``zombie-unfenced``    — a superseded primary's shipper published
  past the promotion fence.
- ``shed-honesty``       — a shed response (`Overloaded`, an
  eviction, or a client-side `CircuitOpen`) for an op the log
  nonetheless holds — a shed MUST have zero log effect.
- ``priority-inversion`` — a CRITICAL op was shed while a
  lower-priority op sat queued (the overload plane's strict-priority
  eviction exists to make this impossible; the queue counts it at
  the shed decision point, under its lock).
- ``shard-isolation``    — a shard's ring holds a key outside its
  `key % N` congruence class, or a shard's final state is not the
  fold of EXACTLY the ops routed to it (an op leaked into the wrong
  shard's keyspace slice). The sharded flavor also reuses
  ``resp-diff`` (per-shard oracle), ``durable-ack-survival`` (a
  promotion lost a shipped-acked op), ``zombie-unfenced``, and
  ``log-content`` (lost/duplicated acks per shard).
- ``txn-atomicity``      — a cross-shard transaction half-applied: an
  acked txn op whose response (or read-back) diverges from the
  per-class oracle, an aborted txn with a visible per-key effect, or
  a DECIDED txn (the coordinator crashed one instruction after its
  durable decision publish) that restart recovery fails to re-drive
  to commit on every participant.
- ``reshard-exactness``  — after a live split, some key's read-back
  is not the fold of exactly its class's acked ops (a moved key lost,
  duplicated, or served from the wrong slice).

The serve flavor's ``burst`` steps drive the overload plane
deterministically: a paused frontend (workers not started) admits a
mixed-priority burst against a tiny adaptive limit — every
shed/evict/circuit decision lands on the stepping thread — then starts,
drains, and the interpreter reads the ACTUAL ring slice back to fold
the oracle in true log order and check the two properties above plus
``resp-diff``.

Devices: `run_case(spec, device=None)` builds every fleet of the case
(the wrappers, each shard's primary, every follower, the fleet that
`recover_fleet` rebuilds) on `device`; `None` means the card and raises
without one. The device is part of neither the spec nor the digest: no
event records it, nor the fused tier that an `engine="auto"` fleet
calibrates on the card, so one seed gives one digest on every device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import shutil
import tempfile

import numpy as np

from node_replication_torch.sim.oracle import make_oracle
from node_replication_torch.sim.scheduler import SimScheduler
from node_replication_torch.utils.clock import SimClock, installed
from node_replication_torch.utils.device import resolve_device

MODELS = ("hashmap", "stack", "queue", "seqreg")
WRAPPERS = ("nr", "cnr")
FLAVORS = ("wrapper", "serve", "crash", "repl", "sharded")

#: canonical sizes — fixed per model so a sweep's cases share compiled
#: kernels (same shapes => jit cache hits; per-case cost stays low)
MODEL_SIZES = {"hashmap": 32, "stack": 24, "queue": 12, "seqreg": 16}
LOG_ENTRIES = 256
GC_SLACK = 32
#: tiny WAL segments in the repl flavor: rotation every few records,
#: so snapshot-floor reclamation has something to delete and the
#: reclaim-vs-ship pin protection is actually load-bearing
REPL_SEGMENT_BYTES = 256
CRASH_SEGMENT_BYTES = 1 << 10

_WRITE_FAULT_SITES = {
    "wrapper": ("replay", "append"),
    "serve": ("serve-batch", "append"),
}
_FAULT_ACTIONS = ("raise", "stall")


@dataclasses.dataclass
class CaseSpec:
    """One fully-seeded scenario (JSON-able; the shrinker edits
    `steps`, everything else is fixed by the seed)."""

    seed: int
    model: str
    wrapper: str  # "nr" | "cnr"
    flavor: str  # "wrapper" | "serve" | "crash" | "repl"
    n_replicas: int
    nlogs: int  # cnr only (1 for nr)
    steps: list
    #: serve-flavor pipeline overlap (`ServeConfig.pipeline_depth`):
    #: 0 = serial worker, 1 = assembly/completion split — drawn from a
    #: FRESH rng stream so every pre-overlap schedule (and canary
    #: artifact) stays byte-identical
    overlap: int = 0
    #: sharded flavor only: keyspace shard count (0 everywhere else,
    #: so pre-sharding failing-seed artifacts keep replaying)
    n_shards: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CaseSpec":
        # defaulted fields stay optional so pre-overlap failing-seed
        # artifacts keep replaying byte-identically
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass
class Violation:
    prop: str
    step: int  # index into spec.steps (-1 = end-of-case check)
    detail: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CaseResult:
    spec: CaseSpec
    violations: list
    events: list
    digest: str

    @property
    def ok(self) -> bool:
        return not self.violations


# ==========================================================================
# generation
# ==========================================================================


def _gen_write(rng: random.Random, model: str, size: int,
               uniq: int) -> list:
    """One mutating op; `uniq` tags payloads so every logged write is
    distinguishable (the log-content property needs exactness)."""
    if model == "hashmap":
        if rng.random() < 0.75:
            return [1, rng.randrange(size), uniq]  # HM_PUT
        return [2, rng.randrange(size), 0]  # HM_REMOVE
    if model == "stack":
        if rng.random() < 0.6:
            return [1, uniq, 0]  # ST_PUSH
        return [2, 0, 0]  # ST_POP
    if model == "queue":
        if rng.random() < 0.6:
            return [1, uniq, 0]  # Q_ENQ
        return [2, 0, 0]  # Q_DEQ
    if model == "seqreg":
        return [1, rng.randrange(size), uniq]  # SR_SET
    raise ValueError(model)


def _gen_unique_write(rng: random.Random, model: str, size: int,
                      uniq: int) -> list:
    """One INSERT-shaped mutating op with a unique payload — burst
    steps need every logged write distinguishable so the ring slice
    maps back to its request (POP/REMOVE ops all encode alike)."""
    if model in ("hashmap", "seqreg"):
        return [1, rng.randrange(size), uniq]  # PUT / SR_SET
    return [1, uniq, 0]  # ST_PUSH / Q_ENQ


def _gen_read(rng: random.Random, model: str, size: int) -> list:
    if model == "hashmap":
        return [1, rng.randrange(size), 0]  # HM_GET
    if model in ("stack", "queue"):
        return [rng.choice((1, 2)), 0, 0]  # PEEK/FRONT or LEN
    if model == "seqreg":
        return [1, rng.randrange(size), 0]  # SR_GET
    raise ValueError(model)


def generate_case(
    seed: int,
    models=MODELS,
    wrappers=WRAPPERS,
    flavors=FLAVORS,
) -> CaseSpec:
    """Derive one `CaseSpec` from `seed` (restricted to the given
    models/wrappers/flavors — `explore.py` passes its CLI filters, and
    `replay.py` must pass the SAME filters to reproduce a sweep's
    case)."""
    rng = random.Random(int(seed))
    # the durability and replication planes are NR surfaces: with
    # "nr" filtered out, those flavors are dropped from the pool
    # rather than silently overriding the wrapper filter. "sharded"
    # is excluded from the BASE pool so the original flavor draw (and
    # every pre-sharding schedule) stays byte-identical — sharded
    # cases come from the fresh-stream conversion below instead
    pool = [f for f in flavors
            if f != "sharded"
            and ("nr" in wrappers or f in ("wrapper", "serve"))]
    flavor = rng.choice(pool or ["wrapper"])
    if flavor in ("crash", "repl") or "cnr" not in wrappers:
        wrapper = "nr"
    else:
        wrapper = rng.choice(
            [w for w in ("nr", "nr", "cnr") if w in wrappers]
        )
    model = rng.choice(list(models))
    nlogs = 1
    if wrapper == "cnr" and model in ("hashmap", "seqreg"):
        nlogs = rng.choice((1, 2))
    with_corrupt = (
        wrapper == "nr" and flavor == "wrapper" and rng.random() < 0.4
    )
    R = 3 if with_corrupt else 2
    n = rng.randint(16, 36)
    # keyspace sharding: a FRESH rng stream decides
    # whether this seed becomes a sharded-fleet case — only serve/nr
    # base cases convert (or every seed, under an explicit
    # `flavors=("sharded",)` filter), and every draw the sharded
    # schedule needs comes from the fresh stream, so non-converted
    # seeds (and the canary expectations) stay byte-identical
    if "sharded" in flavors and "nr" in wrappers:
        srng = random.Random(int(seed) ^ 0x54A8D)
        if not pool or (flavor == "serve" and wrapper == "nr"
                        and srng.random() < 0.3):
            return _generate_sharded(seed, srng, models)
    uniq = 1
    steps: list = []

    def w(fault=None):
        nonlocal uniq
        op = _gen_write(rng, model, MODEL_SIZES[model], uniq)
        uniq += 1
        rid = rng.randrange(R)
        if fault is None:
            steps.append(["w", rid, op])
        else:
            steps.append(["wf", rid, fault[0], fault[1], op])

    def r():
        steps.append(
            ["r", rng.randrange(R),
             _gen_read(rng, model, MODEL_SIZES[model])]
        )

    if flavor in ("wrapper", "serve"):
        kills = 0
        for _ in range(n):
            x = rng.random()
            if x < 0.55:
                w()
            elif x < 0.75:
                r()
            elif x < 0.85 and kills < 2:
                kills += 1
                w(fault=(rng.choice(_WRITE_FAULT_SITES[flavor]),
                         rng.choice(_FAULT_ACTIONS)))
            elif x < 0.92 and flavor == "wrapper":
                steps.append(["rf", rng.randrange(R),
                              _gen_read(rng, model,
                                        MODEL_SIZES[model])])
            elif with_corrupt:
                steps.append(["corrupt", rng.randrange(R)])
                steps.append(["probe"])
            else:
                w()
        if flavor == "serve" and wrapper == "nr":
            # overload bursts (a FRESH rng stream: the base schedule
            # above — and every other flavor's — stays byte-identical
            # to the pre-overload generator, so failing-seed artifacts
            # and canary expectations survive)
            brng = random.Random(int(seed) ^ 0xB0057)
            buniq = 100_000  # disjoint from the w() uniq range
            for _ in range(brng.randrange(1, 3)):
                burst = []
                for _ in range(brng.randrange(8, 15)):
                    prio = brng.choices((0, 1, 2),
                                        weights=(1, 2, 2))[0]
                    burst.append([prio, _gen_unique_write(
                        brng, model, MODEL_SIZES[model], buniq)])
                    buniq += 1
                steps.append(["burst", burst])
        steps.append(["sync"])
        overlap = 0
        if flavor == "serve":
            # pipelined serving: half the serve cases run
            # the assembly/completion split at depth 1, so the
            # 1000-seed sweep races the two-stage handoff for free.
            # A FRESH rng stream keeps every existing schedule (and
            # the canary expectations) byte-identical.
            orng = random.Random(int(seed) ^ 0x0E87A9)
            overlap = int(orng.random() < 0.5)
        return CaseSpec(seed, model, wrapper, flavor, R, nlogs, steps,
                        overlap=overlap)

    if flavor == "crash":
        crashes = 0
        for i in range(n):
            x = rng.random()
            if x < 0.5:
                w()
            elif x < 0.62:
                r()
            elif x < 0.78:
                steps.append(["wal-sync"])
            elif x < 0.86:
                steps.append(["snapshot"])
            elif crashes < 2 and i > 4:
                crashes += 1
                # lose: drop everything past the last fsync; extra:
                # torn-tail remainder bytes kept past that point
                steps.append(["crash", int(rng.random() < 0.6),
                              rng.randrange(64)])
            else:
                w()
        steps.append(["sync"])
        return CaseSpec(seed, model, wrapper, flavor, R, nlogs, steps)

    # repl: weave the client/durability/ship/apply/watch lanes with a
    # seeded cooperative scheduler — the schedule IS the interleaving
    sched = SimScheduler(seed=rng.randrange(1 << 30))
    sched.add("w", lambda: w() or True, weight=3.0)
    sched.add("r", lambda: r() or True, weight=1.0)
    sched.add("wal-sync", lambda: steps.append(["wal-sync"]) or True,
              weight=1.2)
    sched.add("ship", lambda: steps.append(["ship"]) or True,
              weight=1.2)
    sched.add("apply", lambda: steps.append(["apply"]) or True,
              weight=1.2)
    sched.add("fread", lambda: steps.append(
        ["fread", _gen_read(rng, model, MODEL_SIZES[model]),
         rng.choice((2, 4, 8))]) or True, weight=0.8)
    sched.add("watch", lambda: steps.append(["watch", 1]) or True,
              weight=0.5)
    sched.run(n + 10)
    # reclamation pressure mid-stream: snapshot raises the floor, the
    # sync right after advances the GC head past it — only the ship
    # pin now protects unshipped segments (the reclaim-vs-ship race
    # the canary re-opens)
    cut = rng.randrange(len(steps) // 2, len(steps))
    steps[cut:cut] = [["snapshot"], ["sync"]]
    # wire-fault lane: the follower consumes the feed
    # through an in-memory `PipeTransport` twin of the socket client,
    # and a FRESH rng stream inserts disconnect/reconnect windows and
    # partitions — stream gaps, duplicate delivery after a rewound
    # reconnect, and frozen-heartbeat silence are now part of the
    # 1000-seed sweep. The fresh stream keeps the base repl schedule
    # (and the canary-seed expectations) byte-identical to the
    # pre-transport generator; every disconnect is paired with a
    # reconnect BEFORE the kill/promote tail, so promotion always
    # fences over a live pipe.
    prng = random.Random(int(seed) ^ 0x7197E)
    if prng.random() < 0.6:
        p = prng.randrange(2, max(3, len(steps) - 2))
        gap = prng.randrange(0, 4)
        rew = prng.choice((0, 2, 4, 8))
        steps[p:p] = [["disconnect"]]
        q = min(p + 1 + gap, len(steps))
        steps[q:q] = [["reconnect", rew]]
    if prng.random() < 0.35:
        p2 = prng.randrange(1, max(2, len(steps) - 1))
        steps[p2:p2] = [["partition", prng.randrange(1, 3),
                         prng.choice((0, 4))]]
    if rng.random() < 0.7:
        steps.append(["wal-sync"])
        if rng.random() < 0.7:
            steps.append(["ship"])
        steps.append(["kill"])
        for _ in range(9):
            steps.append(["watch", 2])  # 2 virtual ticks per quantum
        steps.append(["promote"])
        if rng.random() < 0.5:
            steps.append(["zombie-ship"])
        for _ in range(rng.randrange(2, 6)):
            op = _gen_write(rng, model, MODEL_SIZES[model], uniq)
            uniq += 1
            steps.append(["w", 0, op])
        steps.append(["fread",
                      _gen_read(rng, model, MODEL_SIZES[model]), 0])
    else:
        steps += [["wal-sync"], ["ship"], ["apply"], ["apply"]]
    return CaseSpec(seed, model, wrapper, flavor, R, nlogs, steps)


def _generate_sharded(seed: int, srng: random.Random,
                      models) -> CaseSpec:
    """One sharded-fleet schedule, drawn ENTIRELY from the fresh
    stream `srng` (the base stream's consumption up to the conversion
    point is identical either way, so non-converted seeds replay
    byte-identically). Keyed models only — `args[0]` is the routing
    key, and stack/queue ops would degenerate onto one shard."""
    keyed = [m for m in ("hashmap", "seqreg") if m in models]
    model = srng.choice(keyed or ["hashmap"])
    size = MODEL_SIZES[model]
    n_shards = 2
    uniq = 1
    steps: list = []

    def wop() -> list:
        nonlocal uniq
        op = _gen_write(srng, model, size, uniq)
        uniq += 1
        return op

    for _ in range(srng.randint(18, 34)):
        x = srng.random()
        if x < 0.40:
            steps.append(["sw", wop()])
        elif x < 0.55:
            steps.append(
                ["sbatch", [wop() for _ in range(srng.randrange(2, 6))]]
            )
        elif x < 0.70:
            steps.append(["sread", _gen_read(srng, model, size)])
        elif x < 0.80:
            steps.append(["swal", srng.randrange(n_shards)])
        elif x < 0.90:
            steps.append(["sship", srng.randrange(n_shards)])
        else:
            steps.append(["sapply", srng.randrange(n_shards)])
    body_end = len(steps)
    killed = srng.random() < 0.7
    if killed:
        # kill → typed-unavailability window (writes keyed into the
        # victim's congruence class surface `ShardUnavailable`; the
        # survivor keeps acking — the isolation half of the property)
        # → promotion → router re-home → post-failover serving
        victim = srng.randrange(n_shards)
        steps.append(["swal", victim])
        if srng.random() < 0.7:
            steps.append(["sship", victim])
        steps.append(["skill", victim])
        for _ in range(srng.randrange(2, 5)):
            steps.append(["sw", wop()])
        steps.append(["spromote", victim])
        if srng.random() < 0.5:
            steps.append(["szombie", victim])
        for _ in range(srng.randrange(2, 6)):
            steps.append(["sw", wop()])
    else:
        for s in range(n_shards):
            steps += [["swal", s], ["sship", s], ["sapply", s]]
    # cross-shard transactions + online resharding: drawn
    # from ANOTHER fresh stream, so every pre-txn sharded schedule
    # (and the existing canary expectations) stays byte-identical.
    # Txn steps insert only into the pre-kill body — the coordinator
    # is exercised against live shards; the kill window's typed
    # unavailability is the abort path, covered by crafted tests.
    trng = random.Random(int(seed) ^ 0x77C27)
    tuniq = 50_000  # disjoint from the wop() uniq range
    if trng.random() < 0.65:
        txn_steps = []
        for _ in range(trng.randrange(1, 3)):
            # adjacent keys straddle the mod-2 congruence: the txn is
            # genuinely cross-shard, so the 2PC path (not the
            # single-group fast path) is what runs
            k0 = trng.randrange(size - 1)
            ops = [[1, k0, tuniq], [1, k0 + 1, tuniq + 1]]
            tuniq += 2
            if trng.random() < 0.5:
                ops.append([1, trng.randrange(size), tuniq])
                tuniq += 1
            # crash=1: the coordinator dies right after its durable
            # decision publish — recovery must re-drive the commit
            txn_steps.append(["stxn", ops,
                              int(trng.random() < 0.4)])
        for st in reversed(txn_steps):
            steps.insert(trng.randrange(0, body_end + 1), st)
    if not killed and trng.random() < 0.5:
        # live split of one congruence class (no-kill runs only: the
        # donor needs a promotable standby), then post-split traffic
        # across the refined topology
        steps.append(["sreshard", trng.randrange(n_shards)])
        for _ in range(trng.randrange(2, 5)):
            steps.append(["sw", [1, trng.randrange(size), tuniq]])
            tuniq += 1
    return CaseSpec(seed, model, "nr", "sharded", 1, 1, steps,
                    n_shards=n_shards)


# ==========================================================================
# interpretation
# ==========================================================================


def _make_dispatch(model: str):
    from node_replication_torch.models import (
        make_hashmap,
        make_queue,
        make_seqreg,
        make_stack,
    )

    maker = {"hashmap": make_hashmap, "stack": make_stack,
             "queue": make_queue, "seqreg": make_seqreg}[model]
    return maker(MODEL_SIZES[model])


def _key_mapper(opcode, args):
    return args[0]


def _host(x) -> np.ndarray:
    """A state leaf as a host array (a tensor on any device, or numpy)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _digest(spec: CaseSpec, events: list) -> str:
    blob = json.dumps([spec.as_dict(), events], sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


class _Run:
    """Mutable interpreter state for one case (one stepping thread)."""

    def __init__(self, spec: CaseSpec, device):
        self.spec = spec
        self.device = device
        self.dispatch = _make_dispatch(spec.model)
        self.oracle = make_oracle(spec.model, MODEL_SIZES[spec.model])
        self.events: list = []
        self.violations: list = []
        self.applied: list = []  # ops in log order (host ground truth)
        self.tokens: dict = {}
        self.tmp: str | None = None
        # flavor plumbing, filled by _build
        self.wr = None
        self.fe = None
        self.mgr = None
        self.wal = None
        self.synced_sizes: dict = {}
        self.feed = None
        self.pipe = None
        self.shipper = None
        self.follower = None
        self.pm = None
        self.oracle_f = None
        self.breaker = None  # per-case client circuit breaker (burst)
        self.fpos = 0
        self.primary_dead = False
        self.promoted = False
        self.shipped_acked = 0
        self.pre_kill_cursor = 0
        # sharded flavor: one primary stack per shard, behind the
        # real router (filled by _build)
        self.shards: list = []  # per-shard plumbing dicts
        self.router = None
        self.smap = None
        self.sh_oracle: list = []  # per-shard oracle
        self.sh_applied: list = []  # per-shard acked ops, in order
        self.sh_dead: list = []
        self.sh_promoted: list = []
        self.sh_pre_cursor: list = []
        self.sh_acked: list = []  # shipped-acked floor at kill time
        # cross-shard txn + reshard plumbing
        self.decisions = None  # DecisionLog shared by the fleet
        self.coord = None  # TxnCoordinator, built on first stxn
        self.sh_txn: list = []  # per-shard TxnParticipant
        self.sh_txn_extra: list = []  # refined-class participants
        self.resharded = False
        self.recipient = None  # the promoted donor follower
        self.reshard_donor = -1

    # ------------------------------------------------------------ plumbing

    def ev(self, i: int, kind: str, **kv) -> None:
        self.events.append([i, kind, kv])

    def vio(self, prop: str, i: int, detail: str) -> None:
        self.violations.append(Violation(prop, i, detail))

    def tail(self) -> int:
        if self.spec.wrapper == "cnr":
            return int(self.wr.ml.tail.sum())
        return int(self.wr.log.tail)

    def token(self, rid: int):
        if rid not in self.tokens:
            self.tokens[rid] = self.wr.register(rid)
        return self.tokens[rid]

    def _build(self):
        from node_replication_torch.core.cnr import MultiLogReplicated
        from node_replication_torch.core.replica import NodeReplicated

        spec = self.spec
        if spec.flavor == "sharded":
            self._build_sharded()
            return
        if spec.wrapper == "cnr":
            self.wr = MultiLogReplicated(
                self.dispatch, _key_mapper, nlogs=spec.nlogs,
                n_replicas=spec.n_replicas, log_entries=LOG_ENTRIES,
                gc_slack=GC_SLACK, device=self.device,
            )
        else:
            self.wr = NodeReplicated(
                self.dispatch, n_replicas=spec.n_replicas,
                log_entries=LOG_ENTRIES, gc_slack=GC_SLACK,
                device=self.device,
            )
        if spec.flavor in ("crash", "repl"):
            from node_replication_torch.durable.wal import WriteAheadLog

            self.tmp = tempfile.mkdtemp(prefix="nr-sim-")
            seg = (CRASH_SEGMENT_BYTES if spec.flavor == "crash"
                   else REPL_SEGMENT_BYTES)
            self.wal = WriteAheadLog(
                os.path.join(self.tmp, "wal"), policy="batch",
                arg_width=self.dispatch.arg_width,
                segment_max_bytes=seg,
            )
            self.wr.attach_wal(self.wal)
        if spec.flavor == "serve":
            from node_replication_torch.serve.frontend import (
                ServeConfig,
                ServeFrontend,
            )

            failover = spec.wrapper == "nr"
            self.fe = ServeFrontend(
                self.wr,
                ServeConfig(batch_linger_s=0.0, queue_depth=64,
                            failover=failover,
                            pipeline_depth=spec.overlap),
            )
            if failover:
                from node_replication_torch.fault.repair import (
                    ReplicaLifecycleManager,
                )

                self.mgr = ReplicaLifecycleManager(self.wr, self.fe)
        if spec.flavor == "wrapper" and spec.wrapper == "nr":
            from node_replication_torch.fault.repair import (
                ReplicaLifecycleManager,
            )

            self.mgr = ReplicaLifecycleManager(self.wr)
        if spec.flavor == "repl":
            from node_replication_torch.repl.feed import DirectoryFeed
            from node_replication_torch.repl.follower import Follower
            from node_replication_torch.repl.promote import (
                PromotionManager,
            )
            from node_replication_torch.repl.shipper import (
                ReplicationShipper,
            )
            from node_replication_torch.repl.transport import (
                PipeTransport,
            )
            from node_replication_torch.serve.frontend import ServeConfig

            self.feed = DirectoryFeed(
                os.path.join(self.tmp, "feed"),
                arg_width=self.dispatch.arg_width,
            )
            self.shipper = ReplicationShipper(
                self.wal, self.feed, auto_start=False,
            )
            # the follower (and the promotion watcher) consume the
            # feed through the deterministic transport twin, so the
            # disconnect/reconnect/partition steps model exactly what
            # a `SocketFeed` client exhibits over a flaky wire
            self.pipe = PipeTransport(self.feed, rewind=4)
            self.follower = Follower(
                self.dispatch, self.pipe,
                directory=os.path.join(self.tmp, "flw"),
                config=ServeConfig(durability="batch",
                                   batch_linger_s=0.0),
                auto_start=False,
                nr_kwargs={"n_replicas": 1,
                           "log_entries": LOG_ENTRIES,
                           "gc_slack": GC_SLACK,
                           "device": self.device},
            )
            self.pm = PromotionManager(
                self.pipe, [self.follower],
                heartbeat_timeout_s=0.5, check_interval_s=0.1,
            )
            self.oracle_f = make_oracle(self.spec.model,
                                        MODEL_SIZES[self.spec.model])

    def _build_sharded(self):
        from node_replication_torch.core.replica import NodeReplicated
        from node_replication_torch.durable.wal import WriteAheadLog
        from node_replication_torch.repl.feed import DirectoryFeed
        from node_replication_torch.repl.follower import Follower
        from node_replication_torch.repl.shipper import (
            ReplicationShipper,
        )
        from node_replication_torch.serve.frontend import (
            ServeConfig,
            ServeFrontend,
        )
        from node_replication_torch.shard.ring import ShardMap
        from node_replication_torch.shard.router import (
            LocalBackend,
            ShardRouter,
        )

        from node_replication_torch.durable.txnlog import DecisionLog
        from node_replication_torch.shard.txn import TxnParticipant

        spec = self.spec
        self.tmp = tempfile.mkdtemp(prefix="nr-sim-")
        self.smap = ShardMap(spec.n_shards)
        self.decisions = DecisionLog(
            os.path.join(self.tmp, "decisions")
        )
        backends: dict = {}
        for s in range(spec.n_shards):
            base = os.path.join(self.tmp, f"s{s}")
            nr = NodeReplicated(
                self.dispatch, n_replicas=1,
                log_entries=LOG_ENTRIES, gc_slack=GC_SLACK,
                device=self.device,
            )
            wal = WriteAheadLog(
                os.path.join(base, "wal"), policy="batch",
                arg_width=self.dispatch.arg_width,
                segment_max_bytes=REPL_SEGMENT_BYTES,
            )
            nr.attach_wal(wal)
            feed = DirectoryFeed(
                os.path.join(base, "feed"),
                arg_width=self.dispatch.arg_width,
            )
            shipper = ReplicationShipper(wal, feed, auto_start=False)
            fe = ServeFrontend(
                nr,
                ServeConfig(batch_linger_s=0.0, queue_depth=64,
                            durability="batch"),
            )
            follower = Follower(
                self.dispatch, feed,
                directory=os.path.join(base, "flw"),
                config=ServeConfig(durability="batch",
                                   batch_linger_s=0.0),
                auto_start=False,
                nr_kwargs={"n_replicas": 1,
                           "log_entries": LOG_ENTRIES,
                           "gc_slack": GC_SLACK,
                           "device": self.device},
            )
            self.shards.append({"nr": nr, "wal": wal, "feed": feed,
                                "shipper": shipper, "fe": fe,
                                "follower": follower})
            txn = TxnParticipant(
                s, fe, self.smap, os.path.join(base, "txn"),
                decisions=self.decisions, wal=wal,
            )
            self.sh_txn.append(txn)
            backends[s] = LocalBackend(s, fe, self.smap,
                                       participant=txn)
            self.sh_oracle.append(
                make_oracle(spec.model, MODEL_SIZES[spec.model])
            )
            self.sh_applied.append([])
            self.sh_dead.append(False)
            self.sh_promoted.append(False)
            self.sh_pre_cursor.append(0)
            self.sh_acked.append(0)
        # sequential shard-ordered fan-out: the sim's determinism knob
        self.router = ShardRouter(self.smap, backends,
                                  concurrent=False)

    def _teardown(self):
        for t in self.sh_txn + self.sh_txn_extra:
            try:
                t.close()
            except Exception:
                pass
        for sh in self.shards:
            try:
                sh["fe"].close(drain=False)
            except Exception:
                pass
            sh["follower"].close()
            try:
                sh["wal"].clear_pin(sh["shipper"].pin_name)
            except Exception:
                pass
        if self.fe is not None:
            self.fe.close()
        if self.mgr is not None:
            self.mgr.wait_idle(30)
        if self.follower is not None:
            self.follower.close()
        if self.shipper is not None and self.wal is not None:
            try:
                self.wal.clear_pin(self.shipper.pin_name)
            except Exception:
                pass
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)

    # ------------------------------------------------------------- helpers

    def _one_shot_plan(self, site: str, action: str):
        from node_replication_torch.fault.inject import (
            FaultPlan,
            FaultSpec,
        )

        return FaultPlan(
            [FaultSpec(site=site, action=action, rid=-1, after=0)],
            seed=self.spec.seed,
        )

    def _record_applied(self, op: list) -> None:
        self.oracle.apply(op)
        self.applied.append(list(op))

    def _advance_oracle_f(self, to: int, i: int) -> None:
        """Fold the follower's oracle up to applied position `to`."""
        if to > len(self.applied):
            self.vio("replication-gap", i,
                     f"follower applied {to} > primary history "
                     f"{len(self.applied)}")
            to = len(self.applied)
        for op in self.applied[self.fpos:to]:
            self.oracle_f.apply(op)
        self.fpos = max(self.fpos, to)

    # ----------------------------------------------------------- op steps

    def _write_target(self):
        """(callable, kind) for the current write path."""
        if self.spec.flavor == "serve" or self.promoted:
            fe = (self.follower.frontend if self.promoted
                  else self.fe)

            def call(op, rid):
                return fe.submit(tuple(op), rid=rid).result()

            return call

        def call(op, rid):
            return self.wr.execute_mut_batch([tuple(op)], rid)[0]

        return call

    def do_write(self, i: int, rid: int, op: list,
                 fault: tuple | None = None) -> None:
        if self.spec.flavor == "repl" and self.primary_dead \
                and not self.promoted:
            self.ev(i, "w-unavailable")
            return
        if self.promoted:
            rid = 0  # the follower fleet serves one replica
        wr = self.follower.nr if self.promoted else self.wr
        tail0 = (int(wr.log.tail)
                 if self.spec.wrapper == "nr" or self.promoted
                 else self.tail())
        call = self._write_target()
        err = None
        try:
            if fault is not None:
                with self._one_shot_plan(*fault).armed():
                    resp = call(op, rid)
            else:
                resp = call(op, rid)
        except Exception as e:  # typed edges + injected faults
            err = e
        if err is not None:
            if self.mgr is not None:
                self.mgr.wait_idle(30)
            tail1 = (int(wr.log.tail)
                     if self.spec.wrapper == "nr" or self.promoted
                     else self.tail())
            applied_now = tail1 > tail0
            from node_replication_torch.serve.errors import ReplicaFailed

            if (isinstance(err, ReplicaFailed)
                    and not err.maybe_executed and applied_now):
                self.vio(
                    "maybe-executed-honesty", i,
                    f"maybe_executed=False but the log advanced "
                    f"{tail0}->{tail1}",
                )
            if applied_now:
                # the op reached the log; only its response was lost.
                # It replays LAZILY (the next combine/sync round), so
                # force the round to completion before the oracle
                # folds it — otherwise a later read legally observes
                # the pre-op state and the differential would flag
                # correct behavior
                wr.sync()
                self._record_applied(op)
            self.ev(i, "w-err", err=type(err).__name__,
                    applied=int(applied_now))
            return
        expect = self.oracle.apply(op)
        self.applied.append(list(op))
        if int(resp) != int(expect):
            self.vio("resp-diff", i,
                     f"op {op} -> {int(resp)}, oracle {int(expect)}")
        self.ev(i, "w", resp=int(resp))

    def do_read(self, i: int, rid: int, op: list,
                fault: tuple | None = None) -> None:
        if self.spec.flavor == "repl" and (self.primary_dead
                                           and not self.promoted):
            self.ev(i, "r-unavailable")
            return
        try:
            if self.promoted:
                val = self.follower.frontend.read(tuple(op), rid=0)
            elif self.fe is not None:
                val = self.fe.read(tuple(op), rid=rid)
            else:
                if fault is not None:
                    with self._one_shot_plan(*fault).armed():
                        val = self.wr.execute(tuple(op),
                                              self.token(rid))
                else:
                    val = self.wr.execute(tuple(op), self.token(rid))
        except Exception as e:
            self.ev(i, "r-err", err=type(e).__name__)
            return
        expect = self.oracle.read(op)
        if int(val) != int(expect):
            self.vio("read-diff", i,
                     f"read {op} on r{rid} -> {int(val)}, "
                     f"oracle {int(expect)}")
        self.ev(i, "r", val=int(val))

    # ------------------------------------------------------ burst steps

    def do_burst(self, i: int, specs: list) -> None:
        """One overload burst (serve flavor, NR): a PAUSED temporary
        frontend (tiny adaptive limit, priorities) admits the whole
        mixed-priority burst on the stepping thread — every shed /
        eviction / circuit decision is deterministic — then starts,
        drains, and closes. The ACTUAL ring slice is read back to
        fold the oracle in true log order; checks `shed-honesty`
        (every rejected op absent from the log), `priority-inversion`
        (queue-measured), and `resp-diff` on the completed futures."""
        if self.spec.flavor != "serve" or self.spec.wrapper != "nr":
            self.ev(i, "burst-skip")
            return
        from node_replication_torch.core.log import ring_slice
        from node_replication_torch.serve.client import CircuitBreaker
        from node_replication_torch.serve.errors import (
            CircuitOpen,
            Overloaded,
        )
        from node_replication_torch.serve.frontend import (
            ServeConfig,
            ServeFrontend,
        )
        from node_replication_torch.serve.overload import OverloadConfig

        if self.breaker is None:
            # SimClock time does not advance on its own, so an opened
            # circuit stays open for the rest of the case — which is
            # exactly the zero-log-effect path the property wants hit
            self.breaker = CircuitBreaker(failure_threshold=3,
                                          cooldown_s=30.0)
        tail0 = int(self.wr.log.tail)
        cfg = ServeConfig(
            queue_depth=6, batch_max_ops=4, batch_linger_s=0.0,
            overload=OverloadConfig(target_delay_s=0.005,
                                    min_limit=2),
        )
        fe = ServeFrontend(self.wr, cfg, rids=[0], auto_start=False)
        aw = int(self.wr.spec.arg_width)

        def key_of(op) -> tuple:
            """Normalize an op to the ring's (opcode, *args[:aw])
            width — the same padding `_check_ring` applies."""
            key = [int(op[0])] + [int(x) for x in op[1:1 + aw]]
            key += [0] * (1 + aw - len(key))
            return tuple(key)

        futs: list = []  # (index, op, future|None, outcome)
        for k, (prio, op) in enumerate(specs):
            op = list(op)
            try:
                self.breaker.before_call()
            except CircuitOpen:
                futs.append((k, op, None, "copen"))
                continue
            try:
                fut = fe.submit(tuple(op), rid=0, priority=int(prio))
            except Overloaded:
                self.breaker.record_failure()
                futs.append((k, op, None, "shed"))
                continue
            self.breaker.record_success()
            futs.append((k, op, fut, "admitted"))
        fe.start()
        fe.drain(timeout=30)
        stats = fe.stats()
        fe.close(drain=True)
        outcomes: list = []
        completed: dict[tuple, tuple] = {}  # op -> (index, resp)
        rejected: list[tuple] = []  # (index, op, kind)
        for k, op, fut, outcome in futs:
            if fut is None:
                outcomes.append([k, outcome])
                rejected.append((k, op, outcome))
                continue
            exc = fut.exception(timeout=30)
            if exc is not None:
                kind = ("evicted"
                        if isinstance(exc, Overloaded) else
                        f"err-{type(exc).__name__}")
                outcomes.append([k, kind])
                rejected.append((k, op, kind))
                continue
            outcomes.append([k, "completed"])
            completed[key_of(op)] = (k, int(fut.result()))
        if stats["priority_inversions"]:
            self.vio("priority-inversion", i,
                     f"{stats['priority_inversions']} CRITICAL "
                     f"shed(s) while lower-priority ops sat queued")
        tail1 = int(self.wr.log.tail)
        if tail1 - tail0 != len(completed):
            self.vio("shed-honesty", i,
                     f"log advanced {tail1 - tail0} but "
                     f"{len(completed)} op(s) completed — a rejected "
                     f"op left a log effect (or an acked one none)")
        ring_ops: list[list] = []
        if tail1 > tail0:
            opcodes, args = ring_slice(self.wr.spec, self.wr.log,
                                       tail0, tail1)
            aw = args.shape[1]
            for k in range(tail1 - tail0):
                ring_ops.append(
                    [int(opcodes[k])] + [int(x) for x in args[k]]
                )
        seen = set()
        for rop in ring_ops:
            key = tuple(rop)  # already (opcode, *args[:aw]); unique
            expect = self.oracle.apply(key)
            self.applied.append(list(key))
            hit = completed.pop(key, None)
            if hit is None or key in seen:
                self.vio("shed-honesty", i,
                         f"log holds {list(key)} which no completed "
                         f"burst op acked (shed/evicted/circuit-open "
                         f"op with a log effect, or a duplicate)")
                continue
            seen.add(key)
            if int(hit[1]) != int(expect):
                self.vio("resp-diff", i,
                         f"burst op {list(key)} -> {hit[1]}, oracle "
                         f"{int(expect)}")
        for key, (k, resp) in completed.items():
            self.vio("shed-honesty", i,
                     f"burst op {list(key)} acked {resp} but the log "
                     f"never recorded it")
        for k, op, kind in rejected:
            if key_of(op) in seen:
                self.vio("shed-honesty", i,
                         f"{kind} op {op} found in the log")
        self.ev(i, "burst", outcomes=outcomes,
                shed=int(stats["shed"]),
                evicted=int(stats["evicted"]),
                applied=len(ring_ops),
                breaker=self.breaker.state)

    # -------------------------------------------------------- fault steps

    def do_corrupt(self, i: int, rid: int) -> None:
        from node_replication_torch.fault.inject import corrupt_states

        if self.spec.wrapper != "nr":
            self.ev(i, "corrupt-skip")
            return
        self.wr.states = corrupt_states(self.wr.states, rid,
                                        seed=self.spec.seed)
        self._corrupted = rid
        self.ev(i, "corrupt", rid=rid)

    def do_probe(self, i: int) -> None:
        if self.mgr is None or self.spec.wrapper != "nr":
            self.ev(i, "probe-skip")
            return
        named = self.mgr.probe()
        rid = getattr(self, "_corrupted", None)
        if rid is not None:
            if rid not in named:
                self.vio("divergence-detect", i,
                         f"corrupted r{rid} not named by the vote "
                         f"(named {named})")
            self._corrupted = None
        self.ev(i, "probe", named=[int(x) for x in named])

    # ------------------------------------------------------ durable steps

    def do_wal_sync(self, i: int) -> None:
        if self.wal is None or self.primary_dead:
            self.ev(i, "wal-sync-skip")
            return
        pos = self.wr.wal_sync()
        if self.wal._segments:
            path = self.wal._segments[-1][1]
            self.synced_sizes[path] = os.path.getsize(path)
        self.ev(i, "wal-sync", durable=int(pos))

    def do_snapshot(self, i: int) -> None:
        from node_replication_torch.durable.recovery import (
            save_durable_snapshot,
        )

        if self.wal is None or self.primary_dead:
            self.ev(i, "snapshot-skip")
            return
        save_durable_snapshot(self.wr, self.tmp)
        self.ev(i, "snapshot", pos=len(self.applied))

    def do_crash(self, i: int, lose: int, extra: int) -> None:
        """Simulated kill -9 + restart: what the OS page cache held
        survives (flush), anything after the last fsync optionally
        does not (truncate to the recorded fsynced size, plus an
        `extra`-byte torn remainder for the recovery scan to chop)."""
        from node_replication_torch.durable.recovery import recover_fleet

        if self.wal is None:
            self.ev(i, "crash-skip")
            return
        durable = self.wal.durable_tail
        with self.wal._lock:
            if self.wal._fh is not None:
                self.wal._fh.flush()
        if lose and self.wal._segments:
            path = self.wal._segments[-1][1]
            cur = os.path.getsize(path)
            base = self.synced_sizes.get(path, 0)
            keep = min(cur, base + (int(extra) % 64))
            os.truncate(path, keep)
        with self.wal._lock:
            if self.wal._fh is not None:
                self.wal._fh.close()
                self.wal._fh = None
        # the old wrapper is the corpse; recover from disk
        nr2, report = recover_fleet(
            self.tmp, self.dispatch, policy="batch", attach=True,
            nr_kwargs={"n_replicas": self.spec.n_replicas,
                       "log_entries": LOG_ENTRIES,
                       "gc_slack": GC_SLACK,
                       "device": self.device},
        )
        T = int(report.tail)
        if T < durable:
            self.vio("durable-ack-survival", i,
                     f"recovered tail {T} < fsync-acked {durable}")
        if T > len(self.applied):
            self.vio("log-content", i,
                     f"recovered tail {T} > ops ever applied "
                     f"{len(self.applied)}")
            T = len(self.applied)
        self.applied = self.applied[:T]
        self.oracle = make_oracle(self.spec.model,
                                  MODEL_SIZES[self.spec.model])
        for op in self.applied:
            self.oracle.apply(op)
        self.wr = nr2
        self.wal = nr2.wal
        self.tokens = {}
        self.synced_sizes = {}
        if self.wal._segments:
            path = self.wal._segments[-1][1]
            self.synced_sizes[path] = os.path.getsize(path)
        state = nr2.verify(lambda s: s)
        self._check_arrays(state, self.oracle, i)
        self.ev(i, "crash", recovered=T, durable=int(durable),
                lost=int(lose))

    # --------------------------------------------------------- repl steps

    def do_ship(self, i: int, zombie: bool = False) -> None:
        from node_replication_torch.repl.feed import EpochFencedError

        if self.shipper is None:
            self.ev(i, "ship-skip")
            return
        if not zombie and (self.primary_dead or self.promoted):
            self.ev(i, "ship-skip")
            return
        cur0 = self.shipper.cursor
        try:
            self.shipper._ship_once()
        except EpochFencedError:
            self.ev(i, "ship-fenced")
            return
        except Exception as e:
            self.vio("replication-gap", i,
                     f"ship failed: {type(e).__name__}: {e}")
            return
        if zombie and self.shipper.cursor > self.pre_kill_cursor:
            self.vio("zombie-unfenced", i,
                     f"superseded shipper published "
                     f"{self.pre_kill_cursor}->{self.shipper.cursor} "
                     f"past the promotion fence")
        self.ev(i, "ship", shipped=int(self.shipper.cursor - cur0),
                cursor=int(self.shipper.cursor))

    def do_apply(self, i: int) -> None:
        if self.follower is None or self.promoted:
            self.ev(i, "apply-skip")
            return
        try:
            n = self.follower._apply_once()
        except Exception as e:
            self.vio("replication-gap", i,
                     f"follower apply failed: "
                     f"{type(e).__name__}: {e}")
            return
        ap = self.follower.applied_pos()
        self._advance_oracle_f(ap, i)
        self.ev(i, "apply", records=int(n), applied=int(ap))

    def do_fread(self, i: int, op: list, max_lag: int) -> None:
        from node_replication_torch.serve.errors import StaleRead

        if self.follower is None:
            self.ev(i, "fread-skip")
            return
        try:
            val, applied, bound = self.follower.read_result(
                tuple(op), rid=0, max_lag_pos=int(max_lag),
                wait_s=0.0,
            )
        except StaleRead as e:
            self.ev(i, "fread-stale", applied=int(e.applied_pos),
                    bound=int(e.min_pos))
            return
        except Exception as e:
            self.ev(i, "fread-err", err=type(e).__name__)
            return
        if applied < bound:
            self.vio("staleness-bound", i,
                     f"read served at {applied} below bound {bound}")
        self._advance_oracle_f(self.follower.applied_pos(), i)
        expect = self.oracle_f.read(op)
        if int(val) != int(expect):
            self.vio("fread-diff", i,
                     f"follower read {op} -> {int(val)}, oracle "
                     f"{int(expect)} at {self.follower.applied_pos()}")
        self.ev(i, "fread", val=int(val), applied=int(applied),
                bound=int(bound))

    def do_watch(self, i: int, ticks: int, clock: SimClock) -> None:
        if self.pm is None:
            self.ev(i, "watch-skip")
            return
        clock.advance(0.1 * int(ticks))
        state = self.pm.check()
        self.ev(i, "watch", state=state)

    # ---------------------------------------------------- transport steps

    def do_pipe(self, i: int, action: str, rewind: int = 0) -> None:
        """`disconnect` / `reconnect` on the transport twin: while
        down, polls go quiet and the cached heartbeat freezes; a
        rewound reconnect re-delivers applied records (the duplicate
        path the follower must absorb idempotently)."""
        if self.pipe is None:
            self.ev(i, f"{action}-skip")
            return
        if action == "disconnect":
            self.pipe.disconnect()
            self.ev(i, "disconnect")
        else:
            self.pipe.reconnect(int(rewind))
            self.ev(i, "reconnect", rewind=int(rewind))

    def do_partition(self, i: int, ticks: int, rewind: int,
                     clock: SimClock) -> None:
        """A bounded partition: disconnect, let virtual time pass
        under the promotion watcher (the frozen heartbeat reads as
        silence — strikes accrue exactly as over a dead socket), then
        heal with a rewound reconnect."""
        if self.pipe is None:
            self.ev(i, "partition-skip")
            return
        self.pipe.disconnect()
        state = None
        for _ in range(int(ticks)):
            clock.advance(0.1)
            if self.pm is not None:
                state = self.pm.check()
        self.pipe.reconnect(int(rewind))
        self.ev(i, "partition", ticks=int(ticks), state=state)

    def do_kill(self, i: int) -> None:
        if self.shipper is None or self.primary_dead:
            self.ev(i, "kill-skip")
            return
        self.primary_dead = True
        self.pre_kill_cursor = int(self.shipper.cursor)
        self.shipped_acked = min(int(self.wal.durable_tail),
                                 self.pre_kill_cursor)
        self.ev(i, "kill", durable=int(self.wal.durable_tail),
                shipped=self.pre_kill_cursor,
                acked=self.shipped_acked)

    def do_promote(self, i: int) -> None:
        from node_replication_torch.fault.health import QUARANTINED

        if self.follower is None or self.promoted:
            self.ev(i, "promote-skip")
            return
        try:
            if (self.pm is not None
                    and self.pm.health.state(self.pm.health_rid)
                    == QUARANTINED):
                rep = self.pm.promote_now(detect_s=0.0)
                applied = int(rep.applied_pos)
                epoch = int(rep.new_epoch)
                detected = 1
            else:
                rep = self.follower.promote()
                applied = int(rep["applied"])
                epoch = int(rep["epoch"])
                detected = 0
        except Exception as e:
            self.vio("replication-gap", i,
                     f"promotion failed: {type(e).__name__}: {e}")
            return
        self.promoted = True
        if applied < self.shipped_acked:
            self.vio("durable-ack-survival", i,
                     f"promoted follower applied {applied} < "
                     f"shipped-acked {self.shipped_acked}")
        self._advance_oracle_f(applied, i)
        # the follower's history is now the authority: the dead
        # primary's unshipped suffix is legally gone
        self.applied = self.applied[:applied]
        self.fpos = min(self.fpos, applied)
        self.oracle = self.oracle_f
        self.ev(i, "promote", applied=applied, epoch=epoch,
                detected=detected)

    # ------------------------------------------------------ sharded steps

    def _shard_of(self, op: list) -> int:
        return self.smap.shard_of_op(tuple(op))

    def _class_fe(self, c: int):
        """The serving frontend for congruence class `c` — a base
        shard's primary (or its promoted follower), an alias class
        riding its base shard after a split, or the split recipient."""
        n0 = len(self.shards)
        if c >= n0:
            d = c - n0
            if d == self.reshard_donor:
                return self.recipient.frontend
            sh = self.shards[d]
            return (sh["follower"].frontend if self.sh_promoted[d]
                    else sh["fe"])
        sh = self.shards[c]
        return (sh["follower"].frontend if self.sh_promoted[c]
                else sh["fe"])

    def _participants(self) -> list:
        return [t for t in self.sh_txn + self.sh_txn_extra
                if t is not None]

    def _fold_shard_ack(self, i: int, s: int, op: list,
                        resp) -> None:
        """Fold one router-acked op into shard `s`'s oracle. Keys are
        disjoint across shards (the `key % N` congruence), so the
        per-shard fold in submission order IS the global fold."""
        expect = self.sh_oracle[s].apply(op)
        self.sh_applied[s].append(list(op))
        if int(resp) != int(expect):
            self.vio("resp-diff", i,
                     f"shard {s} op {op} -> {int(resp)}, oracle "
                     f"{int(expect)}")

    def do_sw(self, i: int, op: list) -> None:
        s = self._shard_of(op)
        try:
            resp = self.router.call(tuple(op))
        except Exception as e:  # typed routing/availability edges
            self.ev(i, "sw-err", shard=s, err=type(e).__name__)
            return
        self._fold_shard_ack(i, s, op, resp)
        self.ev(i, "sw", shard=s, resp=int(resp))

    def do_sbatch(self, i: int, ops: list) -> None:
        """One multi-shard batch through the router: per-op outcomes
        (the CNR non-atomic cross-shard contract) — a dead shard's
        slots error while the survivor's slots commit and must still
        match the oracle."""
        out = self.router.execute_batch(
            [tuple(op) for op in ops], return_exceptions=True,
        )
        results: list = []
        for op, r in zip(ops, out):
            s = self._shard_of(op)
            if isinstance(r, BaseException):
                results.append([s, "err", type(r).__name__])
                continue
            self._fold_shard_ack(i, s, op, r)
            results.append([s, "ok", int(r)])
        self.ev(i, "sbatch", results=results)

    def do_sread(self, i: int, op: list) -> None:
        s = self._shard_of(op)
        fe = self._class_fe(s)
        try:
            val = fe.read(tuple(op), rid=0)
        except Exception as e:
            self.ev(i, "sread-err", shard=s, err=type(e).__name__)
            return
        expect = self.sh_oracle[s].read(op)
        if int(val) != int(expect):
            self.vio("read-diff", i,
                     f"shard {s} read {op} -> {int(val)}, oracle "
                     f"{int(expect)}")
        self.ev(i, "sread", shard=s, val=int(val))

    def do_swal(self, i: int, s: int) -> None:
        if self.sh_dead[s]:
            self.ev(i, "swal-skip", shard=s)
            return
        pos = self.shards[s]["nr"].wal_sync()
        self.ev(i, "swal", shard=s, durable=int(pos))

    def do_sship(self, i: int, s: int, zombie: bool = False) -> None:
        from node_replication_torch.repl.feed import EpochFencedError

        sh = self.shards[s]
        if not zombie and (self.sh_dead[s] or self.sh_promoted[s]):
            self.ev(i, "sship-skip", shard=s)
            return
        cur0 = int(sh["shipper"].cursor)
        try:
            sh["shipper"]._ship_once()
        except EpochFencedError:
            self.ev(i, "sship-fenced", shard=s)
            return
        except Exception as e:
            self.vio("replication-gap", i,
                     f"shard {s} ship failed: "
                     f"{type(e).__name__}: {e}")
            return
        cur = int(sh["shipper"].cursor)
        if zombie and cur > self.sh_pre_cursor[s]:
            self.vio("zombie-unfenced", i,
                     f"shard {s}'s superseded shipper published "
                     f"{self.sh_pre_cursor[s]}->{cur} past the "
                     f"promotion fence")
        self.ev(i, "sship", shard=s, shipped=cur - cur0, cursor=cur)

    def do_sapply(self, i: int, s: int) -> None:
        sh = self.shards[s]
        if self.sh_promoted[s]:
            self.ev(i, "sapply-skip", shard=s)
            return
        try:
            n = sh["follower"]._apply_once()
        except Exception as e:
            self.vio("replication-gap", i,
                     f"shard {s} follower apply failed: "
                     f"{type(e).__name__}: {e}")
            return
        ap = int(sh["follower"].applied_pos())
        if ap > len(self.sh_applied[s]):
            self.vio("replication-gap", i,
                     f"shard {s} follower applied {ap} > acked "
                     f"history {len(self.sh_applied[s])}")
        self.ev(i, "sapply", shard=s, records=int(n), applied=ap)

    def do_skill(self, i: int, s: int) -> None:
        sh = self.shards[s]
        if self.sh_dead[s]:
            self.ev(i, "skill-skip", shard=s)
            return
        sh["fe"].close(drain=True)
        self.sh_dead[s] = True
        self.sh_pre_cursor[s] = int(sh["shipper"].cursor)
        self.sh_acked[s] = min(int(sh["wal"].durable_tail),
                               self.sh_pre_cursor[s])
        self.ev(i, "skill", shard=s,
                durable=int(sh["wal"].durable_tail),
                shipped=self.sh_pre_cursor[s],
                acked=self.sh_acked[s])

    def do_spromote(self, i: int, s: int) -> None:
        from node_replication_torch.shard.router import LocalBackend

        sh = self.shards[s]
        if self.sh_promoted[s]:
            self.ev(i, "spromote-skip", shard=s)
            return
        try:
            rep = sh["follower"].promote()
            applied = int(rep["applied"])
            epoch = int(rep["epoch"])
        except Exception as e:
            self.vio("replication-gap", i,
                     f"shard {s} promotion failed: "
                     f"{type(e).__name__}: {e}")
            return
        self.sh_promoted[s] = True
        self.sh_dead[s] = True
        if applied < self.sh_acked[s]:
            self.vio("durable-ack-survival", i,
                     f"shard {s} promoted at {applied} < "
                     f"shipped-acked {self.sh_acked[s]}")
        if applied > len(self.sh_applied[s]):
            self.vio("replication-gap", i,
                     f"shard {s} promoted at {applied} > acked "
                     f"history {len(self.sh_applied[s])}")
            applied = len(self.sh_applied[s])
        # the follower's history is now the authority for this
        # shard's slice; the dead primary's unshipped suffix is
        # legally gone — truncate and refold the per-shard oracle
        self.sh_applied[s] = self.sh_applied[s][:applied]
        self.sh_oracle[s] = make_oracle(
            self.spec.model, MODEL_SIZES[self.spec.model]
        )
        for op in self.sh_applied[s]:
            self.sh_oracle[s].apply(op)
        # re-home the router: re-publish the bumped map and point the
        # victim's slot at the promoted follower's frontend — the
        # other shards' backends never change (isolation)
        new_map = self.smap.with_address(s, None)
        self.router.repoint(
            s, LocalBackend(s, sh["follower"].frontend, new_map),
            new_map=new_map,
        )
        self.smap = new_map
        for t in self._participants():
            t.set_map(new_map)
        if s < len(self.sh_txn):
            self.sh_txn[s].set_frontend(sh["follower"].frontend,
                                        wal=sh["follower"].nr.wal)
        self.ev(i, "spromote", shard=s, applied=applied, epoch=epoch,
                map_version=int(new_map.version))

    # ------------------------------------------------------- txn steps

    def do_stxn(self, i: int, ops: list, crash: int) -> None:
        """One atomic cross-shard transaction through the REAL
        `TxnCoordinator` (presumed-abort 2PC over the sim's backends,
        intents/decisions on the case's tmp dir). `crash=1` kills the
        coordinator at the `txn-decide` fault site — one instruction
        AFTER its durable decision publish — then simulates the
        restart: epoch bump + every participant resolving in-doubt
        state from the decision log. Property ``txn-atomicity``: a
        decided txn re-drives to commit on every shard; an aborted
        one leaves ZERO per-key effect."""
        if self.router is None:
            self.ev(i, "stxn-skip")
            return
        if self.coord is None:
            from node_replication_torch.shard.txn import TxnCoordinator

            self.coord = TxnCoordinator(
                self.router, os.path.join(self.tmp, "decisions"),
                name="sim",
            )
        tops = [tuple(op) for op in ops]
        shards = sorted({self._shard_of(list(op)) for op in tops})
        plan = (self._one_shot_plan("txn-decide", "raise")
                if crash else None)
        err = None
        results = None
        try:
            if plan is not None:
                with plan.armed():
                    results = self.coord.execute_txn(tops)
            else:
                results = self.coord.execute_txn(tops)
        except Exception as e:
            err = e
        if err is not None and plan is not None and plan.fired:
            # the coordinator REACHED its decision point (the fault
            # site sits one line past the durable publish), so the
            # commit is decided: restart recovery must re-drive it —
            # a resolve to anything else means the decision record
            # was lost (the ack-before-decision bug class)
            epoch = self.decisions.bump_epoch()
            outcomes: dict = {}
            for t in self._participants():
                outcomes.update(t.resolve_in_doubt(
                    decisions=self.decisions, epoch=epoch))
            self.coord = None  # the old generation died with it
            if set(outcomes.values()) != {"commit"}:
                self.vio("txn-atomicity", i,
                         f"decided txn resolved {outcomes} after "
                         f"coordinator restart — the durable commit "
                         f"decision did not survive")
                self.ev(i, "stxn-lost", shards=shards)
                return
            for op in tops:
                s = self._shard_of(list(op))
                self.sh_oracle[s].apply(list(op))
                self.sh_applied[s].append(list(op))
            self.ev(i, "stxn-recovered", shards=shards)
            return
        if err is not None:
            # aborted (conflict / unavailability / in-doubt before
            # the decision): atomicity demands ZERO visible effect —
            # read every touched key back through its serving path
            for op in tops:
                s = self._shard_of(list(op))
                try:
                    val = self._class_fe(s).read(
                        (1, int(op[1]), 0), rid=0)
                except Exception:
                    continue  # dead shard: nothing readable to leak
                expect = self.sh_oracle[s].read([1, int(op[1]), 0])
                if int(val) != int(expect):
                    self.vio("txn-atomicity", i,
                             f"aborted txn left key {int(op[1])} = "
                             f"{int(val)} (expected {int(expect)})")
            self.ev(i, "stxn-abort", err=type(err).__name__,
                    shards=shards)
            return
        for op, r in zip(tops, results):
            s = self._shard_of(list(op))
            expect = self.sh_oracle[s].apply(list(op))
            self.sh_applied[s].append(list(op))
            if int(r) != int(expect):
                self.vio("txn-atomicity", i,
                         f"txn op {list(op)} -> {int(r)}, oracle "
                         f"{int(expect)}")
        self.ev(i, "stxn", shards=shards,
                resps=[int(r) for r in results])

    def do_sreshard(self, i: int, donor: int) -> None:
        """Live split of class `donor` (mod N) into `{donor,
        donor+N}` (mod 2N), mirroring `shard/reshard.py`: catch the
        standby up, stage backends (+ participants) for every refined
        class, adopt the refined map, promote the follower into the
        moved class. Per-class bookkeeping refolds under the new
        congruence; the end-of-case check for resharded runs is
        ``reshard-exactness`` (global per-key read-back)."""
        from node_replication_torch.shard.router import LocalBackend
        from node_replication_torch.shard.txn import TxnParticipant

        donor = int(donor)
        if (self.resharded or donor >= len(self.shards)
                or self.sh_dead[donor] or self.sh_promoted[donor]):
            self.ev(i, "sreshard-skip", donor=donor)
            return
        sh = self.shards[donor]
        # catch-up: cooperative stepping stands in for the background
        # ship/apply lanes (bounded — the history is finite)
        target = len(self.sh_applied[donor])
        for _ in range(200):
            if int(sh["follower"].applied_pos()) >= target:
                break
            sh["nr"].wal_sync()
            sh["shipper"]._ship_once()
            sh["follower"]._apply_once()
        if int(sh["follower"].applied_pos()) < target:
            self.vio("replication-gap", i,
                     f"shard {donor} standby stuck at "
                     f"{sh['follower'].applied_pos()} < {target}")
            return
        n0 = len(self.shards)
        moved = donor + n0
        new_map = self.smap.refine()
        for d in range(n0):
            if d == donor:
                continue
            q = self.shards[d]
            t = TxnParticipant(
                d + n0, q["fe"], new_map,
                os.path.join(self.tmp, f"r{d + n0}", "txn"),
                decisions=self.decisions, wal=q["wal"],
            )
            self.sh_txn_extra.append(t)
            self.router.attach_backend(
                d + n0,
                LocalBackend(d + n0, q["fe"], new_map,
                             participant=t),
            )
        rt = TxnParticipant(
            moved, sh["follower"].frontend, new_map,
            os.path.join(self.tmp, f"r{moved}", "txn"),
            decisions=self.decisions, wal=sh["follower"].nr.wal,
        )
        self.sh_txn_extra.append(rt)
        self.router.attach_backend(
            moved,
            LocalBackend(moved, sh["follower"].frontend, new_map,
                         participant=rt),
        )
        self.router.adopt(new_map, reason=f"sim-split-s{donor}")
        try:
            rep = sh["follower"].promote()
        except Exception as e:
            self.vio("replication-gap", i,
                     f"split promotion failed: "
                     f"{type(e).__name__}: {e}")
            return
        applied = int(rep["applied"])
        if applied < target:
            self.vio("reshard-exactness", i,
                     f"recipient promoted at {applied} < acked "
                     f"history {target}")
        # refold the per-class bookkeeping under the refined
        # congruence: per-shard order is preserved and classes are
        # disjoint, so the refined folds are exact
        C = 2 * n0
        old_applied = self.sh_applied
        self.sh_applied = [[] for _ in range(C)]
        for s in range(n0):
            for op in old_applied[s]:
                c = new_map.shard_of_op(tuple(op))
                self.sh_applied[c].append(op)
        self.sh_oracle = [
            make_oracle(self.spec.model, MODEL_SIZES[self.spec.model])
            for _ in range(C)
        ]
        for c in range(C):
            for op in self.sh_applied[c]:
                self.sh_oracle[c].apply(op)
        self.sh_dead += [False] * n0
        self.sh_promoted += [False] * n0
        self.sh_pre_cursor += [0] * n0
        self.sh_acked += [0] * n0
        self.smap = new_map
        for t in self._participants():
            t.set_map(new_map)
        self.resharded = True
        self.recipient = sh["follower"]
        self.reshard_donor = donor
        self.ev(i, "sreshard", donor=donor, moved=moved,
                map_version=int(new_map.version), applied=applied)

    # ---------------------------------------------------------- end state

    def _check_arrays(self, state, oracle, i: int,
                      prop: str = "state-diff") -> None:
        from node_replication_torch.utils.tree import tree_leaves

        expect = oracle.arrays()
        leaves = {}
        if isinstance(state, dict):
            leaves = state
        else:  # tree fallback
            leaves = {str(k): v for k, v in
                      enumerate(tree_leaves(state))}
        for name, arr in expect.items():
            if name not in leaves:
                self.vio(prop, i, f"state leaf {name!r} missing")
                continue
            got = _host(leaves[name])
            if got.shape != arr.shape or not np.array_equal(
                    got, np.asarray(arr, got.dtype)):
                self.vio(
                    prop, i,
                    f"state leaf {name!r} diverges from the oracle "
                    f"(got {got.tolist()!r:.120s} want "
                    f"{np.asarray(arr).tolist()!r:.120s})",
                )

    def _check_ring(self, nr, expect_ops: list, i: int) -> None:
        from node_replication_torch.core.log import ring_slice

        tail = int(nr.log.tail)
        if tail != len(expect_ops):
            self.vio("log-content", i,
                     f"log tail {tail} != acked op count "
                     f"{len(expect_ops)}")
            return
        if tail == 0:
            return
        opcodes, args = ring_slice(nr.spec, nr.log, 0, tail)
        aw = args.shape[1]
        for k, op in enumerate(expect_ops):
            want = [int(op[0])] + [int(x) for x in op[1:1 + aw]]
            want += [0] * (1 + aw - len(want))
            got = [int(opcodes[k])] + [int(x) for x in args[k]]
            if got != want:
                self.vio("log-content", i,
                         f"log[{k}] = {got} != acked {want}")
                return

    def _check_shard_slice(self, nr, s: int, i: int) -> None:
        """Every key in shard `s`'s ring must be ≡ s (mod N) — an op
        leaked into the wrong shard's keyspace slice is the
        fleet-level routing invariant breaking, named directly."""
        from node_replication_torch.core.log import ring_slice

        tail = int(nr.log.tail)
        if tail == 0:
            return
        _opcodes, args = ring_slice(nr.spec, nr.log, 0, tail)
        for k in range(tail):
            key = int(args[k][0])
            if key % self.spec.n_shards != s:
                self.vio("shard-isolation", i,
                         f"shard {s} log[{k}] holds key {key} "
                         f"(owner shard "
                         f"{key % self.spec.n_shards})")
                return

    def _finalize_sharded(self) -> None:
        if self.resharded:
            # the refined classes interleave the donor's pre-split
            # records across two histories, so the per-shard ring and
            # array checks no longer apply — the reshard contract is
            # GLOBAL read-back exactness: every key serves the fold
            # of exactly its class's acked ops (zero lost, zero
            # duplicated, zero re-homed into the wrong slice)
            size = MODEL_SIZES[self.spec.model]
            for k in range(size):
                c = self.smap.shard_of(k)
                try:
                    val = self._class_fe(c).read((1, k, 0), rid=0)
                except Exception as e:
                    self.vio("reshard-exactness", -1,
                             f"key {k} (class {c}) unreadable after "
                             f"split: {type(e).__name__}")
                    continue
                expect = self.sh_oracle[c].read([1, k, 0])
                if int(val) != int(expect):
                    self.vio("reshard-exactness", -1,
                             f"key {k} (class {c}) -> {int(val)}, "
                             f"fold of acked ops {int(expect)}")
            return
        for s in range(self.spec.n_shards):
            sh = self.shards[s]
            if self.sh_promoted[s]:
                nr = sh["follower"].nr
                nr.sync()
                self._check_shard_slice(nr, s, -1)
                self._check_arrays(nr.verify(lambda st: st),
                                   self.sh_oracle[s], -1,
                                   prop="shard-isolation")
                self._check_ring(nr, self.sh_applied[s], -1)
                continue
            if not self.sh_dead[s]:
                sh["fe"].close()
            nr = sh["nr"]
            nr.sync()
            self._check_shard_slice(nr, s, -1)
            self._check_arrays(nr.verify(lambda st: st),
                               self.sh_oracle[s], -1,
                               prop="shard-isolation")
            self._check_ring(nr, self.sh_applied[s], -1)
            # the follower's state must be a PREFIX fold of exactly
            # this shard's acked ops (no lost/dup/foreign records)
            ap = int(sh["follower"].applied_pos())
            if ap > len(self.sh_applied[s]):
                self.vio("replication-gap", -1,
                         f"shard {s} follower applied {ap} > acked "
                         f"history {len(self.sh_applied[s])}")
                continue
            f_oracle = make_oracle(self.spec.model,
                                   MODEL_SIZES[self.spec.model])
            for op in self.sh_applied[s][:ap]:
                f_oracle.apply(op)
            fnr = sh["follower"].nr
            fnr.sync()
            self._check_shard_slice(fnr, s, -1)
            self._check_arrays(fnr.verify(lambda st: st),
                               f_oracle, -1, prop="shard-isolation")
            self._check_ring(fnr, self.sh_applied[s][:ap], -1)

    def finalize(self) -> None:
        spec = self.spec
        if spec.flavor == "sharded":
            self._finalize_sharded()
            return
        if spec.flavor == "repl":
            if not self.promoted and not self.primary_dead:
                # drain: finish shipping/applying what is already
                # durable so the follower checks run at a fixed point
                # (over a live pipe — a shrunk case may have stripped
                # the generator's paired reconnect)
                if self.pipe is not None:
                    self.pipe.reconnect(0)
                for _ in range(4):
                    self.do_wal_sync(-1)
                    self.do_ship(-1)
                    self.do_apply(-1)
            if self.promoted:
                self.follower.nr.sync()
                self._check_arrays(
                    self.follower.nr.verify(lambda s: s),
                    self.oracle, -1)
                self._check_ring(self.follower.nr, self.applied, -1)
            else:
                self.wr.sync()
                if not self.wr.replicas_equal():
                    self.vio("bit-identity", -1,
                             "replicas disagree after sync")
                self._check_arrays(self.wr.verify(lambda s: s),
                                   self.oracle, -1)
                self._check_ring(self.wr, self.applied, -1)
                ap = self.follower.applied_pos()
                self._advance_oracle_f(ap, -1)
                self.follower.nr.sync()
                self._check_arrays(
                    self.follower.nr.verify(lambda s: s),
                    self.oracle_f, -1)
                self._check_ring(self.follower.nr,
                                 self.applied[:ap], -1)
            return
        if self.fe is not None:
            self.fe.close()
            self.fe = None
        self.wr.sync()
        if not self.wr.replicas_equal():
            self.vio("bit-identity", -1,
                     "replicas disagree after sync")
        self._check_arrays(self.wr.verify(lambda s: s), self.oracle,
                           -1)
        if spec.wrapper == "nr":
            self._check_ring(self.wr, self.applied, -1)


def run_case(spec: CaseSpec, device=None) -> CaseResult:
    """Interpret one spec deterministically on `device` (None: the
    card, raising without one); returns the result with the violation
    list, the event log, and the run digest (same spec => same digest,
    the byte-identical-replay contract, on every device)."""
    run = _Run(spec, resolve_device(device))
    clock = SimClock()
    with installed(clock):
        run._build()
        try:
            for i, step in enumerate(spec.steps):
                kind = step[0]
                if kind == "w":
                    run.do_write(i, int(step[1]), list(step[2]))
                elif kind == "wf":
                    run.do_write(i, int(step[1]), list(step[4]),
                                 fault=(step[2], step[3]))
                elif kind == "r":
                    run.do_read(i, int(step[1]), list(step[2]))
                elif kind == "rf":
                    run.do_read(i, int(step[1]), list(step[2]),
                                fault=("read-sync", "raise"))
                elif kind == "burst":
                    run.do_burst(i, list(step[1]))
                elif kind == "corrupt":
                    run.do_corrupt(i, int(step[1]))
                elif kind == "probe":
                    run.do_probe(i)
                elif kind == "sync":
                    if run.wr is not None and not run.primary_dead:
                        run.wr.sync()
                    run.ev(i, "sync")
                elif kind == "wal-sync":
                    run.do_wal_sync(i)
                elif kind == "snapshot":
                    run.do_snapshot(i)
                elif kind == "crash":
                    run.do_crash(i, int(step[1]), int(step[2]))
                elif kind == "ship":
                    run.do_ship(i)
                elif kind == "zombie-ship":
                    run.do_ship(i, zombie=True)
                elif kind == "apply":
                    run.do_apply(i)
                elif kind == "fread":
                    run.do_fread(i, list(step[1]), int(step[2]))
                elif kind == "watch":
                    run.do_watch(i, int(step[1]), clock)
                elif kind == "disconnect":
                    run.do_pipe(i, "disconnect")
                elif kind == "reconnect":
                    run.do_pipe(i, "reconnect", int(step[1]))
                elif kind == "partition":
                    run.do_partition(i, int(step[1]), int(step[2]),
                                     clock)
                elif kind == "kill":
                    run.do_kill(i)
                elif kind == "promote":
                    run.do_promote(i)
                elif kind == "sw":
                    run.do_sw(i, list(step[1]))
                elif kind == "sbatch":
                    run.do_sbatch(i, [list(o) for o in step[1]])
                elif kind == "sread":
                    run.do_sread(i, list(step[1]))
                elif kind == "swal":
                    run.do_swal(i, int(step[1]))
                elif kind == "sship":
                    run.do_sship(i, int(step[1]))
                elif kind == "sapply":
                    run.do_sapply(i, int(step[1]))
                elif kind == "skill":
                    run.do_skill(i, int(step[1]))
                elif kind == "spromote":
                    run.do_spromote(i, int(step[1]))
                elif kind == "szombie":
                    run.do_sship(i, int(step[1]), zombie=True)
                elif kind == "stxn":
                    run.do_stxn(i, [list(o) for o in step[1]],
                                int(step[2]))
                elif kind == "sreshard":
                    run.do_sreshard(i, int(step[1]))
                else:
                    raise ValueError(f"unknown step kind {kind!r}")
            run.finalize()
        finally:
            run._teardown()
    return CaseResult(
        spec=spec,
        violations=run.violations,
        events=run.events,
        digest=_digest(spec, run.events),
    )
