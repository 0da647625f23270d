"""Host-path sampling profiler: per-role folded stacks from thread names.

The port's copy of `node_replication_tpu/obs/profile.py`, with the same
roles, stage vocabulary and snapshot document. A `SamplingProfiler` is
a stdlib-only `sys._current_frames()` sampler thread at a configurable
rate that aggregates folded call stacks **per thread role**, where
roles come from the repo's thread names (`serve-worker-r<rid>`,
`serve-asm-r<rid>`, `repl-shipper`, `fault-medic-r<rid>`, ...):

    prof = SamplingProfiler(hz=97)
    prof.start()
    ...serve traffic...
    prof.stop()
    print(prof.folded())          # flamegraph.pl / speedscope input
    budget = host_budget(prof.snapshot())

Cost contracts, as in the rest of obs/:

- disabled = the object does not exist: `ServeConfig(profile_hz=None)`
  builds nothing, so no hot path pays a branch for profiling being off.
- bounded memory: at most `max_stacks` unique (role, stack) entries;
  further novel stacks aggregate into a per-role `[overflow]` bucket
  (counted in `overflow_drops`).
- self-measured: the sampler publishes its own duty cycle (time spent
  sampling / wall time) to the `obs.profiler.duty_cycle` gauge.

Each sampled stack is classified once into a host-budget **stage**
(`admission`, `encode`, `append`, `readback`, `fsync`,
`future-resolve`, `lock-wait`, `other`) by walking frames leaf -> root
against the serve/core call-site tables below; `host_budget(snapshot)`
reduces a profile to the per-stage attribution. A thread whose leaf
frame is a wait primitive (`Condition.wait`, socket receive, `sleep`,
...) is `lock-wait`: blocked, not holding the interpreter.

Device waits: a CUDA read-back (`Tensor.cpu()`) is a C call with no
Python frame of its own, so the combiner round's device-to-host reads
go through `core/replica.py:_readback`, a Python frame named in the
stage table: a worker blocked on the card reads as `readback`, not as
the `append` of the round around it. The Python-level torch waits
(`torch.cuda.synchronize`, `Event.synchronize`, `Tensor.__array__`)
match anywhere in a stack.

Folded output (`folded()` / `folded_from_snapshot`) is the
flamegraph/speedscope line format, one stack per line, role as the
root frame:

    serve-worker;frontend.py:_worker_loop;frontend.py:_run_batch;... 42

Remote capture rides the exporter (`obs/export.py`): `profile-start` /
`profile-stop` / `profile-fetch` over the same length+CRC framing, and
`FleetCollector.fetch_profiles` pulls a profile from every node.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from node_replication_torch.analysis.locks import make_lock
from node_replication_torch.obs.metrics import get_registry

#: default sampling rate; prime so the sampler cannot phase-lock with
#: millisecond-periodic serve work (the classic 100 Hz aliasing trap)
DEFAULT_HZ = 97.0

#: default unique-(role, stack) cap before the overflow bucket engages
DEFAULT_MAX_STACKS = 4096

#: frames kept per stack (leafmost); deeper stacks get a root marker
DEFAULT_MAX_DEPTH = 48

TRUNCATED_FRAME = "[truncated]"
OVERFLOW_FRAME = "[overflow]"

# --------------------------------------------------------------------------
# thread-name -> role (the contract `ServeFrontend.threads()` pins and
# the lint rule `unnamed-worker-thread` enforces)
# --------------------------------------------------------------------------

_ROLE_PREFIXES = (
    ("serve-worker-", "serve-worker"),
    ("serve-asm-", "serve-assembly"),
    ("serve-cpl-", "serve-completion"),
    ("serve-client-", "serve-client"),
    ("repl-shipper", "repl-shipper"),
    ("repl-relay-", "repl-relay"),
    ("repl-apply-", "repl-apply"),
    ("repl-feed-", "repl-feed"),
    ("repl-promotion-watch", "repl-promote"),
    ("fault-medic-", "fault-medic"),
    ("obs-export-", "obs-export"),
    ("obs-device-trace-", "obs-export"),
    ("obs-fleet-collector", "obs-collect"),
    ("obs-profiler", "obs-profiler"),
    ("MainThread", "main"),
)

#: every role `role_of` can produce (the profiler's bucket universe)
KNOWN_ROLES = frozenset(r for _, r in _ROLE_PREFIXES) | {"other"}


def role_of(thread_name: str) -> str:
    """Map a thread name onto its profiler role bucket. Unnamed or
    foreign threads collapse into `"other"` — which is exactly why
    nrlint warns on `threading.Thread` without `name=` in the worker
    subsystems (`unnamed-worker-thread`)."""
    name = str(thread_name)
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


# --------------------------------------------------------------------------
# stage classification (the host-budget vocabulary)
# --------------------------------------------------------------------------

#: a thread whose LEAF frame is one of these is blocked, not running —
#: Python-level wait primitives (`Condition.wait` in threading.py, the
#: clock shim's `wait`, framed-socket receive loops). C-level blockers
#: (`lock.acquire`, `socket.recv`, `os.fsync`, `time.sleep`) have no
#: Python frame of their own; their CALLERS appear here when the call
#: site is itself a dedicated wait helper.
_WAIT_LEAF_FUNCS = frozenset({
    "wait", "wait_for", "acquire", "select", "poll", "accept",
    "recv", "recvfrom", "recv_into", "_recv_exact", "sleep", "join",
    "_wait_for_tstate_lock",  # threading.Thread.join's blocking leaf
    "wait_idle", "wait_clear", "park", "readinto", "getch",
})

#: funcname -> budget stage for frames INSIDE this package (matching
#: foreign frames by bare function name would misattribute torch/numpy
#: internals; deep foreign frames attribute to the nearest in-package
#: caller instead, which is the attribution that can be acted on)
_STAGE_FUNCS = {
    # admission: client-side submit/offer path up to the queue
    "submit": "admission", "offer": "admission",
    "readmit": "admission", "call": "admission",
    "call_with_retry": "admission", "_sweep_expired_unlocked":
    "admission",
    # encode: batch assembly — drain, deadline sweep, op staging
    "take_batch": "encode", "_assemble": "encode",
    "_sweep_batch": "encode", "_run_batch": "encode",
    "_worker_loop": "encode", "_assembly_loop": "encode",
    # append: the combiner round's device dispatch
    "execute_mut_batch": "append", "begin_mut_batch": "append",
    "finish_mut_batch": "append", "execute_mut": "append",
    "combine": "append", "_exec_round": "append", "append": "append",
    "sync_log": "append", "log_catchup_all": "append",
    "_begin_round": "append", "_finish_round": "append",
    # ... and the round's helpers and wrapper hooks (`core/replica.py`,
    # `core/cnr.py`)
    "_fused_round": "append", "_hand_out": "append",
    "_record_tier": "append", "_read_answers": "append",
    "_round_log": "append", "_set_round_log": "append",
    "_owes_responses": "append", "_owe_responses": "append",
    "_deliver_answers": "append", "_chain_round": "append",
    "_round_ltail": "append", "_count_round": "append",
    "_count_appended": "append", "_log_attrs": "append",
    "_scatter": "append",
    # readback: read-path sync + device->host result fetch
    "execute": "readback", "execute_stale": "readback",
    "read": "readback", "_readback": "readback",
    # fsync: WAL durability barrier
    "fsync": "fsync", "_fsync": "fsync", "sync": "fsync",
    "ship_barrier": "fsync", "barrier": "fsync",
    # future resolution: response delivery back to clients
    "_finish_delivery": "future-resolve", "_complete": "future-resolve",
    "_completion_loop": "future-resolve", "_resolve": "future-resolve",
    "_reject": "future-resolve", "set_result": "future-resolve",
    "batch_done": "future-resolve",
}

#: device waits that live OUTSIDE the package (torch): the Python-level
#: frames of `torch.cuda.synchronize`, `torch.cuda.Event.synchronize`
#: and `Tensor.__array__`; these may match anywhere in the stack
_FOREIGN_STAGE_FUNCS = {
    "synchronize": "readback", "__array__": "readback",
}

#: the full stage vocabulary, render order for the report section
STAGES = ("lock-wait", "append", "readback", "encode", "admission",
          "fsync", "future-resolve", "other")

_PKG_MARKER = os.sep + "node_replication_torch" + os.sep


def _classify(frames_leaf_first) -> str:
    """Budget stage for one sampled stack: `lock-wait` when the leaf
    is a wait primitive, else the first (leafmost) frame matching the
    stage tables — so torch internals under `execute_mut_batch` read as
    `append`, and `_run_batch`'s own bookkeeping (no deeper match)
    reads as `encode`."""
    if not frames_leaf_first:
        return "other"
    if frames_leaf_first[0][1] in _WAIT_LEAF_FUNCS:
        return "lock-wait"
    for filename, func in frames_leaf_first:
        stage = _FOREIGN_STAGE_FUNCS.get(func)
        if stage is not None:
            return stage
        if _PKG_MARKER in filename:
            stage = _STAGE_FUNCS.get(func)
            if stage is not None:
                return stage
    return "other"


class _StackRec:
    """Aggregated counts for one unique (role, stack)."""

    __slots__ = ("count", "stage", "wait")

    def __init__(self, stage: str, wait: bool):
        self.count = 0
        self.stage = stage
        self.wait = wait


class SamplingProfiler:
    """Samples every live thread's stack at `hz` from one daemon
    thread (`obs-profiler`), aggregating per-role folded stacks.

    The object IS the enablement: construct + `start()` to profile,
    `stop()` to halt (restartable); code that does not hold one pays
    nothing. Thread-safe: `snapshot()`/`folded()` may be called from
    any thread, running or stopped (the remote-capture path fetches
    from a live profiler).
    """

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        max_stacks: int = DEFAULT_MAX_STACKS,
        max_depth: int = DEFAULT_MAX_DEPTH,
        registry=None,
    ):
        if not hz > 0:
            raise ValueError(f"hz must be > 0, got {hz}")
        if max_stacks < 1:
            raise ValueError("max_stacks must be >= 1")
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._lock = make_lock("SamplingProfiler._lock")
        self._stacks: dict[tuple, _StackRec] = {}
        self._roles: dict[str, dict] = {}
        self._role_threads: dict[str, set] = {}
        self._ticks = 0
        self._thread_samples = 0
        self._busy_samples = 0
        self._overflow_drops = 0
        self._spent_s = 0.0    # sampler's own CPU-ish time (duty cycle)
        self._wall_s = 0.0     # accumulated across start/stop segments
        self._t_start: float | None = None
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        reg = registry if registry is not None else get_registry()
        # one gauge pair per process (get-or-create): the profiler's
        # own overhead and the host's busy fraction — `obs/top.py`'s
        # `host` column and the overhead gate read these
        self._g_duty = reg.gauge("obs.profiler.duty_cycle")
        self._g_busy = reg.gauge("obs.host.busy_frac")

    # ------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        # nrcheck: unshared — lock-free poll; one reference load
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def thread(self) -> threading.Thread | None:
        """The live sampler thread (None when stopped) — for thread
        introspection (`ServeFrontend.threads()`), not lifecycle."""
        with self._lock:
            return self._thread

    def start(self) -> None:
        """Start (or restart) the sampler thread; idempotent while
        running. Counts accumulate across segments — `reset()` wipes."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            evt = threading.Event()
            self._stop_evt = evt
            self._t_start = time.monotonic()
            t = threading.Thread(
                target=self._loop, args=(evt,),
                name="obs-profiler", daemon=True,
            )
            self._thread = t
        t.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop sampling (idempotent); the aggregate survives for
        `snapshot()`/`folded()`."""
        with self._lock:
            t = self._thread
            self._stop_evt.set()
        if t is not None and t.is_alive():
            t.join(timeout_s)
        with self._lock:
            if self._t_start is not None:
                self._wall_s += time.monotonic() - self._t_start
                self._t_start = None
            self._thread = None

    def __enter__(self) -> "SamplingProfiler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def reset(self) -> None:
        """Drop every aggregate (the running wall segment restarts)."""
        with self._lock:
            self._stacks.clear()
            self._roles.clear()
            self._role_threads.clear()
            self._ticks = 0
            self._thread_samples = 0
            self._busy_samples = 0
            self._overflow_drops = 0
            self._spent_s = 0.0
            self._wall_s = 0.0
            if self._t_start is not None:
                self._t_start = time.monotonic()

    # ------------------------------------------------------------- sampling

    def _loop(self, stop_evt: threading.Event) -> None:
        period = 1.0 / self.hz
        next_t = time.monotonic() + period
        last_pub = time.monotonic()
        pub = {"spent": 0.0, "samples": 0, "busy": 0}
        while not stop_evt.wait(
                max(0.0, next_t - time.monotonic())):
            t0 = time.monotonic()
            samples, busy = self.sample_once()
            t1 = time.monotonic()
            cost = t1 - t0
            with self._lock:
                self._spent_s += cost
            pub["spent"] += cost
            pub["samples"] += samples
            pub["busy"] += busy
            next_t += period
            if next_t < t1:
                # sampling fell behind the period: drop missed ticks
                # instead of bursting to catch up (duty stays bounded)
                next_t = t1 + period
            if t1 - last_pub >= 1.0:
                self._publish(pub, t1 - last_pub)
                last_pub = t1
                pub = {"spent": 0.0, "samples": 0, "busy": 0}
        # final window so short runs still publish their gauges
        now = time.monotonic()
        if pub["samples"] or pub["spent"]:
            self._publish(pub, max(now - last_pub, 1e-9))

    def _publish(self, pub: dict, window_s: float) -> None:
        self._g_duty.set(min(1.0, pub["spent"] / window_s))
        if pub["samples"]:
            self._g_busy.set(pub["busy"] / pub["samples"])

    def sample_once(self) -> tuple[int, int]:
        """One sweep over every live thread (the sampler's tick, also
        directly callable for deterministic tests). Returns
        `(thread_samples, busy_samples)` for this sweep."""
        me = threading.get_ident()
        with self._lock:
            t = self._thread
        skip = {me}
        if t is not None and t.ident is not None:
            skip.add(t.ident)
        names = {}
        for th in threading.enumerate():
            if th.ident is not None:
                names[th.ident] = th.name
        sampled = []
        # sys._current_frames() is a point-in-time dict; frames may
        # keep running while we walk them — good enough for sampling
        for ident, frame in sys._current_frames().items():
            if ident in skip:
                continue
            leaf_first = []
            f = frame
            depth = 0
            while f is not None and depth < self.max_depth:
                code = f.f_code
                leaf_first.append((code.co_filename, code.co_name))
                f = f.f_back
                depth += 1
            truncated = f is not None
            stage = _classify(leaf_first)
            frames = tuple(
                f"{fn.rsplit(os.sep, 1)[-1]}:{func}"
                for fn, func in reversed(leaf_first)
            )
            if truncated:
                frames = (TRUNCATED_FRAME,) + frames
            role = role_of(names.get(ident, ""))
            sampled.append((role, frames, stage,
                            stage == "lock-wait",
                            names.get(ident, f"tid-{ident}")))
        busy = 0
        with self._lock:
            self._ticks += 1
            for role, frames, stage, wait, name in sampled:
                self._thread_samples += 1
                if not wait:
                    busy += 1
                    self._busy_samples += 1
                rstat = self._roles.get(role)
                if rstat is None:
                    rstat = self._roles[role] = {"samples": 0,
                                                 "busy": 0}
                rstat["samples"] += 1
                if not wait:
                    rstat["busy"] += 1
                seen = self._role_threads.setdefault(role, set())
                if len(seen) < 64:
                    seen.add(name)
                key = (role, frames)
                rec = self._stacks.get(key)
                if rec is None:
                    if len(self._stacks) >= self.max_stacks:
                        # bounded memory: novel stacks past the cap
                        # fold into the per-role overflow bucket
                        self._overflow_drops += 1
                        key = (role, (OVERFLOW_FRAME,))
                        rec = self._stacks.get(key)
                        if rec is None:
                            rec = self._stacks[key] = _StackRec(
                                stage, wait)
                    else:
                        rec = self._stacks[key] = _StackRec(stage,
                                                            wait)
                rec.count += 1
        return len(sampled), busy

    # -------------------------------------------------------------- output

    @property
    def wall_s(self) -> float:
        with self._lock:
            wall = self._wall_s
            if self._t_start is not None:
                wall += time.monotonic() - self._t_start
            return wall

    @property
    def duty_cycle(self) -> float:
        """Fraction of wall time the sampler spent sampling — the
        profiler's self-measured overhead."""
        wall = self.wall_s
        with self._lock:
            return self._spent_s / wall if wall > 0 else 0.0

    def snapshot(self) -> dict:
        """JSON-safe full view: config, self-measurement, per-role
        totals + seen thread names, and every aggregated stack (each
        with its precomputed budget stage) — the document the
        exporter's `profile-fetch` returns."""
        wall = self.wall_s
        with self._lock:
            stacks = [
                {"role": role, "frames": list(frames),
                 "count": rec.count, "stage": rec.stage,
                 "wait": rec.wait}
                for (role, frames), rec in self._stacks.items()
            ]
            roles = {
                role: {
                    "samples": st["samples"], "busy": st["busy"],
                    "threads": sorted(
                        self._role_threads.get(role, ())),
                }
                for role, st in self._roles.items()
            }
            doc = {
                "hz": self.hz,
                "running": self.running,
                "wall_s": wall,
                "spent_s": self._spent_s,
                "duty_cycle": (self._spent_s / wall
                               if wall > 0 else 0.0),
                "ticks": self._ticks,
                "thread_samples": self._thread_samples,
                "busy_samples": self._busy_samples,
                "busy_frac": (
                    self._busy_samples / self._thread_samples
                    if self._thread_samples else 0.0
                ),
                "unique_stacks": len(self._stacks),
                "max_stacks": self.max_stacks,
                "overflow_drops": self._overflow_drops,
                "roles": roles,
            }
        stacks.sort(key=lambda s: (-s["count"], s["role"],
                                   s["frames"]))
        doc["stacks"] = stacks
        return doc

    def folded(self) -> str:
        """Folded-stack text (flamegraph.pl / speedscope "folded"
        importer): `role;frame;frame... count`, hottest first."""
        return folded_from_snapshot(self.snapshot())

    def emit_summary(self, tracer=None, **extra) -> dict:
        """Reduce the profile to its host budget and emit it as ONE
        `profile-summary` trace event, the join point `obs/report.py`'s
        Host budget section reads from a trace artifact. Returns the
        snapshot it summarized."""
        from node_replication_torch.obs.recorder import get_tracer

        snap = self.snapshot()
        budget = host_budget(snap)
        t = tracer if tracer is not None else get_tracer()
        t.emit(
            "profile-summary",
            hz=self.hz,
            wall_s=round(snap["wall_s"], 6),
            ticks=snap["ticks"],
            thread_samples=snap["thread_samples"],
            duty_cycle=round(snap["duty_cycle"], 6),
            busy_frac=round(snap["busy_frac"], 6),
            unique_stacks=snap["unique_stacks"],
            overflow_drops=snap["overflow_drops"],
            roles={r: d["samples"] for r, d in snap["roles"].items()},
            stages={s: d["samples"]
                    for s, d in budget["stages"].items()},
            attributed_frac=budget["attributed_frac"],
            **extra,
        )
        return snap


# --------------------------------------------------------------------------
# snapshot reductions (pure functions — shared by bench, report, CLI)
# --------------------------------------------------------------------------


def folded_from_snapshot(snapshot: dict) -> str:
    """Folded-stack lines from a `SamplingProfiler.snapshot()` (local
    or fetched over the exporter protocol)."""
    lines = []
    for s in snapshot.get("stacks", ()):
        frames = ";".join([s["role"]] + list(s["frames"]))
        lines.append(f"{frames} {int(s['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_folded(text: str) -> list[tuple[list[str], int]]:
    """Parse folded-stack text back into `([frames...], count)` rows
    (round-trip validation for the remote-capture tests and any
    speedscope-compatible consumer)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        rows.append((stack.split(";"), int(count)))
    return rows


def host_budget(snapshot: dict) -> dict:
    """Per-stage host-time attribution from one profile snapshot: the
    "Host budget". Sample counts are the time
    proxy (each thread-sample is ~1/hz of one thread's wall time);
    `attributed_frac` is the share landing in a NAMED stage (everything
    but `other`)."""
    totals: dict[str, int] = {}
    total = 0
    for s in snapshot.get("stacks", ()):
        n = int(s["count"])
        totals[s["stage"]] = totals.get(s["stage"], 0) + n
        total += n
    stages = {}
    for stage in STAGES:
        n = totals.pop(stage, 0)
        if n:
            stages[stage] = {"samples": n, "frac": n / total}
    for stage, n in sorted(totals.items()):  # future-proof: unknowns
        stages[stage] = {"samples": n, "frac": n / total}
    other = stages.get("other", {}).get("samples", 0)
    return {
        "thread_samples": total,
        "wall_s": float(snapshot.get("wall_s", 0.0)),
        "hz": float(snapshot.get("hz", 0.0)),
        "duty_cycle": float(snapshot.get("duty_cycle", 0.0)),
        "busy_frac": float(snapshot.get("busy_frac", 0.0)),
        "stages": stages,
        "attributed_frac": (
            (total - other) / total if total else 0.0
        ),
    }
