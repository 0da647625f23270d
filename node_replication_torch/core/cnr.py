"""`MultiLogReplicated`: the stateful CNR surface (PyTorch).

The port of `node_replication_tpu/core/cnr.py` (the `cnr` crate's
`Replica` API, per-op form; see its docstring). Every op is routed to a
log by the user's `LogMapper` (`hash % nlogs`); writes stage in the
issuing thread's queue tagged with their log and combine per log; reads
sync only their mapped log; `sync()` loops every log and `sync_log`
targets one. The GC-starvation callback fires as `gc_callback(log_idx,
dormant_replica)` from the watchdog when a log's replay stalls.

The batch path is `core/multilog.make_multilog_step`; this wrapper is
the per-op surface over the same stacked log (`core/multilog.py`),
with the split round (`begin_mut_batch`/`finish_mut_batch`) the serve
frontend drives. Each per-log combiner pass is the one combiner-round
protocol `NodeReplicated` runs (`core/replica.py:_FusedTier`) on that
log: this wrapper supplies the log's row of the stacked ring, the
per-log record of owed responses and the per-thread answer queues. So
the fused per-log tier is NR's: a lock-step per-log sub-batch of a
model with a fused engine (the hashmap's K1,
`ops/replay.py:FusedHashmapEngine`) appends, replays and answers in
ONE kernel launch on that log's row of the stacked ring.

`device=None` runs on the card and raises without one; pass
`device="cpu"` to run on the CPU. `mesh=` takes a ('replica', 'log')
`parallel.Mesh`: replica states and the ltails' replica columns are
placed by mesh row (`parallel/mesh.py:place`), every exec round runs
on each row shard with the lattice joined on the host (the
reference's GSPMD tier), and the fused per-log tier stays un-meshed, as
in the reference.

By design, as `NodeReplicated`'s scan round: an exec round stops at
the largest lag of the log's replicas (host cursors it already reads)
instead of running the rest of the static `exec_window` as NOOPs;
cursors, states and every delivered response are the same.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from node_replication_torch.analysis.locks import make_rlock
from node_replication_torch.core.log import WARN_ROUNDS, LogSpec
from node_replication_torch.core.multilog import (
    LogMapper,
    MultiLogSpec,
    _exec_one_log,
    log_view,
    multilog_init,
)
from node_replication_torch.core.replica import (
    BATCH_TID,
    MAX_THREADS_PER_REPLICA,
    LogTooSmallError,
    ReplicaToken,
    _FusedTier,
    _locked,
    _PendingRound,
    _read_cursors,
    _readback,
    replicate_state,
    states_equal,
)
from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import COUNT_BUCKETS, get_registry
from node_replication_torch.ops.encoding import (
    Dispatch,
    apply_read,
)
from node_replication_torch.utils.device import resolve_device
from node_replication_torch.utils.trace import get_tracer, span
from node_replication_torch.utils.tree import tree_map

logger = logging.getLogger("node_replication_torch")


class _PendingCnrBatch:
    """One `begin_mut_batch` batch between begin and finish: the
    per-log `_PendingRound` sub-rounds (in log order) plus the scatter
    map back to submission indices. NOT atomic across logs."""

    __slots__ = ("rid", "n", "subs")

    def __init__(self, rid: int, n: int):
        self.rid = rid
        self.n = n
        #: list of (log_idx, submission_indices, _PendingRound)
        self.subs: list[tuple[int, list[int], _PendingRound]] = []


def _store_log(ml, log_idx: int, log):
    """Write a single-log `LogState` back into row `log_idx` of the
    stacked state, in place: the other logs' rows stay as they are."""
    for field in ("opcodes", "args", "head", "tail", "ctail", "ltails"):
        getattr(ml, field)[log_idx].copy_(getattr(log, field))
    return ml


def _scatter(log_idx: int, idxs: list[int], sink: deque, out: list) -> None:
    """Move log `log_idx`'s answers from the batch's sink to their
    submission indices `idxs` of `out`, all of them or none."""
    if len(sink) != len(idxs):
        raise RuntimeError(
            f"log {log_idx} delivered {len(sink)} responses for "
            f"{len(idxs)} ops"
        )
    for i in idxs:
        out[i] = sink.popleft()


class MultiLogReplicated(_FusedTier):
    """N replicas of one `Dispatch` behind L commutativity-partitioned
    logs."""

    #: the chain's replay engine: every per-log round scans its window
    engine = "scan"

    def __init__(
        self,
        dispatch: Dispatch,
        log_mapper: LogMapper,
        nlogs: int,
        n_replicas: int = 1,
        log_entries: int = 1 << 12,
        gc_slack: int = 128,
        exec_window: int = 128,
        gc_callback: Callable[[int, int], None] | None = None,
        mesh=None,
        engine: str = "auto",
        device=None,
    ):
        if mesh is not None:
            from node_replication_torch.parallel.mesh import (
                Mesh,
                row_devices,
            )

            if not isinstance(mesh, Mesh) or not {
                "replica", "log"
            } <= set(mesh.axis_names):
                raise ValueError(
                    f"MultiLogReplicated needs a ('replica', 'log') "
                    f"Mesh (parallel/mesh.py:make_mesh); got {mesh!r}"
                )
            shape = mesh.shape
            if n_replicas % shape["replica"]:
                raise ValueError(
                    f"R={n_replicas} replicas cannot shard over "
                    f"{shape['replica']} mesh rows"
                )
            if nlogs % shape["log"]:
                raise ValueError(
                    f"L={nlogs} logs cannot shard over "
                    f"{shape['log']} mesh columns"
                )
            home = row_devices(mesh)[0]
            if device is not None and resolve_device(device) != home:
                raise ValueError(
                    f"device={device!r} is not the mesh's home device "
                    f"{home} (mesh row 0's)"
                )
            device = home
        self.device = resolve_device(device)
        self._ml = self._states = None
        self._placed = None
        self.spec = MultiLogSpec(
            nlogs=nlogs,
            capacity=log_entries,
            n_replicas=n_replicas,
            arg_width=dispatch.arg_width,
            gc_slack=gc_slack,
        )
        # every log's own spec: one fused engine serves all their rounds
        self._log_spec = self.spec.one_log()
        self.dispatch = dispatch
        self.log_mapper = log_mapper
        self.exec_window = int(exec_window)
        self.gc_callback = gc_callback

        # one combiner pass at a time across all logs; reentrant so a
        # watchdog gc_callback can re-enter sync_log on the same thread.
        # Built before the first state write: the `ml`/`states` setters
        # take it.
        self._lock = make_rlock("MultiLogReplicated._lock")
        self.ml = multilog_init(self.spec, self.device)
        self.states = replicate_state(dispatch.init_state(self.device),
                                      n_replicas)
        self.mesh = None
        self._mesh_shards = 0
        if mesh is not None:
            from node_replication_torch.parallel.mesh import (
                announce_placement,
                place,
            )

            self.mesh = mesh
            self._mesh_shards = mesh.size
            announce_placement(mesh, n_replicas, "MultiLogReplicated",
                               "gspmd")
            self._placed = place(self._ml, self._states, mesh)
            self._ml = self._states = None

        self._threads_per_replica = [0] * n_replicas
        # staged ops: (rid, tid) -> deque[(log, opcode, args)]
        self._pending: dict[tuple[int, int], deque] = {}
        # appended-but-unanswered, per log: {rid: deque[(pos, tid)]},
        # a replica present only while it is owed a response on that
        # log, so "is anything owed on log h" is `bool(_inflight[h])`
        self._inflight: list[dict[int, deque]] = [{} for _ in range(nlogs)]
        # delivered responses per thread, in enqueue order per log
        self._resps: dict[tuple[int, int], deque] = {}
        # at most ONE begun-but-unfinished batch per replica
        self._pending_batch: dict[int, _PendingCnrBatch] = {}
        self._log_selected = [0] * nlogs
        self._combine_rounds = [0] * nlogs
        # entries appended to all logs: the sum of their tails, kept on
        # the host (a batch's `mut-batch` span carries it as its `round`)
        self._appended = 0
        self._exec_rounds = 0
        self._idle_rounds = 0
        reg = get_registry()
        self._m_rounds = reg.counter("cnr.exec.rounds")
        self._m_idle = reg.counter("cnr.exec.idle_rounds")
        self._m_combine = reg.counter("cnr.combine.rounds")
        self._m_batch = reg.histogram("cnr.combine.batch_size",
                                      buckets=COUNT_BUCKETS)
        self._m_stalls = reg.counter("cnr.watchdog.stalls")

        # the fused per-log combiner tier (`core/replica._FusedTier`):
        # 'pallas' forces it, 'auto' calibrates on a CUDA device
        # (NR_TPU_FUSED_CAL=1 is the CPU-test hook), 'scan' keeps the
        # chain. CNR has no fencing, so no fenced round is built.
        if engine not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        self._init_fused_tier(engine, dispatch, reg, "cnr",
                              mesh=self.mesh)
        if self.mesh is not None:
            self._m_mesh_round = reg.counter("cnr.exec.mesh.gspmd")
            self._m_mesh_sync_bytes = reg.counter("mesh.sync_bytes")

    # ------------------------------------------------------------ placement

    @property
    def ml(self):
        """The stacked logs (on a mesh: the global view on the home
        device)."""
        return self._ml if self._placed is None else self._placed.log

    @ml.setter
    @_locked
    def ml(self, ml) -> None:
        if self._placed is None:
            self._ml = ml
        else:
            self._placed = self._placed.with_log(ml)

    @property
    def states(self):
        """The replica states (on a mesh: the global view on the home
        device)."""
        if self._placed is None:
            return self._states
        return self._placed.states

    @states.setter
    @_locked
    def states(self, states) -> None:
        if self._placed is None:
            self._states = states
        else:
            self._placed = self._placed.with_states(states)

    def _fleet_trees(self) -> tuple:
        """The fleet's tensors as trees, for `utils/fence.py:fence`
        (no global view is built)."""
        if self._placed is None:
            return (self._ml, self._states)
        return tuple(self._placed.trees())

    # ------------------------------------------------------------------ API

    @property
    def n_replicas(self) -> int:
        return self.spec.n_replicas

    @property
    def nlogs(self) -> int:
        return self.spec.nlogs

    def replica_device(self, rid: int) -> torch.device:
        """The device holding replica `rid`'s state: the first device
        of its mesh row, or the fleet's one device un-meshed (the
        reference returns None there)."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._placed is None:
            return self.device
        return self._placed.shards[self._placed.shard_of(rid)[0]].device

    def _cursors(self, log_idx: int) -> tuple[np.ndarray, int]:
        """One readback of log `log_idx`'s `(ltails, tail)`."""
        return _read_cursors(self.ml.ltails[log_idx], self.ml.tail[log_idx])

    @_locked
    def register(self, rid: int = 0) -> ReplicaToken:
        """Register a logical thread on replica `rid` (on every log)."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        tid = self._threads_per_replica[rid]
        if tid >= MAX_THREADS_PER_REPLICA:
            raise RuntimeError(f"replica {rid} thread limit reached")
        self._threads_per_replica[rid] = tid + 1
        self._pending[(rid, tid)] = deque()
        self._resps[(rid, tid)] = deque()
        return ReplicaToken(rid, tid)

    @_locked
    def _map(self, op: tuple) -> int:
        h = self.log_mapper(op[0], tuple(op[1:])) % self.nlogs
        self._log_selected[h] += 1
        return h

    @_locked
    def execute_mut(self, op: tuple, token: ReplicaToken):
        """Route the write to its log, combine that log, return its
        response. Earlier enqueued-but-unread responses stay queued for
        `responses()` (this op's is the newest on its log)."""
        h = self.enqueue_mut(op, token)
        self.combine(token.rid, h)
        q = self._resps[(token.rid, token.tid)]
        return q.pop() if q else None

    @_locked
    def enqueue_mut(self, op: tuple, token: ReplicaToken) -> int:
        """Stage a write without combining; its response arrives via
        `responses()` after a later combine of its mapped log. Returns
        the mapped log index."""
        h = self._map(op)
        self._pending[(token.rid, token.tid)].append(
            (h, op[0], tuple(op[1:]))
        )
        return h

    @_locked
    def flush(self, rid: int | None = None) -> None:
        """Combine every log with staged ops (all replicas by default)."""
        for r in range(self.n_replicas) if rid is None else [rid]:
            logs = {
                h
                for tid in range(self._threads_per_replica[r])
                for (h, _, _) in self._pending[(r, tid)]
            }
            for h in sorted(logs):
                self.combine(r, h)

    @_locked
    def responses(self, token: ReplicaToken) -> list:
        """Drain delivered responses for this thread (enqueue order per
        log; across logs, combine order)."""
        q = self._resps[(token.rid, token.tid)]
        out = list(q)
        q.clear()
        return out

    @_locked
    def execute(self, op: tuple, token: ReplicaToken):
        """Read path: sync only the mapped log, then dispatch locally."""
        h = self._map(op)
        rid = token.rid
        fault_hook("read-sync", rid, self)
        ctail = int(self.ml.ctail[h])
        rounds = 0
        while int(self.ml.ltails[h, rid]) < ctail:
            self._exec_round(h)
            rounds = self._watchdog(rounds, h, "read-sync")
        args = np.zeros((1, self.spec.arg_width), np.int32)
        args[0, : len(op) - 1] = op[1:]
        if self._placed is None:
            state = tree_map(lambda a: a[rid:rid + 1], self._states)
            dev = self.device
        else:
            s, i = self._placed.shard_of(rid)
            sh = self._placed.shards[s]
            state = tree_map(lambda a: a[i:i + 1], sh.states)
            dev = sh.device
        resp = apply_read(
            self.dispatch, state,
            torch.tensor([op[0]], dtype=torch.int32, device=dev),
            torch.from_numpy(args).to(dev),
        )
        return int(resp[0])

    @_locked
    def combine(self, rid: int, log_idx: int) -> None:
        """Drain replica `rid`'s staged ops for `log_idx` (thread
        order), append them to that log and replay it until `rid` has
        applied its own ops: one log's combiner pass."""
        ops: list[tuple] = []
        tids: list[int] = []
        for tid in range(self._threads_per_replica[rid]):
            q = self._pending[(rid, tid)]
            keep = deque()
            while q:
                h, opcode, args = q.popleft()
                if h == log_idx:
                    ops.append((opcode, *args))
                    tids.append(tid)
                else:
                    keep.append((h, opcode, args))
            q.extend(keep)
        if not ops:
            self._exec_round(log_idx)
            return
        self._append_and_replay(log_idx, ops, rid, tids)

    # ---------------------------------------- the combiner round's hooks

    def _round_spec(self) -> LogSpec:
        return self._log_spec

    def _round_log(self, log_idx: int):
        return log_view(self.ml, log_idx)

    @_locked
    def _set_round_log(self, log_idx: int, log) -> None:
        self.ml = _store_log(self.ml, log_idx, log)

    def _log_attrs(self, log_idx: int) -> dict:
        return {"log": log_idx}

    def _owes_responses(self, log_idx: int) -> bool:
        return bool(self._inflight[log_idx])

    def _owe_responses(self, log_idx: int, rid: int, pos0: int,
                       tids: list[int]) -> None:
        self._inflight[log_idx].setdefault(rid, deque()).extend(
            (pos0 + j, tid) for j, tid in enumerate(tids))

    def _deliver_answers(self, rid: int, tids: list[int], resps_np) -> None:
        for j, tid in enumerate(tids):
            self._resps[(rid, tid)].append(int(resps_np[j]))

    def _chain_round(self, log_idx: int, rounds: int, where: str) -> int:
        self._exec_round(log_idx)
        return self._watchdog(rounds, log_idx, where)

    def _round_ltail(self, log_idx: int, rid: int) -> int:
        return int(self.ml.ltails[log_idx, rid])

    @_locked
    def _count_round(self, log_idx: int) -> None:
        self._combine_rounds[log_idx] += 1
        self._m_combine.inc()

    @_locked
    def _count_appended(self, n: int) -> None:
        self._appended += n

    @_locked
    def _drop_batch_inflight(self, rid: int) -> None:
        """Failed-batch hygiene: drop every pending BATCH_TID delivery
        of this replica on every log and clear its sink."""
        for owed in self._inflight:
            if rid in owed:
                q = deque((p, t) for p, t in owed.pop(rid)
                          if t != BATCH_TID)
                if q:
                    owed[rid] = q
        sink = self._resps.get((rid, BATCH_TID))
        if sink is not None:
            sink.clear()

    @_locked
    def _batch_groups(self, ops: list[tuple], rid: int) -> dict:
        """Route a batch through the `LogMapper`: `{log: [submission
        indices]}`, each sub-batch checked against the appendable
        capacity. Creates the replica's BATCH_TID sink."""
        if (rid, BATCH_TID) not in self._resps:
            self._resps[(rid, BATCH_TID)] = deque()
        groups: dict[int, list[int]] = {}
        for i, op in enumerate(ops):
            groups.setdefault(self._map(op), []).append(i)
        max_batch = self.spec.capacity - self.spec.gc_slack
        for h, idxs in groups.items():
            if len(idxs) > max_batch:
                raise LogTooSmallError(
                    f"log {h}: sub-batch of {len(idxs)} exceeds "
                    f"appendable capacity {max_batch}"
                )
        return groups

    @_locked
    def begin_mut_batch(self, ops: list[tuple],
                        rid: int = 0) -> _PendingCnrBatch:
        """Split-round batch entry, first half: route each op through
        the `LogMapper`, then append every per-log sub-batch in log
        order (launching its fused round where eligible), deferring each
        log's replay-to-target to `finish_mut_batch`. At most ONE
        begun-but-unfinished batch per replica. NOT atomic across
        logs."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._pending_batch.get(rid) is not None:
            raise RuntimeError(
                f"replica {rid} already has a batch in flight; "
                f"finish_mut_batch it before beginning another "
                f"(at most one split round per replica)"
            )
        groups = self._batch_groups(ops, rid)
        pend = _PendingCnrBatch(rid, len(ops))
        try:
            for h in sorted(groups):
                idxs = groups[h]
                sub = self._begin_round(
                    h, [ops[i] for i in idxs], rid,
                    [BATCH_TID] * len(idxs), batch=True, defer=True,
                )
                pend.subs.append((h, idxs, sub))
        except BaseException:
            self._drop_batch_inflight(rid)
            raise
        self._pending_batch[rid] = pend
        return pend

    @_locked
    def finish_mut_batch(self, pend: _PendingCnrBatch) -> list:
        """Split-round batch entry, second half: complete every per-log
        sub-round (in log order), scatter responses back to submission
        indices, release the replica's in-flight slot."""
        rid = pend.rid
        if self._pending_batch.get(rid) is not pend:
            raise RuntimeError(
                f"pending batch for replica {rid} is not this "
                f"replica's in-flight batch (already finished?)"
            )
        sink = self._resps[(rid, BATCH_TID)]
        out: list = [None] * pend.n
        try:
            for h, idxs, sub in pend.subs:
                self._finish_round(sub)
                _scatter(h, idxs, sink, out)
            return out
        except BaseException:
            self._drop_batch_inflight(rid)
            raise
        finally:
            self._pending_batch.pop(rid, None)

    @_locked
    def abort_mut_batch(self, pend: _PendingCnrBatch) -> None:
        """Abandon a begun-but-unfinished split batch: every appended
        sub-batch WILL replay; only response delivery drops.
        Idempotent."""
        rid = pend.rid
        if self._pending_batch.get(rid) is not pend:
            return
        self._pending_batch.pop(rid, None)
        for _, _, sub in pend.subs:
            sub.done = True
            sub.fused_resps = None
        self._drop_batch_inflight(rid)

    @_locked
    def execute_mut_batch(self, ops: list[tuple],
                          rid: int = 0) -> list:
        """Execute a caller-assembled batch as one combiner pass PER
        MAPPED LOG (in log order) and return responses in submission
        order. A failure in log h's pass leaves later logs' sub-batches
        unappended (the serial contract; `begin_mut_batch` appends them
        all up front). The batch runs inside a `mut-batch` span whose
        `round` (the entries appended to all logs before it, the sum of
        their tails) every span of the batch carries."""
        with span("mut-batch", rid=rid, n=len(ops), round=self._appended):
            if not 0 <= rid < self.n_replicas:
                raise ValueError(f"replica {rid} out of range")
            if self._pending_batch.get(rid) is not None:
                raise RuntimeError(
                    f"replica {rid} already has a batch in flight; "
                    f"finish_mut_batch it before executing another"
                )
            n = len(ops)
            if n == 0:
                return []
            groups = self._batch_groups(ops, rid)
            sink = self._resps[(rid, BATCH_TID)]
            out: list = [None] * n
            try:
                for h in sorted(groups):
                    idxs = groups[h]
                    self._append_and_replay(
                        h, [ops[i] for i in idxs], rid,
                        [BATCH_TID] * len(idxs), batch=True,
                    )
                    _scatter(h, idxs, sink, out)
                return out
            except BaseException:
                self._drop_batch_inflight(rid)
                raise

    @_locked
    def sync(self, rid: int | None = None) -> None:
        """Catch up on every log."""
        for l in range(self.nlogs):
            self.sync_log(rid, l)

    @_locked
    def sync_log(self, rid: int | None, log_idx: int) -> None:
        """Targeted single-log sync (`rid=None`: every replica); the
        answer to a GC-starvation report."""
        rounds = 0
        while True:
            lt, tail = self._cursors(log_idx)
            done = (bool((lt >= tail).all()) if rid is None
                    else int(lt[rid]) >= tail)
            if done:
                return
            self._exec_round(log_idx)
            rounds = self._watchdog(rounds, log_idx, "sync")

    @_locked
    def verify(self, fn: Callable[[Any], Any], rid: int = 0):
        """Force-sync, then hand replica `rid`'s state (numpy) to `fn`."""
        self.sync()
        state = tree_map(lambda a: _readback(a[rid]), self.states)
        return fn(state)

    @_locked
    def replicas_equal(self) -> bool:
        return states_equal(self.states)

    @_locked
    def stats(self) -> dict:
        """Flat per-log counters; `snapshot()` is the structured
        superset."""
        return {
            "tails": [int(t) for t in _readback(self.ml.tail)],
            "ctails": [int(t) for t in _readback(self.ml.ctail)],
            "heads": [int(t) for t in _readback(self.ml.head)],
            "log_selected": list(self._log_selected),
            "combine_rounds": list(self._combine_rounds),
            "exec_rounds": self._exec_rounds,
            "idle_rounds": self._idle_rounds,
            "fused_rounds": self._fused_rounds,
            "fused_tier": self._fused_tier_state(),
        }

    @_locked
    def snapshot(self) -> dict:
        """Structured observability snapshot (JSON-safe): per-log
        cursors and per-(log, replica) lag, LogMapper routing counts,
        combiner passes and replay rounds per log, and the metrics."""
        tails = _readback(self.ml.tail)
        heads = _readback(self.ml.head)
        ctails = _readback(self.ml.ctail)
        ltails = _readback(self.ml.ltails)
        logs = []
        for l in range(self.nlogs):
            lag = [int(tails[l] - lt) for lt in ltails[l]]
            logs.append({
                "tail": int(tails[l]),
                "head": int(heads[l]),
                "ctail": int(ctails[l]),
                "lag": lag,
                "max_lag": max(lag) if lag else 0,
                "selected": self._log_selected[l],
                "combine_rounds": self._combine_rounds[l],
                "occupancy": (int(tails[l]) - int(heads[l]))
                / self.spec.capacity,
            })
        total_sel = sum(self._log_selected)
        return {
            "nlogs": self.nlogs,
            "capacity": self.spec.capacity,
            "logs": logs,
            # routing imbalance: max over mean selections (1.0 = even)
            "selection_imbalance": (
                max(self._log_selected) * self.nlogs / total_sel
                if total_sel else 0.0
            ),
            "replicas": {
                "n": self.n_replicas,
                "threads": list(self._threads_per_replica),
            },
            "exec": {
                "window": self.exec_window,
                "rounds": self._exec_rounds,
                "idle_rounds": self._idle_rounds,
                "fused_rounds": self._fused_rounds,
                "fused_tier": self._fused_tier_state(),
            },
            "mesh": (
                None if self.mesh is None else {
                    "devices": self._mesh_shards,
                    "tier": "gspmd",
                    "shape": dict(self.mesh.shape),
                }
            ),
            "device": str(self.device),
            "metrics": get_registry().snapshot(),
        }

    # ------------------------------------------------------------ internals

    @_locked
    def _exec_round(self, log_idx: int) -> None:
        """One replay round of log `log_idx` into every replica, plus
        response distribution; skipped (counted idle) when every
        replica is at the log's tail."""
        fault_hook("replay", -1, self)
        lt_before, tail = self._cursors(log_idx)
        if int(lt_before.min()) >= tail and int(lt_before.max()) <= tail:
            self._idle_rounds += 1
            self._m_idle.inc()
            return
        self._exec_rounds += 1
        self._m_rounds.inc()
        window = max(1, min(self.exec_window, tail - int(lt_before.min())))
        sl = slice(log_idx, log_idx + 1)
        if self._placed is None:
            ml = self._ml
            self._states, resps, lt = _exec_one_log(
                self.spec, self.dispatch, ml.opcodes[sl], ml.args[sl],
                ml.tail[sl], self._states, ml.ltails[sl], window,
            )
            lt, resps = lt[0], resps[0]
            ml.ltails[log_idx] = lt
            ml.ctail[log_idx] = torch.maximum(ml.ctail[log_idx], lt.max())
            ml.head[log_idx] = lt.min()
        else:
            lt, resps = self._mesh_exec_log(log_idx, window)
        lt_after = _readback(lt)
        resps_np = _readback(resps)
        if self.mesh is not None:
            self._m_mesh_round.inc()
            self._m_mesh_sync_bytes.inc(resps_np.nbytes + lt_before.nbytes
                                        + 8 + lt_after.nbytes)
        owed = self._inflight[log_idx]
        for r, q in list(owed.items()):
            while q and q[0][0] < int(lt_after[r]):
                pos, tid = q.popleft()
                self._resps[(r, tid)].append(
                    int(resps_np[r, pos - int(lt_before[r])])
                )
            if not q:
                del owed[r]

    @_locked
    def _mesh_exec_log(self, log_idx: int, window: int):
        """One exec round of log `log_idx` on every row shard, then the
        log's cursor lattice joined on the host (`ctail = max`, `head =
        min` of its ltails) and written into each shard's log row.
        Returns the log's global `(ltails int64[R], resps int32[R,
        window])` on the home device."""
        fleet = self._placed
        home = fleet.home
        sl = slice(log_idx, log_idx + 1)
        parts, states, resps = [], [], []
        for sh in fleet.shards:
            ml = sh.log
            st, r, lt = _exec_one_log(
                self.spec, self.dispatch, ml.opcodes[sl], ml.args[sl],
                ml.tail[sl], sh.states, ml.ltails[sl], window,
            )
            parts.append(lt[0])
            states.append(st)
            resps.append(r[0])
        lt = torch.cat([p.to(home) for p in parts])
        ctail = torch.maximum(fleet.shards[0].log.ctail[log_idx].to(home),
                              lt.max())
        head = lt.min()
        for sh, part in zip(fleet.shards, parts):
            # every shard owns its ltails; ctail/head are the device's
            # copy, written once per device
            sh.log.ltails[log_idx] = part
        for d in fleet.devices():
            ml = next(sh.log for sh in fleet.shards if sh.device == d)
            ml.ctail[log_idx] = ctail.to(d)
            ml.head[log_idx] = head.to(d)
        self._placed = fleet.with_shards([sh.log for sh in fleet.shards],
                                         states)
        return lt, torch.cat([r.to(home) for r in resps])

    def _watchdog(self, rounds: int, log_idx: int, where: str) -> int:
        rounds += 1
        # re-warn every WARN_ROUNDS forever, like the reference's per-log
        # GC starvation callback (`cnr/src/log.rs:505-515`)
        if rounds % WARN_ROUNDS == 0:
            self._m_stalls.inc()
            lt, tail = self._cursors(log_idx)
            dormant = int(np.argmin(lt))
            logger.warning(
                "cnr replay stalled in %s on log %d after %d rounds; "
                "dormant replica=%d (ltail=%d, tail=%d)",
                where, log_idx, rounds, dormant, int(lt[dormant]), tail,
            )
            get_tracer().emit(
                "watchdog", where=where, log=log_idx, rounds=rounds,
                dormant=dormant, ltail=int(lt[dormant]), tail=tail,
            )
            if self.gc_callback is not None:
                self.gc_callback(log_idx, dormant)
        return rounds
