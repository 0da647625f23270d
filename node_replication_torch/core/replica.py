"""Replica runtime: flat-combining batching + lock-step replay (PyTorch).

The port of `node_replication_tpu/core/replica.py` (see its docstring
for the mapping from the reference's `Replica`). `NodeReplicated` keeps
the same surface and the same host protocol: per-thread `Context`
rings drained into one append batch per combiner round, replay rounds
until the combiner's own ops are applied, reads gated on the completed
tail, the help-GC-before-append rule, fencing, the split round, and the
fused one-launch tier with its winner-selection calibration, the
donor-snapshot join (`grow_fleet`), the write-ahead log (`attach_wal`,
`durable/wal.py`), `checkpoint`/`restore`/`recover`
(`core/checkpoint.py`), and mesh placement (`mesh=`, `parallel/`): the
replica axis sharded over the mesh rows, the exec round run per shard
with the cursor lattice joined on the host (`collectives='shmap'` or
`'gspmd'`), the mesh-fused tier (one fused launch per shard) and the
ring catch-up tier of `sync()`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import statistics
import time
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from node_replication_torch.analysis.locks import make_rlock
from node_replication_torch.core.log import (
    _FAR,
    LogSpec,
    WARN_ROUNDS,
    gather_window,
    log_append,
    log_catchup_all,
    log_exec_all,
    log_init,
    log_space,
    ring_slice,
    takes_union,
    union_merge,
    union_plan,
)
from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import COUNT_BUCKETS, get_registry
from node_replication_torch.ops.context import MAX_PENDING_OPS, Context
from node_replication_torch.ops.encoding import (
    Dispatch,
    apply_read,
    encode_ops,
)
from node_replication_torch.utils.checks import debug_checks
from node_replication_torch.utils.device import resolve_device
from node_replication_torch.utils.trace import get_tracer, span
from node_replication_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "MAX_PENDING_OPS", "MAX_THREADS_PER_REPLICA", "DEFAULT_EXEC_WINDOW",
    "NodeReplicated", "ReplicaToken", "ReplicaFencedError",
    "LogTooSmallError", "replicate_state", "states_equal",
]

logger = logging.getLogger("node_replication_torch")

# Max logical threads per replica (`nr/src/replica.rs:56`).
MAX_THREADS_PER_REPLICA = 256

# Default replay window per device round.
DEFAULT_EXEC_WINDOW = 256

# Fused-tier winner selection (`engine='auto'` + a fused-capable
# dispatch): per tier, the first WARMUP eligible rounds are off the
# books, the next SAMPLES rounds are timed, and the tier with the lower
# median commits. Both tiers run real rounds with identical results.
FUSED_CAL_WARMUP = 1
FUSED_CAL_SAMPLES = 2

# Reserved context key for `execute_mut_batch` response sinks.
BATCH_TID = -1


# Every device-to-host read of the combiner round goes through
# `_readback`: a `d2h` span around it and one count in `nr.d2h.reads`.
_m_d2h_reads = get_registry().counter("nr.d2h.reads")


def _readback(t: torch.Tensor) -> np.ndarray:
    """A round's device-to-host read: waits for the card. `.cpu()` is a
    C call with no Python frame, so this frame is what the sampling
    profiler (`obs/profile.py`) attributes to the `readback` stage."""
    with span("d2h"):
        out = t.cpu().numpy()
    _m_d2h_reads.inc()
    return out


def _read_cursors(ltails: torch.Tensor,
                  tail: torch.Tensor) -> tuple[np.ndarray, int]:
    """One readback of a log's `(ltails, tail)`."""
    cur = _readback(torch.cat([ltails, tail.reshape(1)]))
    return cur[:-1], int(cur[-1])


class _BatchSink:
    """Response sink for caller-assembled batches (`execute_mut_batch`):
    the response half of `Context` without the 32-slot pending ring."""

    __slots__ = ("_resps", "_inflight")

    def __init__(self) -> None:
        self._resps: list = []
        self._inflight = 0

    def expect(self, n: int) -> None:
        self._inflight += n

    def enqueue_resps(self, resps) -> None:
        self._inflight -= len(resps)
        self._resps.extend(resps)

    def take(self) -> list:
        out = self._resps
        self._resps = []
        return out

    def reset(self) -> None:
        """Discard delivered responses and the expectation count."""
        self._resps = []
        self._inflight = 0


class _PendingRound:
    """One combiner round between `begin` and `finish` (the split round
    protocol). After `begin` the batch is APPENDED; `finish` replays to
    the target (chain tier) or reads back the fused launch's responses.
    `done` marks a round `begin` already completed; `fused` a round the
    fused tier ran, eagerly or deferred, whose `finish` has yet to hit
    the `replay` fault site."""

    __slots__ = ("rid", "tids", "n", "pos0", "target",
                 "fused_resps", "done", "fused", "t_chain", "pad", "fkey",
                 "tier", "log_idx")

    def __init__(self, rid: int, tids: list[int], n: int, pos0: int,
                 log_idx: int = 0):
        self.rid = rid
        #: the log the round appended to (NodeReplicated's one log is 0)
        self.log_idx = log_idx
        self.tids = tids
        self.n = n
        self.pos0 = pos0
        self.target = pos0 + n
        #: device tensor of the fused launch awaiting readback
        self.fused_resps = None
        self.done = False
        self.fused = False
        self.t_chain: float | None = None
        self.pad = 0
        self.fkey: tuple = ()
        self.tier: str | None = None


def _read_answers(pending: _PendingRound) -> np.ndarray:
    """A fused round's answers to its replica: row `rid` of the launch's
    responses, read back (the wait for the card)."""
    resps, pending.fused_resps = pending.fused_resps, None
    return _readback(resps[pending.rid, :pending.n])


def hit_replay_site(pending: _PendingRound, owner) -> None:
    """The `replay` fault site of a fused round, hit once at its finish:
    where the chain tier hits it (its first exec round, the batch in
    the log), so an injected replay fault strikes a round whichever
    tier the calibration chose."""
    if pending.fused:
        pending.fused = False
        fault_hook("replay", -1, owner)


class ReplicaToken(NamedTuple):
    """Registration handle (`ReplicaToken`, `nr/src/replica.rs:27-30`)."""

    rid: int
    tid: int


class LogTooSmallError(RuntimeError):
    """A single batch exceeds the log's appendable capacity."""


class ReplicaFencedError(RuntimeError):
    """The operation targets a fenced (quarantined) replica."""

    def __init__(self, rid: int):
        super().__init__(
            f"replica {rid} is fenced (quarantined); repair and "
            f"unfence it before routing operations to it"
        )
        self.rid = rid


# Locked methods emit trace events and update instruments; the tracer
# and instrument handles come from module-level get_* accessors the
# analyzer cannot type through, so the nesting is declared:
# nrcheck: lock-order NodeReplicated._lock -> Tracer._lock — locked methods emit trace events
# nrcheck: lock-order MultiLogReplicated._lock -> Tracer._lock — CNR locked methods emit trace events
# nrcheck: lock-order NodeReplicated._lock -> Counter._lock — locked methods bump counters
# nrcheck: lock-order MultiLogReplicated._lock -> Counter._lock — CNR locked methods bump counters
# nrcheck: lock-order NodeReplicated._lock -> Histogram._lock — locked methods observe durations
# nrcheck: lock-order MultiLogReplicated._lock -> Histogram._lock — CNR locked methods observe durations
# nrcheck: lock-order NodeReplicated._lock -> WriteAheadLog._lock — the combiner round journals the batch into the attached WAL
# nrcheck: lock-order MultiLogReplicated._lock -> WriteAheadLog._lock — same journaling through the CNR wrapper
def _locked(fn):
    """Run a method under the instance's reentrant combiner lock,
    timing contended acquisitions into `nr.lock.wait_s` when metrics
    are on (the reference's `_locked`)."""
    reg = get_registry()
    m_wait = reg.histogram("nr.lock.wait_s")

    @functools.wraps(fn)
    def inner(self, *args, **kwargs):
        lock = self._lock
        if not reg.enabled:
            with lock:
                return fn(self, *args, **kwargs)
        if not lock.acquire(blocking=False):
            t0 = time.monotonic()
            lock.acquire()
            m_wait.observe(time.monotonic() - t0)
        try:
            return fn(self, *args, **kwargs)
        finally:
            lock.release()

    return inner


def replicate_state(state, n_replicas: int):
    """Stack one replica state into an [R, ...] lock-step fleet: R real
    copies (never a broadcast view, which would alias every replica)."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((n_replicas,) + tuple(x.shape))
        .clone(memory_format=torch.contiguous_format),
        state,
    )


def states_equal(states) -> bool:
    """All replicas of an [R, ...] state tree are bit-identical."""
    return all(bool((leaf == leaf[0:1]).all())
               for leaf in tree_leaves(states))


class _FusedTier:
    """The combiner-round protocol both wrappers run (`_begin_round`,
    `_finish_round`), each round on one log, and the fused-tier plumbing
    (the reference's `_FusedTier`): lazy spec-bound engine construction,
    the calibration sampler, and the winner-selection state machine.
    All methods run under the host's combiner lock.

    A wrapper supplies what differs: where a round's log is read from
    and written to (`_round_log`, `_set_round_log`), who is owed
    responses (`_owes_responses`, `_owe_responses`), where an answer
    goes (`_deliver_answers`), the chain's replay round (`_chain_round`,
    `_round_ltail`) and its own counters (`_count_round`,
    `_count_appended`). NodeReplicated's one log is log 0; the fence
    mask, the WAL and the debug checks are its own, and None (off) on
    MultiLogReplicated."""

    _fenced: np.ndarray | None = None
    _wal = None
    debug = False

    def _round_spec(self) -> LogSpec:
        """The spec of one log, which every round's log shares."""
        return self.spec

    def _fused_fence_key(self) -> tuple:
        """Calibration key for the CURRENT quarantine mask: the sorted
        fenced rids (empty when none). Fused and chain timings are only
        comparable under the same mask."""
        f = self._fenced
        if f is None:
            return ()
        return tuple(int(r) for r in np.where(f)[0])

    def _is_fenced(self, rid: int) -> bool:
        f = self._fenced
        return f is not None and bool(f[rid])

    def _init_fused_tier(self, engine: str, dispatch, reg, prefix: str,
                         debug: bool = False, mesh=None,
                         mesh_fused: bool = False) -> None:
        """`engine='pallas'` FORCES the tier (the model must carry a
        `fused_factory`; debug checks have no fused twin; on a mesh the
        host must run the mesh-fused composition, `mesh_fused=True`,
        NodeReplicated only); `engine='auto'` with a fused-capable
        dispatch arms the measured calibration on a CUDA device (the
        reference arms it on a TPU; NR_TPU_FUSED_CAL=1 is the CPU-test
        hook); otherwise off."""
        self._fused = None
        self._fused_spec = None
        self._fused_mode = "off"
        self._fused_choice: bool | None = False
        self._fused_verdicts: dict[tuple, bool] = {}
        self._fused_mesh = mesh if mesh_fused else None
        self._fused_tier_name = (
            "mesh_fused" if self._fused_mesh is not None
            else "pallas_fused"
        )
        self._fused_samples: dict[str, dict[tuple, list]] = {
            "pallas_fused": {}, "chain": {},
        }
        self._fused_rounds = 0
        self.last_round_tier: str | None = None
        self._tier_by_rid: dict[int, str] = {}
        self._pos_by_rid: dict[int, int] = {}
        self._m_engine_fused = reg.counter(
            f"{prefix}.exec.engine.pallas_fused"
        )
        self._m_fused_fallback = reg.counter(
            f"{prefix}.exec.engine.fused_fallback"
        )
        # the fallbacks the owed-response test alone sends to the chain
        self._m_fused_fallback_inflight = reg.counter(
            f"{prefix}.exec.engine.fused_fallback.inflight"
        )
        if engine == "pallas":
            if dispatch.fused_factory is None:
                raise ValueError(
                    f"engine='pallas' but {dispatch.name} has no "
                    f"fused_factory (no fused kernel for this model)"
                )
            if mesh is not None and not mesh_fused:
                raise ValueError(
                    "engine='pallas' does not take mesh= here (the "
                    "mesh-fused composition is NodeReplicated-only; "
                    "the CNR per-log tier runs un-meshed)"
                )
            if debug:
                raise ValueError(
                    "engine='pallas' has no debug-check twin; use "
                    "debug=False (the fused round replays inside the "
                    "kernel, outside the checks' reach)"
                )
            spec = self._round_spec()
            self._fused = self._build_fused_engine(spec)
            self._fused_spec = spec
            self._fused_mode = "forced"
            self._fused_choice = True
        elif (
            engine == "auto"
            and dispatch.fused_factory is not None
            and (mesh is None or mesh_fused)
            and not debug
            and (self.device.type == "cuda"
                 or os.environ.get("NR_TPU_FUSED_CAL") == "1")
        ):
            self._fused_mode = "auto"
            self._fused_choice = None  # calibration pending

    def _build_fused_engine(self, spec: LogSpec):
        """The dispatch's own fused engine un-meshed, the per-shard
        `MeshFusedEngine` on a mesh; both raise ValueError for an
        unsupported config."""
        if self._fused_mesh is not None:
            from node_replication_torch.parallel.collectives import (
                MeshFusedEngine,
            )

            return MeshFusedEngine(self.dispatch, spec, self._fused_mesh)
        return self.dispatch.fused_factory(spec, device=self.device)

    def _fused_engine(self):
        """Lazily (re)build the tier's engine for the CURRENT spec; a
        factory rejection degrades the tier to off with a warning."""
        if self._fused_mode == "off":
            return None
        spec = self._round_spec()
        if self._fused is None or self._fused_spec != spec:
            try:
                self._fused = self._build_fused_engine(spec)
                self._fused_spec = spec
            except ValueError as e:
                logger.warning(
                    "fused engine rejected spec (%s); falling back to "
                    "the ordinary chain", e
                )
                self._fused_mode = "off"
                self._fused_choice = False
                return None
        return self._fused

    def _fused_calibrating(self, fkey: tuple | None = None) -> bool:
        """Auto mode with no committed verdict for the CURRENT fence
        mask. A fenced mask whose engine has no fenced variant commits
        `chain` at once (nothing to measure)."""
        if self._fused_mode != "auto":
            return False
        if fkey is None:
            fkey = self._fused_fence_key()
        if self._fused_verdicts.get(fkey) is not None:
            return False
        if fkey:
            eng = self._fused_engine()
            if eng is None or not eng.supports_fenced:
                self._fused_verdicts[fkey] = False
                get_tracer().emit(
                    "fused-calibration", window=0, fenced=list(fkey),
                    tier=self._fused_tier_name,
                    devices=getattr(eng, "devices", 1),
                    fused_s=0.0, chain_s=0.0, winner="chain",
                    reason="no-fenced-variant",
                )
                return False
        return True

    def _fused_tier_wanted(self, pad: int, fkey: tuple | None = None):
        """The engine to route a `pad`-window round through, or None
        for the ordinary chain. During calibration the chain goes first
        at each (window, fence-mask) key."""
        if self._fused_mode == "off" or self._fused_choice is False:
            return None
        if self._fused_mode == "auto":
            if fkey is None:
                fkey = self._fused_fence_key()
            verdict = self._fused_verdicts.get(fkey)
            if verdict is False:
                return None
            if verdict is None:
                need = FUSED_CAL_WARMUP + FUSED_CAL_SAMPLES
                chain = self._fused_samples["chain"].get(
                    (pad, fkey), ()
                )
                if len(chain) < need:
                    return None
        return self._fused_engine()

    def _note_fused_sample(self, tier: str, pad: int, dt: float,
                           fkey: tuple = ()) -> None:
        need = FUSED_CAL_WARMUP + FUSED_CAL_SAMPLES
        key = (pad, tuple(fkey))
        samples = self._fused_samples[tier].setdefault(key, [])
        if len(samples) < need:
            samples.append(dt)
        chain = self._fused_samples["chain"].get(key, ())
        fused = self._fused_samples["pallas_fused"].get(key, ())
        if len(chain) < need or len(fused) < need:
            return
        med_c = statistics.median(chain[FUSED_CAL_WARMUP:])
        med_f = statistics.median(fused[FUSED_CAL_WARMUP:])
        verdict = med_f <= med_c
        self._fused_verdicts[tuple(fkey)] = verdict
        get_tracer().emit(
            "fused-calibration", window=pad, fenced=list(fkey),
            tier=self._fused_tier_name,
            devices=getattr(self._fused, "devices", 1),
            fused_s=med_f, chain_s=med_c,
            winner=(self._fused_tier_name if verdict else "chain"),
        )

    def _reset_fused_calibration(self) -> None:
        """Fleet-shape change under engine='auto': the committed
        verdicts were measured at the OLD (R, capacity) point — drop
        them and recalibrate at the new one."""
        if self._fused_mode == "auto":
            self._fused_verdicts = {}
            self._fused_samples = {"pallas_fused": {}, "chain": {}}

    def round_tier(self, rid: int) -> str | None:
        """The engine tier that served replica `rid`'s latest round."""
        return self._tier_by_rid.get(rid)

    def round_pos(self, rid: int) -> int | None:
        """The log position replica `rid`'s latest round appended at."""
        return self._pos_by_rid.get(rid)

    def _fused_tier_state(self) -> str:
        if self._fused_mode == "off":
            return "off"
        if self._fused_mode == "forced":
            return "forced"
        verdict = self._fused_verdicts.get(self._fused_fence_key())
        if verdict is None:
            return "calibrating"
        return (
            f"auto:{self._fused_tier_name}" if verdict else "auto:chain"
        )

    # ------------------------------------------------- the combiner round

    @_locked
    def _begin_round(self, log_idx: int, ops: list[tuple], rid: int,
                     tids: list[int], batch: bool = False,
                     defer: bool = False) -> _PendingRound:
        """First half of the combiner-round protocol on log `log_idx`:
        fence guard, append-site fault hook, help GC until the batch
        fits, encode + append (or launch the fused round), record
        in-flight response destinations. `defer=True` leaves the
        replay-to-target (or the fused readback) for `_finish_round`;
        calibration rounds ignore it."""
        if self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        fault_hook("append", rid, self)
        n = len(ops)
        spec = self._round_spec()
        max_batch = spec.capacity - spec.gc_slack
        if n > max_batch:
            raise LogTooSmallError(
                f"batch of {n} exceeds appendable capacity {max_batch}"
            )
        self._count_round(log_idx)
        self._m_batch.observe(n)
        rounds = 0
        log = self._round_log(log_idx)
        while max_batch - int(_readback(log.tail - log.head)) < n:
            rounds = self._chain_round(log_idx, rounds, "append-gc")
            log = self._round_log(log_idx)

        pos0 = int(_readback(log.tail))
        pad = 1 << (max(n, 1) - 1).bit_length()
        at = self._log_attrs(log_idx)
        with span("encode", **at):
            opcodes, args, _ = encode_ops(
                ops, spec.arg_width, pad_to=pad, device=self.device
            )
        fkey = self._fused_fence_key()
        timing = self._fused_calibrating(fkey)
        pending = _PendingRound(rid, list(tids), n, pos0, log_idx)
        pending.pad = pad
        pending.fkey = fkey
        if self._fused_round(pending, log, ops, opcodes, args,
                             defer and not timing):
            return pending
        if timing:
            pending.t_chain = time.perf_counter()
        extra = {"batch": True} if batch else {}
        with span("append", **at, rid=rid, n=n, pos0=pos0, **extra) as sp:
            with debug_checks(self.debug):
                log = log_append(spec, log, opcodes, args, n)
            self._set_round_log(log_idx, log)
            sp.fence(log)
        if self._wal is not None:
            # WAL write AFTER the device append, under the same lock: a
            # record exists only for ops that ARE in the in-memory log
            self._wal.append(pos0, ops)
        self._count_appended(n)
        self._owe_responses(log_idx, rid, pos0, tids)
        return pending

    def _fused_round(self, pending: _PendingRound, log, ops, opcodes,
                     args, defer: bool) -> bool:
        """Route the round through the fused engine when eligible (every
        live cursor of its log at the pre-append tail, no responses
        owed on that log, a supported window); False falls back to the
        append+exec chain. Results are bit-identical either way. With
        `defer` the kernel is launched here and the response readback
        waits for `_finish_round`."""
        log_idx, rid, n = pending.log_idx, pending.rid, pending.n
        pos0, pad, fkey = pending.pos0, pending.pad, pending.fkey
        eng = self._fused_tier_wanted(pad, fkey)
        if eng is None:
            return False
        fenced = self._fenced
        if (fenced is not None and not eng.supports_fenced) \
                or not eng.supports(pad):
            self._m_fused_fallback.inc()
            return False
        if self._owes_responses(log_idx):
            self._m_fused_fallback.inc()
            self._m_fused_fallback_inflight.inc()
            return False
        lts, tail = _read_cursors(log.ltails, log.tail)
        live = lts if fenced is None else lts[~fenced]
        if not (live.size
                and int(live.min()) == tail == int(live.max())):
            self._m_fused_fallback.inc()
            return False
        timing = self._fused_calibrating(fkey)
        t0 = time.perf_counter()
        extra = {"deferred": True} if defer else {}
        if eng.tier == "mesh_fused":
            extra["devices"] = eng.devices
        with span("fused-round", **self._log_attrs(log_idx), rid=rid, n=n,
                  pos0=pos0, window=pad, **extra) as sp:
            if self._placed is not None:  # one launch a mesh shard
                self._placed, resps = eng.round(
                    self._placed, opcodes, args, n, fenced=fenced)
            else:
                log, self.states, resps = eng.round(
                    log, self.states, opcodes, args, n, fenced=fenced)
                self._set_round_log(log_idx, log)
            pending.fused_resps = resps
            if not defer:
                # the response readback is also the round's host
                # fence; only replica `rid`'s row is delivered
                resps_np = _read_answers(pending)
                sp.fence(*self._fleet_trees())
        if timing:
            self._note_fused_sample(
                "pallas_fused", pad, time.perf_counter() - t0, fkey
            )
        if self._wal is not None:
            # same order as the chain: journal once the ops ARE in the
            # in-memory log, before any response is delivered
            self._wal.append(pos0, ops)
            if fenced is None or not fenced.any():
                floor = pos0 + n
            else:
                floor = min(int(lts[fenced].min()), pos0 + n)
            self._wal.maybe_reclaim(floor)
        self._fused_rounds += 1
        self._m_engine_fused.inc()
        if eng.tier == "mesh_fused":
            # a mesh round by tier, next to the shmap/gspmd chain rounds
            self._m_mesh_fused_round.inc()
        self._count_appended(n)
        pending.fused = True
        pending.tier = eng.tier
        if not defer:
            pending.done = True  # ran eagerly end to end
            self._hand_out(pending, resps_np)
        return True

    def _hand_out(self, pending: _PendingRound, resps_np) -> None:
        """Deliver a fused round's answers, read back, to their threads
        and record the round's tier."""
        with span("deliver", **self._log_attrs(pending.log_idx)):
            self._deliver_answers(pending.rid, pending.tids, resps_np)
        self._record_tier(pending, pending.tier)

    def _record_tier(self, pending: _PendingRound, tier: str) -> None:
        self.last_round_tier = tier
        self._tier_by_rid[pending.rid] = tier
        self._pos_by_rid[pending.rid] = pending.pos0

    @_locked
    def _finish_round(self, pending: _PendingRound) -> None:
        """Second half of the protocol: replay the round's log until
        replica `rid` has applied its own ops (chain tier), or read back
        and deliver the fused launch's responses."""
        hit_replay_site(pending, self)
        if pending.done:
            return
        pending.done = True
        rid, log_idx = pending.rid, pending.log_idx
        if self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        if pending.fused_resps is not None:
            self._hand_out(pending, _read_answers(pending))
            return
        target = pending.target
        rounds = 0
        with span("combine-replay", **self._log_attrs(log_idx), rid=rid,
                  target=target) as sp:
            while self._round_ltail(log_idx, rid) < target:
                rounds = self._chain_round(log_idx, rounds,
                                           "combine-replay")
            sp.fence(*self._fleet_trees())
        self._record_tier(pending, self.engine)
        if pending.t_chain is not None:
            self._note_fused_sample("chain", pending.pad,
                                    time.perf_counter()
                                    - pending.t_chain, pending.fkey)

    @_locked
    def _append_and_replay(self, log_idx: int, ops: list[tuple], rid: int,
                           tids: list[int], batch: bool = False) -> None:
        """`_begin_round` + `_finish_round` back to back."""
        self._finish_round(
            self._begin_round(log_idx, ops, rid, tids, batch=batch)
        )

    # hooks whose default is NodeReplicated's

    def _log_attrs(self, log_idx: int) -> dict:
        """The round's log, as its spans name it."""
        return {}

    def _count_round(self, log_idx: int) -> None:
        """Count a combiner round on log `log_idx` as it begins."""

    def _count_appended(self, n: int) -> None:
        """Count `n` entries appended by a round."""


class NodeReplicated(_FusedTier):
    """N replicas of one `Dispatch` data structure behind a shared log.

    `device=None` runs on the card (`torch.device("cuda")`) and raises
    without one; pass `device="cpu"` to run on the CPU. With `mesh=`
    (a `parallel.Mesh`, a shard count, or a `ReplicaStrategy`) the
    fleet is placed over the mesh rows and `device` is the home device,
    mesh row 0's; `log` and `states` read as the global view there.
    """

    def __init__(
        self,
        dispatch: Dispatch,
        n_replicas: int = 1,
        log_entries: int | None = None,
        gc_slack: int | None = None,
        exec_window: int = DEFAULT_EXEC_WINDOW,
        gc_callback: Callable[[int, int], None] | None = None,
        debug: bool | None = None,
        engine: str = "auto",
        mesh=None,
        collectives: str = "auto",
        device=None,
    ):
        if mesh is not None:
            from node_replication_torch.parallel.mesh import (
                ReplicaStrategy,
                replica_mesh,
                row_devices,
            )

            if isinstance(mesh, int):
                mesh = replica_mesh(mesh)
            elif isinstance(mesh, ReplicaStrategy):
                mesh = replica_mesh(strategy=mesh)
            if "replica" not in mesh.axis_names:
                raise ValueError(
                    f"mesh {mesh.axis_names} has no 'replica' axis"
                )
            home = row_devices(mesh)[0]
            if device is not None and resolve_device(device) != home:
                raise ValueError(
                    f"device={device!r} is not the mesh's home device "
                    f"{home} (mesh row 0's)"
                )
            device = home
        self.device = resolve_device(device)
        # un-meshed fleet; `_placed` (parallel/mesh.py) replaces both
        # once the fleet is placed over a mesh
        self._log = self._states = None
        self._placed = None
        kw = {}
        if log_entries is not None:
            kw["capacity"] = log_entries
        if gc_slack is not None:
            kw["gc_slack"] = gc_slack
        self.spec = LogSpec(
            n_replicas=n_replicas, arg_width=dispatch.arg_width, **kw
        )
        self.dispatch = dispatch
        self.exec_window = int(exec_window)
        self.gc_callback = gc_callback
        # `debug` arms the host-side cursor invariants (utils/checks.py)
        # around every append and replay call; None defers to the
        # NR_TPU_DEBUG env var
        if debug is None:
            from node_replication_torch.utils.checks import debug_default

            debug = debug_default()
        self.debug = bool(debug)

        # built before the first state write: the `log`/`states`
        # setters take it
        self._lock = make_rlock("NodeReplicated._lock")
        self.log = log_init(self.spec, self.device)
        self.states = replicate_state(dispatch.init_state(self.device),
                                      n_replicas)

        self._contexts: dict[tuple[int, int], Context] = {}
        self._threads_per_replica = [0] * n_replicas
        # appended-but-unanswered ops per replica: deque[(pos, tid)]
        self._inflight: list[deque] = [deque() for _ in range(n_replicas)]
        # at most ONE begun-but-unfinished split round per replica
        self._pending_batch: dict[int, _PendingRound] = {}
        # quarantine mask: None until the first fence_replica
        self._fenced: np.ndarray | None = None
        self._exec_rounds = 0
        self._idle_rounds = 0
        # write-ahead log (`durable/wal.py`): None costs one branch per
        # round
        self._wal = None

        reg = get_registry()
        self._m_rounds = reg.counter("nr.exec.rounds")
        self._m_idle = reg.counter("nr.exec.idle_rounds")
        self._m_batch = reg.histogram("nr.combine.batch_size",
                                      buckets=COUNT_BUCKETS)
        self._m_stalls = reg.counter("nr.watchdog.stalls")
        self._m_lag = reg.histogram("nr.replica.lag",
                                    buckets=COUNT_BUCKETS)

        if engine not in ("auto", "combined", "scan", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        if (dispatch.window_plan is None) != (
            dispatch.window_merge is None
        ):
            raise ValueError(
                f"{dispatch.name}: window_plan and window_merge come "
                f"as a pair (got only one)"
            )
        has_any_combined = (
            dispatch.window_apply is not None
            or dispatch.window_plan is not None
        )
        if engine == "combined" and not has_any_combined:
            raise ValueError(
                f"engine='combined' but {dispatch.name} has no "
                f"window_apply or window_plan"
            )
        auto_combined = (
            dispatch.window_apply is not None
            or (dispatch.window_plan is not None
                and dispatch.window_canonical)
        )
        use_combined = (
            auto_combined if engine in ("auto", "pallas")
            else engine == "combined"
        )
        self.engine = "combined" if use_combined else "scan"
        # engine='combined' asserts the union-tier contract; 'auto'
        # defers to the model's own window_canonical opt-in
        self._union = True if engine == "combined" else None
        self._m_engine = reg.counter(f"nr.exec.engine.{self.engine}")

        # mesh placement (`parallel/`): states and ltails shard over the
        # mesh's 'replica' rows, the ring planes and scalar cursors are
        # copied per device. `collectives` picks the exec tier: 'shmap'
        # = the scan exec on each shard (`make_shmap_exec`), 'gspmd' =
        # the wrapper's own engine exec on each shard, 'auto' = gspmd
        # for the combined engine or debug checks, else shmap. Both join
        # the cursor lattice on the host.
        if collectives not in ("auto", "shmap", "gspmd"):
            raise ValueError(f"unknown collectives tier {collectives!r}")
        self.mesh = None
        self._mesh_shards = 0
        self._mesh_tier = None
        self._ring_rounds = 0
        self._shmap_cache: dict = {}
        self._ring_fn = None
        if mesh is not None:
            from node_replication_torch.parallel.mesh import (
                announce_placement,
            )

            shards = mesh.shape["replica"]
            if n_replicas % shards:
                raise ValueError(
                    f"R={n_replicas} replicas cannot shard over "
                    f"{shards} mesh shards"
                )
            if collectives == "auto":
                tier = (
                    "gspmd"
                    if (self.engine == "combined" or self.debug)
                    else "shmap"
                )
            else:
                tier = collectives
            if tier == "shmap" and self.debug:
                raise ValueError(
                    "collectives='shmap' has no debug-check twin; use "
                    "the gspmd tier (or debug=False) on a mesh"
                )
            self.mesh = mesh
            self._mesh_shards = shards
            self._mesh_tier = tier
            self._m_mesh_round = reg.counter(f"nr.exec.mesh.{tier}")
            self._m_mesh_sync_bytes = reg.counter("mesh.sync_bytes")
            self._m_mesh_dur = reg.histogram("mesh.round.duration_s")
            self._m_ring = reg.counter("nr.exec.engine.ring")
            self._m_mesh_fused_round = reg.counter(
                "nr.exec.mesh.mesh_fused"
            )
            announce_placement(mesh, n_replicas, "NodeReplicated", tier)
        self._init_fused_tier(engine, dispatch, reg, "nr",
                              debug=self.debug, mesh=self.mesh,
                              mesh_fused=True)
        self._place_on_mesh()

    # -------------------------------------------------------- placement

    @property
    def log(self):
        """The log (on a mesh: the global view on the home device)."""
        return self._log if self._placed is None else self._placed.log

    @log.setter
    @_locked
    def log(self, log) -> None:
        if self._placed is None:
            self._log = log
        else:
            self._placed = self._placed.with_log(log)

    @property
    def states(self):
        """The replica states (on a mesh: the global view on the home
        device, one copy of every shard's rows)."""
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
            return (self._log, self._states)
        return tuple(self._placed.trees())

    @_locked
    def _place_on_mesh(self) -> None:
        """Place the un-meshed fleet over the mesh (construction, and
        after `grow_fleet` changes the shard rows); a new placement is a
        new (R, capacity, devices) point, so an auto-mode verdict is
        recalibrated. No-op un-meshed."""
        if self.mesh is None:
            return
        from node_replication_torch.parallel.mesh import place

        self._placed = place(self._log, self._states, self.mesh)
        self._log = self._states = None
        self._reset_fused_calibration()

    def _shard_spec(self) -> LogSpec:
        return dataclasses.replace(
            self.spec, n_replicas=self.n_replicas // self._mesh_shards)

    @_locked
    def _shmap_fn(self, window: int, fenced: bool):
        """Build-once cache of the explicit-collective exec
        (`parallel/collectives.py:make_shmap_exec`), keyed (window,
        fenced)."""
        fn = self._shmap_cache.get((window, fenced))
        if fn is None:
            from node_replication_torch.parallel.collectives import (
                make_shmap_exec,
            )

            fn = make_shmap_exec(self.dispatch, self.spec, self.mesh,
                                 window, fenced=fenced)
            self._shmap_cache[(window, fenced)] = fn
        return fn

    @_locked
    def _mesh_exec(self, fenced, window: int, ltails: np.ndarray):
        """One replay round over a placed fleet: the shmap exec, or the
        wrapper's own engine exec on each shard (gspmd); the lattice is
        joined across shards. `ltails` are the round's cursors, read
        back. Returns the global responses."""
        if self._mesh_tier == "shmap":
            extra = () if fenced is None else (fenced,)
            self._placed, resps = self._shmap_fn(
                window, fenced is not None)(self._placed, *extra)
            return resps
        from node_replication_torch.parallel.collectives import (
            sharded_exec,
        )

        spec, d = self._shard_spec(), self.dispatch
        if self.engine == "combined" and takes_union(d, self._union):
            return self._mesh_union(fenced, window, ltails)

        def shard_exec(sh, fen):
            if self.engine == "combined":
                lg, st, r = log_catchup_all(
                    spec, d, sh.log, sh.states, window, union=self._union,
                    fenced=fen, idle_check=False,
                )
            else:
                lg, st, r = log_exec_all(spec, d, sh.log, sh.states, window,
                                         fenced=fen)
            return lg.ltails, st, r

        self._placed, resps = sharded_exec(self._placed, shard_exec,
                                           fenced)
        return resps

    @_locked
    def _mesh_union(self, fenced, window: int, ltails: np.ndarray):
        """The gspmd tier's union round: the un-meshed round's window
        `[m, end)` with `m` the GLOBAL least live cursor (joined on the
        host), planned once on the donor's shard and its plan copied to
        every other shard, each of which merges it into its replicas.
        A shard's own least cursor would start its window later, and
        its replicas would end the round further ahead than the
        reference's."""
        placed = self._placed
        masked = ltails if self._fenced is None else np.where(
            self._fenced, _FAR, ltails)
        donor = int(np.argmin(masked))
        s, local = placed.shard_of(donor)
        src = placed.shards[s]
        m = torch.tensor(int(masked[donor]), dtype=torch.int64,
                         device=src.device)
        end, plan = union_plan(self._shard_spec(), self.dispatch, src.log,
                               src.states, window, m, local)

        def shard_exec(sh, fen):
            def to(x):
                return x.to(sh.device)

            lg, st, r = union_merge(self.dispatch, sh.log, sh.states,
                                    window, to(m), to(end),
                                    tree_map(to, plan), fenced=fen)
            return lg.ltails, st, r

        from node_replication_torch.parallel.collectives import (
            sharded_exec,
        )

        self._placed, resps = sharded_exec(placed, shard_exec, fenced)
        return resps

    # ------------------------------------------------------------ calls

    def _round_window(self, pending: int) -> int:
        """The window one replay round runs. `pending` is the largest
        lag of a live replica (host cursors). The scan engine stops
        there instead of running the rest of the static `exec_window`
        as NOOPs (the reference's `_exec_jit` always runs it all): the
        NOOPs change no cursor, state or delivered response, since
        responses past a replica's lag are never read. The combined
        engine runs the static window, as the reference does."""
        if self.engine == "combined":
            return self.exec_window
        return max(1, min(self.exec_window, pending))

    def _exec_call(self, fenced, window: int):
        """One replay round over the fleet (the reference's
        `_exec_jit`/`_exec_fenced_jit`) over `window` entries."""
        if self.engine == "combined":
            return log_catchup_all(
                self.spec, self.dispatch, self.log, self.states,
                window, union=self._union, fenced=fenced,
                idle_check=False,
            )
        return log_exec_all(self.spec, self.dispatch, self.log,
                            self.states, window, fenced=fenced)

    # -------------------------------------------------------------- API

    @property
    def n_replicas(self) -> int:
        return self.spec.n_replicas

    def _ltails_host(self) -> np.ndarray:
        return _readback(self.log.ltails)

    @_locked
    def ltail(self, rid: int) -> int:
        """Replica `rid`'s applied cursor (host int)."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        return int(self._ltails_host()[rid])

    def replica_device(self, rid: int) -> torch.device:
        """The device holding replica `rid`'s state: its mesh shard's
        (the first device of its mesh row; rows split the replica axis
        into contiguous blocks), or the fleet's one device un-meshed
        (the reference returns None there)."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._placed is None:
            return self.device
        return self._placed.shards[self._placed.shard_of(rid)[0]].device

    @_locked
    def register(self, rid: int = 0) -> ReplicaToken:
        """Register a logical thread on replica `rid`."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        tid = self._threads_per_replica[rid]
        if tid >= MAX_THREADS_PER_REPLICA:
            raise RuntimeError(
                f"replica {rid} already has {MAX_THREADS_PER_REPLICA} "
                f"threads"
            )
        self._threads_per_replica[rid] = tid + 1
        self._contexts[(rid, tid)] = Context()
        return ReplicaToken(rid, tid)

    @_locked
    def grow_fleet(self, k: int = 1, donor: int | None = None,
                   catch_up: bool = True) -> list[int]:
        """Dynamic replica registration: add `k` replicas to a LIVE
        instance and return their new rids (the reference's
        `grow_fleet`, `core/replica.py:952`).

        Each newcomer CLONES the most caught-up unfenced replica's
        state — a consistent snapshot at exactly `ltails[donor]` —
        inherits that cursor, and catches up through the ordinary exec
        loop, so a join is valid at any point of the log's lifetime,
        wraps included. Existing tokens stay valid; `head` is unchanged
        (the newcomer's ltail is >= min(ltails)). The fused engine is
        spec-bound (R, capacity): it is dropped, to be rebuilt for
        R + k at the next round, and an auto-mode verdict is
        recalibrated.
        """
        if k < 1:
            raise ValueError("grow_fleet needs k >= 1")
        R = self.n_replicas
        if self.mesh is not None and (R + k) % self._mesh_shards:
            # validated BEFORE any state mutates: an indivisible fleet
            # cannot keep the mesh rows balanced
            raise ValueError(
                f"grown fleet of {R + k} replicas cannot shard over "
                f"{self._mesh_shards} mesh shards (grow in multiples "
                f"of the shard count)"
            )
        ltails = self._ltails_host()
        if donor is None:
            # never clone from a fenced (possibly corrupt) replica
            masked = (
                ltails if self._fenced is None
                else np.where(self._fenced, -1, ltails)
            )
            donor = int(np.argmax(masked))
        elif not 0 <= donor < R:
            raise ValueError(f"donor replica {donor} out of range")
        elif self._is_fenced(donor):
            raise ReplicaFencedError(donor)
        donor_ltail = int(ltails[donor])

        self.spec = dataclasses.replace(self.spec, n_replicas=R + k)
        states = tree_map(
            lambda x: torch.cat(
                [x, x[donor:donor + 1].expand((k,) + tuple(x.shape[1:]))],
                dim=0,
            ),
            self.states,
        )
        log = self.log._replace(
            ltails=torch.cat([
                self.log.ltails,
                torch.full((k,), donor_ltail, dtype=torch.int64,
                           device=self.device),
            ])
        )
        # the mesh rows change with R: unplace, then place anew
        self._placed = None
        self._log, self._states = log, states
        self._threads_per_replica.extend([0] * k)
        self._inflight.extend(deque() for _ in range(k))
        if self._fenced is not None:
            self._fenced = np.concatenate(
                [self._fenced, np.zeros(k, bool)]
            )
        self._fused = None
        self._shmap_cache = {}
        self._reset_fused_calibration()
        self._place_on_mesh()
        new_rids = list(range(R, R + k))
        get_tracer().emit(
            "grow_fleet", k=k, donor=donor, donor_ltail=donor_ltail,
            n_replicas=R + k,
        )
        if catch_up:
            for rid in new_rids:
                self.sync(rid)
        return new_rids

    # --------------------------------------------------------- fencing

    @property
    def fenced_rids(self) -> list[int]:
        f = self._fenced
        return [] if f is None else [int(r) for r in np.where(f)[0]]

    @_locked
    def fence_replica(self, rid: int) -> None:
        """Fence `rid` out of the fleet: its replay freezes and GC skips
        it; its in-flight responses are dropped (crash semantics).
        Idempotent."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._fenced is None:
            self._fenced = np.zeros(self.n_replicas, bool)
        if self._fenced[rid]:
            return
        self._fenced[rid] = True
        self._inflight[rid] = deque()
        sink = self._contexts.get((rid, BATCH_TID))
        if sink is not None:
            sink.reset()
        stale = self._pending_batch.pop(rid, None)
        if stale is not None:
            stale.done = True
            stale.fused_resps = None
        get_tracer().emit(
            "fault-fence", rid=rid, ltail=int(self._ltails_host()[rid]),
        )

    @_locked
    def unfence_replica(self, rid: int) -> None:
        """Readmit `rid` to replay and GC accounting (re-seat it with
        `clone_replica_from` first). Idempotent."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._fenced is None or not self._fenced[rid]:
            return
        self._fenced[rid] = False
        if not self._fenced.any():
            self._fenced = None  # restore the no-mask hot path
        get_tracer().emit("fault-unfence", rid=rid)

    @_locked
    def clone_replica_from(self, rid: int,
                           donor: int | None = None) -> tuple[int, int]:
        """Overwrite replica `rid`'s state and cursor with a copy of a
        healthy donor's (default: the most caught-up unfenced replica).
        Returns `(donor, donor_ltail)`."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        ltails = self._ltails_host()
        eligible = np.ones(self.n_replicas, bool)
        eligible[rid] = False
        if self._fenced is not None:
            eligible &= ~self._fenced
        if donor is None:
            if not eligible.any():
                raise RuntimeError(
                    "no healthy donor replica available (all fenced)"
                )
            masked = np.where(eligible, ltails, -1)
            donor = int(np.argmax(masked))
        elif donor == rid or not 0 <= donor < self.n_replicas:
            raise ValueError(f"bad donor replica {donor}")
        elif self._is_fenced(donor):
            raise ReplicaFencedError(donor)
        donor_ltail = int(ltails[donor])

        def copy_row(x):
            x = x.clone()
            x[rid] = x[donor]
            return x

        self.states = tree_map(copy_row, self.states)
        lt = self.log.ltails.clone()
        lt[rid] = donor_ltail
        self.log = self.log._replace(ltails=lt)
        self._inflight[rid] = deque()
        get_tracer().emit(
            "fault-clone", rid=rid, donor=donor, donor_ltail=donor_ltail,
        )
        return donor, donor_ltail

    # ------------------------------------------- durability (durable/)

    @property
    def wal(self):
        """The attached write-ahead log (None when not durable)."""
        return self._wal

    @_locked
    def attach_wal(self, wal, backfill: bool = True) -> None:
        """Attach a `durable/wal.py:WriteAheadLog`: every later
        combiner append is persisted into it (fsync per its policy),
        and the exec loop drives segment reclamation from GC-head
        progress. `backfill=True` persists the entries the ring holds
        past the WAL's tail (`[wal.tail, tail)`, `core/log.py:
        ring_slice`); a WAL ahead of the log is refused."""
        if self._wal is not None:
            raise RuntimeError("a WAL is already attached")
        tail = int(self.log.tail)
        wal_tail = wal.tail
        if wal_tail > tail:
            raise ValueError(
                f"WAL tail {wal_tail} is ahead of the log tail {tail}; "
                f"recover the WAL into the fleet first "
                f"(durable/recovery.py)"
            )
        if wal_tail < tail:
            if not backfill:
                raise ValueError(
                    f"WAL tail {wal_tail} is behind the log tail "
                    f"{tail} and backfill=False"
                )
            opcodes, args = ring_slice(self.spec, self.log,
                                       wal_tail, tail)
            wal.append(wal_tail, [
                (int(opcodes[i]), *(int(a) for a in args[i]))
                for i in range(opcodes.shape[0])
            ])
        self._wal = wal
        get_tracer().emit("wal-attach", tail=tail,
                          backfilled=tail - wal_tail)

    @_locked
    def detach_wal(self):
        """Detach and return the WAL (not closed — the caller owns its
        lifecycle)."""
        wal, self._wal = self._wal, None
        return wal

    def wal_sync(self) -> int:
        """fsync the attached WAL — the serve frontend's durable-ack
        barrier. Not under the combiner lock: fsync latency must not
        stall concurrent rounds; the WAL has its own lock."""
        wal = self._wal
        if wal is None:
            raise RuntimeError("no WAL attached (attach_wal)")
        return wal.sync()

    @_locked
    def checkpoint(self, path: str) -> None:
        """Durable snapshot of log + all replica states
        (`core/checkpoint.py`, the reference's file format)."""
        from node_replication_torch.core.checkpoint import save_snapshot

        save_snapshot(path, self.spec, self.log, self.states)

    @classmethod
    def restore(cls, path: str, dispatch: Dispatch,
                **kwargs) -> "NodeReplicated":
        """Rebuild a NodeReplicated from a snapshot (on `device=` of
        `kwargs`, the card by default). Thread registrations are not
        part of a snapshot; re-register after restore."""
        from node_replication_torch.core.checkpoint import (
            load_snapshot,
            peek_spec,
        )

        spec = peek_spec(path)
        nr = cls(dispatch, n_replicas=spec.n_replicas,
                 log_entries=spec.capacity, gc_slack=spec.gc_slack,
                 **kwargs)
        _, nr.log, nr.states = load_snapshot(path, nr.states)
        return nr

    @_locked
    def recover(self, base_states=None,
                base_pos: int | None = None) -> None:
        """Discard replica states and rebuild them by replay from
        position 0 (needs `tail <= capacity`) or from a snapshot's
        `base_states` at `base_pos`. In-flight responses are lost,
        matching a crash."""
        from node_replication_torch.core.checkpoint import recover_states

        self.log, self.states = recover_states(
            self.dispatch, self.spec, self.log,
            base_states=base_states, base_pos=base_pos,
            window=self.exec_window,
        )
        self._inflight = [deque() for _ in range(self.n_replicas)]
        # crash semantics: begun-but-unfinished split rounds die too
        self._pending_batch.clear()
        # full-fleet rebuild: every replica is freshly consistent
        self._fenced = None

    # ---------------------------------------------------- writes/reads

    @_locked
    def execute_mut(self, op: tuple, token: ReplicaToken):
        """Stage one write op, combine, and return its response."""
        ctx = self._contexts[(token.rid, token.tid)]
        if not ctx.enqueue(op[0], tuple(op[1:])):
            self.combine(token.rid)
            ctx.enqueue(op[0], tuple(op[1:]))
        self.combine(token.rid)
        return ctx.res_newest()

    @_locked
    def enqueue_mut(self, op: tuple, token: ReplicaToken) -> None:
        """Stage a write without combining (combines first if this
        thread's 32-slot ring is full)."""
        ctx = self._contexts[(token.rid, token.tid)]
        if not ctx.enqueue(op[0], tuple(op[1:])):
            self.combine(token.rid)
            ctx.enqueue(op[0], tuple(op[1:]))

    @_locked
    def flush(self, rid: int | None = None) -> None:
        """Combine pending batches (all replicas by default)."""
        for r in range(self.n_replicas) if rid is None else [rid]:
            self.combine(r)

    @_locked
    def responses(self, token: ReplicaToken) -> list:
        """Drain delivered responses for this thread, in enqueue order."""
        ctx = self._contexts[(token.rid, token.tid)]
        out = []
        r = ctx.res()
        while r is not None:
            out.append(r)
            r = ctx.res()
        return out

    @_locked
    def execute(self, op: tuple, token: ReplicaToken):
        """Read path: wait until this replica has replayed up to the
        completed tail (helping replay while waiting), then dispatch
        locally."""
        rid = token.rid
        if self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        fault_hook("read-sync", rid, self)
        ctail = int(self.log.ctail)
        rounds = 0
        while int(self._ltails_host()[rid]) < ctail:
            self._exec_round()
            rounds = self._watchdog(rounds, "read-sync")
        return self._dispatch_read(rid, op)

    def _dispatch_read(self, rid: int, op: tuple) -> int:
        """Pack args and answer one read against replica `rid`'s state.
        Caller holds the combiner lock and has fence-checked."""
        args = np.zeros((1, self.spec.arg_width), np.int32)
        args[0, : len(op) - 1] = op[1:]
        state, dev = self._replica_rows(rid)
        resp = apply_read(
            self.dispatch, state,
            torch.tensor([op[0]], dtype=torch.int32, device=dev),
            torch.from_numpy(args).to(dev),
        )
        return int(resp[0])

    def _replica_rows(self, rid: int):
        """`(states of replica rid as a one-row fleet, its device)`,
        read from its shard on a mesh."""
        if self._placed is None:
            return tree_map(lambda a: a[rid:rid + 1], self._states), \
                self.device
        s, i = self._placed.shard_of(rid)
        sh = self._placed.shards[s]
        return tree_map(lambda a: a[i:i + 1], sh.states), sh.device

    @_locked
    def read_lag(self, rid: int) -> int:
        """Positions the completed tail leads replica `rid`'s cursor."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        ctail = int(self.log.ctail)
        return max(0, ctail - int(self._ltails_host()[rid]))

    @_locked
    def execute_stale(self, op: tuple, token: ReplicaToken):
        """Bounded-staleness read: dispatch against this replica's
        CURRENT state with no read-sync."""
        rid = token.rid
        if self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        return self._dispatch_read(rid, op)

    @_locked
    def execute_stale_bounded(self, op: tuple, token: ReplicaToken,
                              max_lag: int):
        """`execute_stale` with the staleness bound checked atomically:
        `(value, lag)` when `lag <= max_lag`, else None."""
        rid = token.rid
        if self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        ctail = int(self.log.ctail)
        lag = max(0, ctail - int(self._ltails_host()[rid]))
        if lag > int(max_lag):
            return None
        return self._dispatch_read(rid, op), lag

    @_locked
    def combine(self, rid: int) -> None:
        """Drain this replica's thread contexts (thread order), append
        the batch, and replay until this replica applied its own ops."""
        ops: list[tuple] = []
        tids: list[int] = []
        for tid in range(self._threads_per_replica[rid]):
            for opcode, args in self._contexts[(rid, tid)].ops():
                ops.append((opcode, *args))
                tids.append(tid)
        if not ops:
            self._exec_round()  # combine with nothing staged still helps
            return
        self._append_and_replay(0, ops, rid, tids)

    # ---------------------------------------- the combiner round's hooks

    def _round_log(self, log_idx: int):
        return self.log

    @_locked
    def _set_round_log(self, log_idx: int, log) -> None:
        self.log = log

    def _owes_responses(self, log_idx: int) -> bool:
        return any(self._inflight)

    def _owe_responses(self, log_idx: int, rid: int, pos0: int,
                       tids: list[int]) -> None:
        inflight = self._inflight[rid]
        for j, tid in enumerate(tids):
            inflight.append((pos0 + j, tid))

    def _deliver_answers(self, rid: int, tids: list[int], resps_np) -> None:
        for j, tid in enumerate(tids):
            self._contexts[(rid, tid)].enqueue_resps([int(resps_np[j])])

    def _chain_round(self, log_idx: int, rounds: int, where: str) -> int:
        self._exec_round()
        return self._watchdog(rounds, where)

    def _round_ltail(self, log_idx: int, rid: int) -> int:
        return int(self._ltails_host()[rid])

    @_locked
    def _drop_batch_inflight(self, rid: int) -> None:
        """Failed-batch hygiene: drop the batch's pending deliveries and
        reset its sink (the ops stay in the log and WILL replay)."""
        self._inflight[rid] = deque(
            (p, t) for p, t in self._inflight[rid] if t != BATCH_TID
        )
        self._contexts[(rid, BATCH_TID)].reset()

    @_locked
    def begin_mut_batch(self, ops: list[tuple],
                        rid: int = 0) -> _PendingRound:
        """Split-round batch entry, first half: GC-wait, encode, append
        (on the fused tier: launch). At most ONE begun-but-unfinished
        round per replica."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"replica {rid} out of range")
        if self._pending_batch.get(rid) is not None:
            raise RuntimeError(
                f"replica {rid} already has a round in flight; "
                f"finish_mut_batch it before beginning another "
                f"(at most one split round per replica)"
            )
        n = len(ops)
        sink = self._contexts.get((rid, BATCH_TID))
        if sink is None:
            sink = _BatchSink()
            self._contexts[(rid, BATCH_TID)] = sink
        if n == 0:
            pending = _PendingRound(rid, [], 0, int(_readback(self.log.tail)))
            pending.done = True
            self._pending_batch[rid] = pending
            return pending
        sink.expect(n)
        try:
            pending = self._begin_round(
                0, list(ops), rid, [BATCH_TID] * n, batch=True, defer=True,
            )
        except BaseException:
            self._drop_batch_inflight(rid)
            raise
        self._pending_batch[rid] = pending
        return pending

    @_locked
    def finish_mut_batch(self, pending: _PendingRound) -> list:
        """Split-round batch entry, second half: complete the round and
        return its responses in op order."""
        rid = pending.rid
        if self._pending_batch.get(rid) is not pending:
            raise RuntimeError(
                f"pending round for replica {rid} is not this "
                f"replica's in-flight round (already finished?)"
            )
        sink = self._contexts[(rid, BATCH_TID)]
        try:
            self._finish_round(pending)
            resps = sink.take()
            if len(resps) != pending.n:
                raise RuntimeError(
                    f"round delivered {len(resps)} responses for "
                    f"{pending.n} ops"
                )
            return resps
        except BaseException:
            self._drop_batch_inflight(rid)
            raise
        finally:
            self._pending_batch.pop(rid, None)

    @_locked
    def abort_mut_batch(self, pending: _PendingRound) -> None:
        """Abandon a begun-but-unfinished split round (its ops stay in
        the log; its responses are dropped). Idempotent."""
        rid = pending.rid
        if self._pending_batch.get(rid) is not pending:
            return
        self._pending_batch.pop(rid, None)
        pending.done = True
        pending.fused_resps = None
        self._drop_batch_inflight(rid)

    @_locked
    def execute_mut_batch(self, ops: list[tuple], rid: int = 0) -> list:
        """Execute a caller-assembled batch of write ops as ONE
        combiner round (`begin_mut_batch` + `finish_mut_batch`), inside
        a `mut-batch` span whose `round` (the round's first log
        position) every span of the round carries."""
        with span("mut-batch", rid=rid, n=len(ops), round=None) as sp:
            pending = self.begin_mut_batch(ops, rid)
            sp.add(round=pending.pos0)
            return self.finish_mut_batch(pending)

    @_locked
    def sync(self, rid: int | None = None) -> None:
        """Catch replicas up with the log tail; `rid=None` syncs every
        UNFENCED replica. On a mesh a large uniform backlog takes the
        ring tier first (`_ring_catchup`), then ordinary exec rounds
        the remainder."""
        if rid is not None and self._is_fenced(rid):
            raise ReplicaFencedError(rid)
        rounds = 0
        while True:
            ltails = self._ltails_host()
            tail = int(self.log.tail)
            if rid is None:
                live = (
                    ltails if self._fenced is None
                    else ltails[~self._fenced]
                )
                done = all(int(lt) >= tail for lt in live)
            else:
                done = int(ltails[rid]) >= tail
            if done:
                return
            if self._ring_catchup():
                continue  # made >= 2 * shards positions of progress
            self._exec_round()
            rounds = self._watchdog(rounds, "sync")

    @_locked
    def _ring_catchup(self) -> bool:
        """One ring-replay pass over the pending window, the mesh
        catch-up tier (`nr.exec.engine.ring`;
        `parallel/collectives.py:make_ring_exec`). Eligible only where
        it equals the scan rounds it replaces: a mesh on the shmap tier,
        no replica fenced (the ring applies the window to every shard),
        no responses owed (the ring produces none), every cursor at one
        position. Applies `chunk * shards` entries (chunk the largest
        power of two <= min(exec_window, pending / shards)) in log
        order to every replica, and joins the lattice on the host:
        ltails, ctail and head land at the window's end. Returns False
        when ineligible; progress is >= 2 * shards positions."""
        if self.mesh is None or self._mesh_tier == "gspmd":
            return False
        if self._fenced is not None or any(self._inflight):
            return False
        log = self.log
        cur = _readback(torch.cat([log.ltails, log.tail.reshape(1)]))
        lts, tail = cur[:-1], int(cur[-1])
        lt = int(lts.min())
        if int(lts.max()) != lt:
            return False
        shards = self._mesh_shards
        pending = tail - lt
        if shards < 2 or pending < 2 * shards:
            return False
        chunk = min(self.exec_window,
                    1 << ((pending // shards).bit_length() - 1))
        W = chunk * shards
        opc, args = gather_window(self.spec, log.opcodes, log.args, lt,
                                  tail, W)
        if self._ring_fn is None:
            from node_replication_torch.parallel.collectives import (
                make_ring_exec,
            )

            self._ring_fn = make_ring_exec(self.dispatch, self.mesh)
        with span("ring-exec", window=W, chunk=chunk, shards=shards,
                  start=lt) as sp:
            self._placed = self._ring_fn(opc, args, self._placed)
            sp.fence(*self._fleet_trees())
        # every replica consumed [lt, lt + W) in order: the cursors
        # land at lt + W (no fenced mask, by eligibility)
        new_lt = lt + W
        self.log = log._replace(
            ltails=torch.full((self.n_replicas,), new_lt,
                              dtype=torch.int64, device=self.device),
            ctail=torch.clamp(log.ctail, min=new_lt),
            head=torch.full_like(log.head, new_lt),
        )
        if self._wal is not None:
            self._wal.maybe_reclaim(new_lt)
        self._ring_rounds += 1
        self._m_ring.inc()
        # each shard forwards its chunk 2 * shards - 1 hops: about
        # twice the window, counted once per pass
        self._m_mesh_sync_bytes.inc(
            2 * (opc.numel() * opc.element_size()
                 + args.numel() * args.element_size()))
        return True

    @_locked
    def stats(self) -> dict:
        """Flat observability counters."""
        ltails = self._ltails_host()
        tail = int(self.log.tail)
        return {
            "appended": tail,
            "head": int(self.log.head),
            "ctail": int(self.log.ctail),
            "min_ltail": int(ltails.min()),
            "exec_rounds": self._exec_rounds,
            "idle_rounds": self._idle_rounds,
            "ring_rounds": self._ring_rounds,
            "engine": self.engine,
            "fused_rounds": self._fused_rounds,
            "fused_tier": self._fused_tier_state(),
            "mesh_devices": self._mesh_shards,
            "max_lag": tail - int(ltails.min()),
        }

    @_locked
    def snapshot(self) -> dict:
        """Structured observability snapshot (JSON-safe)."""
        ltails = self._ltails_host()
        tail = int(self.log.tail)
        head = int(self.log.head)
        lags = [tail - int(lt) for lt in ltails]
        return {
            "log": {
                "tail": tail,
                "head": head,
                "ctail": int(self.log.ctail),
                "capacity": self.spec.capacity,
                "occupancy": (tail - head) / self.spec.capacity,
                "space": int(log_space(self.spec, self.log)),
            },
            "replicas": {
                "n": self.n_replicas,
                "ltails": [int(lt) for lt in ltails],
                "lag": lags,
                "max_lag": max(lags) if lags else 0,
                "threads": list(self._threads_per_replica),
                "inflight": [len(q) for q in self._inflight],
                "fenced": self.fenced_rids,
            },
            "exec": {
                "engine": self.engine,
                # the configured bound, as the reference reports it; a
                # scan round may run fewer (`_round_window`), and its
                # `exec-round` trace event carries what it ran
                "window": self.exec_window,
                "rounds": self._exec_rounds,
                "idle_rounds": self._idle_rounds,
                "ring_rounds": self._ring_rounds,
                "fused_rounds": self._fused_rounds,
                "fused_tier": self._fused_tier_state(),
            },
            # shard shape only; the per-rid lookup is replica_device()
            "mesh": (
                None if self.mesh is None else {
                    "devices": self._mesh_shards,
                    "tier": self._mesh_tier,
                    "replicas_per_device":
                        self.n_replicas // self._mesh_shards,
                }
            ),
            "device": str(self.device),
            "metrics": get_registry().snapshot(),
        }

    @_locked
    def verify(self, fn: Callable[[Any], Any], rid: int = 0):
        """Force-sync, then hand replica `rid`'s state (numpy) to `fn`."""
        self.sync()
        rows, _ = self._replica_rows(rid)
        state = tree_map(lambda a: _readback(a[0]), rows)
        return fn(state)

    @_locked
    def replicas_equal(self) -> bool:
        """All replicas converged to identical state (on a mesh: each
        shard's rows, and every shard against shard 0's first row)."""
        if self._placed is None:
            return states_equal(self._states)
        first = self._placed.shards[0].states
        return all(
            states_equal(sh.states) and all(
                bool(torch.equal(a[:1].to(b.device), b[:1]))
                for a, b in zip(tree_leaves(first),
                                tree_leaves(sh.states)))
            for sh in self._placed.shards
        )

    # ------------------------------------------------------- internals

    @_locked
    def _exec_round(self) -> bool:
        """One replay round for every replica, plus response
        distribution; skipped (counted idle) when every live cursor is
        already at the tail. Returns True if any replica progressed."""
        fault_hook("replay", -1, self)
        fenced = self._fenced
        cur = _readback(torch.cat([self.log.ltails,
                                   self.log.tail.reshape(1)]))
        ltails_before, tail = cur[:-1], int(cur[-1])
        live = (
            ltails_before if fenced is None
            else ltails_before[~fenced]
        )
        idle = bool(
            live.size
            and int(live.min()) >= tail
            and int(live.max()) <= tail
        )
        if idle and fenced is not None:
            idle = int(self.log.head) >= int(live.min())
        if idle:
            self._idle_rounds += 1
            self._m_idle.inc()
            return False
        self._exec_rounds += 1
        self._m_rounds.inc()
        self._m_engine.inc()
        tracer = get_tracer()
        # mesh rounds always time: the round-duration histogram is part
        # of the mesh.* metrics
        t0 = (time.perf_counter()
              if (tracer.enabled or self.mesh is not None) else 0.0)
        f_arr = (None if fenced is None
                 else torch.from_numpy(fenced).to(self.device))
        window = self._round_window(
            tail - int(live.min()) if live.size else 1)
        with debug_checks(self.debug):
            if self._placed is not None:
                resps = self._mesh_exec(f_arr, window, ltails_before)
            else:
                self.log, self.states, resps = self._exec_call(f_arr,
                                                               window)
        ltails_after = self._ltails_host()
        self._m_lag.observe(tail - int(ltails_after.min()))
        if self._wal is not None:
            # GC/head coupling (`durable/wal.py`): min(ltails) is the
            # head this round just computed (<= head under fencing)
            self._wal.maybe_reclaim(int(ltails_after.min()))
        resps_np = _readback(resps)
        for r in range(self.n_replicas):
            q = self._inflight[r]
            while q and q[0][0] < int(ltails_after[r]):
                pos, tid = q.popleft()
                self._contexts[(r, tid)].enqueue_resps(
                    [int(resps_np[r, pos - int(ltails_before[r])])]
                )
        progressed = bool(np.any(ltails_after > ltails_before))
        sync_bytes = 0
        if self.mesh is not None:
            # rounds by tier, round time, and the bytes this round
            # brought back to the host (responses and the two cursor
            # readbacks)
            sync_bytes = resps_np.nbytes + cur.nbytes + ltails_after.nbytes
            self._m_mesh_round.inc()
            self._m_mesh_dur.observe(time.perf_counter() - t0)
            self._m_mesh_sync_bytes.inc(sync_bytes)
        if tracer.enabled:
            if tracer.fence_spans:
                from node_replication_torch.utils.fence import fence

                fence(*self._fleet_trees())
            extra = (
                {"mesh_tier": self._mesh_tier,
                 "mesh_devices": self._mesh_shards,
                 "sync_bytes": sync_bytes}
                if self.mesh is not None else {}
            )
            tracer.emit(
                "exec-round",
                duration_s=time.perf_counter() - t0,
                fenced=tracer.fence_spans,
                engine=self.engine,
                window=window,
                progressed=progressed,
                advanced=int((ltails_after - ltails_before).sum()),
                **extra,
            )
        return progressed

    def _watchdog(self, rounds: int, where: str) -> int:
        rounds += 1
        # re-warn every WARN_ROUNDS (`nr/src/log.rs:43`)
        if rounds % WARN_ROUNDS == 0:
            self._m_stalls.inc()
            ltails = self._ltails_host()
            dormant = int(np.argmin(ltails))
            ltail = int(ltails[dormant])
            tail = int(self.log.tail)
            logger.warning(
                "replay stalled in %s after %d rounds; most dormant "
                "replica=%d (ltail=%d, tail=%d)",
                where, rounds, dormant, ltail, tail,
            )
            get_tracer().emit(
                "watchdog", where=where, rounds=rounds, dormant=dormant,
                ltail=ltail, tail=tail,
            )
            if self.gc_callback is not None:
                self.gc_callback(0, dormant)
        return rounds
