"""The shared operation log as a device-resident ring buffer (PyTorch).

The port of `node_replication_tpu/core/log.py` (see its docstring for
the mapping from the reference's lock-free ring). A struct-of-arrays
ring `(opcodes int32[L], args int32[L, A])` with monotone int64
cursors `head`/`tail`/`ctail` (0-d tensors) and `ltails int64[R]`;
the physical slot of logical position `pos` is `pos & (L-1)`, taken in
int64 and cast to an index only after the mask.

Every function here is functional to its caller: inputs are never
written, results are new tensors. The fleet functions replay into a
clone of the states (the model's write ops update that clone in
place). Where the reference `vmap`s a per-replica function, the port
works on the replica axis directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops.encoding import Dispatch, NOOP, apply_write
from node_replication_torch.utils.checks import check
from node_replication_torch.utils.device import resolve_device
from node_replication_torch.utils.tree import tree_map

PyTree = Any

# Engine-dispatch counters: which replay tier `log_catchup_all` routed a
# call to. The reference increments these on the host side of its tier
# decision, so under jit they count per trace; the port has no jit, so
# the SAME counters count per call here. Per-round engine usage of the
# stateful wrapper is the separate `nr.exec.engine.*` family.
_m_engine_scan = get_registry().counter("log.engine.scan")
_m_engine_window = get_registry().counter("log.engine.window_apply")
_m_engine_union = get_registry().counter("log.engine.union_plan")
_m_idle_skips = get_registry().counter("log.engine.idle_skip")
# fused tier: whole combiner rounds executed as one kernel launch
# (`ops/replay.py:FusedHashmapEngine`), counted per round
_m_engine_pallas_fused = get_registry().counter("log.engine.pallas_fused")
# mesh tiers (`parallel/collectives.py`): shmap exec builds, and fused
# rounds run once per mesh shard (`MeshFusedEngine`)
_m_engine_shmap = get_registry().counter("log.engine.shmap")
_m_engine_mesh_fused = get_registry().counter("log.engine.mesh_fused")

DEFAULT_LOG_ENTRIES = 1 << 16
GC_FROM_HEAD = 8192
WARN_ROUNDS = 64

# Far-future sentinel for fenced-cursor masking (int64 cursors).
_FAR = 1 << 60


@dataclasses.dataclass(frozen=True)
class LogSpec:
    """Static log configuration. `capacity` is rounded up to a power of
    two with a floor of `2 * gc_slack` (`Log::new`,
    `nr/src/log.rs:184-196`)."""

    capacity: int = DEFAULT_LOG_ENTRIES
    n_replicas: int = 1
    arg_width: int = 3
    gc_slack: int = GC_FROM_HEAD

    def __post_init__(self):
        cap = max(int(self.capacity), 2 * self.gc_slack)
        cap = 1 << (cap - 1).bit_length()  # next power of two
        object.__setattr__(self, "capacity", cap)
        if self.n_replicas < 1:
            raise ValueError("need at least one replica")

    @property
    def mask(self) -> int:
        return self.capacity - 1


class LogState(NamedTuple):
    """Device-resident log: ring tensors + monotone int64 cursors."""

    opcodes: torch.Tensor  # int32[L]
    args: torch.Tensor  # int32[L, A]
    head: torch.Tensor  # int64 0-d
    tail: torch.Tensor  # int64 0-d
    ctail: torch.Tensor  # int64 0-d (completed tail)
    ltails: torch.Tensor  # int64[R] (per-replica local tails)


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def log_init(spec: LogSpec, device=None) -> LogState:
    """Allocate an empty log on `device` (None means the card)."""
    dev = resolve_device(device)
    return LogState(
        opcodes=torch.full((spec.capacity,), NOOP, dtype=torch.int32,
                           device=dev),
        args=torch.zeros((spec.capacity, spec.arg_width),
                         dtype=torch.int32, device=dev),
        head=torch.zeros((), dtype=torch.int64, device=dev),
        tail=torch.zeros((), dtype=torch.int64, device=dev),
        ctail=torch.zeros((), dtype=torch.int64, device=dev),
        ltails=torch.zeros((spec.n_replicas,), dtype=torch.int64,
                           device=dev),
    )


def log_reset(spec: LogSpec, log: LogState) -> LogState:
    """A fresh empty log on the same device."""
    return log_init(spec, log.tail.device)


def log_space(spec: LogSpec, log: LogState) -> torch.Tensor:
    """Free slots an append may consume while preserving the GC slack."""
    used = log.tail - log.head
    return torch.clamp(spec.capacity - spec.gc_slack - used, min=0)


def log_append(spec: LogSpec, log: LogState, opcodes: torch.Tensor,
               args: torch.Tensor, count) -> LogState:
    """Batched reserve-then-write of the first `count` slots of a
    fixed-shape batch. Capacity is NOT checked (callers go through
    `log_space`); under debug checks an overrunning append raises.

    The reference scatters invalid lanes to index L with
    `mode="drop"`; torch has no drop mode, so only the `count` valid
    lanes are written (a tensor `count` goes through an L+1 buffer
    whose extra slot is discarded). The written slots are distinct
    because `count <= capacity - gc_slack`, so the scatter has no
    duplicate indices."""
    dev = log.tail.device
    check(
        lambda: log.tail + count <= log.head + spec.capacity,
        "log_append overwrites unconsumed entries: tail {t} + count {c} "
        "> head {h} + capacity " + str(spec.capacity),
        t=log.tail, c=count, h=log.head,
    )
    if isinstance(count, torch.Tensor):
        batch = opcodes.shape[0]
        lanes = torch.arange(batch, dtype=torch.int64, device=dev)
        valid = lanes < count
        slot = torch.where(valid, (log.tail + lanes) & spec.mask,
                           _i64(spec.capacity, dev))
        opc = torch.cat([log.opcodes, log.opcodes[:1]])
        arg = torch.cat([log.args, log.args[:1]])
        opc[slot] = opcodes
        arg[slot] = args
        new_opc, new_args = opc[:-1], arg[:-1]
        count_t = count.to(torch.int64)
    else:
        count = int(count)
        lanes = torch.arange(count, dtype=torch.int64, device=dev)
        slot = (log.tail + lanes) & spec.mask
        new_opc = log.opcodes.clone()
        new_args = log.args.clone()
        new_opc[slot] = opcodes[:count]
        new_args[slot] = args[:count]
        count_t = count
    return log._replace(opcodes=new_opc, args=new_args,
                        tail=log.tail + count_t)


def _freeze_limits(log: LogState, limits, fenced):
    """Fold a fenced mask into the per-replica replay `limits`: a fenced
    replica is frozen at its own ltail, others keep their limit."""
    fenced = torch.as_tensor(fenced, dtype=torch.bool,
                             device=log.ltails.device)
    frozen = torch.where(fenced, log.ltails, _i64(_FAR, log.ltails.device))
    if limits is None:
        return frozen
    return torch.minimum(_i64(limits, log.ltails.device), frozen)


def _gc_head(log: LogState, new_ltails, fenced):
    """The GC reduction `head = min(ltails)` with fenced replicas
    masked OUT, clamped monotone at the old head; `fenced=None` is the
    exact unmasked reduction."""
    if fenced is None:
        return new_ltails.min()
    fenced = torch.as_tensor(fenced, dtype=torch.bool,
                             device=new_ltails.device)
    masked = torch.where(fenced, _i64(_FAR, new_ltails.device), new_ltails)
    # all-fenced degenerate fleet: hold head still rather than min(FAR)
    return torch.where(
        fenced.all(), log.head, torch.maximum(log.head, masked.min()),
    )


def gather_window(spec, opcodes_ring, args_ring, start, tail, window: int):
    """Gather `window` ring entries from logical position `start`,
    masking positions at or past `tail` to NOOP. `start`/`tail` may
    carry a leading replica axis (`[R]`), giving `[R, window]`."""
    dev = opcodes_ring.device
    lanes = torch.arange(window, dtype=torch.int64, device=dev)
    start = _i64(start, dev)
    tail = _i64(tail, dev)
    pos = start[..., None] + lanes
    idx = pos & spec.mask
    opcodes = torch.where(pos < tail[..., None], opcodes_ring[idx],
                          torch.full_like(opcodes_ring[idx], NOOP))
    return opcodes, args_ring[idx]


def _clone_states(states):
    return tree_map(lambda x: x.clone(), states)


def _exec_one(spec: LogSpec, d: Dispatch, log: LogState, states: PyTree,
              window: int, limits=None):
    """Replay up to `window` entries of `[ltails[r], tail)` into every
    replica r: the reference's vmapped `lax.scan` (`_exec_one`) as one
    loop over window offsets, each offset one masked `apply_write`
    across the replica axis. `limits` (int64[R]) caps a replica's
    effective tail at `min(tail, limits[r])`."""
    ltails = log.ltails
    eff_tail = log.tail if limits is None else torch.minimum(
        log.tail, _i64(limits, ltails.device))
    check(lambda: (ltails <= log.tail).all(),
          "replica ltail {lt} ahead of log tail {t}",
          lt=ltails, t=log.tail)
    check(lambda: (ltails >= log.head).all(),
          "replay window starts at {lt}, behind GC head {h}: entries "
          "already overwritten",
          lt=ltails, h=log.head)
    states = _clone_states(states)
    resps = []
    for j in range(window):
        pos = ltails + j
        active = pos < eff_tail
        idx = pos & spec.mask
        opcode = torch.where(active, log.opcodes[idx],
                             torch.full_like(log.opcodes[idx], NOOP))
        resps.append(apply_write(d, states, opcode, log.args[idx]))
    R = ltails.shape[0]
    resps = (torch.stack(resps, dim=1) if resps else
             torch.zeros((R, 0), dtype=torch.int32, device=ltails.device))
    new_ltails = torch.minimum(ltails + window, eff_tail)
    new_ltails = torch.maximum(new_ltails, ltails)  # limit below ltail
    return states, resps, new_ltails


def log_exec_all(spec: LogSpec, d: Dispatch, log: LogState, states: PyTree,
                 window: int, limits=None, fenced=None):
    """Replay a static `window` of pending entries into every replica in
    lock-step, then fold in the cursor lattice: `ltails[r] =
    min(ltails[r] + window, tail)`, `ctail = max(ctail, max(ltails))`,
    `head` by `_gc_head`. `limits` caps replay per replica (dormant
    laggards); `fenced` (bool[R]) freezes quarantined replicas and
    masks them out of GC. Returns `(log, states, resps int32[R,
    window])`, `resps[r, i]` answering position `old_ltails[r] + i`."""
    if fenced is not None:
        limits = _freeze_limits(log, limits, fenced)
    states, resps, new_ltails = _exec_one(spec, d, log, states, window,
                                          limits)
    log = log._replace(
        ltails=new_ltails,
        ctail=torch.maximum(log.ctail, new_ltails.max()),
        head=_gc_head(log, new_ltails, fenced),
    )
    return log, states, resps


def log_catchup_all(spec: LogSpec, d: Dispatch, log: LogState,
                    states: PyTree, window: int, limits=None,
                    need_resps: bool = True, on_trajectory: bool = True,
                    union: bool | None = None, fenced=None,
                    idle_check: bool = True):
    """Combined catch-up: `log_exec_all` semantics at combined speed,
    through the reference's three tiers (see its docstring): the
    union-window plan (plan/merge models that opted into
    `window_canonical`, or `union=True`; no `limits`; on-trajectory
    fleets), the per-replica `window_apply`, and the scan.

    `idle_check=False` skips the union tier's host-side idle
    short-circuit (one cursor readback). The reference's check runs
    only for eager callers — under `NodeReplicated`'s jit the cursors
    are tracers and the wrapper's `_exec_round` makes the same check
    first — so the wrapper passes False to read back no more than the
    reference does.
    """
    if d.window_apply is None and d.window_plan is None:
        _m_engine_scan.inc()
        return log_exec_all(spec, d, log, states, window, limits,
                            fenced=fenced)
    if takes_union(d, union) and limits is None and on_trajectory:
        return _catchup_union_plan(spec, d, log, states, window,
                                   need_resps, fenced=fenced,
                                   idle_check=idle_check)
    if d.window_apply is None:
        _m_engine_scan.inc()
        return log_exec_all(spec, d, log, states, window, limits,
                            fenced=fenced)
    _m_engine_window.inc()
    if fenced is not None:
        limits = _freeze_limits(log, limits, fenced)
    ltails = log.ltails
    eff_tail = log.tail if limits is None else torch.minimum(
        log.tail, _i64(limits, ltails.device))
    check(lambda: (ltails <= log.tail).all(),
          "replica ltail {lt} ahead of log tail {t}",
          lt=ltails, t=log.tail)
    check(lambda: (ltails >= log.head).all(),
          "catch-up window starts at {lt}, behind GC head {h}: "
          "entries already overwritten",
          lt=ltails, h=log.head)
    R = ltails.shape[0]
    opcodes, args = gather_window(
        spec, log.opcodes, log.args, ltails,
        torch.broadcast_to(eff_tail, (R,)), window,
    )
    # one plan per replica (its own window against its own state)
    states, resps = d.window_apply(states, opcodes, args)
    new_ltails = torch.minimum(ltails + window, eff_tail)
    new_ltails = torch.maximum(new_ltails, ltails)  # limit below ltail
    log = log._replace(
        ltails=new_ltails,
        ctail=torch.maximum(log.ctail, new_ltails.max()),
        head=_gc_head(log, new_ltails, fenced),
    )
    return log, states, resps


def takes_union(d: Dispatch, union: bool | None) -> bool:
    """Whether `log_catchup_all` takes the union-window tier for this
    dispatch (given no `limits` and an on-trajectory fleet)."""
    return bool(d.window_canonical if union is None else union) \
        and d.window_plan is not None


def union_plan(spec: LogSpec, d: Dispatch, log: LogState, states: PyTree,
               window: int, m, donor):
    """The union tier's plan: `(end, plan)` of the window `[m, end)`,
    `end = min(m + window, tail)`, computed once from replica `donor`'s
    state, whose cursor is `m` (int64 0-d tensors on the log's
    device)."""
    end = torch.minimum(m + window, log.tail)
    check(lambda: m >= log.head,
          "catch-up window starts at {m}, behind GC head {h}: entries "
          "already overwritten",
          m=m, h=log.head)
    opcodes, args = gather_window(spec, log.opcodes, log.args, m, end,
                                  window)
    donor_state = tree_map(lambda x: x[donor], states)
    return end, d.window_plan(donor_state, opcodes, args)


def union_merge(d: Dispatch, log: LogState, states: PyTree, window: int,
                m, end, plan, need_resps: bool = True, fenced=None):
    """The union tier's merge: `plan` (of `[m, end)`) merged into every
    unfenced replica whose cursor is below `end`; those cursors land at
    `end`. Returns `(log, states, resps int32[R, window])`, `resps[r,
    i]` answering position `old_ltails[r] + i`."""
    dev = log.ltails.device
    if fenced is not None:
        fenced = torch.as_tensor(fenced, dtype=torch.bool, device=dev)
    _m_engine_union.inc()
    check(lambda: log.ltails.max() <= log.tail,
          "replica ltail {lt} ahead of log tail {t}",
          lt=lambda: log.ltails.max(), t=log.tail)
    merged, presps = d.window_merge(states, plan)
    take = log.ltails < end
    if fenced is not None:
        take = take & ~fenced
    states = tree_map(
        lambda a, b: torch.where(
            take.reshape((-1,) + (1,) * (a.dim() - 1)), b, a
        ),
        states, merged,
    )
    if need_resps:
        # resps[r, i] answers logical position old_ltails[r] + i,
        # gathered from the canonical per-position plan responses
        offs = (log.ltails - m)[:, None] + torch.arange(
            window, dtype=torch.int64, device=dev)[None, :]
        resps = torch.gather(presps, 1, offs.clamp(0, window - 1))
        resps = torch.where((offs >= 0) & (offs < (end - m)), resps,
                            torch.zeros_like(resps))
    else:
        resps = torch.zeros(presps.shape, dtype=presps.dtype, device=dev)
    new_ltails = torch.maximum(log.ltails, end)
    if fenced is not None:
        new_ltails = torch.where(fenced, log.ltails, new_ltails)
    log = log._replace(
        ltails=new_ltails,
        ctail=torch.maximum(log.ctail, new_ltails.max()),
        head=_gc_head(log, new_ltails, fenced),
    )
    return log, states, resps


def _catchup_union_plan(spec: LogSpec, d: Dispatch, log: LogState,
                        states: PyTree, window: int,
                        need_resps: bool = True, fenced=None,
                        idle_check: bool = True):
    """Union-window catch-up (the reference's `_catchup_union_plan`;
    its docstring holds the soundness argument). The plan of the
    window `[m, end)`, `m` the least unfenced cursor, is computed once
    from that replica's state (`union_plan`) and merged into every
    unfenced replica whose cursor is below `end` (`union_merge`)."""
    dev = log.ltails.device
    if fenced is not None:
        fenced = torch.as_tensor(fenced, dtype=torch.bool, device=dev)
    masked_lt = (
        log.ltails if fenced is None
        else torch.where(fenced, _i64(_FAR, dev), log.ltails)
    )
    if idle_check:
        lt = log.ltails.cpu().numpy()
        live = lt if fenced is None else lt[~fenced.cpu().numpy()]
        idle = bool(
            live.size
            and int(live.min()) >= int(log.tail) >= int(live.max())
        )
        if idle and fenced is not None:
            # a freshly fenced laggard may still pin head below the
            # live min: one device round must run to advance GC
            idle = int(log.head) >= int(live.min())
        if idle:
            _m_idle_skips.inc()
            R = log.ltails.shape[0]
            return log, states, torch.zeros((R, window), dtype=torch.int32,
                                            device=dev)
    m = masked_lt.min()
    end, plan = union_plan(spec, d, log, states, window, m,
                           masked_lt.argmin())
    return union_merge(d, log, states, window, m, end, plan, need_resps,
                       fenced)


def ring_slice(spec: LogSpec, log: LogState, start: int,
               stop: int) -> tuple[np.ndarray, np.ndarray]:
    """Host readback of ring entries `[start, stop)` as numpy
    `(opcodes int32[n], args int32[n, A])`; only entries the ring still
    physically holds (`start >= tail - capacity`, `stop <= tail`)."""
    start, stop = int(start), int(stop)
    tail = int(log.tail)
    if stop > tail:
        raise ValueError(
            f"ring_slice [{start}, {stop}) runs past tail {tail}"
        )
    if start < tail - spec.capacity:
        raise ValueError(
            f"ring_slice [{start}, {stop}) starts below "
            f"tail - capacity = {tail - spec.capacity}: entries "
            f"already overwritten by ring wrap"
        )
    if stop < start:
        raise ValueError(f"ring_slice [{start}, {stop}) is negative")
    idx = (np.arange(start, stop, dtype=np.int64)
           & spec.mask).astype(np.int64)
    opcodes = log.opcodes.cpu().numpy()[idx]
    args = log.args.cpu().numpy()[idx]
    return opcodes, args


def is_replica_synced_for_reads(log: LogState, ridx: int,
                                ctail: torch.Tensor) -> torch.Tensor:
    """May replica `ridx` serve reads issued at completed tail `ctail`?"""
    return log.ltails[ridx] >= ctail


def get_ctail(log: LogState) -> torch.Tensor:
    return log.ctail
