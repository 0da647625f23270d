"""Multi-log node replication: the CNR (`cnr` crate) equivalent (PyTorch).

The port of `node_replication_tpu/core/multilog.py` (see its docstring
for the mapping from `cnr`'s per-log combiners). The L logs are one
stacked ring: `opcodes int32[L, C]`, `args int32[L, C, A]`, int64
cursors `head`/`tail`/`ctail` `[L]` and `ltails int64[L, R]`. A
`LogMapper` routes each op to log `hash % L` on the host.

Where the reference `vmap`s its single-log scan over (log x replica),
the port flattens those two axes into one batch axis of `L * R` lanes
(lane `l * R + r`): a partitioned model's states become `[L * R, sub]`
and every per-(log, replica) replay runs as one batched computation.
Monolithic states fold the logs one after another, each log through
`core/log.py:_exec_one`.

Every function here is functional to its caller: inputs are never
written, results are new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from node_replication_torch.core.log import (
    LogSpec,
    LogState,
    _exec_one,
    gather_window,
)
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops.encoding import (
    Dispatch,
    NOOP,
    apply_write,
    dispatch_reads,
)
from node_replication_torch.utils.checks import check, debug_checks
from node_replication_torch.utils.device import resolve_device
from node_replication_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

# Which replay tier `multilog_exec_all` took, counted per call (the
# reference counts per trace; the port has no jit).
_m_ml_lockstep = get_registry().counter("multilog.engine.combined_lockstep")
_m_ml_combined = get_registry().counter("multilog.engine.combined")
_m_ml_part_scan = get_registry().counter("multilog.engine.partitioned_scan")
_m_ml_seq = get_registry().counter("multilog.engine.sequential")

# LogMapper: host-side commutativity hash (`cnr/src/lib.rs:123-137`).
LogMapper = Callable[[int, tuple], int]


@dataclasses.dataclass(frozen=True)
class MultiLogSpec:
    """Static config for a stacked multi-log."""

    nlogs: int
    capacity: int = 1 << 14
    n_replicas: int = 1
    arg_width: int = 3
    gc_slack: int = 1024

    def __post_init__(self):
        cap = max(int(self.capacity), 2 * self.gc_slack)
        cap = 1 << (cap - 1).bit_length()
        object.__setattr__(self, "capacity", cap)
        if self.nlogs < 1:
            raise ValueError("need at least one log")

    @property
    def mask(self) -> int:
        return self.capacity - 1

    def one_log(self) -> LogSpec:
        return LogSpec(
            capacity=self.capacity,
            n_replicas=self.n_replicas,
            arg_width=self.arg_width,
            gc_slack=self.gc_slack,
        )


class MultiLogState(NamedTuple):
    """L stacked rings; every cursor grows a leading log axis."""

    opcodes: torch.Tensor  # int32[L, C]
    args: torch.Tensor  # int32[L, C, A]
    head: torch.Tensor  # int64[L]
    tail: torch.Tensor  # int64[L]
    ctail: torch.Tensor  # int64[L]
    ltails: torch.Tensor  # int64[L, R]


def multilog_init(spec: MultiLogSpec, device=None) -> MultiLogState:
    """Allocate L empty logs on `device` (None means the card)."""
    dev = resolve_device(device)
    L, C = spec.nlogs, spec.capacity
    z = torch.zeros((L,), dtype=torch.int64, device=dev)
    return MultiLogState(
        opcodes=torch.full((L, C), NOOP, dtype=torch.int32, device=dev),
        args=torch.zeros((L, C, spec.arg_width), dtype=torch.int32,
                         device=dev),
        head=z, tail=z.clone(), ctail=z.clone(),
        ltails=torch.zeros((L, spec.n_replicas), dtype=torch.int64,
                           device=dev),
    )


def log_view(ml: MultiLogState, log_idx: int) -> LogState:
    """Log `log_idx` of the stack as a single-log `LogState` (views)."""
    return LogState(
        opcodes=ml.opcodes[log_idx], args=ml.args[log_idx],
        head=ml.head[log_idx], tail=ml.tail[log_idx],
        ctail=ml.ctail[log_idx], ltails=ml.ltails[log_idx],
    )


def multilog_space(spec: MultiLogSpec, ml: MultiLogState) -> torch.Tensor:
    return torch.clamp(spec.capacity - spec.gc_slack - (ml.tail - ml.head),
                       min=0)


def multilog_append(spec: MultiLogSpec, ml: MultiLogState, opcodes,
                    args, counts) -> MultiLogState:
    """Per-log batched append of the valid prefix `counts int64[L]` of
    `opcodes int32[L, B]`/`args int32[L, B, A]` (already partitioned
    per log). Invalid lanes go to a sentinel slot past the ring, which
    is cut off (the reference's `mode="drop"`); the valid slots of a
    log are distinct, so no set has a duplicate index."""
    dev = ml.tail.device
    opcodes = torch.as_tensor(opcodes, dtype=torch.int32, device=dev)
    args = torch.as_tensor(args, dtype=torch.int32, device=dev)
    counts = torch.as_tensor(counts, dtype=torch.int64, device=dev)
    L, B = opcodes.shape
    C = spec.capacity
    lanes = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    valid = lanes < counts[:, None]
    slot = torch.where(valid, (ml.tail[:, None] + lanes) & spec.mask,
                       torch.full_like(lanes, C))
    rows = torch.arange(L, device=dev)[:, None].expand(L, B)
    opc = torch.cat([ml.opcodes, ml.opcodes[:, :1]], dim=1)
    arg = torch.cat([ml.args, ml.args[:, :1]], dim=1)
    opc[rows, slot] = opcodes
    arg[rows, slot] = args
    return ml._replace(opcodes=opc[:, :C], args=arg[:, :C],
                       tail=ml.tail + counts)


def _gather_logs(spec, opcodes_ring, args_ring, start, tail, window: int):
    """Each log's window from `start int64[L, ...]` through
    `core/log.py:gather_window`: `(opcodes int32[L, ..., window], args
    int32[L, ..., window, A])`, positions at or past the log's tail
    masked to NOOP."""
    wins = [gather_window(spec, opcodes_ring[l], args_ring[l], start[l],
                          tail[l], window)
            for l in range(opcodes_ring.shape[0])]
    return (torch.stack([w[0] for w in wins]),
            torch.stack([w[1] for w in wins]))


def _exec_one_log(spec, d, opcodes_ring, args_ring, tail, states, ltails,
                  window: int):
    """Per-(log, replica) replay scan, the reference's vmapped
    `lax.scan` as one loop over window offsets: rings `[L, C]`/`[L, C,
    A]`, `tail int64[L]`, `ltails int64[L, R]`, states flattened to `L *
    R` lanes (lane `l * R + r`). Returns `(states, resps int32[L, R,
    window], new_ltails)`; the states are a clone, written in place."""
    L, R = ltails.shape
    A = args_ring.shape[-1]
    rows = torch.arange(L, device=ltails.device)[:, None]
    states = tree_map(lambda x: x.clone(), states)
    resps = []
    for j in range(window):
        pos = ltails + j
        idx = pos & spec.mask
        opcode = torch.where(pos < tail[:, None], opcodes_ring[rows, idx],
                             torch.full_like(idx, NOOP, dtype=torch.int32))
        resps.append(apply_write(d, states, opcode.reshape(L * R),
                                 args_ring[rows, idx].reshape(L * R, A)))
    resps = (torch.stack(resps, dim=1).reshape(L, R, window) if resps
             else torch.zeros((L, R, 0), dtype=torch.int32,
                              device=ltails.device))
    return states, resps, torch.minimum(ltails + window, tail[:, None])


def _exec_one_log_combined(spec, d, opcodes_ring, args_ring, tail, states,
                           ltails, window: int):
    """Combined twin of `_exec_one_log`: gather each (log, replica)'s
    pending window from its own ltail and apply it with the model's
    batched `window_apply` (bit-identical to the scan)."""
    L, R = ltails.shape
    if window == 0:
        return states, torch.zeros((L, R, 0), dtype=torch.int32,
                                   device=ltails.device), ltails
    opc, arg = _gather_logs(spec, opcodes_ring, args_ring, ltails, tail,
                            window)
    states, resps = d.window_apply(states, opc.reshape(L * R, window),
                                   arg.reshape(L * R, window, -1))
    return (states, resps.reshape(L, R, window),
            torch.minimum(ltails + window, tail[:, None]))


def _exec_lockstep(spec, d, opcodes_ring, args_ring, tail, states, ltails,
                   window: int):
    """Lock-step combined replay: every replica of a log starts at the
    same ltail (`ltails[:, 0]` speaks for the fleet), so each log's
    window is gathered once. A sub-model with `window_plan` plans that
    window once, on the log's replica 0, and merges the plan into all
    the log's replicas (the port's `core/step.py` plan-once form; sound
    because the replicas of a log are identical by induction, which
    `make_multilog_step` guarantees); one without applies the shared
    window to every lane. Both preconditions are checked under debug
    checks."""
    L, R = ltails.shape
    lt0 = ltails[:, 0]
    check(lambda: (ltails == lt0[:, None]).all(),
          "lockstep multilog replay requires equal per-replica ltails on "
          "every log: {lt}", lt=ltails)
    opc, arg = _gather_logs(spec, opcodes_ring, args_ring, lt0, tail,
                            window)
    if d.window_plan is not None:
        by_log = tree_map(lambda x: x.reshape((L, R) + tuple(x.shape[1:])),
                          states)
        check(lambda: all(bool((x == x[:, :1]).all())
                          for x in tree_leaves(by_log)),
              "lockstep plan/merge requires identical replicas on every log")
        plan = d.window_plan(tree_map(lambda x: x[:, 0], by_log), opc, arg)
        # plan leaves [L, 1, ...] broadcast over the log's R replicas
        by_log, resps = d.window_merge(
            by_log, tree_map(lambda x: x[:, None], plan))
        states = tree_map(
            lambda x: x.reshape((L * R,) + tuple(x.shape[2:])), by_log)
    else:
        states, resps = d.window_apply(
            states, opc[:, None].expand(L, R, window).reshape(L * R, window),
            arg[:, None].expand(L, R, window, arg.shape[-1]).reshape(
                L * R, window, -1))
    new_lt = torch.minimum(lt0 + window, tail)
    return (states, resps.reshape(L, R, window),
            new_lt[:, None].expand(L, R).clone())


def multilog_exec_all(spec: MultiLogSpec, d: Dispatch, ml: MultiLogState,
                      states: PyTree, window: int,
                      partitioned: "PartitionedModel | None" = None,
                      combined: bool | None = None,
                      lockstep: bool = False):
    """Replay `window` pending entries of every log into every replica
    (the reference's `multilog_exec_all`; its docstring gives the
    contract of `partitioned`, `combined` and `lockstep`).

    With a `PartitionedModel` every (log, replica) replays into its own
    partition as one batched computation: the partitioned scan, the
    combined replay (`combined`, default: when the sub-model has a
    `window_apply`) or, with `lockstep=True`, the combined replay with
    each log's window gathered once. Without one the logs fold into
    the full states one after another.

    Returns `(ml, states, resps int32[L, R, window])`.
    """
    L, R = spec.nlogs, spec.n_replicas
    if partitioned is not None:
        if partitioned.nlogs != spec.nlogs:
            raise ValueError(
                f"PartitionedModel is {partitioned.nlogs}-way but the "
                f"multilog has {spec.nlogs} logs"
            )
        sub = partitioned.sub
        if combined is None:
            combined = sub.window_apply is not None
        if combined and sub.window_apply is None:
            raise ValueError(
                f"combined=True but {sub.name} has no window_apply"
            )
        # [R, K, ...] -> [R, L, K/L, ...] -> [L, R, K/L, ...] -> [L*R, ...]
        stacked = tree_map(
            lambda x: torch.movedim(x, 1, 0).reshape(
                (L * R,) + tuple(x.shape[2:])),
            partitioned.split(states, lead=1),
        )
        if combined and lockstep and window > 0:
            # nrlint: disable=obs-in-traced — per-step tier counter: the step closure runs once per step, on the host
            _m_ml_lockstep.inc()
            exec_fn = _exec_lockstep
        else:
            # nrlint: disable=obs-in-traced — per-step tier counter: the step closure runs once per step, on the host
            (_m_ml_combined if combined else _m_ml_part_scan).inc()
            exec_fn = _exec_one_log_combined if combined else _exec_one_log
        new_subs, resps, new_ltails = exec_fn(
            spec, sub, ml.opcodes, ml.args, ml.tail, stacked, ml.ltails,
            window,
        )
        new_subs = tree_map(
            lambda x: torch.movedim(
                x.reshape((L, R) + tuple(x.shape[1:])), 0, 1),
            new_subs,
        )
        states = partitioned.merge(new_subs, lead=1)
    else:
        # nrlint: disable=obs-in-traced — per-step tier counter: the step closure runs once per step, on the host
        _m_ml_seq.inc()
        one = spec.one_log()
        resps_list, ltails_list = [], []
        for l in range(L):
            states, resps_l, lt_l = _exec_one(
                one, d, log_view(ml, l), states, window)
            resps_list.append(resps_l)
            ltails_list.append(lt_l)
        resps = torch.stack(resps_list)
        new_ltails = torch.stack(ltails_list)
    ml = ml._replace(
        ltails=new_ltails,
        ctail=torch.maximum(ml.ctail, new_ltails.max(dim=1).values),
        head=new_ltails.min(dim=1).values,
    )
    return ml, states, resps


def is_log_synced_for_reads(ml: MultiLogState, log_idx: int, ridx: int,
                            ctail) -> torch.Tensor:
    """Reads sync only their mapped log (`cnr/src/replica.rs:599-617`)."""
    return ml.ltails[log_idx, ridx] >= ctail


def make_multilog_step(dispatch: Dispatch, spec: MultiLogSpec,
                       writes_per_log: int, reads_per_replica: int,
                       partitioned: "PartitionedModel | None" = None,
                       combined: bool | None = None, debug: bool = False):
    """Fused CNR step: per-log append, per-log replay, reads.

    `step(ml, states, wr_opcodes int32[L, B], wr_args int32[L, B, A],
    counts int64[L], rd_opcodes int32[R, Br], rd_args int32[R, Br, A])
    -> (ml, states, wr_resps int32[L, R, B], rd_resps int32[R, Br])`,
    the batch already LogMapper-partitioned (`partition_ops`).
    Precondition: every replica synced on every log at entry (true by
    induction step after step). `debug=True` arms the host-side
    invariants (`utils/checks.py`), here the lock-step equal-ltails
    precondition, and raises `CheckError` on a violation. The
    reference's `jit`/`donate` have no counterpart: the port runs
    eagerly and never writes its inputs.
    """
    B = int(writes_per_log)
    max_batch = spec.capacity - spec.gc_slack
    if B > max_batch:
        raise ValueError(
            f"per-log batch {B} exceeds appendable capacity {max_batch}"
        )

    def step(ml, states, wr_opcodes, wr_args, counts, rd_opcodes, rd_args):
        dev = ml.tail.device
        with debug_checks(debug):
            ml = multilog_append(spec, ml, wr_opcodes, wr_args, counts)
            ml, states, wr_resps = multilog_exec_all(
                spec, dispatch, ml, states, B, partitioned=partitioned,
                combined=combined, lockstep=True,
            )
        rd_resps = dispatch_reads(
            dispatch, states,
            torch.as_tensor(rd_opcodes, dtype=torch.int32, device=dev),
            torch.as_tensor(rd_args, dtype=torch.int32, device=dev),
        )
        return ml, states, wr_resps, rd_resps

    return step


def partition_ops(mapper: LogMapper, nlogs: int,
                  ops: list[tuple[int, tuple]], arg_width: int,
                  pad_to: int | None = None, device=None):
    """Host-side LogMapper application: split `[(opcode, args), ...]`
    into per-log fixed-shape batches (`hash % nlogs`) on `device`
    (None means the card).

    Returns `(opcodes int32[L, B], args int32[L, B, A], counts
    int64[L], placements)` where `placements[i] = (log, slot)` of op i.
    """
    buckets: list[list[tuple[int, tuple]]] = [[] for _ in range(nlogs)]
    placements = []
    for opcode, args in ops:
        h = mapper(opcode, args) % nlogs
        placements.append((h, len(buckets[h])))
        buckets[h].append((opcode, args))
    B = pad_to if pad_to is not None else max(
        1, max(len(b) for b in buckets)
    )
    opcodes = np.full((nlogs, B), NOOP, np.int32)
    args_arr = np.zeros((nlogs, B, arg_width), np.int32)
    counts = np.zeros((nlogs,), np.int64)
    for l, bucket in enumerate(buckets):
        if len(bucket) > B:
            raise ValueError(f"log {l} bucket {len(bucket)} > pad {B}")
        counts[l] = len(bucket)
        for j, (opcode, a) in enumerate(bucket):
            opcodes[l, j] = opcode
            args_arr[l, j, : len(a)] = a
    dev = resolve_device(device)
    return (
        torch.from_numpy(opcodes).to(dev),
        torch.from_numpy(args_arr).to(dev),
        torch.from_numpy(counts).to(dev),
        placements,
    )
