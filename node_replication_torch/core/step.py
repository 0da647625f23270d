"""Fused append -> replay -> read step: the lock-step batch path (PyTorch).

The port of `node_replication_tpu/core/step.py`: one step

1. concatenates every replica's write batch in replica-major order,
2. appends it to the log,
3. replays the appended window into all replicas,
4. answers each replica's read batch against its post-replay state.

Precondition (the combined engines rely on it): all replicas are synced
(`ltails == tail`) and hold identical states when the step begins —
true by induction for fleets driven only by this step. The reference's
`jit`/`donate` arguments have no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import os

import torch

from node_replication_torch.core.log import (
    LogSpec,
    gather_window,
    log_append,
    log_exec_all,
)
from node_replication_torch.ops.encoding import Dispatch, dispatch_reads
from node_replication_torch.utils.tree import tree_leaves, tree_map


class LockstepError(RuntimeError):
    """A combined step was handed a fleet that is not lock-step."""


def make_step(
    dispatch: Dispatch,
    spec: LogSpec,
    writes_per_replica: int,
    reads_per_replica: int,
    combined: bool | None = None,
    check_lockstep: bool | None = None,
):
    """Build `step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args)
    -> (log, states, wr_resps int32[R, Bw], rd_resps int32[R, Br])`.

    Shapes: `wr_opcodes int32[R, Bw]`, `wr_args int32[R, Bw, A]`,
    `rd_opcodes int32[R, Br]`, `rd_args int32[R, Br, A]`.
    `wr_resps[r, j]` answers replica r's j-th write (from r's own
    replay of its own entry); NOOP slots answer 0.

    `combined`: True = the model's combined replay (plan once, merge per
    replica), False = the scan, None = combined when the model has one.
    `check_lockstep` (or env NR_TPU_CHECK_LOCKSTEP=1 with the default
    None) makes a combined step verify synced cursors — and, for the
    plan/merge split, identical replica states — before it runs, and
    raise `LockstepError` otherwise (one host readback per step).
    """
    R = spec.n_replicas
    Bw = int(writes_per_replica)
    Br = int(reads_per_replica)
    span = R * Bw
    max_batch = spec.capacity - spec.gc_slack
    if span > max_batch:
        raise ValueError(
            f"step appends {span} entries but log fits {max_batch}; "
            f"grow LogSpec.capacity or shrink the per-step batch"
        )
    if (dispatch.window_plan is None) != (dispatch.window_merge is None):
        raise ValueError(
            f"{dispatch.name}: window_plan and window_merge come as a "
            f"pair (got only one)"
        )
    has_combined = (
        dispatch.window_apply is not None
        or dispatch.window_plan is not None
    )
    if combined is None:
        combined = has_combined
    if combined and not has_combined:
        raise ValueError(
            f"combined=True but {dispatch.name} has no window_apply "
            f"or window_plan/window_merge"
        )
    if check_lockstep is None:
        check_lockstep = os.environ.get("NR_TPU_CHECK_LOCKSTEP", "") == "1"
    guard_combined = bool(check_lockstep and combined)
    guard_plan = guard_combined and dispatch.window_plan is not None

    def step(log, states, wr_opcodes, wr_args, rd_opcodes, rd_args):
        if guard_combined:
            # nrlint: disable=scalar-cast-in-jit — the opt-in lock-step guard (check_lockstep) reads back once per step by design
            ok = bool((log.ltails == log.tail).all())
            msg = "combined step requires synced cursors (ltails == tail)"
            if guard_plan:
                ok = ok and all(bool((leaf == leaf[:1]).all())
                                for leaf in tree_leaves(states))
                msg = ("plan/merge fast path requires a lock-step fleet "
                       "(synced cursors + identical replica states)")
            if not ok:
                raise LockstepError(
                    msg + "; use combined=False or NodeReplicated "
                    "catch-up for divergent fleets"
                )
        # 1-2. replica-major concatenation + one batched append
        log = log_append(
            spec, log, wr_opcodes.reshape(span),
            wr_args.reshape(span, spec.arg_width), span,
        )
        # 3. replay exactly the appended window into every replica
        if combined and span == 0:
            resps = torch.zeros((R, 0), dtype=torch.int32,
                                device=log.tail.device)
        elif combined:
            opc_w, args_w = gather_window(
                spec, log.opcodes, log.args, log.tail - span, log.tail,
                span,
            )
            if dispatch.window_plan is not None:
                # plan once on a representative replica (lock-step
                # precondition), merge into every replica
                plan = dispatch.window_plan(
                    tree_map(lambda x: x[0], states), opc_w, args_w
                )
                states, resps = dispatch.window_merge(states, plan)
            else:
                states, resps = dispatch.window_apply(
                    states, opc_w.expand(R, span),
                    args_w.expand(R, span, spec.arg_width),
                )
            # lock-step cursor bookkeeping: every replica consumed the span
            log = log._replace(
                ltails=log.tail.expand(R).clone(),
                ctail=log.tail.clone(), head=log.tail.clone(),
            )
        else:
            log, states, resps = log_exec_all(spec, dispatch, log, states,
                                              span)
        # replica r's own writes sit at window offsets [r*Bw, (r+1)*Bw)
        dev = log.tail.device
        own = (torch.arange(R, dtype=torch.int64, device=dev)[:, None] * Bw
               + torch.arange(Bw, dtype=torch.int64, device=dev)[None, :])
        wr_resps = torch.gather(resps, 1, own)
        # 4. per-replica read batches against post-replay local state
        rd_resps = dispatch_reads(dispatch, states, rd_opcodes, rd_args)
        return log, states, wr_resps, rd_resps

    return step
