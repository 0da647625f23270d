"""Replicated bounded FIFO queue (PyTorch).

The port of `node_replication_tpu/models/queue.py`: a bounded ring of
int32 values with monotone int32 head/tail cursors, indexed modulo the
capacity (floored, `torch.remainder`).

Write opcodes: Q_ENQ=1 (v -> new length, or -1 when full),
Q_DEQ=2 (-> dequeued value, or -1 when empty).
Read opcodes: Q_FRONT=1 (-> front value or -1), Q_LEN=2 (-> length).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

Q_ENQ = 1
Q_DEQ = 2
Q_FRONT = 1
Q_LEN = 2

EMPTY = -1


def make_queue(capacity: int) -> Dispatch:
    """Bounded FIFO over a ring indexed modulo `capacity`."""

    def make_state(device=None):
        dev = resolve_device(device)
        return {
            "buf": torch.zeros((capacity,), dtype=torch.int32, device=dev),
            "head": torch.zeros((), dtype=torch.int32, device=dev),
            "tail": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _rows(states):
        return torch.arange(states["head"].shape[0],
                            device=states["head"].device)

    def enq(states, args, lanes):
        rows, head, tail = _rows(states), states["head"], states["tail"]
        buf = states["buf"]
        n = tail - head
        ok = n < capacity
        idx = torch.where(ok, torch.remainder(tail, capacity), 0).long()
        buf[rows, idx] = torch.where(lanes & ok, args[:, 0],
                                     buf[rows, idx])
        tail.copy_(torch.where(lanes & ok, tail + 1, tail))
        return torch.where(ok, n + 1, torch.full_like(n, EMPTY))

    def deq(states, args, lanes):
        rows, head, tail = _rows(states), states["head"], states["tail"]
        ok = tail > head
        idx = torch.where(ok, torch.remainder(head, capacity), 0).long()
        val = torch.where(ok, states["buf"][rows, idx],
                          torch.full_like(head, EMPTY))
        head.copy_(torch.where(lanes & ok, head + 1, head))
        return val

    def front(states, args):
        rows, head = _rows(states), states["head"]
        ok = states["tail"] > head
        return torch.where(
            ok, states["buf"][rows, torch.remainder(head, capacity).long()],
            torch.full_like(head, EMPTY),
        )

    def length(states, args):
        return states["tail"] - states["head"]

    def window_plan(state, opcodes, args):
        """Shared half of the combined replay (the reference's
        `window_plan`; its `window_apply` docstring gives the
        algorithm). Leading axes are batch axes."""
        from node_replication_torch.ops.windowkit import (
            clamped_walk,
            last_update_table,
            slot_resolve,
        )

        is_enq = opcodes == Q_ENQ
        is_deq = opcodes == Q_DEQ
        v = args[..., 0]
        delta = torch.where(is_enq, 1, torch.where(is_deq, -1, 0))
        head0, tail0 = state["head"], state["tail"]
        before, after = clamped_walk(delta, 0, capacity, tail0 - head0)
        eff_enq = (is_enq & (before < capacity)).to(torch.int32)
        eff_deq = (is_deq & (before > 0)).to(torch.int32)
        # int32 cumsums, as the reference's (torch's would widen)
        enq_sum = torch.cumsum(eff_enq, dim=-1, dtype=torch.int32)
        deq_sum = torch.cumsum(eff_deq, dim=-1, dtype=torch.int32)
        t_before = tail0.to(torch.int32)[..., None] + enq_sum - eff_enq
        h_before = head0.to(torch.int32)[..., None] + deq_sum - eff_deq
        cap = torch.full_like(before, capacity)
        slot_upd = torch.where(eff_enq > 0,
                               torch.remainder(t_before, capacity), cap)
        slot_qry = torch.where(eff_deq > 0,
                               torch.remainder(h_before, capacity), cap)
        dequeued = slot_resolve(slot_upd, v, slot_qry, state["buf"],
                                capacity)
        empty = torch.full_like(before, EMPTY)
        resps = torch.where(
            is_enq,
            torch.where(eff_enq > 0, before + 1, empty),
            torch.where(is_deq, torch.where(eff_deq > 0, dequeued, empty),
                        torch.zeros_like(before)),
        ).to(torch.int32)
        touched, lastv = last_update_table(slot_upd, v, capacity)
        W = opcodes.shape[-1]
        zero = torch.zeros_like(before[..., 0] if W else head0)
        enq_total = enq_sum[..., W - 1] if W > 0 else zero
        deq_total = deq_sum[..., W - 1] if W > 0 else zero
        return {
            "touched": touched, "lastv": lastv, "resps": resps,
            # ABSOLUTE final cursors, so the plan is prefix-absorbing
            # (see the reference)
            "head_final": (head0 + deq_total).to(torch.int32),
            "tail_final": (tail0 + enq_total).to(torch.int32),
        }

    def window_merge(states, plan):
        buf = torch.where(plan["touched"], plan["lastv"], states["buf"])
        lead = buf.shape[:-1]
        return {
            "buf": buf,
            "head": plan["head_final"].expand(lead).clone(),
            "tail": plan["tail_final"].expand(lead).clone(),
        }, plan["resps"].expand(lead + plan["resps"].shape[-1:])

    def window_apply(states, opcodes, args):
        return window_merge(states, window_plan(states, opcodes, args))

    return Dispatch(
        name=f"queue{capacity}",
        make_state=make_state,
        write_ops=(enq, deq),
        read_ops=(front, length),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        window_canonical=True,
    )
