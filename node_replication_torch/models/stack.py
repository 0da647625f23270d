"""Replicated stack (PyTorch).

The port of `node_replication_tpu/models/stack.py`: a fixed-capacity
buffer plus a top cursor per replica; a push onto a full stack and a
pop from an empty one are dropped with resp -1.

Write opcodes: ST_PUSH=1 (args v -> resp new depth, or -1 when full),
ST_POP=2 (-> resp popped value, or -1 when empty).
Read opcodes: ST_PEEK=1 (-> top value or -1), ST_LEN=2 (-> depth).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

ST_PUSH = 1
ST_POP = 2
ST_PEEK = 1
ST_LEN = 2

EMPTY = -1


def _rows(states):
    return torch.arange(states["top"].shape[0], device=states["top"].device)


def make_stack(capacity: int) -> Dispatch:
    def make_state(device=None):
        dev = resolve_device(device)
        return {
            "buf": torch.zeros((capacity,), dtype=torch.int32, device=dev),
            "top": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def push(states, args, lanes):
        rows, top, buf = _rows(states), states["top"], states["buf"]
        ok = top < capacity
        idx = torch.where(ok, top, capacity - 1).long()
        buf[rows, idx] = torch.where(lanes & ok, args[:, 0],
                                     buf[rows, idx])
        new_top = torch.where(ok, top + 1, top)
        top.copy_(torch.where(lanes, new_top, top))
        return torch.where(ok, new_top, torch.full_like(top, EMPTY))

    def pop(states, args, lanes):
        rows, top = _rows(states), states["top"]
        ok = top > 0
        idx = torch.where(ok, top - 1, 0).long()
        val = torch.where(ok, states["buf"][rows, idx],
                          torch.full_like(top, EMPTY))
        top.copy_(torch.where(lanes & ok, top - 1, top))
        return val

    def peek(states, args):
        rows, top = _rows(states), states["top"]
        return torch.where(
            top > 0, states["buf"][rows, (top - 1).clamp(min=0).long()],
            torch.full_like(top, EMPTY),
        )

    def length(states, args):
        return states["top"]

    def window_plan(state, opcodes, args):
        """The shared (sorting) half of the combined replay (the
        reference's `window_plan`; its `window_apply` docstring gives
        the algorithm): the clamped depth walk, the slot-keyed sort
        resolving pops, the per-slot last-push table and the
        responses. Leading axes are batch axes."""
        from node_replication_torch.ops.windowkit import (
            clamped_walk,
            last_update_table,
            slot_resolve,
        )

        is_push = opcodes == ST_PUSH
        is_pop = opcodes == ST_POP
        v = args[..., 0]
        delta = torch.where(is_push, 1, torch.where(is_pop, -1, 0))
        before, after = clamped_walk(delta, 0, capacity, state["top"])
        eff_push = is_push & (before < capacity)
        eff_pop = is_pop & (before > 0)
        cap = torch.full_like(before, capacity)
        slot_upd = torch.where(eff_push, before, cap)
        slot_qry = torch.where(eff_pop, before - 1, cap)
        popped = slot_resolve(slot_upd, v, slot_qry, state["buf"],
                              capacity)
        empty = torch.full_like(before, EMPTY)
        resps = torch.where(
            is_push,
            torch.where(eff_push, before + 1, empty),
            torch.where(is_pop, torch.where(eff_pop, popped, empty),
                        torch.zeros_like(before)),
        ).to(torch.int32)
        touched, lastv = last_update_table(slot_upd, v, capacity)
        W = opcodes.shape[-1]
        top = (after[..., W - 1] if W > 0 else state["top"]).to(
            torch.int32)
        return {"touched": touched, "lastv": lastv, "top": top,
                "resps": resps}

    def window_merge(states, plan):
        """Per-replica dense merge of the shared plan; responses come
        back broadcast to the states' leading axes."""
        buf = torch.where(plan["touched"], plan["lastv"], states["buf"])
        lead = buf.shape[:-1]
        return {"buf": buf, "top": plan["top"].expand(lead).clone()}, \
            plan["resps"].expand(lead + plan["resps"].shape[-1:])

    def window_apply(states, opcodes, args):
        return window_merge(states, window_plan(states, opcodes, args))

    return Dispatch(
        name=f"stack{capacity}",
        make_state=make_state,
        write_ops=(push, pop),
        read_ops=(peek, length),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        window_canonical=True,
    )
