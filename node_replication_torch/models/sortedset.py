"""Replicated ordered set over a bounded keyspace (PyTorch).

The port of `node_replication_tpu/models/sortedset.py`: a presence
bitmap per replica, keys folded with the floored `k % n_keys`;
membership is one gather, the order statistics are masked reductions.
`sortedset_log_mapper` partitions by key (equal keys conflict and share
a log; distinct keys commute).

Write opcodes:
  SS_INSERT=1  args (k) -> resp 1 if newly inserted else 0.
  SS_REMOVE=2  args (k) -> resp 1 if present else 0.
Read opcodes:
  SS_CONTAINS=1    args (k) -> 0/1.
  SS_RANGE_COUNT=2 args (lo, hi) -> #elements in [lo, hi).
  SS_RANK=3        args (k) -> #elements < k.
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

SS_INSERT = 1
SS_REMOVE = 2
SS_CONTAINS = 1
SS_RANGE_COUNT = 2
SS_RANK = 3


def sortedset_log_mapper(opcode: int, args: tuple) -> int:
    return args[0]


def make_sortedset(n_keys: int) -> Dispatch:
    def make_state(device=None):
        return {"present": torch.zeros((n_keys,), dtype=torch.bool,
                                       device=resolve_device(device))}

    def _cells(states, args):
        rows = torch.arange(states["present"].shape[0],
                            device=args.device)
        return rows, torch.remainder(args[:, 0], n_keys).long()

    def insert(states, args, lanes):
        rows, k = _cells(states, args)
        present = states["present"]
        was = present[rows, k]
        present[rows, k] = was | lanes
        return (~was).to(torch.int32)

    def remove(states, args, lanes):
        rows, k = _cells(states, args)
        present = states["present"]
        was = present[rows, k]
        present[rows, k] = was & ~lanes
        return was.to(torch.int32)

    def contains(states, args):
        rows, k = _cells(states, args)
        return states["present"][rows, k].to(torch.int32)

    def range_count(states, args):
        ks = torch.arange(n_keys, dtype=torch.int32, device=args.device)
        mask = ((ks >= args[:, 0:1]) & (ks < args[:, 1:2])
                & states["present"])
        return mask.sum(dim=-1).to(torch.int32)

    def rank(states, args):
        ks = torch.arange(n_keys, dtype=torch.int32, device=args.device)
        return ((ks < args[:, 0:1]) & states["present"]).sum(dim=-1).to(
            torch.int32)

    def window_plan(state, opcodes, args):
        """Combined replay (the reference's `window_plan`, the hashmap
        twin): insert/remove are last-writer-wins per key; every
        response is presence-just-before. One stable sort, a
        predecessor lookup and a scatter-max of window positions.
        Leading axes are batch axes."""
        W = opcodes.shape[-1]
        k = torch.remainder(args[..., 0], n_keys)
        is_ins = opcodes == SS_INSERT
        is_rem = opcodes == SS_REMOVE
        active = is_ins | is_rem
        key_eff = torch.where(active, k.long(),
                              torch.full_like(k, n_keys, dtype=torch.long))
        idx = torch.arange(W, dtype=torch.long,
                           device=opcodes.device).expand_as(key_eff)
        sk, order = torch.sort(key_eff, dim=-1, stable=True)
        same_prev = torch.cat(
            [torch.zeros_like(sk[..., :1], dtype=torch.bool),
             sk[..., 1:] == sk[..., :-1]], dim=-1,
        )
        prev = torch.cat([order[..., :1], order[..., :-1]], dim=-1)
        init_present = state["present"].gather(
            -1, sk.clamp(max=n_keys - 1))
        pres_before = torch.where(same_prev, is_ins.gather(-1, prev),
                                  init_present)
        zero = torch.zeros_like(opcodes)
        resp_sorted = torch.where(
            is_ins.gather(-1, order), (~pres_before).to(torch.int32),
            torch.where(is_rem.gather(-1, order),
                        pres_before.to(torch.int32), zero),
        )
        resps = zero.scatter(-1, order, resp_sorted)
        last = torch.full(
            key_eff.shape[:-1] + (n_keys + 1,), -1, dtype=torch.long,
            device=opcodes.device,
        ).scatter_reduce(-1, key_eff, idx, "amax",
                         include_self=True)[..., :n_keys]
        touched = last >= 0
        li = last.clamp(min=0)
        return {"touched": touched, "present": is_ins.gather(-1, li),
                "resps": resps}

    def window_merge(states, plan):
        present = torch.where(plan["touched"], plan["present"],
                              states["present"])
        lead = present.shape[:-1]
        return {"present": present}, plan["resps"].expand(
            lead + plan["resps"].shape[-1:])

    def window_apply(states, opcodes, args):
        return window_merge(states, window_plan(states, opcodes, args))

    return Dispatch(
        name=f"sortedset{n_keys}",
        make_state=make_state,
        write_ops=(insert, remove),
        read_ops=(contains, range_count, rank),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        window_canonical=True,
    )
