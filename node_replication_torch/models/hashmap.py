"""Replicated hash map, dense-keyspace variant (PyTorch).

The port of `node_replication_tpu/models/hashmap.py`: a dense
`values: int32[K]` + `present: bool[K]` table per replica, keys hashed
onto it with the floored `k % K` (`torch.remainder`, not C's `%`).

Write opcodes: HM_PUT=1 (args k, v -> resp 0), HM_REMOVE=2 (args k ->
resp 1 if the key was present else 0). Read opcodes: HM_GET=1 (args k
-> resp value, or -1 when absent).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

HM_PUT = 1
HM_REMOVE = 2
HM_GET = 1

ABSENT = -1


def make_hashmap(n_keys: int, prefill_value: int | None = None) -> Dispatch:
    """Build the hashmap Dispatch over a dense table of `n_keys` slots.

    `prefill_value` pre-populates every key.
    """

    def make_state(device=None):
        dev = resolve_device(device)
        if prefill_value is None:
            return {
                "values": torch.zeros((n_keys,), dtype=torch.int32,
                                      device=dev),
                "present": torch.zeros((n_keys,), dtype=torch.bool,
                                       device=dev),
            }
        return {
            "values": torch.full((n_keys,), prefill_value,
                                 dtype=torch.int32, device=dev),
            "present": torch.ones((n_keys,), dtype=torch.bool, device=dev),
        }

    def _cells(states, args):
        rows = torch.arange(states["values"].shape[0],
                            device=args.device)
        return rows, torch.remainder(args[:, 0], n_keys).long()

    def put(states, args, lanes):
        rows, k = _cells(states, args)
        values, present = states["values"], states["present"]
        values[rows, k] = torch.where(lanes, args[:, 1], values[rows, k])
        present[rows, k] = lanes | present[rows, k]
        return torch.zeros_like(args[:, 0])

    def remove(states, args, lanes):
        rows, k = _cells(states, args)
        values, present = states["values"], states["present"]
        was = present[rows, k]
        values[rows, k] = torch.where(
            lanes, torch.zeros_like(args[:, 0]), values[rows, k]
        )
        present[rows, k] = was & ~lanes
        return was.to(torch.int32)

    def get(states, args):
        rows, k = _cells(states, args)
        return torch.where(
            states["present"][rows, k], states["values"][rows, k],
            torch.full_like(args[:, 0], ABSENT),
        )

    def window_plan(state, opcodes, args):
        """Combined replay of a whole window (the reference's
        `window_plan`; see its docstring for the algorithm).

        PUT/REMOVE are last-writer-wins per key: group entries by key
        with one STABLE sort; presence-before(entry) is the same-key
        predecessor's effect, else the replica's initial presence; each
        key's last active entry (a scatter-max of window positions,
        order-independent hence deterministic) gives the final cell.
        Leading axes of `state` and the window are batch axes (one plan
        per replica for the per-replica `window_apply` tier).
        """
        W = opcodes.shape[-1]
        k = torch.remainder(args[..., 0], n_keys)
        v = args[..., 1]
        is_put = opcodes == HM_PUT
        is_rem = opcodes == HM_REMOVE
        active = is_put | is_rem
        # inactive slots group into a sentinel bucket past the keyspace
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
        # the reference's `.at[sk].get(mode="clip")`: the sentinel
        # clamps onto the last real key, harmless (never a REMOVE)
        init_present = state["present"].gather(
            -1, sk.clamp(max=n_keys - 1)
        )
        pres_before = torch.where(same_prev, is_put.gather(-1, prev),
                                  init_present)
        resp_sorted = torch.where(
            is_rem.gather(-1, order), pres_before.to(torch.int32),
            torch.zeros_like(opcodes),
        )
        # `order` is a permutation: no duplicate scatter indices
        resps = torch.zeros_like(opcodes).scatter(-1, order, resp_sorted)
        last = torch.full(
            key_eff.shape[:-1] + (n_keys + 1,), -1, dtype=torch.long,
            device=opcodes.device,
        ).scatter_reduce(-1, key_eff, idx, "amax",
                         include_self=True)[..., :n_keys]
        touched = last >= 0
        li = last.clamp(min=0)
        last_is_put = is_put.gather(-1, li)
        return {
            "touched": touched,
            "value": torch.where(last_is_put, v.gather(-1, li),
                                 torch.zeros_like(li, dtype=v.dtype)),
            "present": last_is_put,
            "resps": resps,
        }

    def window_merge(states, plan):
        """Blend `plan` into `states`; responses come back broadcast to
        the states' leading axes (a read-only view)."""
        values = torch.where(plan["touched"], plan["value"],
                             states["values"])
        present = torch.where(plan["touched"], plan["present"],
                              states["present"])
        resps = plan["resps"]
        lead = values.shape[:-1]
        return {"values": values, "present": present}, resps.expand(
            lead + resps.shape[-1:]
        )

    def window_apply(states, opcodes, args):
        # arbitrary-state form: the plan's presence-before half reads
        # THIS state, so the composition is the full per-replica fold
        return window_merge(states, window_plan(states, opcodes, args))

    def fused_factory(spec, device=None):
        from node_replication_torch.ops.replay import FusedHashmapEngine

        return FusedHashmapEngine(n_keys, spec, device=device)

    return Dispatch(
        name=f"hashmap{n_keys}",
        make_state=make_state,
        write_ops=(put, remove),
        read_ops=(get,),
        arg_width=3,
        window_apply=window_apply,
        window_plan=window_plan,
        window_merge=window_merge,
        # prefix-absorbing plan + canonical responses, pinned by
        # tests/test_torch_window.py
        window_canonical=True,
        fused_factory=fused_factory,
    )
