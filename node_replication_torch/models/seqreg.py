"""Sequence-register model: per-slot fetch-and-set, the serve-layer
correctness oracle (PyTorch).

The port of `node_replication_tpu/models/seqreg.py`. A dense array of
int32 registers where the ONLY write op sets a slot and returns its
PREVIOUS value. That response makes lost, duplicated and reordered
executions all observable from the client side: a client that owns
slot `s` and writes the values `1, 2, 3, …` in order must read back
exactly `0, 1, 2, …` — any gap is a lost op, any repeat a duplicate,
any other mismatch a reorder.

Responses depend on the pre-state of each entry, so the model has no
combined window form and no fused kernel on purpose: it runs the
generic per-entry scan replay (`core/log.py:log_exec_all`).

Write opcodes: SR_SET=1 (args slot, v -> resp previous value).
Read opcodes: SR_GET=1 (args slot -> resp current value).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

SR_SET = 1
SR_GET = 1


def make_seqreg(n_slots: int) -> Dispatch:
    """Build the sequence-register Dispatch over `n_slots` registers
    (all initially 0). Slots index with the floored `slot % n_slots`."""

    def make_state(device=None):
        return {"values": torch.zeros((n_slots,), dtype=torch.int32,
                                      device=resolve_device(device))}

    def _cells(states, args):
        rows = torch.arange(states["values"].shape[0],
                            device=args.device)
        return rows, torch.remainder(args[:, 0], n_slots).long()

    def fetch_and_set(states, args, lanes):
        rows, s = _cells(states, args)
        values = states["values"]
        old = values[rows, s]
        values[rows, s] = torch.where(lanes, args[:, 1], old)
        return old

    def get(states, args):
        rows, s = _cells(states, args)
        return states["values"][rows, s]

    return Dispatch(
        name=f"seqreg{n_slots}",
        make_state=make_state,
        write_ops=(fetch_and_set,),
        read_ops=(get,),
        arg_width=3,
    )
