"""Operation encoding and the `Dispatch` contract (PyTorch).

The port of `node_replication_tpu/ops/encoding.py`. An operation is a
fixed-width record `(opcode: int32, args: int32[arg_width])`; opcode 0
is NOOP in both the write and the read space, so padded or masked
slots replay as no-ops.

The reference's transitions are per-replica pure functions that `vmap`
lifts over the replica axis and `lax.switch` selects by opcode. PyTorch
has neither, so the port's transitions are written over the replica
axis directly:

- `write_ops[i](states, args, lanes) -> resp` applies write op i+1 IN
  PLACE to the lanes (replicas) where the bool mask `lanes[R]` is set,
  with `args int32[R, A]`, and returns `resp int32[R]` (read only where
  `lanes` is set). Each lane touches its own replica row, so no two
  writes of one call hit the same element.
- `read_ops[i](states, args) -> resp` answers read op i+1 for every
  lane, pure.

`apply_write`/`apply_read` take the opcode as an index into that branch
table (out-of-range opcodes index the NOOP branch, as in the
reference): each write branch runs masked to the lanes whose opcode
selects it, and the read branches' answers are stacked and gathered by
the same index. The fleet-level functions (`core/log.py`) clone the
states once before applying, so they stay functional to their callers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

PyTree = Any

# Reserved opcode: replay/padding no-op in both the write and read spaces.
NOOP = 0

# Responses are a single int32 lane; "None" is encoded as -1 by the
# bundled models.
RESP_DTYPE = torch.int32


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """A replicated data structure: state constructor + transitions.

    `make_state(device=None)` builds ONE replica's state (a dict of
    tensors) on `device` (None means the card, `utils/device.py`).
    `write_ops`/`read_ops` are the fleet-level transitions described in
    the module docstring.

    `window_plan`/`window_merge`/`window_apply` are the combined replay
    (see the reference's `Dispatch` docstring for the lock-step and the
    `window_canonical` prefix-absorbing contracts, which hold here
    unchanged). In the port they take a leading batch axis where the
    reference takes `vmap`: `window_plan(state, opcodes, args)` plans a
    window `[..., W]` against a state with the same leading axes (none
    for one replica), and `window_merge(states, plan)` blends a plan
    into a fleet `[R, ...]`, returning `(states, resps[R, W])`.

    `fused_factory(spec, device=None)` builds the model's one-launch
    combiner-round engine (`ops/replay.py:FusedHashmapEngine`).
    """

    name: str
    make_state: Callable[..., PyTree]
    write_ops: tuple
    read_ops: tuple
    arg_width: int = 3
    window_apply: Callable | None = None
    window_plan: Callable | None = None
    window_merge: Callable | None = None
    window_canonical: bool = False
    fused_factory: Callable | None = None

    @property
    def n_write_ops(self) -> int:
        return len(self.write_ops)

    @property
    def n_read_ops(self) -> int:
        return len(self.read_ops)

    def init_state(self, device=None) -> PyTree:
        return self.make_state(device)


def _branch_index(opcode: torch.Tensor, n_branches: int) -> torch.Tensor:
    valid = (opcode >= 0) & (opcode < n_branches)
    return torch.where(valid, opcode, torch.zeros_like(opcode))


def apply_write(d: Dispatch, states: PyTree, opcode: torch.Tensor,
                args: torch.Tensor) -> torch.Tensor:
    """Apply one encoded write per replica IN PLACE: `opcode int32[R]`,
    `args int32[R, A]` -> `resp int32[R]`. Unknown opcodes are inert
    NOOPs (resp 0)."""
    idx = _branch_index(opcode, len(d.write_ops) + 1)
    resp = torch.zeros(opcode.shape, dtype=RESP_DTYPE, device=opcode.device)
    for i, f in enumerate(d.write_ops, start=1):
        lanes = idx == i
        r = f(states, args, lanes)
        resp = torch.where(lanes, r.to(RESP_DTYPE), resp)
    return resp


def apply_read(d: Dispatch, states: PyTree, opcode: torch.Tensor,
               args: torch.Tensor) -> torch.Tensor:
    """Answer one encoded read per replica: `opcode int32[R]`, `args
    int32[R, A]` -> `int32[R]` (never mutates)."""
    idx = _branch_index(opcode, len(d.read_ops) + 1)
    answers = [torch.zeros(opcode.shape, dtype=RESP_DTYPE,
                           device=opcode.device)]
    answers += [f(states, args).to(RESP_DTYPE) for f in d.read_ops]
    table = torch.stack(answers)  # [n_branches, R]
    return table.gather(0, idx.long()[None]).squeeze(0)


def dispatch_reads(d: Dispatch, states: PyTree, rd_opcodes: torch.Tensor,
                   rd_args: torch.Tensor) -> torch.Tensor:
    """Per-replica read batches against local replica state:
    `rd_opcodes int32[R, Br]`, `rd_args int32[R, Br, A]` ->
    `int32[R, Br]`."""
    cols = [apply_read(d, states, rd_opcodes[:, j], rd_args[:, j])
            for j in range(rd_opcodes.shape[1])]
    if not cols:
        return torch.zeros(rd_opcodes.shape, dtype=RESP_DTYPE,
                           device=rd_opcodes.device)
    return torch.stack(cols, dim=1)


def encode_ops(
    ops: Sequence[tuple], arg_width: int, pad_to: int | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Encode a host-side list of `(opcode, *args)` tuples into tensors
    on `device` (None means the card).

    Returns `(opcodes int32[B], args int32[B, arg_width], count)` where
    slots past `count` are NOOP padding; `pad_to` fixes B.
    """
    from node_replication_torch.utils.device import resolve_device

    n = len(ops)
    pad = n if pad_to is None else pad_to
    if n > pad:
        raise ValueError(f"{n} ops do not fit in pad_to={pad}")
    opcodes = np.full((pad,), NOOP, np.int32)
    args = np.zeros((pad, arg_width), np.int32)
    for i, o in enumerate(ops):
        opcodes[i] = int(o[0])
        args[i, : len(o) - 1] = o[1:]
    dev = resolve_device(device)
    return (
        torch.from_numpy(opcodes).to(dev),
        torch.from_numpy(args).to(dev),
        n,
    )
