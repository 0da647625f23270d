"""Synthetic tunable-cost data structure (PyTorch).

The port of `node_replication_tpu/models/synthetic.py`: state is
`lines: int32[n]`; an op touches `cold_*` lines drawn from the whole
state and `hot_*` lines from a small hot set, the lines derived from
its seed by a splitmix-style uint32 hash. Reads fold into a checksum,
writes add `seed + checksum` to the written lines.

The hash runs in int64 masked to 32 bits (torch's uint32 lacks
multiply and shift on many builds). The checksum is summed in int64,
as the reference's int32 sum is under x64, and wraps to int32 where it
becomes a response or an update.

Write opcode SYN_WRITE=1 (args seed -> resp checksum of read lines);
read opcode SYN_READ=1 (same footprint, no mutation).
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

SYN_WRITE = 1
SYN_READ = 1

_M32 = 0xFFFFFFFF


def _mix(x):
    # splitmix32-style avalanche over uint32 values held in int64
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _lines(seed, count: int, n: int, salt: int):
    """`int64[R, count]` line indices for seeds `int32[R]`."""
    i = torch.arange(count, dtype=torch.int64, device=seed.device)
    x = ((seed.to(torch.int64) & _M32)[:, None]
         + ((salt * 0x9E3779B9) & _M32) + i) & _M32
    return torch.remainder(_mix(x), n)


def make_synthetic(
    n: int = 200_000,
    cold_reads: int = 20,
    cold_writes: int = 5,
    hot_reads: int = 2,
    hot_writes: int = 1,
    hot_set: int = 1024,
) -> Dispatch:
    hot_set = min(hot_set, n)

    def make_state(device=None):
        return {"lines": torch.zeros((n,), dtype=torch.int32,
                                     device=resolve_device(device))}

    def footprint(states, seed):
        cr = _lines(seed, cold_reads, n, 1)
        idx = (torch.cat([cr, _lines(seed, hot_reads, hot_set, 2)], dim=1)
               if hot_reads else cr)
        return states["lines"].gather(1, idx).sum(dim=1)  # int64

    def write(states, args, lanes):
        seed = args[:, 0]
        checksum = footprint(states, seed)
        cw = _lines(seed, cold_writes, n, 3)
        idx = (torch.cat([cw, _lines(seed, hot_writes, hot_set, 4)],
                         dim=1)
               if hot_writes else cw)
        add = torch.where(lanes, seed.to(torch.int64) + checksum, 0)
        # duplicate lines add up, as `.at[idx].add` does; integer adds
        # do not depend on their order, so this is deterministic
        states["lines"].scatter_add_(
            1, idx, add.to(torch.int32)[:, None].expand(idx.shape))
        return checksum.to(torch.int32)

    def read(states, args):
        return footprint(states, args[:, 0]).to(torch.int32)

    return Dispatch(
        name=f"synthetic{n}",
        make_state=make_state,
        write_ops=(write,),
        read_ops=(read,),
        arg_width=3,
    )
