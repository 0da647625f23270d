"""Open-addressing hash map for sparse keyspaces (PyTorch).

The port of `node_replication_tpu/models/oahashmap.py`: a real hash
table over arbitrary int32 keys, linear probing over a STATIC window of
`probe` slots from the key's hash home (wrapping past the end), three
int32 planes per replica (`keys`, `vals`, `flag`: 0 empty, 1 occupied,
2 tombstone). Every op gathers its window, picks the first match, else
the first free slot, and writes one slot; keys only ever live inside
their own window, so membership is "a match anywhere in the window".
An insert whose window holds neither is DROPPED with resp -2.

Write opcodes: OA_PUT=1 (k, v -> 0 ok, -2 window full), OA_REMOVE=2
(k -> 1 was present, else 0). Read opcodes: OA_GET=1 (k -> value, or -1
absent).

The reference hashes in uint32 (`_mix`); PyTorch has no general uint32
arithmetic, so `_mix` works on the uint32 value held in int64 (a
negative key k is 2^32 + k) and keeps every product below 2^63.
"""

from __future__ import annotations

import torch

from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.device import resolve_device

OA_PUT = 1
OA_REMOVE = 2
OA_GET = 1

ABSENT = -1
DROPPED = -2

_EMPTY = 0
_OCC = 1
_TOMB = 2

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """`x * c mod 2^32` for `x` in [0, 2^32) (int64) and a 32-bit
    constant, in two 16-bit halves so no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 mix of int32 keys, as int64 in [0, 2^32)."""
    x = x.long() & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def probe_window(keys: torch.Tensor, n_slots: int,
                 probe: int) -> torch.Tensor:
    """int64 `[..., probe]`: the slots `(home + i) mod n_slots` of each
    key's window, `home = _mix(k) mod n_slots`."""
    home = torch.remainder(_mix(keys), n_slots)
    off = torch.arange(probe, dtype=torch.int64, device=keys.device)
    return torch.remainder(home[..., None] + off, n_slots)


def first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the first True along the last axis, whether any): the
    index is 0 where there is none."""
    n = mask.shape[-1]
    pos = torch.arange(n, dtype=torch.int64, device=mask.device)
    first = torch.where(mask, pos, n).amin(-1)
    return first.clamp(max=n - 1), first < n


def make_oahashmap(n_slots: int, probe: int = 16) -> Dispatch:
    """Open-addressed table of `n_slots` with a `probe`-slot window."""

    def make_state(device=None):
        dev = resolve_device(device)
        z = lambda: torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return {"keys": z(), "vals": z(), "flag": z()}

    def _scan(states, k):
        """Per replica: the window, its match mask and its free mask."""
        idx = probe_window(k, n_slots, probe)
        flags = states["flag"].gather(1, idx)
        match = (flags == _OCC) & (states["keys"].gather(1, idx)
                                   == k[:, None])
        return idx, match, flags != _OCC

    def put(states, args, lanes):
        k, v = args[:, 0], args[:, 1]
        idx, match, free = _scan(states, k)
        fm, any_match = first_true(match)
        ff, any_free = first_true(free)
        ok = any_match | any_free
        slot = idx.gather(1, torch.where(any_match, fm, ff)[:, None])[:, 0]
        rows = torch.arange(k.shape[0], device=k.device)
        w = ok & lanes
        for key, new in (("keys", k), ("vals", v),
                         ("flag", torch.full_like(k, _OCC))):
            plane = states[key]
            plane[rows, slot] = torch.where(w, new, plane[rows, slot])
        return torch.where(ok, 0, DROPPED).to(torch.int32)

    def remove(states, args, lanes):
        k = args[:, 0]
        idx, match, _ = _scan(states, k)
        fm, was = first_true(match)
        slot = idx.gather(1, fm[:, None])[:, 0]
        rows = torch.arange(k.shape[0], device=k.device)
        flag = states["flag"]
        flag[rows, slot] = torch.where(was & lanes, _TOMB, flag[rows, slot])
        return was.to(torch.int32)

    def get(states, args):
        k = args[:, 0]
        idx, match, _ = _scan(states, k)
        fm, found = first_true(match)
        got = states["vals"].gather(1, idx.gather(1, fm[:, None]))[:, 0]
        return torch.where(found, got, torch.full_like(got, ABSENT))

    return Dispatch(
        name=f"oahashmap{n_slots}p{probe}",
        make_state=make_state,
        write_ops=(put, remove),
        read_ops=(get,),
        arg_width=3,
    )
