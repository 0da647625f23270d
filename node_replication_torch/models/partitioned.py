"""State-partitioned models: the parallel multi-log replay (PyTorch).

The port of `node_replication_tpu/models/partitioned.py` (see its
docstring for the CNR argument): ops on different logs commute, so
each log's span can replay into a disjoint partition of the state, and
all L per-log replays run as one batched computation.

A `PartitionedModel` holds the full `Dispatch`, the `sub` Dispatch over
one partition (write args arrive with full keys; `k -> k // L` maps
them into the partition), and `split`/`merge`, the reshapes between a
state and its `[L, ...]` stacked partitions. Partition l owns every key
congruent to l mod L, so `split` is `[K] -> [K/L, L] -> [L, K/L]`.
`split`/`merge` take `lead=`, the number of leading batch axes before
the keyed axis (0 for one replica's state, 1 for a fleet `[R, K]`,
giving `[R, L, K/L]`).

Replay through `split -> per-log replay with sub -> merge` is
bit-identical to the sequential fold with `full` iff every op on log l
has `args[0] % L == l` (the LogMapper invariant).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from node_replication_torch.models.hashmap import make_hashmap
from node_replication_torch.models.memfs import make_memfs
from node_replication_torch.models.sortedset import make_sortedset
from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.tree import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PartitionedModel:
    """A Dispatch plus its L-way disjoint state partition."""

    full: Dispatch
    sub: Dispatch
    nlogs: int
    split: Callable[..., PyTree]
    merge: Callable[..., PyTree]

    @property
    def name(self) -> str:
        return f"{self.full.name}/p{self.nlogs}"


def _congruence_split(nlogs: int):
    """split/merge for trees whose every leaf is keyed by the axis
    `lead` of congruence classes: `[..., K, ...] -> [..., L, K/L, ...]`
    with `stacked[..., l, j] = state[..., j * L + l]`."""

    def split(state: PyTree, lead: int = 0) -> PyTree:
        def one(x):
            s = tuple(x.shape)
            x = x.reshape(s[:lead] + (s[lead] // nlogs, nlogs)
                          + s[lead + 1:])
            return torch.movedim(x, lead + 1, lead)

        return tree_map(one, state)

    def merge(stacked: PyTree, lead: int = 0) -> PyTree:
        def one(x):
            s = tuple(x.shape)
            x = torch.movedim(x, lead, lead + 1)
            return x.reshape(s[:lead] + (s[lead] * s[lead + 1],)
                             + s[lead + 2:])

        return tree_map(one, stacked)

    return split, merge


def _div_arg0(d: Dispatch, nlogs: int, name: str) -> Dispatch:
    """Wrap a Dispatch so args[0] is floor-divided by L before each op
    (the partition-local addressing `k -> k // L`); the combined
    `window_apply` and `window_plan` get the same transform on their
    whole window (`window_merge` reads no args). The reference leaves
    `window_plan` unwrapped, as nothing of it plans a partition's
    window; the port's lock-step multilog replay does."""

    def div(args):
        args = args.clone()
        args[..., 0] = torch.div(args[..., 0], nlogs,
                                 rounding_mode="floor")
        return args

    def wrap_write(f):
        def g(states, args, lanes):
            return f(states, div(args), lanes)

        return g

    def wrap_read(f):
        def g(states, args):
            return f(states, div(args))

        return g

    def wrap_window(f):
        if f is None:
            return None

        def g(states, opcodes, args):
            return f(states, opcodes, div(args))

        return g

    return dataclasses.replace(
        d,
        name=name,
        write_ops=tuple(wrap_write(f) for f in d.write_ops),
        read_ops=tuple(wrap_read(f) for f in d.read_ops),
        window_apply=wrap_window(d.window_apply),
        window_plan=wrap_window(d.window_plan),
    )


def _check_divisible(n: int, nlogs: int, what: str) -> None:
    if nlogs < 1:
        raise ValueError("need at least one log")
    if n % nlogs:
        raise ValueError(
            f"{what}={n} must be a multiple of nlogs={nlogs} for the "
            f"congruence partition (pad {what} up)"
        )


def make_partitioned_hashmap(
    n_keys: int, nlogs: int, prefill_value: int | None = None
) -> PartitionedModel:
    """Key-congruence partition of the dense hashmap: log l owns keys
    congruent to l mod L; each partition is a dense hashmap of K/L."""
    _check_divisible(n_keys, nlogs, "n_keys")
    full = make_hashmap(n_keys, prefill_value)
    sub = _div_arg0(
        make_hashmap(n_keys // nlogs, prefill_value),
        nlogs,
        f"hashmap{n_keys}sub{nlogs}",
    )
    split, merge = _congruence_split(nlogs)
    return PartitionedModel(full, sub, nlogs, split, merge)


def make_partitioned_sortedset(n_keys: int, nlogs: int) -> PartitionedModel:
    """Key-congruence partition of the ordered set; the order-statistic
    reads span partitions and so run against the merged full state."""
    _check_divisible(n_keys, nlogs, "n_keys")
    full = make_sortedset(n_keys)
    sub = _div_arg0(
        make_sortedset(n_keys // nlogs),
        nlogs,
        f"sortedset{n_keys}sub{nlogs}",
    )
    split, merge = _congruence_split(nlogs)
    return PartitionedModel(full, sub, nlogs, split, merge)


def make_partitioned_memfs(
    n_files: int, n_blocks: int, nlogs: int
) -> PartitionedModel:
    """Per-file partition of the in-memory FS (the nrfs LogMapper):
    log l owns files congruent to l mod L."""
    _check_divisible(n_files, nlogs, "n_files")
    full = make_memfs(n_files, n_blocks)
    sub = _div_arg0(
        make_memfs(n_files // nlogs, n_blocks),
        nlogs,
        f"memfs{n_files}x{n_blocks}sub{nlogs}",
    )
    split, merge = _congruence_split(nlogs)
    return PartitionedModel(full, sub, nlogs, split, merge)
