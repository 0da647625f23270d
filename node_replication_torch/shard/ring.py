"""`ShardMap`: the deterministic keyspace → shard congruence map.

The port's copy of `node_replication_tpu/shard/ring.py`; a published
`shard_map.json` is byte-identical to the reference's, and either
package loads the other's.

The fleet-level twin of the in-process `LogMapper` (PAPER.md's CNR
layer; `models/partitioned.py` pins the same contract for device
state): shard `s` of `N` owns every key `k` with `k % N == s`, where
an op's key is `args[0]` — exactly the commutativity hash the benches
and `MultiLogReplicated` use (`hash = args[0] % nlogs`). Two
consequences the router relies on:

- **determinism**: any two parties holding the same `(n_shards,
  version)` route every op identically, with no coordination;
- **commutativity across shards**: ops on different congruence
  classes touch disjoint keys, so per-shard sub-batches may execute
  concurrently and acks interleave freely — which is also why a
  cross-shard batch is explicitly NOT atomic (see `shard/router.py`).

The map is **versioned and durably published**: `publish()` writes
the JSON document through `durable_publish` (atomic tmp + fsync +
rename), so a concurrent reader observes either the previous complete
map or the new complete map, never a torn one — the same discipline
every other control file in the repo follows. Routers and shards
compare versions on every (re)connect; a mismatch is a typed
`WrongShard`, never a silent mis-route. Promotions bump the version
(`with_address`) so a router that re-homed a shard's writes can prove
any stale peer wrong.
"""

from __future__ import annotations

import dataclasses
import json
import os

from node_replication_torch.durable.wal import durable_publish

#: default published filename inside a fleet's shared directory
MAP_FILENAME = "shard_map.json"


class ShardMapCorruptError(RuntimeError):
    """A published `shard_map.json` failed validation on load.

    The `WalCorruptError`/`SnapshotCorruptError` discipline applied to
    the routing control file: `durable_publish` guarantees a reader
    never sees a TORN document, so a file that fails to parse — or
    parses into an inconsistent map (address count != `n_shards`,
    non-positive version) — is bit rot or a hand edit, and must be a
    TYPED refusal the router's `refresh_map()` can survive (keep the
    old map, count `shard.map_corrupt`) rather than a raw
    `JSONDecodeError`/`KeyError` escaping into the retry path."""

    def __init__(self, path: str | None, detail: str):
        where = f" at {path}" if path else ""
        super().__init__(f"corrupt shard map{where}: {detail}")
        self.path = path
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Immutable, versioned keyspace map.

    `addresses[s]` is shard `s`'s submit endpoint — `[host, port]`
    for a socket backend, `None` for a local/in-process one. Equality
    of `(n_shards, version)` is the routing agreement the fleet
    checks; addresses are advisory (how to reach the shard), the
    congruence is the contract (which keys it owns).
    """

    n_shards: int
    version: int = 1
    addresses: tuple = ()

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.version < 1:
            raise ValueError("version must be >= 1")
        addrs = tuple(
            tuple(a) if a is not None else None for a in self.addresses
        ) or (None,) * self.n_shards
        if len(addrs) != self.n_shards:
            raise ValueError(
                f"{len(addrs)} addresses for {self.n_shards} shards"
            )
        object.__setattr__(self, "addresses", addrs)

    # ---------------------------------------------------------- routing

    def shard_of(self, key: int) -> int:
        """Owning shard of `key`: the `key % N` congruence class."""
        return int(key) % self.n_shards

    def shard_of_op(self, op) -> int:
        """Owning shard of one op `(opcode, *args)` — the key is
        `args[0]`, matching the benches' LogMapper and the
        partitioned model's congruence contract."""
        if len(op) < 2:
            raise ValueError(f"op {op!r} has no key argument")
        return self.shard_of(op[1])

    def split_batch(self, ops) -> dict[int, list[tuple[int, tuple]]]:
        """Partition a batch into per-shard sub-batches, keeping each
        op's submission index so responses reassemble in submission
        order. Within one shard the sub-batch preserves submission
        order; ACROSS shards sub-batches are independent (disjoint
        congruence classes — the CNR commutativity argument)."""
        groups: dict[int, list[tuple[int, tuple]]] = {}
        for i, op in enumerate(ops):
            groups.setdefault(self.shard_of_op(op), []).append(
                (i, tuple(op))
            )
        return groups

    # ------------------------------------------------------- publication

    def with_address(self, shard: int, address) -> "ShardMap":
        """A NEW map with `shard` re-pointed (a promotion re-homing
        its writes) and the version bumped — publish it so every
        router and shard can prove stale peers wrong."""
        if not (0 <= int(shard) < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        addrs = list(self.addresses)
        addrs[int(shard)] = tuple(address) if address is not None \
            else None
        return ShardMap(self.n_shards, self.version + 1, tuple(addrs))

    def refine(self, overrides: dict | None = None) -> "ShardMap":
        """The reshard doubling (`shard/reshard.py`): every class `s`
        of `N` refines into `{s, s + N}` under `mod 2N` — a key in
        class `s (mod N)` is in class `s` or `s + N (mod 2N)`, never
        anywhere else, so the refinement moves ONLY the keys whose new
        class is re-addressed. By default class `s + N` keeps class
        `s`'s address (the same primary serves both halves until a
        split re-homes one); `overrides` maps new-shard → address for
        the re-homed slices. Version bumps once."""
        addrs = list(self.addresses) * 2
        for s, addr in (overrides or {}).items():
            if not (0 <= int(s) < 2 * self.n_shards):
                raise ValueError(f"shard {s} out of range for refine")
            addrs[int(s)] = tuple(addr) if addr is not None else None
        return ShardMap(2 * self.n_shards, self.version + 1,
                        tuple(addrs))

    def coarsen(self) -> "ShardMap":
        """The merge inverse of `refine`: classes `{s, s + N}` under
        `mod 2N` collapse back into class `s` under `mod N`, each
        merged class served at the LOWER half's address. Requires an
        even shard count (only a refined map coarsens)."""
        if self.n_shards % 2:
            raise ValueError(
                f"cannot coarsen an odd shard count ({self.n_shards})"
            )
        half = self.n_shards // 2
        return ShardMap(half, self.version + 1,
                        tuple(self.addresses[:half]))

    def as_dict(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "version": self.version,
            "addresses": [list(a) if a is not None else None
                          for a in self.addresses],
        }

    @classmethod
    def from_dict(cls, d: dict, path: str | None = None) -> "ShardMap":
        """Validate + build. EVERY defect in the document — missing
        keys, non-numeric fields, an address list whose length
        disagrees with `n_shards` — is a typed `ShardMapCorruptError`
        so the router's refresh path can keep its old map instead of
        crashing on a raw `KeyError`."""
        try:
            n_shards = int(d["n_shards"])
            version = int(d["version"])
            addresses = tuple(
                tuple(a) if a is not None else None
                for a in d.get("addresses", [])
            )
        except (KeyError, TypeError, ValueError) as e:
            raise ShardMapCorruptError(
                path, f"{type(e).__name__}: {e}"
            ) from e
        if addresses and len(addresses) != n_shards:
            raise ShardMapCorruptError(
                path,
                f"{len(addresses)} addresses for {n_shards} shards",
            )
        try:
            return cls(n_shards=n_shards, version=version,
                       addresses=addresses)
        except ValueError as e:
            raise ShardMapCorruptError(path, str(e)) from e

    def publish(self, path: str) -> None:
        """Durably publish this map (atomic tmp + fsync + rename via
        `durable_publish`) so routers and shards agree across
        restarts. `path` may be a directory (the fleet's shared dir;
        the map lands at `<path>/shard_map.json`) or a file path."""
        if os.path.isdir(path):
            path = os.path.join(path, MAP_FILENAME)
        durable_publish(
            path,
            json.dumps(self.as_dict(), sort_keys=True).encode(),
        )

    @classmethod
    def load(cls, path: str) -> "ShardMap":
        """Load a published map. Always observes a COMPLETE document
        (the `durable_publish` rename guarantee) — so a document that
        does not parse/validate is corruption or a hand edit, raised
        as typed `ShardMapCorruptError` (missing file stays a plain
        `FileNotFoundError`: absent and corrupt are different
        failures)."""
        if os.path.isdir(path):
            path = os.path.join(path, MAP_FILENAME)
        with open(path, "rb") as f:
            raw = f.read()
        try:
            doc = json.loads(raw.decode())
        except ValueError as e:
            raise ShardMapCorruptError(path, f"bad JSON: {e}") from e
        if not isinstance(doc, dict):
            raise ShardMapCorruptError(
                path, f"expected an object, got {type(doc).__name__}"
            )
        return cls.from_dict(doc, path=path)
