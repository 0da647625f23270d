"""Crash-consistent recovery: snapshot base + WAL tail, bit-identical.

The port's copy of `node_replication_tpu/durable/recovery.py`. A
recovered fleet's `NodeReplicated` takes `nr_kwargs` (`device=`,
`engine=`, ...): with no `device` it is built on the card, like every
entry point of this package. WAL records replay through the same
combiner protocol as live traffic, so a hashmap fleet with the fused
tier replays them through the fused round.

The orchestrator over the two durable artifacts a fleet leaves on
disk:

- **snapshots** (`snap-<tail>.npz`, written by `save_durable_snapshot`
  through the hardened `core/checkpoint.py:save_snapshot`): the log
  ring + cursors + replica states at one position, digest-sealed.
- **the WAL** (`<dir>/wal/`, `durable/wal.py`): every combiner append
  since, with a durable tail bounded by fsync policy.

`recover_fleet` rebuilds a `NodeReplicated` after a crash:

1. load the NEWEST snapshot that passes integrity validation
   (`SnapshotCorruptError` candidates are skipped, not fatal — an
   older good snapshot plus a longer WAL replay reaches the same
   state, because replay is deterministic);
2. open the WAL (torn tails truncate here) and replay every record in
   `[snapshot_pos, durable_tail)` through the SAME combiner protocol
   live traffic uses (`_append_and_replay` → the dispatch scan /
   combined engines), so the restart is bit-identical to a fleet that
   never died;
3. re-attach the WAL at the recovered tail so the instance keeps
   journaling where it left off.

The recovery floor invariant: `save_durable_snapshot` raises the
WAL's `reclaim_floor` to the snapshot position AFTER the snapshot is
durably published, so at every instant the disk holds a valid base +
a WAL covering `[base, durable_tail)` — the crash window never has a
gap. The serve layer reopens mid-traffic state through
`ServeFrontend.from_recovery`, which wraps this.
"""

from __future__ import annotations

import dataclasses
import os
import re

from node_replication_torch.core.checkpoint import (
    SnapshotCorruptError,
    load_snapshot,
    peek_spec,
)
from node_replication_torch.core.replica import NodeReplicated
from node_replication_torch.durable.wal import WalError, WriteAheadLog
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer, span

_SNAP_RE = re.compile(r"^snap-(\d{20})\.npz$")

#: WAL subdirectory inside a durability directory.
WAL_SUBDIR = "wal"


def snapshot_path(directory: str, pos: int) -> str:
    return os.path.join(directory, f"snap-{int(pos):020d}.npz")


def list_snapshots(directory: str) -> list[tuple[int, str]]:
    """`(pos, path)` pairs, newest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)),
                        os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def save_durable_snapshot(nr, directory: str,
                          keep: int = 2) -> str:
    """Checkpoint `nr` into `directory` as `snap-<tail>.npz` and raise
    the WAL reclaim floor to the snapshot position (segments wholly
    below it delete as GC head passes). Keeps the newest `keep`
    snapshots and prunes the rest — but only AFTER the new one is
    durably published, so a crash mid-prune still finds a valid base.
    Returns the snapshot path."""
    os.makedirs(directory, exist_ok=True)
    with nr._lock:  # pin tail across name + save (lock is reentrant)
        tail = int(nr.log.tail)
        path = snapshot_path(directory, tail)
        nr.checkpoint(path)
    get_registry().counter("recovery.snapshots").inc()
    get_tracer().emit("durable-snapshot", pos=tail, path=path)
    wal = getattr(nr, "wal", None)
    if wal is not None:
        wal.reclaim_floor = max(wal.reclaim_floor, tail)
        wal.maybe_reclaim(int(nr.log.head))
    for _, old in list_snapshots(directory)[max(1, int(keep)):]:
        if old != path:
            os.remove(old)
    return path


@dataclasses.dataclass
class RecoveryReport:
    """What one `recover_fleet` run found and did (JSON-safe)."""

    directory: str
    snapshot: str | None
    snapshot_pos: int
    skipped_snapshots: list  # [(path, reason), ...] corrupt candidates
    wal_records: int
    wal_ops: int
    wal_truncated_bytes: int
    tail: int
    duration_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def recover_fleet(
    directory: str,
    dispatch,
    policy: str = "batch",
    attach: bool = True,
    nr_kwargs: dict | None = None,
) -> tuple[NodeReplicated, RecoveryReport]:
    """Rebuild a `NodeReplicated` from `directory` (snapshots + WAL).

    Missing/empty directory boots a fresh fleet (and starts journaling
    into it when `attach=True`). `nr_kwargs` configures the wrapper
    when no snapshot pins the spec (and engine/debug knobs always).
    The returned instance has the reopened WAL attached at its tail,
    so serving can resume immediately (`ServeFrontend.from_recovery`).
    """
    t0 = get_clock().now()
    kw = dict(nr_kwargs or {})
    os.makedirs(directory, exist_ok=True)
    skipped: list = []
    nr = None
    snap_path = None
    snap_pos = 0
    for pos, path in list_snapshots(directory):
        try:
            spec = peek_spec(path)
            cand = NodeReplicated(
                dispatch,
                n_replicas=spec.n_replicas,
                log_entries=spec.capacity,
                gc_slack=spec.gc_slack,
                **{k: v for k, v in kw.items()
                   if k not in ("n_replicas", "log_entries",
                                "gc_slack")},
            )
            _, cand.log, cand.states = load_snapshot(path, cand.states)
            nr, snap_path, snap_pos = cand, path, int(cand.log.tail)
            break
        except SnapshotCorruptError as e:
            skipped.append((path, str(e)))
    if nr is None:
        nr = NodeReplicated(dispatch, **kw)
    wal = WriteAheadLog(
        os.path.join(directory, WAL_SUBDIR), policy=policy,
        arg_width=dispatch.arg_width,
    )
    if wal.tail > snap_pos and wal.base > snap_pos:
        raise WalError(
            f"WAL covers [{wal.base}, {wal.tail}) but the newest "
            f"valid snapshot is at {snap_pos}: entries "
            f"[{snap_pos}, {wal.base}) are on neither artifact "
            f"(reclaim outran the snapshot?)"
        )
    records = 0
    ops_replayed = 0
    with span("recovery", dir=directory, snapshot_pos=snap_pos,
              wal_tail=wal.tail) as sp:
        for rec in wal.records(start=snap_pos):
            expect = snap_pos + ops_replayed
            if rec.pos != expect:
                raise WalError(
                    f"WAL replay position {rec.pos} does not chain "
                    f"from recovered tail {expect}"
                )
            # the SAME combiner-round protocol live appends use:
            # GC-wait, encode, append, replay-to-target (no response
            # destinations — a crash drops in-flight deliveries,
            # exactly like `recover`'s crash semantics)
            nr._append_and_replay(0, rec.ops(), 0, [])
            records += 1
            ops_replayed += rec.count
        nr.sync()
        sp.add(records=records, ops=ops_replayed)
    if snap_path is not None:
        wal.reclaim_floor = max(wal.reclaim_floor, snap_pos)
    if attach:
        nr.attach_wal(wal)  # backfills [wal.tail, tail) when snapshot
        # was ahead of the WAL (policy `none`, lost unsynced tail)
    else:
        wal.close()
    dur = get_clock().now() - t0
    reg = get_registry()
    reg.counter("recovery.runs").inc()
    reg.counter("wal.replayed").inc(ops_replayed)
    reg.histogram("recovery.restore_s").observe(dur)
    report = RecoveryReport(
        directory=directory,
        snapshot=snap_path,
        snapshot_pos=snap_pos,
        skipped_snapshots=skipped,
        wal_records=records,
        wal_ops=ops_replayed,
        wal_truncated_bytes=wal.truncated_bytes,
        tail=int(nr.log.tail),
        duration_s=dur,
    )
    get_tracer().emit(
        "recovery-done", snapshot_pos=snap_pos, records=records,
        ops=ops_replayed, tail=report.tail, duration_s=dur,
        skipped=len(skipped),
        truncated_bytes=wal.truncated_bytes,
    )
    return nr, report
