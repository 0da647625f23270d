"""Segmented write-ahead persistence for the operation log.

The port's copy of `node_replication_tpu/durable/wal.py`: the segment
and record bytes are the reference's, so a WAL written by either
package opens, and replays, in the other.

The reference's recovery property is structural: any replica is the
deterministic fold of the log (SURVEY.md §5, `nr/src/log.rs`). `fault/`
makes that property survive *replica* death while the process lives;
this module makes it survive the process. Every appended batch is
framed into an append-only segment file, so after a kill -9 or a
preemption the log itself — the source of truth — is still on disk and
`durable/recovery.py` can rebuild a bit-identical fleet from
snapshot + WAL tail.

Format (little-endian throughout):

- **segment files** `wal-<base>.seg`, named by the logical position of
  their first record (zero-padded so lexicographic order is log
  order). Header: 8-byte magic ``NRWAL001`` + int64 base position +
  int32 arg width. A segment covers `[base, next segment's base)`;
  rotation starts a new segment once the active one passes
  `segment_max_bytes`.
- **records**: `u32 length | u32 crc32(payload) | payload` where the
  payload is `int64 pos | int32 count` followed by the batch's
  `opcodes int32[count]` and `args int32[count * arg_width]`. One
  record per combiner append, written with a single `write()` call.

Crash-consistency rules on open (the framing exists for these):

- a record that runs past end-of-file in the NEWEST segment is a
  **torn tail** — the crash interrupted the write — and is truncated
  away (`wal.truncated_tail` counter, `wal-truncate` event); acks
  never covered it because acks wait for fsync.
- a complete record whose CRC mismatches, or any short read in a
  non-final segment, is **corruption** — `WalCorruptError` with the
  segment path, byte offset, and logical position, never a silent
  truncation of acknowledged history.
- record positions must chain (`pos[i+1] == pos[i] + count[i]`); a
  gap or overlap is corruption too.

fsync policy (`none | batch | always`) governs when appends become
durable: `always` fsyncs inside every `append` (an acked op is on
disk before the combiner returns), `batch` leaves fsync to an explicit
`sync()` — the serve frontend calls it once per batch before resolving
futures (`ServeConfig(durability="batch")`) — and `none` never fsyncs
until `close()` (page-cache durability only; acks are NOT
crash-durable). `durable_tail` is the logical position covered by the
last fsync — recovery's replay bound.

Reclamation is keyed to the log's GC head (`core/log.py`): the wrapper
reports head progress through `maybe_reclaim`, and whole segments
strictly below `min(head, reclaim_floor, pins…)` are deleted —
`reclaim_floor` is raised to the newest durable snapshot's position
(`durable/recovery.py:save_durable_snapshot`), because recovery needs
the WAL only from the snapshot forward; without a snapshot the floor
stays 0 and nothing is ever reclaimed (replay-from-init needs the
whole history). **Pins** (`set_pin`/`clear_pin`) let consumers that
stream the WAL hold reclamation below their own cursor, so a segment
such a consumer has not read yet can never be deleted out from under
it, however far the snapshot floor and GC head have advanced.

Fault sites (`fault/inject.py`): `wal-open`, `wal-append`, `wal-fsync`
fire at the top of the corresponding operations; the `corrupt-bytes`
action calls `_corrupt_tail_bytes` to flip one byte of the last
record on disk, giving the CRC machinery something real to catch.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
import threading

from node_replication_torch.analysis.locks import make_lock
import zlib
from typing import Iterator, Sequence

import numpy as np

from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

_MAGIC = b"NRWAL001"
_SEG_HEADER = struct.Struct("<8sqi")  # magic, base pos, arg_width
_REC_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
_REC_PREFIX = struct.Struct("<qi")  # logical pos, count
_SEG_RE = re.compile(r"^wal-(\d{20})\.seg$")

# Sanity bound on a record payload: a length field past this is frame
# garbage, not a real batch (the largest legal batch is bounded by the
# log's appendable capacity, far below this).
MAX_PAYLOAD_BYTES = 1 << 26

FSYNC_POLICIES = ("none", "batch", "always")

DEFAULT_SEGMENT_BYTES = 4 << 20


class WalError(RuntimeError):
    """WAL usage/IO failure (gap appends, closed WAL, disk errors)."""


class WalCorruptError(WalError):
    """A WAL record failed validation somewhere a torn tail cannot
    explain. Carries exactly where, so operators can decide what the
    blast radius is instead of silently losing acknowledged history."""

    def __init__(self, segment: str, offset: int, pos: int, detail: str):
        super().__init__(
            f"corrupt WAL record in {segment} at byte {offset} "
            f"(logical position {pos}): {detail}"
        )
        self.segment = segment
        self.offset = offset
        self.pos = pos
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded append batch: `count` ops at logical `pos`."""

    pos: int
    opcodes: np.ndarray  # int32[count]
    args: np.ndarray  # int32[count, arg_width]

    @property
    def count(self) -> int:
        return int(self.opcodes.shape[0])

    def ops(self) -> list[tuple]:
        """The batch as host `(opcode, *args)` tuples — the same shape
        the combiner appends, so recovery replays through the same
        dispatch scan (`core/replica._append_and_replay`)."""
        return [
            (int(self.opcodes[i]), *(int(a) for a in self.args[i]))
            for i in range(self.count)
        ]


def _segment_name(base: int) -> str:
    return f"wal-{base:020d}.seg"


def _fsync_dir(path: str) -> None:
    """fsync a directory so entry creation/removal is itself durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def durable_publish(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically publish `data` at `path`: tmp file + flush (+ fsync
    when `fsync`) + `os.replace` (+ parent-dir fsync). THE hardened
    publish path for every small control file the durability plane
    exposes to other processes (snapshots: `core/checkpoint.py`
    inlines the same discipline). A reader can NEVER observe a
    torn file: it sees the old content or the new, and with `fsync`
    the new content survives a crash of the publisher. `fsync=False`
    keeps the rename atomicity (no torn reads) without the per-publish
    disk flush — right for high-rate beacons whose loss is harmless
    but whose tearing is not. The tmp name is pid- AND thread-tagged
    so concurrent publishers — other processes, or two server
    connection threads fencing the same feed — cannot corrupt each
    other's staging; a failed publish removes its tmp file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if fsync:
        _fsync_dir(os.path.dirname(path) or ".")


class WriteAheadLog:
    """Append-only segmented WAL for encoded op batches.

    Thread-safe: appends arrive under the wrapper's combiner lock, but
    `sync()` (serve workers), `records()` (recovery verification) and
    `maybe_reclaim` (exec rounds) may race them, so every public entry
    takes the WAL's own lock.
    """

    def __init__(
        self,
        directory: str,
        policy: str = "batch",
        arg_width: int = 3,
        segment_max_bytes: int = DEFAULT_SEGMENT_BYTES,
    ):
        if policy not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {policy!r} "
                f"(policies: {', '.join(FSYNC_POLICIES)})"
            )
        self.dir = directory
        self.policy = policy
        self.arg_width = int(arg_width)
        self.segment_max_bytes = int(segment_max_bytes)
        #: newest durable snapshot position (`save_durable_snapshot`
        #: raises it); reclamation never passes min(GC head, floor)
        self.reclaim_floor = 0
        # named reclamation pins (`set_pin`): each holds the effective
        # reclaim floor at or below its position while present
        self._pins: dict[str, int] = {}
        # Instrument/trace handles come through module-level get_*
        # accessors the analyzer cannot type through:
        # nrcheck: lock-order WriteAheadLog._lock -> Tracer._lock — fsync/reclaim emit trace events under the lock
        # nrcheck: lock-order WriteAheadLog._lock -> Counter._lock — append/fsync counters bump under the lock
        # nrcheck: lock-order WriteAheadLog._lock -> Histogram._lock — fsync durations observe under the lock
        self._lock = make_lock("WriteAheadLog._lock")
        self._fh = None  # active segment append handle
        self._segments: list[tuple[int, str]] = []  # (base, path) sorted
        self._tail = 0  # logical pos after the last written record
        self._durable = 0  # logical pos covered by the last fsync
        self._closed = False
        self._failed: BaseException | None = None
        #: bytes dropped by torn-tail truncation at the last open
        #: (recovery reports surface it)
        self.truncated_bytes = 0

        reg = get_registry()
        self._m_appended = reg.counter("wal.appended")
        self._m_records = reg.counter("wal.records")
        self._m_synced = reg.counter("wal.synced")
        self._m_truncated = reg.counter("wal.truncated_tail")
        self._m_reclaimed = reg.counter("wal.reclaimed_segments")
        self._m_fsync = reg.histogram("wal.fsync_s")

        fault_hook("wal-open", -1, self)
        os.makedirs(self.dir, exist_ok=True)
        self._open_and_recover()

    # ------------------------------------------------------------ open

    def _list_segments(self) -> list[tuple[int, str]]:
        segs = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                segs.append((int(m.group(1)),
                             os.path.join(self.dir, name)))
        segs.sort()
        return segs

    def _open_and_recover(self) -> None:
        """Scan every segment, validate framing, truncate a torn tail,
        and position the append handle after the last valid record."""
        with self._lock:
            self._segments = self._list_segments()
            truncated = 0
            pos = None
            for i, (base, path) in enumerate(self._segments):
                is_last = i == len(self._segments) - 1
                pos, cut = self._scan_segment(
                    base, path, expect_pos=pos, may_truncate=is_last
                )
                truncated += cut
            if pos is None:
                pos = 0
            self._tail = pos
            # everything that survived the scan is on disk already;
            # the durable cursor restarts at the recovered tail
            self._durable = pos
            # a torn-header segment removed itself from disk; drop it
            # from the index too
            self._segments = [s for s in self._segments
                              if os.path.exists(s[1])]
            if self._segments:
                self._fh = open(self._segments[-1][1], "ab")
            self.truncated_bytes = truncated
            n_segments = len(self._segments)
        if truncated:
            self._m_truncated.inc()
        get_tracer().emit(
            "wal-open", dir=self.dir, segments=n_segments,
            tail=pos, truncated_bytes=truncated,
            policy=self.policy,
        )

    def _scan_segment(self, base: int, path: str, expect_pos: int | None,
                      may_truncate: bool) -> tuple[int, int]:
        """Validate one segment; returns `(next logical pos, truncated
        bytes)`. `may_truncate` (final segment only) downgrades a
        record that runs past EOF from corruption to a torn tail."""
        with open(path, "rb") as f:
            data = f.read()

        def torn(off: int, pos: int, detail: str) -> int:
            if not may_truncate:
                raise WalCorruptError(path, off, pos, detail)
            dropped = len(data) - off
            os.truncate(path, off)
            get_tracer().emit(
                "wal-truncate", segment=os.path.basename(path),
                offset=off, dropped_bytes=dropped, pos=pos,
            )
            return dropped

        if len(data) < _SEG_HEADER.size:
            # header never finished: an empty rotation cut short. An
            # empty file is not a valid segment — drop it entirely
            # (the caller prunes its index entry)
            cut = torn(0, base, "segment header torn")
            os.remove(path)
            return (base if expect_pos is None else expect_pos), cut
        magic, hdr_base, aw = _SEG_HEADER.unpack_from(data, 0)
        if magic != _MAGIC or hdr_base != base:
            raise WalCorruptError(
                path, 0, base, f"bad segment header (magic {magic!r}, "
                               f"base {hdr_base})"
            )
        if aw != self.arg_width:
            raise WalCorruptError(
                path, 0, base,
                f"segment arg_width {aw} != WAL arg_width "
                f"{self.arg_width}",
            )
        if expect_pos is not None and base != expect_pos:
            raise WalCorruptError(
                path, 0, base,
                f"segment base {base} does not chain from previous "
                f"segment end {expect_pos}",
            )
        off = _SEG_HEADER.size
        pos = base
        while off < len(data):
            if off + _REC_HEADER.size > len(data):
                return pos, torn(off, pos, "record header torn")
            length, crc = _REC_HEADER.unpack_from(data, off)
            if length < _REC_PREFIX.size or length > MAX_PAYLOAD_BYTES:
                return pos, torn(
                    off, pos, f"implausible record length {length}"
                )
            body = data[off + _REC_HEADER.size:
                        off + _REC_HEADER.size + length]
            if len(body) < length:
                return pos, torn(off, pos, "record payload torn")
            if zlib.crc32(body) != crc:
                # a COMPLETE record with a bad checksum is bit rot, not
                # an interrupted write — never silently truncated
                raise WalCorruptError(
                    path, off, pos, "payload CRC mismatch"
                )
            rpos, count = _REC_PREFIX.unpack_from(body, 0)
            want = _REC_PREFIX.size + 4 * count * (1 + self.arg_width)
            if count < 1 or length != want:
                raise WalCorruptError(
                    path, off, pos,
                    f"record shape invalid (count {count}, length "
                    f"{length} != {want})",
                )
            if rpos != pos:
                raise WalCorruptError(
                    path, off, pos,
                    f"record position {rpos} does not chain (expected "
                    f"{pos})",
                )
            pos += count
            off += _REC_HEADER.size + length
        return pos, 0

    # ---------------------------------------------------------- append

    @property
    def tail(self) -> int:
        """Logical position after the last written (not necessarily
        fsynced) record."""
        return self._tail

    @property
    def durable_tail(self) -> int:
        """Logical position covered by the last fsync — the recovery
        guarantee boundary for `always`/`batch` acks."""
        return self._durable

    @property
    def base(self) -> int:
        """First logical position the WAL still holds (reclamation
        deletes whole segments below the floor)."""
        return self._segments[0][0] if self._segments else self._tail

    def fsync_lag(self) -> int:
        """Positions written but not yet fsynced (`tail -
        durable_tail`) — the journal's unfsynced backlog. Exported as
        an overload-plane backpressure signal (`serve/overload.py`):
        the serve frontend auto-registers this behind its
        `wal_lag_low/high` watermarks so admission throttles before
        the backlog (and the ship/ack pipeline behind it) can grow
        unbounded. GIL-atomic int reads; no lock needed."""
        return max(0, self._tail - self._durable)

    def _check_usable(self) -> None:
        if self._closed:
            raise WalError("WAL is closed")
        if self._failed is not None:
            raise WalError(
                f"WAL failed a previous write and is fenced: "
                f"{self._failed}"
            )

    def _rotate(self, base: int) -> None:
        """Finalize the active segment (flush + fsync: a rotated-away
        segment is immutable history) and start a new one at `base`."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        path = os.path.join(self.dir, _segment_name(base))
        # nrlint: disable=lock-discipline — caller (append) holds the lock
        self._fh = open(path, "ab")
        self._fh.write(_SEG_HEADER.pack(_MAGIC, base, self.arg_width))
        self._segments.append((base, path))
        _fsync_dir(self.dir)

    def append(self, pos: int, ops: Sequence[tuple]) -> None:
        """Persist one combiner batch starting at logical `pos`.

        `pos` must equal the WAL tail (records chain densely) — except
        for the very first record of an empty WAL, which may start at
        any position (`attach_wal` backfills from the ring, recovery
        attaches at the recovered tail). Policy `always` fsyncs before
        returning, so the caller's ack is durable."""
        if not ops:
            return
        with self._lock:
            self._check_usable()
            fault_hook("wal-append", -1, self)
            pos = int(pos)
            if self._segments and pos != self._tail:
                raise WalError(
                    f"append at {pos} does not chain from WAL tail "
                    f"{self._tail} (gap or overlap)"
                )
            n = len(ops)
            opcodes = np.asarray([int(o[0]) for o in ops], np.int32)
            args = np.zeros((n, self.arg_width), np.int32)
            for i, o in enumerate(ops):
                vals = o[1:1 + self.arg_width]
                args[i, :len(vals)] = vals
            payload = (
                _REC_PREFIX.pack(pos, n)
                + opcodes.tobytes() + args.tobytes()
            )
            record = _REC_HEADER.pack(
                len(payload), zlib.crc32(payload)
            ) + payload
            if (self._fh is None
                    or self._fh.tell() >= self.segment_max_bytes):
                # `pos == self._tail` when segments exist (chain check
                # above); an empty WAL adopts the first record's pos
                if not self._segments:
                    self._tail = pos
                self._rotate(pos)
            start = self._fh.tell()
            try:
                self._fh.write(record)
                self._tail = pos + n
                if self.policy == "always":
                    self._fsync_locked()
            except OSError as e:
                self._tail = pos
                # roll the partial write back so the frame stays
                # parseable; if even that fails, fence the WAL — a
                # half-written record must never be appended past
                try:
                    self._fh.flush()
                    os.truncate(self._fh.fileno(), start)
                    self._fh.seek(start)
                except OSError:
                    self._failed = e
                raise WalError(f"WAL append failed: {e}") from e
            self._m_records.inc()
            self._m_appended.inc(n)

    def sync(self) -> int:
        """fsync buffered records; returns the new `durable_tail`.
        The serve frontend's per-batch durable-ack barrier
        (`ServeConfig(durability="batch")`)."""
        with self._lock:
            self._check_usable()
            if self._fh is None or self._durable >= self._tail:
                return self._durable
            self._fsync_locked()
            return self._durable

    def _fsync_locked(self) -> None:
        fault_hook("wal-fsync", -1, self)
        # injected clock (the satellite narrowing of the old
        # perf_counter exemption): under RealClock this is the same
        # monotonic interval; under SimClock the fsync span measures
        # virtual time like every other timed quantity in the
        # subsystem, so sim timelines stay coherent
        t0 = get_clock().now()
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            # nrlint: disable=lock-discipline — caller (append/sync) holds the lock
            self._failed = e
            raise WalError(f"WAL fsync failed: {e}") from e
        dur = get_clock().now() - t0
        # nrlint: disable=lock-discipline — caller (append/sync) holds the lock
        self._durable = self._tail
        self._m_synced.inc()
        self._m_fsync.observe(dur)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit("wal-sync", duration_s=dur,
                        synced_to=self._durable)

    # ------------------------------------------------------------ read

    def records(self, start: int = 0) -> Iterator[WalRecord]:
        """Decode records at logical positions >= `start`, in order.
        Records straddling `start` are sliced. Reads fresh handles, so
        a live WAL can be scanned concurrently (flush first for
        buffered tails: `sync()` or policy `always`)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            segments = list(self._segments)
        for base, path in segments:
            with open(path, "rb") as f:
                data = f.read()
            off = _SEG_HEADER.size
            while off + _REC_HEADER.size <= len(data):
                length, crc = _REC_HEADER.unpack_from(data, off)
                body = data[off + _REC_HEADER.size:
                            off + _REC_HEADER.size + length]
                if len(body) < length or zlib.crc32(body) != crc:
                    return  # unsynced torn tail of a live WAL
                pos, count = _REC_PREFIX.unpack_from(body, 0)
                opc = np.frombuffer(
                    body, np.int32, count, _REC_PREFIX.size
                )
                args = np.frombuffer(
                    body, np.int32, count * self.arg_width,
                    _REC_PREFIX.size + 4 * count,
                ).reshape(count, self.arg_width)
                if pos + count > start:
                    lo = max(0, start - pos)
                    yield WalRecord(pos + lo, opc[lo:].copy(),
                                    args[lo:].copy())
                off += _REC_HEADER.size + length

    # ------------------------------------------------------- reclaim

    def set_pin(self, name: str, pos: int) -> None:
        """Hold reclamation at or below logical `pos` under `name`.
        A streaming consumer pins its cursor BEFORE reading and
        advances the pin only after it is done with the read content,
        so reclamation can never outrun it. Re-pinning the same name moves it."""
        with self._lock:
            self._pins[name] = int(pos)

    def clear_pin(self, name: str) -> None:
        """Release a reclamation pin (missing names are a no-op)."""
        with self._lock:
            self._pins.pop(name, None)

    def pins(self) -> dict:
        """Current reclamation pins (name -> position)."""
        with self._lock:
            return dict(self._pins)

    def _pin_floor_locked(self, floor: int) -> int:
        if self._pins:
            floor = min(floor, min(self._pins.values()))
        return floor

    def reclaim(self, floor: int) -> int:
        """Delete whole segments strictly below logical `floor` (a
        segment is deletable only when a NEWER segment exists and
        starts at or below the floor). The floor is re-clamped to the
        pins UNDER the lock — a pin set between the caller computing
        its floor and this deletion still protects its segments (the
        reclaim-vs-ship race). Returns segments deleted."""
        deleted = 0
        with self._lock:
            floor = self._pin_floor_locked(int(floor))
            while (len(self._segments) >= 2
                   and self._segments[1][0] <= floor):
                base, path = self._segments.pop(0)
                os.remove(path)
                deleted += 1
            if deleted:
                _fsync_dir(self.dir)
        if deleted:
            self._m_reclaimed.inc(deleted)
            get_tracer().emit("wal-reclaim", deleted=deleted,
                              floor=floor)
        return deleted

    def maybe_reclaim(self, gc_head: int) -> int:
        """GC-head coupling (`core/replica._exec_round`): reclaim up to
        `min(gc_head, reclaim_floor, pins…)` — the log has logically
        consumed the prefix, a durable snapshot covers it, AND every
        attached streaming consumer has shipped past it. One
        uncontended lock acquire + O(1) when nothing is reclaimable
        (the per-round hot-path case); the pin floor must be read
        under the lock — iterating `_pins` while `clear_pin` pops
        concurrently raises."""
        floor = min(int(gc_head), self.reclaim_floor)
        with self._lock:
            floor = self._pin_floor_locked(floor)
            if len(self._segments) < 2 or self._segments[1][0] > floor:
                return 0
        return self.reclaim(floor)

    # ------------------------------------------------------- lifecycle

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.flush()
                    # the close-path fsync IS the durability critical
                    # section: _lock must stay held so no writer can
                    # append between the final flush and the fsync
                    # nrlint: disable=lock-held-across-blocking-call
                    os.fsync(self._fh.fileno())
                    self._durable = self._tail
                except OSError:
                    pass
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "tail": self._tail,
                "durable_tail": self._durable,
                "base": self.base,
                "segments": len(self._segments),
                "policy": self.policy,
                "reclaim_floor": self.reclaim_floor,
                "pins": dict(self._pins),
            }

    # ------------------------------------------------- fault plumbing

    def _corrupt_tail_bytes(self) -> None:
        """`corrupt-bytes` fault action (`fault/inject.py`): flip one
        byte of the last record on disk so the next open must catch it
        through the CRC. Test machinery, deliberately blunt."""
        if self._fh is not None:
            self._fh.flush()
        if not self._segments:
            return
        path = self._segments[-1][1]
        size = os.path.getsize(path)
        if size <= _SEG_HEADER.size:
            return
        with open(path, "r+b") as f:
            f.seek(size - 3)
            b = f.read(1)
            f.seek(size - 3)
            f.write(bytes([b[0] ^ 0xFF]))
