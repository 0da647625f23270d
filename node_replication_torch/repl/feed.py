"""Replication feed: the transport between a primary's WAL and its
follower fleet.

The port's copy of `node_replication_tpu/repl/feed.py`: numpy and the
standard library on the host, and every message file byte for byte the
reference's, so either package reads the other's feed. One difference,
in `poll`: a directory listing taken while the shipper creates message
files may leave out a file created during it and still hold a later one
(readdir returns entries in the filesystem's order, ext4's hash order,
and makes no promise about entries added while it runs). The
reference's `poll` then reports a hole that is not there, and its
follower stops on a `FeedGapError`. Here a hole at the cursor is taken
as real only if a second listing, begun after the first ended, shows
it too, and a hole after the cursor ends the poll there (the next poll
starts at it).

A `Feed` carries the WAL's record stream — the same position-chained
`(pos, opcodes, args)` batches `durable/wal.py` frames on disk — from
the shipper (`repl/shipper.py`) to any number of followers
(`repl/follower.py`), each tracking its own read cursor. The transport
is abstracted so tests are hermetic: `DirectoryFeed` is the bundled
shared-disk implementation, a directory of one CRC-framed message file
per shipped record, which models a network feed faithfully (messages
can arrive torn, duplicated, or with gaps) while staying a pure-stdlib
filesystem exchange any two local processes can share. Its cross-host
twin is `repl/transport.py`: `FeedServer` serves any feed-shaped
source over TCP and `SocketFeed` implements this same read interface
on the far end, so followers (and relays, `repl/relay.py`) on other
hosts consume the identical stream under the identical delivery
rules.

Message format (little-endian): file `rec-<pos:020d>.msg` holds one
record `u32 length | u32 crc32(payload) | payload` where the payload is
`int64 epoch | int64 pos | int32 count` followed by `opcodes
int32[count]` and `args int32[count * arg_width]`. Naming messages by
their starting position makes log order lexicographic order AND makes
re-shipping idempotent: a shipper that resumes (or a promoted primary
that re-publishes an overlapping batch) overwrites the same name
rather than forking history.

Delivery edge cases, each with a defined rule:

- **torn tail** — a message whose frame is incomplete (the writer was
  killed mid-`publish`). `poll` stops BEFORE it without error (it may
  still be in flight); a shipper that resumes re-publishes over it.
  Ship-before-ack (`repl/shipper.py:barrier`) means nothing torn was
  ever acked, so dropping it at promotion loses no acknowledged write
  — the same torn-tail reasoning `durable/recovery.py` applies to the
  WAL itself.
- **duplicate delivery** — a message whose records the follower has
  already applied; the follower skips it idempotently
  (`repl.duplicate_records`).
- **gap** — a message starting PAST the follower's cursor with nothing
  in between (the feed was pruned beyond this follower, or files were
  lost): typed `FeedGapError` carrying both positions; the follower
  needs a re-seed, never a silent skip.
- **corruption** — a COMPLETE message with a bad CRC below the feed's
  readable tail: `FeedCorruptError`, never silently dropped history.

Epoch fencing: the feed carries an `EPOCH` file (durably published:
tmp + fsync + rename + dir fsync). `publish` re-reads it and refuses
records stamped with an older epoch (`EpochFencedError`) — after a
promotion bumps the epoch (`fence`), a zombie primary's late records
are rejected at the transport. Followers enforce the same monotonicity
on the apply side (`repl/follower.py`): once a record of epoch E is
applied, lower-epoch records are fenced, closing the race where a
zombie's write lands between the epoch check and the file write.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import re
import struct
import zlib

import numpy as np

from node_replication_torch.durable.wal import durable_publish
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.utils.trace import get_tracer

_MSG_RE = re.compile(r"^rec-(\d{20})\.msg$")
_MSG_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
_MSG_PREFIX = struct.Struct("<qqi")  # epoch, pos, count

#: sanity bound on one message payload (mirrors the WAL's frame bound)
MAX_PAYLOAD_BYTES = 1 << 26

EPOCH_FILE = "EPOCH"
HEARTBEAT_FILE = "HEARTBEAT"


class FeedError(RuntimeError):
    """Replication-feed usage/IO failure."""


class FeedGapError(FeedError):
    """The next available feed record starts past the follower's
    cursor: positions `[expected, got)` are on no message this feed
    still holds. The follower cannot continue by replay alone — it
    needs a re-seed (snapshot transfer) — so the gap is a typed,
    position-carrying error, never a silent skip."""

    def __init__(self, expected: int, got: int):
        super().__init__(
            f"feed gap: next record starts at {got} but the follower "
            f"has applied only up to {expected} (positions "
            f"[{expected}, {got}) are missing)"
        )
        self.expected = expected
        self.got = got


class FeedCorruptError(FeedError):
    """A complete feed message failed validation below the readable
    tail — bit rot or a framing bug, not an in-flight write."""

    def __init__(self, path: str, pos: int, detail: str):
        super().__init__(
            f"corrupt feed message {path} (position {pos}): {detail}"
        )
        self.path = path
        self.pos = pos
        self.detail = detail


class EpochFencedError(FeedError):
    """A publish carried an epoch older than the feed's — the writer
    is a fenced (zombie) primary; its record was NOT written."""

    def __init__(self, epoch: int, current: int):
        super().__init__(
            f"publish fenced: record epoch {epoch} < feed epoch "
            f"{current} (a newer primary owns this feed)"
        )
        self.epoch = epoch
        self.current = current


@dataclasses.dataclass(frozen=True)
class FeedRecord:
    """One shipped batch: `count` ops at logical `pos`, stamped with
    the shipping primary's `epoch`."""

    epoch: int
    pos: int
    opcodes: np.ndarray  # int32[count]
    args: np.ndarray  # int32[count, arg_width]

    @property
    def count(self) -> int:
        return int(self.opcodes.shape[0])

    def ops(self) -> list[tuple]:
        """The batch as host `(opcode, *args)` tuples — the shape the
        follower replays through `_append_and_replay`."""
        return [
            (int(self.opcodes[i]), *(int(a) for a in self.args[i]))
            for i in range(self.count)
        ]


def _message_name(pos: int) -> str:
    return f"rec-{int(pos):020d}.msg"


class DirectoryFeed:
    """Shared-directory feed: one CRC-framed message file per record.

    One writer (the current primary's shipper) and any number of
    readers; readers are cursor-based and independent. All methods are
    stateless over the directory (safe to call from several threads /
    processes), except that `publish` assumes a single live writer —
    exactly the invariant epoch fencing exists to enforce.
    """

    def __init__(self, directory: str, arg_width: int = 3,
                 fsync: bool = False):
        self.dir = directory
        self.arg_width = int(arg_width)
        # fsync per message: off by default — the feed's durability
        # story is the follower's own WAL (applied records are
        # re-journaled there); flipping this on makes the feed itself
        # a crash-durable artifact at a per-publish fsync cost
        self.fsync = bool(fsync)
        os.makedirs(self.dir, exist_ok=True)
        reg = get_registry()
        self._m_published = reg.counter("repl.published_records")
        self._m_fenced_pub = reg.counter("repl.fenced_publishes")

    # ------------------------------------------------------------ epoch

    def epoch(self) -> int:
        """The feed's current fencing epoch (0 when never fenced)."""
        try:
            with open(os.path.join(self.dir, EPOCH_FILE), "rb") as f:
                return int(f.read().decode("ascii").strip() or 0)
        except FileNotFoundError:
            return 0

    def fence(self, epoch: int) -> int:
        """Raise the feed's epoch (promotion, `repl/promote.py`).
        Durably published (tmp + fsync + rename + dir fsync) so a
        fence survives a crash of the promoting process. Refuses to
        move backwards. Returns the new epoch."""
        epoch = int(epoch)
        current = self.epoch()
        if epoch <= current:
            raise FeedError(
                f"fence epoch {epoch} must exceed current {current}"
            )
        durable_publish(os.path.join(self.dir, EPOCH_FILE),
                        str(epoch).encode("ascii"))
        get_tracer().emit("repl-fence", epoch=epoch, previous=current)
        return epoch

    # ---------------------------------------------------------- publish

    def publish(self, epoch: int, pos: int, opcodes, args) -> None:
        """Write one record at `pos` stamped with `epoch`. Re-reads
        the fence file first: a stale epoch raises `EpochFencedError`
        and writes NOTHING — a zombie primary cannot extend the feed.
        The message file is written in place (no tmp+rename) so a
        mid-write kill leaves a torn tail for `poll`'s torn-tail rule,
        exactly like a half-shipped network frame."""
        epoch = int(epoch)
        current = self.epoch()
        if epoch < current:
            self._m_fenced_pub.inc()
            get_tracer().emit("repl-fenced-publish", epoch=epoch,
                              current=current, pos=int(pos))
            raise EpochFencedError(epoch, current)
        opcodes = np.ascontiguousarray(opcodes, np.int32)
        args = np.ascontiguousarray(args, np.int32)
        n = int(opcodes.shape[0])
        payload = (
            _MSG_PREFIX.pack(epoch, int(pos), n)
            + opcodes.tobytes() + args.tobytes()
        )
        frame = _MSG_HEADER.pack(len(payload),
                                 zlib.crc32(payload)) + payload
        path = os.path.join(self.dir, _message_name(pos))
        with open(path, "wb") as f:
            f.write(frame)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self._m_published.inc()

    def publish_record(self, epoch: int, rec) -> None:
        """Publish a `durable/wal.py:WalRecord` (the shipper's unit)."""
        self.publish(epoch, rec.pos, rec.opcodes, rec.args)

    # ------------------------------------------------------------- read

    def _messages(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            m = _MSG_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.dir, name)))
        out.sort()
        return out

    def _read_message(self, pos: int, path: str):
        """Decode one message file; returns a `FeedRecord`, or None
        when the frame is incomplete (torn / still being written).
        A complete frame that fails CRC or shape checks raises
        `FeedCorruptError`."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None  # pruned between listing and read
        if len(data) < _MSG_HEADER.size:
            return None
        length, crc = _MSG_HEADER.unpack_from(data, 0)
        if length < _MSG_PREFIX.size or length > MAX_PAYLOAD_BYTES:
            raise FeedCorruptError(
                path, pos, f"implausible message length {length}"
            )
        body = data[_MSG_HEADER.size:_MSG_HEADER.size + length]
        if len(body) < length:
            return None  # torn tail: the write never finished
        if zlib.crc32(body) != crc:
            raise FeedCorruptError(path, pos, "payload CRC mismatch")
        epoch, rpos, count = _MSG_PREFIX.unpack_from(body, 0)
        want = _MSG_PREFIX.size + 4 * count * (1 + self.arg_width)
        if count < 1 or length != want or rpos != pos:
            raise FeedCorruptError(
                path, pos,
                f"message shape invalid (pos {rpos}, count {count}, "
                f"length {length} != {want})",
            )
        opcodes = np.frombuffer(body, np.int32, count,
                                _MSG_PREFIX.size)
        args = np.frombuffer(
            body, np.int32, count * self.arg_width,
            _MSG_PREFIX.size + 4 * count,
        ).reshape(count, self.arg_width)
        return FeedRecord(int(epoch), int(rpos), opcodes.copy(),
                          args.copy())

    def poll(self, start: int = 0) -> list[FeedRecord]:
        """Readable records covering positions >= `start`, in order.
        Includes a record straddling `start` whole (the follower
        slices the overlap — its dedup path). Stops cleanly at the
        first incomplete (in-flight / torn) message; a corrupt
        complete message below that point raises. Gap DETECTION is the
        follower's job — `poll` reports what is readable, the follower
        compares against its cursor."""
        out = self._poll_listed(start)
        if out and out[0].pos > start:
            # a hole at the cursor: real only if a fresh listing shows
            # it too (see the module docstring)
            out = self._poll_listed(start)
        return out

    def _poll_listed(self, start: int) -> list[FeedRecord]:
        """`poll` over one directory listing: the readable records from
        the one covering `start`, up to the first hole between them."""
        msgs = self._messages()
        # skip messages wholly below `start` WITHOUT decoding them:
        # positions chain densely, so only the last message starting
        # at or below `start` can straddle it — everything earlier is
        # history. The listing itself stays O(files in the feed);
        # `prune()` is what bounds that.
        lo = max(0, bisect.bisect_right([p for p, _ in msgs],
                                        int(start)) - 1)
        out: list[FeedRecord] = []
        for pos, path in msgs[lo:]:
            rec = self._read_message(pos, path)
            if rec is None:
                break  # in-flight tail: nothing past it is applicable
            if rec.pos + rec.count > start:
                if out and rec.pos > out[-1].pos + out[-1].count:
                    break  # a hole this listing may have made
                out.append(rec)
        return out

    def tail_pos(self) -> int:
        """End position of the newest READABLE record (0 when empty) —
        the follower's staleness reference: `max_lag_pos` bounds are
        measured against this. Scans backwards past a torn tail."""
        msgs = self._messages()
        for pos, path in reversed(msgs):
            try:
                rec = self._read_message(pos, path)
            except FeedCorruptError:
                rec = None
            if rec is not None:
                return rec.pos + rec.count
        return 0

    # ------------------------------------------------------------ prune

    def prune(self, floor: int) -> int:
        """Delete messages whose records lie wholly below `floor`
        (operator/manager entry — a pruned follower cursor below the
        floor turns into `FeedGapError`, by design). Returns the
        number of messages removed."""
        removed = 0
        msgs = self._messages()
        for i, (pos, path) in enumerate(msgs):
            nxt = msgs[i + 1][0] if i + 1 < len(msgs) else None
            if nxt is None or nxt > floor:
                break
            os.remove(path)
            removed += 1
        return removed

    # -------------------------------------------------------- heartbeat

    def write_heartbeat(self, value: str) -> None:
        """Publish the liveness beacon (the shipper — or a relay
        forwarding its upstream's beacon — writes a monotonically
        changing value each loop). Routed through the hardened publish
        path with `fsync=False`: the atomic rename means a reader (or
        a downstream `FeedServer` re-serving the value) can never
        observe a torn beacon — a crashed relay mid-write leaves the
        previous complete value — while skipping the per-beacon disk
        flush a lost-on-crash beacon does not need."""
        durable_publish(os.path.join(self.dir, HEARTBEAT_FILE),
                        value.encode("utf-8"), fsync=False)

    def read_heartbeat(self) -> str | None:
        try:
            with open(os.path.join(self.dir, HEARTBEAT_FILE)) as f:
                return f.read()
        except FileNotFoundError:
            return None
