"""Network transport for the replication feed: the cross-host twin of
`repl/feed.py`'s `DirectoryFeed`.

The port's copy of `node_replication_tpu/repl/transport.py`: every
frame is the reference's bytes, so a client of either package talks to
a server of the other, snapshot bootstrap included.

`DirectoryFeed` models a replication stream faithfully but stops at the
filesystem: every follower must share a disk with its primary. This
module carries the SAME record stream over TCP so follower fleets live
on other hosts:

- **`FeedServer`** serves any feed-shaped source — a primary's
  `DirectoryFeed` (populated by `repl/shipper.py`), or a relay's local
  journal (`repl/relay.py`) — plus, over a sidecar exchange, the
  newest durable snapshot from a durability directory, so a cold
  follower bootstraps from `snap-<tail>.npz` instead of replaying the
  whole WAL.
- **`SocketFeed`** is the client: it implements the exact
  `DirectoryFeed` read interface (`poll` / `tail_pos` / `epoch` /
  `read_heartbeat` / `fence`) so `repl/follower.py:Follower` and
  `repl/promote.py:PromotionManager` work unchanged behind it.
- **`PipeTransport`** is the deterministic in-memory twin tests
  drive: the same client semantics (cached state while
  disconnected, duplicate delivery after reconnect) with no sockets
  and no threads.

Wire format (little-endian): every message is one CRC frame
`u32 length | u32 crc32(payload) | payload`, the WAL's own framing
idiom. The first payload byte is the message kind; records travel in
the feed's message-payload encoding (`epoch | pos | count | opcodes |
args`), so a record's bytes are identical on disk and on the wire.

Delivery semantics, mapped onto the feed's rules:

- **torn stream** — a connection dying mid-frame is the wire's torn
  tail: the client discards the partial frame, reconnects, and
  re-polls from its cursor. Nothing is applied from a frame whose CRC
  never validated.
- **reconnect = re-ship** — every poll carries the follower's cursor,
  so a resumed connection simply re-serves from it; records the
  follower already applied are duplicates it skips idempotently
  (`repl.duplicate_records`), the same name-idempotent re-ship
  semantics `DirectoryFeed`'s pos-keyed message files give.
- **gap** — the server reports what its source holds; a record
  starting past the follower's cursor surfaces as the follower's
  typed `FeedGapError`, exactly as on a pruned directory feed.
- **epoch fencing rides the stream** — records carry their epoch;
  `SocketFeed.fence` forwards a promotion fence to the server, which
  fences its SOURCE feed (durably, `EPOCH` publish), so a zombie
  primary's late publishes are rejected at the source with the same
  typed `EpochFencedError` contract.

Transient transport failures are NOT errors to the read path: `poll`
returns nothing, `tail_pos`/`epoch`/`read_heartbeat` answer from the
last connected observation, and the client reconnects on the next
call — a follower behind a flaky link degrades to a lagging follower,
never a dead one. (A frozen cached heartbeat is exactly what lets the
promotion watcher detect a dead upstream.) `fence` and
`fetch_snapshot` DO raise on transport failure: promotion and
bootstrap must never silently half-happen.

Liveness discipline: every socket in this module carries an explicit
timeout — blocking `accept`/`recv` without one would wedge a worker
thread forever on a half-open connection (nrlint rule
`raw-socket-in-worker` enforces this for repl/ thread targets).
"""

from __future__ import annotations

import io
import logging
import os
import socket
import struct
import threading

from node_replication_torch.analysis.locks import (
    make_condition,
    make_lock,
)
import zlib

import numpy as np

from node_replication_torch.durable.wal import durable_publish
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.repl.feed import (
    EpochFencedError,
    FeedError,
    FeedGapError,
    FeedRecord,
    MAX_PAYLOAD_BYTES,
)
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer, pos_sampled

logger = logging.getLogger("node_replication_torch")

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_REC_PREFIX = struct.Struct("<qqi")  # epoch, pos, count (feed format)

# ---- message kinds (first payload byte) -------------------------------
_REQ_POLL = 1  # <q start><i max_records>
_REQ_STAT = 2  # (empty)
_REQ_FENCE = 3  # <q epoch><16s fencer token>
_REQ_SNAP = 4  # <q min_pos>

_RSP_RECORDS = 16  # <q tail><q epoch><i hb_len><i nrec> hb recs
_RSP_STAT = 17  # <q tail><q epoch><i hb_len> hb
_RSP_ERROR = 18  # <i code><q a><q b> msg
_RSP_SNAP_META = 19  # <q pos><q size> (pos < 0: nothing newer)
_RSP_SNAP_CHUNK = 20  # raw file bytes
_RSP_SNAP_END = 21  # <q total_bytes>

_ERR_GENERIC = 0
_ERR_FENCED = 1  # a = record epoch, b = current epoch
_ERR_GAP = 2  # a = expected, b = got
_ERR_CORRUPT = 3

_POLL_HDR = struct.Struct("<qi")
_RECORDS_HDR = struct.Struct("<qqii")
_STAT_HDR = struct.Struct("<qqi")
_ERROR_HDR = struct.Struct("<iqq")
_SNAP_META = struct.Struct("<qq")
_Q = struct.Struct("<q")
_I = struct.Struct("<i")

#: snapshot stream chunk size (each chunk is one CRC frame)
SNAP_CHUNK_BYTES = 1 << 18

#: soft cap on one poll response's record bytes — comfortably under
#: the frame bound the client enforces, so a deep backlog streams as
#: several responses instead of one rejected mega-frame
MAX_RESPONSE_BYTES = 1 << 23

#: client-side frame bound: one response may legally carry one
#: maximum-size feed record plus headers
MAX_FRAME_BYTES = MAX_PAYLOAD_BYTES + 4096

#: WAL reclamation pin prefix held while a snapshot transfer streams
SNAPSHOT_PIN = "snapshot-server"


class TransportError(FeedError):
    """A transient wire failure (disconnect, timeout, torn frame).
    The client's cue to reconnect and resume from its cursor — never a
    statement about the data, which is CRC-framed end to end."""


# ==========================================================================
# framing
# ==========================================================================


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (TimeoutError, socket.timeout) as e:
            raise TransportError(f"socket timeout mid-frame: {e}") from e
        except OSError as e:
            raise TransportError(f"socket error: {e}") from e
        if not chunk:
            raise TransportError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    """Write one CRC frame (single `sendall`)."""
    try:
        sock.sendall(
            _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        )
    except (TimeoutError, socket.timeout) as e:
        raise TransportError(f"socket timeout on send: {e}") from e
    except OSError as e:
        raise TransportError(f"socket error on send: {e}") from e


def recv_frame(sock: socket.socket,
               max_bytes: int = MAX_FRAME_BYTES) -> bytes:
    """Read one CRC frame; raises `TransportError` on EOF, timeout, an
    implausible length, or a CRC mismatch — all of which mean "this
    connection is done", not "the feed is corrupt" (the data is intact
    at the source; the client re-polls over a fresh connection)."""
    hdr = _recv_exact(sock, _FRAME.size)
    length, crc = _FRAME.unpack(hdr)
    if length > max_bytes:
        raise TransportError(f"implausible frame length {length}")
    payload = _recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise TransportError("frame CRC mismatch (torn stream)")
    return payload


def encode_record(rec: FeedRecord) -> bytes:
    """One record in the feed's message-payload encoding."""
    opcodes = np.ascontiguousarray(rec.opcodes, np.int32)
    args = np.ascontiguousarray(rec.args, np.int32)
    return (
        _REC_PREFIX.pack(int(rec.epoch), int(rec.pos), rec.count)
        + opcodes.tobytes() + args.tobytes()
    )


def decode_record(data: bytes, arg_width: int) -> FeedRecord:
    """Inverse of `encode_record` (frame CRC already validated)."""
    epoch, pos, count = _REC_PREFIX.unpack_from(data, 0)
    want = _REC_PREFIX.size + 4 * count * (1 + arg_width)
    if count < 1 or len(data) != want:
        raise TransportError(
            f"record shape invalid (count {count}, {len(data)} bytes "
            f"!= {want})"
        )
    opcodes = np.frombuffer(data, np.int32, count, _REC_PREFIX.size)
    args = np.frombuffer(
        data, np.int32, count * arg_width,
        _REC_PREFIX.size + 4 * count,
    ).reshape(count, arg_width)
    return FeedRecord(int(epoch), int(pos), opcodes.copy(), args.copy())


def _pack_hb(hb: str | None) -> tuple[int, bytes]:
    if hb is None:
        return -1, b""
    raw = hb.encode("utf-8")
    return len(raw), raw


def _error_payload(code: int, a: int, b: int, msg: str) -> bytes:
    return (bytes([_RSP_ERROR]) + _ERROR_HDR.pack(code, a, b)
            + msg.encode("utf-8"))


def _raise_error(payload: bytes) -> None:
    code, a, b = _ERROR_HDR.unpack_from(payload, 1)
    msg = payload[1 + _ERROR_HDR.size:].decode("utf-8", "replace")
    if code == _ERR_FENCED:
        raise EpochFencedError(a, b)
    if code == _ERR_GAP:
        raise FeedGapError(a, b)
    raise FeedError(msg)


# ==========================================================================
# server
# ==========================================================================


class FeedServer:
    """Serves a feed-shaped source (and optionally snapshots) over TCP.

    One server per node; any number of downstream `SocketFeed` clients,
    each on its own connection handled by its own thread. The source
    needs the `DirectoryFeed` read surface (`poll` / `tail_pos` /
    `epoch` / `read_heartbeat`) plus `fence` for promotion forwarding.

        feed = DirectoryFeed(feed_dir)          # shipper publishes here
        srv = FeedServer(feed, snapshot_dir=durability_dir)
        host, port = srv.address                # hand to followers

    `snapshot_dir` (a durability directory holding `snap-<tail>.npz`
    files from `save_durable_snapshot`) enables bootstrap serving; a
    relay passes `snapshot_provider` instead to fetch-and-cache from
    its upstream. `wal=` (the primary only) lets a snapshot transfer
    pin WAL reclamation at the snapshot position under its own
    `snapshot-server:<n>` key while the stream is in flight, so the
    bootstrap window can never be reclaimed out from under the
    fetching follower. `on_fence` (the relay) observes forwarded
    fences AFTER the source accepted them.
    """

    _seq = 0
    _seq_lock = make_lock("FeedServer._seq_lock")

    def __init__(
        self,
        source,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_dir: str | None = None,
        snapshot_provider=None,
        wal=None,
        on_fence=None,
        max_records: int = 256,
        accept_timeout_s: float = 0.2,
        io_timeout_s: float = 10.0,
        auto_start: bool = True,
        name: str = "feed-server",
    ):
        if snapshot_dir is not None and snapshot_provider is not None:
            raise ValueError(
                "pass snapshot_dir OR snapshot_provider, not both"
            )
        self.source = source
        self.name = name
        self.snapshot_dir = snapshot_dir
        self._snapshot_provider = snapshot_provider
        self._wal = wal
        self._on_fence = on_fence
        self.max_records = int(max_records)
        self.accept_timeout_s = float(accept_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        with FeedServer._seq_lock:
            self._id = FeedServer._seq
            FeedServer._seq += 1

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self._sock.settimeout(self.accept_timeout_s)
        self.address: tuple[str, int] = self._sock.getsockname()[:2]

        self._lock = make_lock("FeedServer._lock")
        self._cond = make_condition("FeedServer._lock", lock=self._lock)
        self._stop = False
        self._conns: dict[int, socket.socket] = {}
        #: conn id -> highest poll cursor the client has CONFIRMED (a
        #: POLL at `start` proves the client holds everything below
        #: `start`) — the tree ack barrier reads this
        self._cursors: dict[int, int] = {}
        self._conn_seq = 0
        self._threads: list[threading.Thread] = []
        self._snap_seq = 0
        self._fence_lock = make_lock("FeedServer._fence_lock")
        self._last_fence: tuple[int, bytes] | None = None

        reg = get_registry()
        self._m_conns = reg.counter("repl.transport.connections")
        self._m_requests = reg.counter("repl.transport.requests")
        self._m_records = reg.counter("repl.transport.records_served")
        self._m_bytes = reg.counter("repl.transport.bytes_served")
        self._m_snaps = reg.counter("repl.transport.snapshots_served")
        self._m_errors = reg.counter("repl.transport.server_errors")

        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"repl-feed-server-{name}",
            daemon=True,
        )
        if auto_start:
            self.start()

    # -------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self._accept_thread.is_alive() \
                and not self._accept_thread.ident:
            self._accept_thread.start()
            get_tracer().emit("transport-serve", name=self.name,
                             host=self.address[0],
                             port=self.address[1])

    def close(self) -> None:
        """Stop accepting, close every connection, join the threads."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            conns = list(self._conns.values())
            threads = list(self._threads)
            self._cond.notify_all()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread.ident:
            self._accept_thread.join(5.0)
        for t in threads:
            if t.ident:
                t.join(5.0)

    def __enter__(self) -> "FeedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ accept loop

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            try:
                conn, _addr = self._sock.accept()
            except (TimeoutError, socket.timeout):
                continue  # the periodic stop-flag check
            except OSError:
                with self._lock:
                    stopping = self._stop
                if stopping:
                    return
                self._m_errors.inc()
                continue
            conn.settimeout(self.io_timeout_s)
            with self._lock:
                if self._stop:
                    conn.close()
                    return
                cid = self._conn_seq
                self._conn_seq += 1
                self._conns[cid] = conn
                t = threading.Thread(
                    target=self._serve_conn, args=(cid, conn),
                    name=f"repl-feed-conn-{self.name}-{cid}",
                    daemon=True,
                )
                self._threads.append(t)
                # bound the join list: forget threads that finished
                self._threads = [x for x in self._threads
                                 if x.is_alive() or not x.ident]
            self._m_conns.inc()
            t.start()

    # ------------------------------------------------- connection serve

    def _serve_conn(self, cid: int, conn: socket.socket) -> None:
        try:
            while True:
                with self._lock:
                    if self._stop:
                        return
                try:
                    req = recv_frame(conn)
                except TransportError:
                    return  # client went away: its cursor re-syncs on
                    # the next connection's polls
                self._m_requests.inc()
                try:
                    rsp_frames = self._handle(cid, conn, req)
                except Exception as e:
                    # a per-request failure is ANSWERED, not swallowed:
                    # the client gets a typed error frame and the
                    # failure is counted/traced via _record_failure
                    self._record_failure(e, cid)
                    rsp_frames = [self._error_for(e)]
                for frame in rsp_frames:
                    send_frame(conn, frame)
                    self._m_bytes.inc(len(frame))
        except TransportError:
            return  # mid-response disconnect: nothing to clean beyond
            # the finally below; the client re-polls from its cursor
        finally:
            with self._lock:
                self._conns.pop(cid, None)
                self._cursors.pop(cid, None)
                self._cond.notify_all()
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _error_for(exc: Exception) -> bytes:
        if isinstance(exc, EpochFencedError):
            return _error_payload(_ERR_FENCED, exc.epoch, exc.current,
                                  str(exc))
        if isinstance(exc, FeedGapError):
            return _error_payload(_ERR_GAP, exc.expected, exc.got,
                                  str(exc))
        return _error_payload(
            _ERR_GENERIC, 0, 0, f"{type(exc).__name__}: {exc}"
        )

    def _record_failure(self, exc: Exception, cid: int) -> None:
        """Count + trace a request-handling failure (the sanctioned
        worker-exception path: the error is also RETURNED to the
        client as a typed frame by the caller)."""
        self._m_errors.inc()
        get_tracer().emit("transport-error", name=self.name, conn=cid,
                          cause=type(exc).__name__)
        logger.exception("feed server %s: request failed on conn %d",
                         self.name, cid)

    def _stat_payload(self, kind: int) -> bytes:
        tail = int(self.source.tail_pos())
        epoch = int(self.source.epoch())
        hb_len, hb = _pack_hb(self.source.read_heartbeat())
        return bytes([kind]) + _STAT_HDR.pack(tail, epoch,
                                              hb_len) + hb

    def _handle(self, cid: int, conn: socket.socket,
                req: bytes) -> list[bytes]:
        if not req:
            raise FeedError("empty request frame")
        kind = req[0]
        if kind == _REQ_POLL:
            start, max_records = _POLL_HDR.unpack_from(req, 1)
            return [self._poll_payload(cid, start, max_records)]
        if kind == _REQ_STAT:
            return [self._stat_payload(_RSP_STAT)]
        if kind == _REQ_FENCE:
            (epoch,) = _Q.unpack_from(req, 1)
            token = bytes(req[1 + _Q.size:1 + _Q.size + 16])
            epoch = int(epoch)
            # serialized: concurrent fences from racing promotions
            # must not both pass the source's check-then-publish.
            # Token-keyed idempotence: the client retries a request
            # whose RESPONSE was lost on the wire, so re-applying the
            # SAME fencer's fence at the current epoch succeeds —
            # while a DIFFERENT promoter racing to the same number
            # still fails typed (two winners at one epoch would be
            # split brain, exactly what fencing exists to prevent).
            with self._fence_lock:
                current = int(self.source.epoch())
                if not (epoch == current
                        and self._last_fence == (epoch, token)):
                    current = int(self.source.fence(epoch))
                    self._last_fence = (current, token)
                if self._on_fence is not None:
                    self._on_fence(current)
            return [self._stat_payload(_RSP_STAT)]
        if kind == _REQ_SNAP:
            (min_pos,) = _Q.unpack_from(req, 1)
            return self._snapshot_frames(conn, int(min_pos))
        raise FeedError(f"unknown request kind {kind}")

    def _poll_payload(self, cid: int, start: int,
                      max_records: int) -> bytes:
        start = int(start)
        with self._lock:
            self._cursors[cid] = max(self._cursors.get(cid, 0), start)
            self._cond.notify_all()
        cap = min(int(max_records) if max_records > 0 else
                  self.max_records, self.max_records)
        records = self.source.poll(start)[:cap]
        tail = int(self.source.tail_pos())
        epoch = int(self.source.epoch())
        hb_len, hb = _pack_hb(self.source.read_heartbeat())
        # bound the response by BYTES as well as record count: the
        # client's recv_frame rejects frames past MAX_PAYLOAD_BYTES,
        # and an uncapped backlog response would be rejected on every
        # retry — a silent permanent stall. Truncation is safe: the
        # follower's next poll continues from its advanced cursor.
        blobs: list[bytes] = []
        total = 0
        for rec in records:
            blob = encode_record(rec)
            if blobs and total + len(blob) > MAX_RESPONSE_BYTES:
                break  # the FIRST record always ships, however large
            blobs.append(blob)
            total += _I.size + len(blob)
        out = io.BytesIO()
        out.write(bytes([_RSP_RECORDS]))
        out.write(_RECORDS_HDR.pack(tail, epoch, hb_len, len(blobs)))
        out.write(hb)
        for blob in blobs:
            out.write(_I.pack(len(blob)))
            out.write(blob)
        if blobs:
            self._m_records.inc(len(blobs))
            # the record's wire hop (`obs/` fleet tracing): a sampled
            # record leaving THIS node for a downstream consumer —
            # sampled on `pos` like ship/forward/apply, so the fleet
            # report sees which edge a record crossed and when
            tracer = get_tracer()
            if tracer.enabled:
                for rec in records[:len(blobs)]:
                    if pos_sampled(rec.pos):
                        tracer.emit("transport-poll", pos=rec.pos,
                                    n=rec.count, name=self.name,
                                    conn=cid)
        return out.getvalue()

    # --------------------------------------------------------- snapshot

    def _newest_snapshot(self, min_pos: int):
        """(pos, path) of the newest servable snapshot past `min_pos`,
        or None."""
        if self._snapshot_provider is not None:
            return self._snapshot_provider(min_pos)
        if self.snapshot_dir is None:
            return None
        from node_replication_torch.durable.recovery import list_snapshots

        for pos, path in list_snapshots(self.snapshot_dir):
            if pos > min_pos:
                return pos, path
            break  # newest first: nothing newer exists
        return None

    def _snapshot_frames(self, conn: socket.socket,
                         min_pos: int) -> list[bytes]:
        """Stream the newest snapshot past `min_pos` as META + CHUNK*
        + END frames (sent inline: the sidecar connection carries
        nothing else). Integrity is layered: each chunk is CRC-framed
        in flight, and the npz itself carries the blake2b manifest
        digest `recover_fleet` validates before trusting it."""
        found = self._newest_snapshot(min_pos)
        if found is None:
            return [bytes([_RSP_SNAP_META]) + _SNAP_META.pack(-1, 0)]
        pos, path = found
        size = os.path.getsize(path)
        pin = None
        if self._wal is not None:
            with self._lock:
                self._snap_seq += 1
                pin = f"{SNAPSHOT_PIN}:{self._id}.{self._snap_seq}"
            self._wal.set_pin(pin, pos)
        try:
            send_frame(conn, bytes([_RSP_SNAP_META])
                       + _SNAP_META.pack(pos, size))
            sent = 0
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(SNAP_CHUNK_BYTES)
                    if not chunk:
                        break
                    send_frame(conn, bytes([_RSP_SNAP_CHUNK]) + chunk)
                    sent += len(chunk)
                    self._m_bytes.inc(len(chunk))
        finally:
            if pin is not None:
                self._wal.clear_pin(pin)
        self._m_snaps.inc()
        get_tracer().emit("transport-snapshot-served", pos=pos,
                          bytes=sent, name=self.name)
        return [bytes([_RSP_SNAP_END]) + _Q.pack(sent)]

    # ---------------------------------------------------- ack plumbing

    def downstream_cursors(self) -> dict[int, int]:
        """conn id -> highest confirmed poll cursor (live conns only)."""
        with self._lock:
            return {cid: cur for cid, cur in self._cursors.items()
                    if cid in self._conns}

    def barrier(self, pos: int, min_clients: int = 1,
                timeout: float | None = 30.0) -> None:
        """Block until at least `min_clients` live downstream
        connections have confirmed (via a poll cursor) every record
        below `pos` — the tree's ship-before-ack extension: composed
        with `ReplicationShipper.barrier` (`make_tree_barrier`), an
        ack then implies the write is fsynced, feed-visible, AND
        received by `min_clients` downstream node(s). Raises
        `FeedError` on timeout or server shutdown (the serve layer
        maps it to its maybe_executed rejection)."""
        pos = int(pos)
        min_clients = max(1, int(min_clients))
        clock = get_clock()
        t_end = None if timeout is None else clock.now() + timeout
        with self._lock:
            while True:
                confirmed = sum(
                    1 for cid, cur in self._cursors.items()
                    if cid in self._conns and cur >= pos
                )
                if confirmed >= min_clients:
                    return
                if self._stop:
                    raise FeedError("feed server stopped; downstream "
                                    "receipt cannot be confirmed")
                rem = None if t_end is None else t_end - clock.now()
                if rem is not None and rem <= 0:
                    raise FeedError(
                        f"downstream barrier timed out: {confirmed}/"
                        f"{min_clients} connection(s) past {pos}"
                    )
                clock.wait(self._cond,
                           0.05 if rem is None else min(rem, 0.05))

    def stats(self) -> dict:
        with self._lock:
            return {
                "address": list(self.address),
                "connections": len(self._conns),
                "cursors": {str(k): v for k, v in
                            self._cursors.items()
                            if k in self._conns},
                "stopped": self._stop,
            }


def make_tree_barrier(shipper, server: FeedServer,
                      min_clients: int = 1,
                      timeout: float | None = 30.0):
    """`ServeFrontend.ack_barrier` for a tree root: ship-before-ack
    (the record is fsynced and feed-visible, `shipper.barrier`) AND
    received-downstream-before-ack (`server.barrier`). With relays
    journaling what they receive, an ack survives the loss of the
    primary AND any `min_clients - 1` downstream nodes."""

    def ack_barrier(pos: int) -> None:
        shipper.barrier(pos)
        server.barrier(pos, min_clients=min_clients, timeout=timeout)

    return ack_barrier


# ==========================================================================
# client
# ==========================================================================


class SocketFeed:
    """TCP client side of a `FeedServer`: the `DirectoryFeed` read
    interface over the wire.

        feed = SocketFeed(host, port, arg_width=dispatch.arg_width)
        follower = Follower(dispatch, feed, directory=my_dir)

    Thread-safe (one request/response in flight at a time under the
    client lock — the apply thread, read path, and promotion watcher
    all share the connection). Transient failures reconnect-and-retry
    once per call; a still-dead upstream degrades reads to cached
    state and polls to empty, which is indistinguishable from a slow
    feed — by design (see module docstring).
    """

    def __init__(
        self,
        host: str,
        port: int,
        arg_width: int = 3,
        connect_timeout_s: float = 5.0,
        io_timeout_s: float = 10.0,
        max_records: int = 256,
        name: str = "socket-feed",
    ):
        self.host = host
        self.port = int(port)
        self.arg_width = int(arg_width)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.max_records = int(max_records)
        self.name = name

        # nrcheck: lock-order SocketFeed._lock -> Counter._lock — RPC failure/retry counters bump under the transport lock
        self._lock = make_lock("SocketFeed._lock")
        self._sock: socket.socket | None = None
        # last connected observations: the degraded-mode answers
        self._tail = 0
        self._epoch = 0
        self._hb: str | None = None

        reg = get_registry()
        self._m_connects = reg.counter("repl.transport.connects")
        self._m_reconnects = reg.counter("repl.transport.reconnects")
        self._m_errors = reg.counter("repl.transport.client_errors")
        self._m_records = reg.counter("repl.transport.records_fetched")
        self._m_snap_bytes = reg.counter("repl.snapshot.bytes_fetched")

    # ------------------------------------------------------- connection

    def _connect_locked(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
        except OSError as e:
            raise TransportError(
                f"cannot connect to {self.host}:{self.port}: {e}"
            ) from e
        sock.settimeout(self.io_timeout_s)
        self._sock = sock
        self._m_connects.inc()
        get_tracer().emit("transport-connect", host=self.host,
                          port=self.port, name=self.name)
        return sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, payload: bytes) -> bytes:
        """One framed exchange; reconnects and retries ONCE on a
        transient failure (torn stream / dead socket). Error frames
        raise their typed exception."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    sock = self._connect_locked()
                    send_frame(sock, payload)
                    rsp = recv_frame(sock)
                    break
                except TransportError:
                    self._drop_locked()
                    if attempt:
                        self._m_errors.inc()
                        raise
                    self._m_reconnects.inc()
                    get_tracer().emit("transport-reconnect",
                                      host=self.host, port=self.port,
                                      name=self.name)
        if rsp and rsp[0] == _RSP_ERROR:
            _raise_error(rsp)
        return rsp

    def close(self) -> None:
        with self._lock:
            self._drop_locked()

    def __enter__(self) -> "SocketFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- read

    def poll(self, start: int = 0) -> list:
        """Readable records covering positions >= `start` (capped per
        response — the follower's poll loop drains the rest). Empty on
        transport failure: a flaky link reads as a quiet feed."""
        try:
            rsp = self._request(
                bytes([_REQ_POLL])
                + _POLL_HDR.pack(int(start), self.max_records)
            )
        except TransportError:
            return []
        if rsp[0] != _RSP_RECORDS:
            raise FeedError(f"unexpected response kind {rsp[0]}")
        tail, epoch, hb_len, nrec = _RECORDS_HDR.unpack_from(rsp, 1)
        off = 1 + _RECORDS_HDR.size
        self._note_stat(tail, epoch, hb_len,
                        rsp[off:off + max(0, hb_len)])
        off += max(0, hb_len)
        records = []
        for _ in range(nrec):
            (blob_len,) = _I.unpack_from(rsp, off)
            off += _I.size
            records.append(
                decode_record(rsp[off:off + blob_len], self.arg_width)
            )
            off += blob_len
        if records:
            self._m_records.inc(len(records))
        return records

    def _note_stat(self, tail: int, epoch: int, hb_len: int,
                   hb_raw: bytes) -> None:
        with self._lock:
            self._tail = max(self._tail, int(tail))
            self._epoch = max(self._epoch, int(epoch))
            if hb_len >= 0:
                self._hb = hb_raw.decode("utf-8", "replace")

    def _stat(self) -> None:
        try:
            rsp = self._request(bytes([_REQ_STAT]))
        except TransportError:
            return  # degraded: cached observations answer
        if rsp[0] != _RSP_STAT:
            raise FeedError(f"unexpected response kind {rsp[0]}")
        tail, epoch, hb_len = _STAT_HDR.unpack_from(rsp, 1)
        off = 1 + _STAT_HDR.size
        self._note_stat(tail, epoch, hb_len,
                        rsp[off:off + max(0, hb_len)])

    def tail_pos(self) -> int:
        self._stat()
        with self._lock:
            return self._tail

    def epoch(self) -> int:
        self._stat()
        with self._lock:
            return self._epoch

    def read_heartbeat(self) -> str | None:
        self._stat()
        with self._lock:
            return self._hb

    def peek_stat(self) -> tuple[int, int, str | None]:
        """`(tail, epoch, heartbeat)` from the LAST response, no RPC —
        every poll response already carries all three, so a tight
        consumer loop (the relay pump) reads them here instead of
        issuing redundant STAT round-trips after each poll."""
        with self._lock:
            return self._tail, self._epoch, self._hb

    # ------------------------------------------------------------ fence

    def fence(self, epoch: int) -> int:
        """Forward a promotion fence to the server's source feed.
        Raises (never degrades) on transport failure: a promotion must
        know whether the fence took. The per-call fencer token makes
        the internal retry safe: a fence whose RESPONSE was lost on
        the wire re-applies idempotently, while a different promoter
        racing to the same epoch still fails typed."""
        rsp = self._request(bytes([_REQ_FENCE])
                            + _Q.pack(int(epoch))
                            + os.urandom(16))
        if rsp[0] != _RSP_STAT:
            raise FeedError(f"unexpected response kind {rsp[0]}")
        tail, new_epoch, hb_len = _STAT_HDR.unpack_from(rsp, 1)
        off = 1 + _STAT_HDR.size
        self._note_stat(tail, new_epoch, hb_len,
                        rsp[off:off + max(0, hb_len)])
        return int(new_epoch)

    # --------------------------------------------------------- snapshot

    def fetch_snapshot(self, dest_dir: str,
                       min_pos: int = 0) -> tuple[int, str] | None:
        """Download the server's newest snapshot strictly past
        `min_pos` into `dest_dir` as `snap-<pos>.npz` (the name
        `recover_fleet` globs). Returns `(pos, path)`, or None when
        the server holds nothing newer. Uses a SIDECAR connection so a
        long transfer never blocks the record stream; the file is
        durably published (tmp + fsync + rename) and its manifest
        digest is validated by `recover_fleet` before anything trusts
        it. Raises on transport failure — bootstrap never
        half-happens."""
        from node_replication_torch.durable.recovery import snapshot_path

        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
        except OSError as e:
            raise TransportError(
                f"cannot connect to {self.host}:{self.port}: {e}"
            ) from e
        sock.settimeout(self.io_timeout_s)
        try:
            send_frame(sock, bytes([_REQ_SNAP]) + _Q.pack(int(min_pos)))
            meta = recv_frame(sock)
            if meta[0] == _RSP_ERROR:
                _raise_error(meta)
            if meta[0] != _RSP_SNAP_META:
                raise FeedError(f"unexpected response kind {meta[0]}")
            pos, size = _SNAP_META.unpack_from(meta, 1)
            if pos < 0:
                return None
            os.makedirs(dest_dir, exist_ok=True)
            buf = io.BytesIO()
            while True:
                frame = recv_frame(sock)
                if frame[0] == _RSP_SNAP_CHUNK:
                    buf.write(frame[1:])
                    continue
                if frame[0] == _RSP_SNAP_END:
                    (total,) = _Q.unpack_from(frame, 1)
                    break
                if frame[0] == _RSP_ERROR:
                    _raise_error(frame)
                raise FeedError(
                    f"unexpected response kind {frame[0]}"
                )
            data = buf.getvalue()
            if len(data) != total or total != size:
                raise TransportError(
                    f"snapshot transfer incomplete ({len(data)} of "
                    f"{size} bytes)"
                )
        finally:
            try:
                sock.close()
            except OSError:
                pass
        path = snapshot_path(dest_dir, pos)
        durable_publish(path, data)
        self._m_snap_bytes.inc(len(data))
        get_tracer().emit("transport-snapshot-fetched", pos=int(pos),
                          bytes=len(data), name=self.name)
        return int(pos), path


# ==========================================================================
# in-memory twin
# ==========================================================================


class PipeTransport:
    """Deterministic in-memory stand-in for `SocketFeed`: wraps any
    feed and reproduces the CLIENT's degraded-mode contract without
    sockets or threads — tests drive it to cover stream gaps,
    duplicate delivery, and zombie fencing over "the wire" where a
    real listener would only add nondeterminism.

    - `disconnect()` → polls return [], `tail_pos`/`epoch`/
      `read_heartbeat` answer from the last connected observation (so
      a promotion watcher sees heartbeat silence, exactly as over a
      dead socket), `fence` raises.
    - `reconnect(rewind=k)` → the next poll re-serves from `k`
      positions before the caller's cursor: the retransmit-after-
      resume duplicate delivery the follower must absorb
      idempotently.
    """

    def __init__(self, inner, rewind: int = 8):
        self.inner = inner
        self.arg_width = getattr(inner, "arg_width", 3)
        self.rewind = int(rewind)
        self._connected = True
        self._replay_next = 0  # rewind amount pending for next poll
        self._tail = 0
        self._epoch = 0
        self._hb: str | None = None
        self._m_drops = get_registry().counter(
            "repl.transport.pipe_drops"
        )

    @property
    def connected(self) -> bool:
        return self._connected

    def disconnect(self) -> None:
        self._connected = False

    def reconnect(self, rewind: int | None = None) -> None:
        if not self._connected:
            self._connected = True
            self._replay_next = (
                self.rewind if rewind is None else int(rewind)
            )

    # ---- DirectoryFeed read surface -----------------------------------

    def poll(self, start: int = 0) -> list:
        if not self._connected:
            self._m_drops.inc()
            return []
        eff = max(0, int(start) - self._replay_next)
        self._replay_next = 0
        records = self.inner.poll(eff)
        self._tail = max(self._tail, self.inner.tail_pos())
        self._epoch = max(self._epoch, self.inner.epoch())
        hb = self.inner.read_heartbeat()
        if hb is not None:
            self._hb = hb
        return records

    def tail_pos(self) -> int:
        if not self._connected:
            return self._tail
        self._tail = max(self._tail, self.inner.tail_pos())
        return self._tail

    def epoch(self) -> int:
        if not self._connected:
            return self._epoch
        self._epoch = max(self._epoch, self.inner.epoch())
        return self._epoch

    def read_heartbeat(self) -> str | None:
        if not self._connected:
            return self._hb
        hb = self.inner.read_heartbeat()
        if hb is not None:
            self._hb = hb
        return self._hb

    def peek_stat(self) -> tuple[int, int, str | None]:
        """The socket client's no-RPC cache peek, same contract."""
        return self._tail, self._epoch, self._hb

    def fence(self, epoch: int) -> int:
        if not self._connected:
            raise FeedError(
                "transport disconnected: cannot forward fence"
            )
        return self.inner.fence(epoch)

    def fetch_snapshot(self, dest_dir: str, min_pos: int = 0):
        if not self._connected:
            raise TransportError(
                "transport disconnected: cannot fetch snapshot"
            )
        fetch = getattr(self.inner, "fetch_snapshot", None)
        if fetch is None:
            return None
        return fetch(dest_dir, min_pos=min_pos)
