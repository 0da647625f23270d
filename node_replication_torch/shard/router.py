"""The routing tier: split → fan out → reassemble, over CRC frames.

The port's copy of `node_replication_tpu/shard/router.py`, over the
port's `repl/transport.py` framing. Its frames (JSON payloads, typed
errors included) are byte-identical to the reference's, so a
`SocketShardClient` of either package talks to a `ShardServer` of the
other.

`ShardRouter` is the embeddable client-side router (and the core of
the thin proxy `bench.py --sharded` runs): it holds a versioned
`ShardMap`, splits every submitted batch into per-shard sub-batches,
fans them out concurrently, and reassembles the responses in
submission order. Backends come in two shapes behind one protocol
(`submit_batch(ops, peer_version, ...)`):

- `LocalBackend` — an in-process `ServeFrontend` (the shard primary
  lives in this process, or the router just re-homed a shard onto a
  promoted follower). It re-verifies EVERY op against the map — key
  congruence and version — before staging, so a mis-routed op is a
  typed `WrongShard` before any log effect, never a silent write into
  the wrong keyspace slice.
- `SocketShardClient` — a shard primary in another process, reached
  through `ShardServer` over `repl/transport.py`'s length+CRC framing
  (`send_frame`/`recv_frame`; payloads are JSON). The client replays
  a HELLO carrying its map version on EVERY (re)connect and the
  server checks it on every submit — a fenced zombie shard (stale
  map after a promotion re-published it) can never ack.

**The cross-shard BATCH contract is the CNR one — explicitly NOT
atomic.** Ops on different shards live in disjoint `key % N`
congruence classes (`shard/ring.py`), so their sub-batches execute
concurrently and independently: one shard's sub-batch can commit and
ack while another's fails (`ShardUnavailable`), exactly as CNR's
per-log batches commit independently (PAPER.md;
`models/partitioned.py` pins the same semantics in-process).
`execute_batch` therefore reports per-op outcomes; there is no
cross-shard rollback. Callers that need multi-shard atomicity use the
transaction layer ON TOP: `shard/txn.py:TxnCoordinator` drives
presumed-abort 2PC through these same backends (the `txn_verb`
surface routed by `txn_call`), and costs this path nothing when
unused — see README "Keyspace sharding" for the guarantee table.

Failure semantics mirror the serve plane: `ShardUnavailable` with
`maybe_executed=False` means the sub-batch provably never reached the
shard's log (resubmit is exactly-once safe; `call_with_retry` does),
`maybe_executed=True` means the connection died after the ops were
sent (they may commit and replay; only the caller can decide).
`call_with_retry` re-routes across a shard promotion by calling
`refresh_map()` — the router reloads the durably-published map,
adopts the bumped version, and pushes it to every backend.
"""

from __future__ import annotations

import itertools
import json
import socket
import threading

from node_replication_torch.analysis.locks import make_lock
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.repl.transport import (
    MAX_FRAME_BYTES,
    TransportError,
    recv_frame,
    send_frame,
)
from node_replication_torch.serve.errors import (
    DeadlineExceeded,
    FrontendClosed,
    NotPrimary,
    Overloaded,
    ReplicaFailed,
    ServeError,
    ShardUnavailable,
    TxnAborted,
    TxnConflict,
    TxnInDoubt,
    WrongShard,
)
from node_replication_torch.shard.ring import ShardMap, ShardMapCorruptError
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer

# ==========================================================================
# error encoding (typed errors survive the wire)
# ==========================================================================


def _encode_error(e: BaseException) -> dict:
    """One JSON dict per typed serve error, so the client re-raises
    the SAME type `call_with_retry` routes on — a shard's `Overloaded`
    must back off, its `WrongShard` must refresh the map, and a
    generic string would collapse both into a blind retry."""
    if isinstance(e, WrongShard):
        return {"type": "WrongShard", "key": e.key, "shard": e.shard,
                "expected_shard": e.expected_shard,
                "map_version": e.map_version,
                "peer_version": e.peer_version}
    if isinstance(e, ShardUnavailable):
        return {"type": "ShardUnavailable", "shard": e.shard,
                "maybe_executed": e.maybe_executed,
                "detail": str(e.cause) if e.cause else ""}
    if isinstance(e, Overloaded):
        return {"type": "Overloaded", "rid": e.rid, "depth": e.depth}
    if isinstance(e, ReplicaFailed):
        return {"type": "ReplicaFailed", "rid": e.rid,
                "maybe_executed": e.maybe_executed,
                "detail": str(e.cause) if e.cause else ""}
    if isinstance(e, DeadlineExceeded):
        return {"type": "DeadlineExceeded", "rid": e.rid,
                "late_by_s": e.late_by_s}
    if isinstance(e, NotPrimary):
        return {"type": "NotPrimary", "rid": e.rid}
    if isinstance(e, FrontendClosed):
        return {"type": "FrontendClosed", "detail": str(e)}
    if isinstance(e, TxnConflict):
        return {"type": "TxnConflict", "key": e.key, "txn": e.txn}
    if isinstance(e, TxnAborted):
        return {"type": "TxnAborted", "txn": e.txn,
                "detail": str(e.cause) if e.cause else ""}
    if isinstance(e, TxnInDoubt):
        return {"type": "TxnInDoubt", "txn": e.txn,
                "decision": e.decision,
                "detail": str(e.cause) if e.cause else ""}
    return {"type": "ServeError",
            "detail": f"{type(e).__name__}: {e}"}


def _decode_error(d: dict, shard: int) -> ServeError:
    t = d.get("type")
    if t == "WrongShard":
        return WrongShard(d["key"], d["shard"], d["expected_shard"],
                          d["map_version"], d.get("peer_version"))
    if t == "ShardUnavailable":
        cause = RuntimeError(d["detail"]) if d.get("detail") else None
        return ShardUnavailable(d["shard"], cause=cause,
                                maybe_executed=d["maybe_executed"])
    if t == "Overloaded":
        return Overloaded(d["rid"], d["depth"])
    if t == "ReplicaFailed":
        cause = RuntimeError(d["detail"]) if d.get("detail") else None
        return ReplicaFailed(d["rid"], cause=cause,
                             maybe_executed=d["maybe_executed"])
    if t == "DeadlineExceeded":
        return DeadlineExceeded(d["rid"], d["late_by_s"])
    if t == "NotPrimary":
        return NotPrimary(d["rid"])
    if t == "FrontendClosed":
        return FrontendClosed(d.get("detail", "frontend closed"))
    if t == "TxnConflict":
        return TxnConflict(d["key"], d["txn"])
    if t == "TxnAborted":
        cause = RuntimeError(d["detail"]) if d.get("detail") else None
        return TxnAborted(d["txn"], cause=cause)
    if t == "TxnInDoubt":
        cause = RuntimeError(d["detail"]) if d.get("detail") else None
        return TxnInDoubt(d["txn"], decision=d.get("decision"),
                          cause=cause)
    return ServeError(
        f"shard {shard} remote error: {d.get('detail', d)}"
    )


def _encode_pairs(pairs: list) -> list:
    """`submit_batch` outcome pairs → JSON rows. Results must be
    JSON-representable (the replicated models return ints / None;
    tuples survive as lists)."""
    out = []
    for status, val in pairs:
        if status == "ok":
            out.append(["ok", val])
        else:
            out.append(["err", _encode_error(val)])
    return out


def _decode_pairs(rows: list, shard: int) -> list:
    return [
        ("ok", val) if status == "ok"
        else ("err", _decode_error(val, shard))
        for status, val in rows
    ]


# ==========================================================================
# backends
# ==========================================================================


class LocalBackend:
    """One shard's in-process submit path.

    Used three ways: inside `ShardServer` (the shard primary's
    process), inside an all-in-one `ShardGroup` (tests, sim), and as
    the re-home target after a promotion (`ShardRouter.repoint` onto
    the promoted follower's frontend). In every role it re-verifies
    the routing invariant — the caller's map version matches and each
    op's key lands in THIS shard's congruence class — before any op
    is staged, so the fleet-level LogMapper contract is enforced at
    the door, not assumed (nrlint rule `unrouted-key-in-shard-path`
    machine-checks that no shard/ submit path skips this lookup).
    """

    def __init__(self, shard: int, frontend, shard_map: ShardMap,
                 participant=None):
        self.shard = int(shard)
        self._frontend = frontend
        self._map = shard_map
        #: the shard's 2PC participant (`shard/txn.py`), when wired:
        #: routes txn verbs and fences non-txn ops off locked keys
        self._participant = participant
        self._lock = make_lock("LocalBackend._lock")
        # in-flight submit_batch tokens: `quiesce()` waits for the
        # calls that entered BEFORE a map fence to leave, closing the
        # check-then-stage window a reshard cutover must not race
        # (`shard/reshard.py`: an op that passed the old-version check
        # must finish acking — ship barrier armed — before the donor's
        # shipper stops, or an acked moved-key write could miss the
        # promote drain)
        self._active: set = set()
        self._active_seq = itertools.count()

    @property
    def map(self) -> ShardMap:
        with self._lock:
            return self._map

    def set_map(self, m: ShardMap) -> None:
        with self._lock:
            self._map = m

    def update_version(self, m: ShardMap) -> None:
        """Router pushed a newer map (uniform backend surface with
        `SocketShardClient.update_version`)."""
        self.set_map(m)

    def set_frontend(self, frontend) -> None:
        with self._lock:
            self._frontend = frontend

    def set_participant(self, participant) -> None:
        with self._lock:
            self._participant = participant

    @property
    def participant(self):
        with self._lock:
            return self._participant

    def txn_verb(self, verb: str, txn: str, gen: int,
                 peer_version: int, ops=None,
                 timeout: float | None = None):
        """Dispatch one 2PC verb to this shard's participant
        (`shard/txn.py`). The participant does its own version and
        congruence fencing; a shard with no participant refuses
        retryably — the coordinator re-homes via the published map
        exactly like a dead primary."""
        with self._lock:
            p = self._participant
        if p is None:
            raise ShardUnavailable(
                self.shard,
                cause=RuntimeError("shard has no txn participant"),
            )
        if verb == "prepare":
            return p.prepare(txn, gen, ops or [], peer_version)
        if verb == "commit":
            return p.commit(txn, peer_version)
        if verb == "abort":
            p.abort(txn, peer_version)
            return True
        if verb == "status":
            return p.status(txn)
        raise ServeError(f"unknown txn verb {verb!r}")

    def submit_batch(self, ops, peer_version: int,
                     deadline_s: float | None = None,
                     timeout: float | None = None,
                     priority: int | None = None,
                     rid: int = 0) -> list:
        """Verify-then-stage the sub-batch; returns one `("ok",
        result)` / `("err", exc)` pair per op, submission order.

        All ops are staged before any result is awaited (the frontend
        batches them into combiner rounds); per-op failures stay
        per-op — an `Overloaded` shed of op k never aborts op k+1,
        matching the non-atomic contract.
        """
        tok = next(self._active_seq)
        with self._lock:
            m = self._map
            fe = self._frontend
            p = self._participant
            self._active.add(tok)
        try:
            return self._submit_batch(m, fe, p, ops, peer_version,
                                      deadline_s, timeout, priority,
                                      rid)
        finally:
            with self._lock:
                self._active.discard(tok)

    def _submit_batch(self, m, fe, p, ops, peer_version,
                      deadline_s, timeout, priority, rid) -> list:
        if peer_version != m.version:
            raise WrongShard(-1, self.shard, self.shard, m.version,
                             peer_version=peer_version)
        for op in ops:
            owner = m.shard_of_op(op)
            if owner != self.shard:
                raise WrongShard(op[1], self.shard, owner, m.version,
                                 peer_version=peer_version)
        if p is not None and p.has_locks():
            # a prepared-but-undecided txn blocks CONFLICTING KEYS,
            # not the shard; the flag read above is the txn plane's
            # entire cost on the non-txn path when nothing is in
            # flight (the `obs_port=None` discipline)
            p.check_conflicts(ops)
        kwargs = {} if priority is None else {"priority": priority}

        def translate(e: ServeError) -> ServeError:
            # a closed/dead frontend is PERMANENT for its process but
            # TRANSIENT for the shard — the op never reached the log
            # and the slice is about to be re-homed onto the promoted
            # follower, so surface the retryable shard-plane error;
            # likewise a follower-mode frontend mid-cutover
            # (`shard/reshard.py`: the recipient backend is attached
            # BEFORE its promotion drains) refuses with zero effect —
            # retryably, so closed-loop clients ride the fence out
            if isinstance(e, (FrontendClosed, NotPrimary)):
                return ShardUnavailable(self.shard, cause=e)
            return e

        staged: list = []
        with fe.staging(rid):
            for op in ops:
                try:
                    staged.append(
                        ("fut", fe.submit(tuple(op), rid=rid,
                                          deadline_s=deadline_s,
                                          **kwargs))
                    )
                except ServeError as e:
                    staged.append(("err", translate(e)))
        pairs: list = []
        for status, item in staged:
            if status == "err":
                pairs.append(("err", item))
                continue
            try:
                pairs.append(("ok", item.result(timeout)))
            except TimeoutError as e:
                pairs.append(("err", e))
            except ServeError as e:
                pairs.append(("err", translate(e)))
        return pairs

    def quiesce(self, timeout: float = 10.0) -> bool:
        """Wait until every `submit_batch` call that entered BEFORE
        this point has left (acked or failed). Calls entering after
        do not extend the wait — they already see the current map, so
        a cutover that fenced the map first only needs the OLD
        epoch's in-flight calls gone. True when drained in time."""
        with self._lock:
            snap = set(self._active)
        clock = get_clock()
        t_end = clock.now() + float(timeout)
        while snap:
            with self._lock:
                snap &= self._active
            if not snap:
                break
            if clock.now() >= t_end:
                return False
            clock.sleep(0.002)
        return True

    def close(self) -> None:
        pass


class SocketShardClient:
    """One shard's remote submit path, over the repl CRC framing.

    Connection discipline follows `repl/transport.py:SocketFeed`: one
    socket guarded by the client lock, and EVERY (re)connect replays
    the HELLO carrying this client's map version — the server refuses
    a mismatch with a typed `WrongShard`, which is what makes a fenced
    zombie shard (or a stale router) unable to exchange a single ack
    after a promotion bumps the published map.

    Retry discipline is STRICTER than the feed's, because submits are
    not idempotent: a failure BEFORE the request frame was fully sent
    reconnects and retries once (a torn frame fails the server's CRC
    check, so nothing executed); a failure AFTER the send raises
    `ShardUnavailable(maybe_executed=True)` — the sub-batch may commit
    and replay from the shard's WAL, so the client must not blindly
    resubmit (`call_with_retry` refuses exactly like a
    `maybe_executed` `ReplicaFailed`).
    """

    def __init__(self, shard: int, address, map_version: int,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 10.0):
        self.shard = int(shard)
        self.address = (str(address[0]), int(address[1]))
        self._version = int(map_version)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self._lock = make_lock("SocketShardClient._lock")
        self._sock: socket.socket | None = None

    # ------------------------------------------------- connection mgmt

    def _connect_locked(self) -> None:
        sock = socket.create_connection(
            self.address, timeout=self.connect_timeout_s
        )
        sock.settimeout(self.io_timeout_s)
        try:
            send_frame(sock, json.dumps(
                {"kind": "hello", "version": self._version}
            ).encode())
            rsp = json.loads(
                recv_frame(sock, MAX_FRAME_BYTES).decode()
            )
        except BaseException:
            sock.close()
            raise
        if rsp.get("kind") == "error":
            sock.close()
            raise _decode_error(rsp["err"], self.shard)
        if (rsp.get("kind") != "hello-ok"
                or rsp.get("shard") != self.shard):
            sock.close()
            raise TransportError(
                f"bad hello response from shard {self.shard}: {rsp}"
            )
        self._sock = sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def update_version(self, m: ShardMap) -> None:
        """Adopt a newer map (and address): drop the connection so the
        next request replays HELLO under the new version — the
        map-version check runs on every reconnect by construction."""
        with self._lock:
            self._version = m.version
            addr = m.addresses[self.shard]
            if addr is not None:
                self.address = (str(addr[0]), int(addr[1]))
            self._drop_locked()

    # ------------------------------------------------------- requests

    def _request(self, obj: dict) -> dict:
        with self._lock:
            last: BaseException | None = None
            for attempt in (0, 1):
                if self._sock is None:
                    try:
                        self._connect_locked()
                    except (TransportError, OSError) as e:
                        self._drop_locked()
                        last = e
                        continue
                sent = False
                try:
                    send_frame(self._sock, json.dumps(obj).encode())
                    sent = True
                    return json.loads(
                        recv_frame(self._sock,
                                   MAX_FRAME_BYTES).decode()
                    )
                except TransportError as e:
                    self._drop_locked()
                    if sent:
                        # the request frame left intact: the shard may
                        # execute it and lose only the response
                        raise ShardUnavailable(
                            self.shard, cause=e, maybe_executed=True
                        ) from e
                    last = e
            raise ShardUnavailable(self.shard, cause=last) from last

    def submit_batch(self, ops, peer_version: int,
                     deadline_s: float | None = None,
                     timeout: float | None = None,
                     priority: int | None = None,
                     rid: int = 0) -> list:
        rsp = self._request({
            "kind": "submit",
            "version": int(peer_version),
            "ops": [list(op) for op in ops],
            "deadline_s": deadline_s,
            "timeout": timeout,
            "priority": priority,
            "rid": int(rid),
        })
        if rsp.get("kind") == "error":
            raise _decode_error(rsp["err"], self.shard)
        if rsp.get("kind") != "ack":
            raise ShardUnavailable(
                self.shard,
                cause=RuntimeError(f"bad response kind: {rsp}"),
            )
        return _decode_pairs(rsp["pairs"], self.shard)

    def txn_verb(self, verb: str, txn: str, gen: int,
                 peer_version: int, ops=None,
                 timeout: float | None = None):
        """One 2PC verb over the wire (`ShardServer` routes it to the
        shard's participant). Same post-send honesty as `submit`: a
        connection death after the frame left raises
        `maybe_executed=True` — but unlike a submit, commit/abort are
        idempotent at the participant, so the coordinator MAY re-drive
        them (and does)."""
        rsp = self._request({
            "kind": "txn",
            "verb": str(verb),
            "txn": str(txn),
            "gen": int(gen),
            "version": int(peer_version),
            "ops": [list(op) for op in (ops or [])],
            "timeout": timeout,
        })
        if rsp.get("kind") == "error":
            raise _decode_error(rsp["err"], self.shard)
        if rsp.get("kind") != "txn-ok":
            raise ShardUnavailable(
                self.shard,
                cause=RuntimeError(f"bad response kind: {rsp}"),
            )
        return rsp.get("result")

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


# ==========================================================================
# the shard-side server
# ==========================================================================


class ShardServer:
    """One shard primary's submit endpoint (thin proxy target).

    Lifecycle and socket discipline mirror
    `repl/transport.py:FeedServer`: a named accept thread polling a
    stop flag under an accept timeout, one named thread per
    connection with an io timeout, and every failure ANSWERED as a
    typed error frame (`_encode_error`), never swallowed — a client
    must be able to tell `WrongShard` (refresh and re-route) from
    `Overloaded` (back off) without string-matching.

    Version fencing: the server holds the shard's current `ShardMap`
    and checks the client's version at HELLO **and on every submit**
    (`LocalBackend` re-checks it), so bumping the map via `set_map`
    immediately fences every stale peer — the shard-level twin of the
    feed's epoch fence.
    """

    def __init__(self, shard: int, frontend, shard_map: ShardMap,
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = "shard",
                 accept_timeout_s: float = 0.2,
                 io_timeout_s: float = 10.0):
        self.shard = int(shard)
        self.name = name
        self._backend = LocalBackend(shard, frontend, shard_map)
        self._accept_timeout_s = float(accept_timeout_s)
        self._io_timeout_s = float(io_timeout_s)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET,
                               socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self._lsock.settimeout(self._accept_timeout_s)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._conn_id = 0
        self._threads_lock = make_lock("ShardServer._threads_lock")
        self._conn_threads: list[threading.Thread] = []
        reg = get_registry()
        self._m_submitted = reg.counter(
            f"shard.s{self.shard}.server_submitted"
        )
        self._m_refused = reg.counter(
            f"shard.s{self.shard}.server_refused"
        )
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"shard-server-{name}-s{self.shard}",
            daemon=True,
        )
        self._accept_thread.start()

    @property
    def map(self) -> ShardMap:
        return self._backend.map

    def set_map(self, m: ShardMap) -> None:
        """Adopt a re-published map: every in-flight and future
        submit carrying the old version is refused (`WrongShard`)."""
        self._backend.set_map(m)

    def set_frontend(self, frontend) -> None:
        self._backend.set_frontend(frontend)

    def set_participant(self, participant) -> None:
        """Wire the shard's 2PC participant (`shard/txn.py`); txn
        frames are refused (retryably) until one is attached."""
        self._backend.set_participant(participant)

    # --------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except (TimeoutError, socket.timeout):
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            conn.settimeout(self._io_timeout_s)
            with self._threads_lock:
                self._conn_id += 1
                t = threading.Thread(
                    target=self._serve_conn,
                    args=(conn,),
                    name=(f"shard-conn-{self.name}-s{self.shard}"
                          f"-{self._conn_id}"),
                    daemon=True,
                )
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = json.loads(
                        recv_frame(conn, MAX_FRAME_BYTES).decode()
                    )
                except (TransportError, ValueError):
                    return  # client gone / torn stream: done
                try:
                    rsp = self._handle(req)
                except Exception as e:  # answered, never swallowed
                    self._record_failure(e)
                    rsp = {"kind": "error", "err": _encode_error(e)}
                try:
                    send_frame(conn, json.dumps(rsp).encode())
                except TransportError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _record_failure(self, e: BaseException) -> None:
        """Count + trace a refused request (the FeedServer report
        discipline): every failure is ANSWERED as a typed error frame
        by the caller, and this makes it visible to obs too."""
        self._m_refused.inc()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit("shard-refused", shard=self.shard,
                        error=type(e).__name__, detail=str(e))

    def _handle(self, req: dict) -> dict:
        kind = req.get("kind")
        if kind == "hello":
            m = self._backend.map
            peer = int(req.get("version", -1))
            if peer != m.version:
                raise WrongShard(-1, self.shard, self.shard,
                                 m.version, peer_version=peer)
            return {"kind": "hello-ok", "shard": self.shard,
                    "version": m.version}
        if kind == "submit":
            ops = [tuple(op) for op in req["ops"]]
            self._m_submitted.inc(len(ops))
            pairs = self._backend.submit_batch(
                ops,
                int(req["version"]),
                deadline_s=req.get("deadline_s"),
                timeout=req.get("timeout"),
                priority=req.get("priority"),
                rid=int(req.get("rid", 0)),
            )
            return {"kind": "ack", "pairs": _encode_pairs(pairs)}
        if kind == "txn":
            result = self._backend.txn_verb(
                req["verb"],
                req["txn"],
                int(req.get("gen", 0)),
                int(req["version"]),
                ops=[tuple(op) for op in req.get("ops", [])],
                timeout=req.get("timeout"),
            )
            if isinstance(result, list):
                # commit results: the models return JSON-safe scalars
                result = [
                    v if v is None else int(v) for v in result
                ]
            return {"kind": "txn-ok", "result": result}
        raise ServeError(f"unknown request kind {kind!r}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        with self._threads_lock:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(timeout=5.0)


# ==========================================================================
# the router
# ==========================================================================


class ShardRouter:
    """Split → fan out → reassemble over a fleet of shard backends.

    Frontend-shaped on purpose: `call(op, ...)` is drop-in for
    `serve/client.py:call_with_retry`, which then handles the shard
    plane's transients for free — `ShardUnavailable` backs off and
    retries (the op provably never reached a log), `WrongShard`
    triggers `refresh_map()` so a promotion's re-published map is
    adopted mid-retry-loop and the resubmission routes to the shard's
    new home. The router deliberately does NOT expose
    `healthy_rids()`: keys are pinned to shards by the congruence
    map, so re-routing an op to a different shard is never correct —
    re-homing happens by map adoption, not replica choice.
    """

    def __init__(self, shard_map: ShardMap, backends: dict,
                 map_path: str | None = None,
                 concurrent: bool = True):
        self._lock = make_lock("ShardRouter._lock")
        self._map = shard_map
        self._backends = dict(backends)
        self._map_path = map_path
        #: sequential shard-ordered fan-out when False — the sim's
        #: determinism knob (thread interleaving is schedule noise)
        self.concurrent = bool(concurrent)
        reg = get_registry()
        self._m_fanout = reg.histogram("shard.router.fanout_s")
        self._m_version = reg.gauge("shard.map_version")
        self._m_version.set(shard_map.version)
        self._m_corrupt = reg.counter("shard.map_corrupt")
        # per-shard counters are created LAZILY: a reshard can grow
        # `n_shards` mid-life (`shard/reshard.py`), and metric
        # creation on first touch keeps the registry in step without
        # a resize hook
        self._m_sub: dict[int, object] = {}
        self._m_ack: dict[int, object] = {}
        self._m_reroute: dict[int, object] = {}
        for s in range(shard_map.n_shards):
            self._shard_counters(s)

    def _shard_counters(self, s: int) -> tuple:
        sub = self._m_sub.get(s)
        if sub is None:
            reg = get_registry()
            sub = self._m_sub[s] = reg.counter(f"shard.s{s}.submitted")
            self._m_ack[s] = reg.counter(f"shard.s{s}.acked")
            self._m_reroute[s] = reg.counter(f"shard.s{s}.rerouted")
        return sub, self._m_ack[s], self._m_reroute[s]

    @property
    def map(self) -> ShardMap:
        with self._lock:
            return self._map

    # ------------------------------------------------------ map churn

    def adopt(self, new_map: ShardMap, backends: dict | None = None,
              reason: str = "map-update") -> None:
        """Adopt a newer map (and optionally replacement backends for
        re-homed shards), pushing the version to every backend so
        socket clients replay HELLO under it on their next request."""
        with self._lock:
            old = self._map
            if new_map.version < old.version:
                return
            self._map = new_map
            if backends:
                for s, b in backends.items():
                    prev = self._backends.get(s)
                    if prev is not None and prev is not b:
                        prev.close()
                    self._backends[int(s)] = b
            live = list(self._backends.items())
        self._m_version.set(new_map.version)
        # growth-safe move detection: a refined map (`ShardMap.refine`)
        # has MORE classes than the old one — a brand-new class index
        # counts as moved only when a backend was re-homed onto it
        moved = [
            s for s in range(new_map.n_shards)
            if (backends and s in backends)
            or (s < old.n_shards
                and new_map.addresses[s] != old.addresses[s])
        ]
        for s in moved:
            self._shard_counters(s)[2].inc()
        tracer = get_tracer()
        if tracer.enabled and (moved or new_map.version != old.version):
            tracer.emit("serve-reroute", reason=reason,
                        map_version=new_map.version,
                        from_version=old.version, shards=moved)
        for _s, b in live:
            b.update_version(new_map)

    def backend(self, shard: int):
        """The backend currently attached for `shard` (None when
        absent) — the reshard plan's handle for quiescing the donor
        at its cutover fence."""
        with self._lock:
            return self._backends.get(int(shard))

    def attach_backend(self, shard: int, backend) -> None:
        """Register a backend WITHOUT adopting a new map — the reshard
        cutover's staging step (`shard/reshard.py`): backends for the
        refined classes are attached first (inert; no key routes to a
        class beyond the current map), so the instant the doubled map
        is adopted every class already has a home and moved-key
        unavailability is the fence window, not a backend scramble."""
        with self._lock:
            prev = self._backends.get(int(shard))
            if prev is not None and prev is not backend:
                prev.close()
            self._backends[int(shard)] = backend

    def txn_call(self, shard: int, verb: str, txn: str, gen: int,
                 ops=None, timeout: float | None = None):
        """Route one 2PC verb (`shard/txn.py:TxnCoordinator`) to a
        shard's backend under the CURRENT map version — the
        participant fences it exactly like a submit."""
        with self._lock:
            m = self._map
            backend = self._backends.get(int(shard))
        if backend is None:
            raise ShardUnavailable(
                int(shard),
                cause=RuntimeError("no backend attached"),
            )
        return backend.txn_verb(verb, txn, gen, m.version, ops=ops,
                                timeout=timeout)

    def repoint(self, shard: int, backend,
                new_map: ShardMap | None = None) -> ShardMap:
        """Re-home one shard onto `backend` (a promotion: the shard's
        follower took over). Bumps the map version unless a
        re-published map is given, then adopts it fleet-wide."""
        with self._lock:
            m = self._map
        if new_map is None:
            addr = getattr(backend, "address", None)
            new_map = m.with_address(shard, addr)
        self.adopt(new_map, {int(shard): backend},
                   reason=f"repoint-s{shard}")
        return new_map

    def refresh_map(self) -> bool:
        """Reload the durably-published map; adopt if newer. This is
        `call_with_retry`'s re-route hook (`WrongShard` /
        `ShardUnavailable` both trigger it). Returns True when a newer
        version was adopted.

        Survives a CORRUPT published map: `ShardMap.load` raises
        typed `ShardMapCorruptError` for a document that parses or
        validates wrong (a hand edit, bit rot — never a torn publish,
        `durable_publish` excludes those), and the router keeps its
        old map and counts `shard.map_corrupt` — routing on the last
        good topology beats adopting garbage or crashing the retry
        loop."""
        if self._map_path is None:
            return False
        try:
            m = ShardMap.load(self._map_path)
        except ShardMapCorruptError:
            self._m_corrupt.inc()
            return False
        except (OSError, ValueError, KeyError):
            return False
        with self._lock:
            newer = m.version > self._map.version
        if newer:
            self.adopt(m, reason="refresh")
        return newer

    # ------------------------------------------------------ submit path

    def _fan_out(self, m: ShardMap, backends: dict, groups: dict,
                 deadline_s, timeout, priority, rid) -> dict:
        """One `submit_batch` per shard; concurrently when configured.
        Returns shard → pairs-or-exception (a whole-sub-batch failure
        is recorded per shard and mapped onto its ops by the caller)."""
        def run_one(shard: int, entries: list) -> list:
            backend = backends.get(shard)
            if backend is None:
                raise ShardUnavailable(
                    shard, cause=RuntimeError("no backend attached")
                )
            return backend.submit_batch(
                [op for _i, op in entries], m.version,
                deadline_s=deadline_s, timeout=timeout,
                priority=priority, rid=rid,
            )

        out: dict = {}
        shards = sorted(groups)
        if not self.concurrent or len(shards) == 1:
            for s in shards:
                try:
                    out[s] = run_one(s, groups[s])
                except Exception as e:
                    out[s] = e
            return out

        sinks: dict[int, list] = {s: [] for s in shards}

        def worker(s: int) -> None:
            try:
                sinks[s].append(("done", run_one(s, groups[s])))
            except Exception as e:
                # recorded to the per-shard sink; surfaced as this
                # sub-batch's per-op errors by the caller
                sinks[s].append(("error", e))

        threads = [
            threading.Thread(target=worker, args=(s,),
                             name=f"shard-router-fan-s{s}")
            for s in shards
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for s in shards:
            status, payload = sinks[s][0] if sinks[s] else (
                "error",
                ShardUnavailable(s, cause=RuntimeError(
                    "fan-out worker died"
                )),
            )
            out[s] = payload
        return out

    def execute_batch(self, ops, deadline_s: float | None = None,
                      timeout: float | None = None,
                      priority: int | None = None, rid: int = 0,
                      return_exceptions: bool = False) -> list:
        """Route a batch: split by congruence class, fan out, and
        reassemble responses in SUBMISSION order.

        Per-op outcomes are independent across shards (the CNR
        non-atomic contract): with `return_exceptions=True` each slot
        is either the op's result or its typed exception; with the
        default False the first failing op's exception is raised —
        AFTER every sub-batch completed, so ops on other shards have
        already committed (there is no rollback; the docstring above
        is the contract).
        """
        clock = get_clock()
        with self._lock:
            m = self._map
            backends = dict(self._backends)
        groups = m.split_batch(ops)
        for s, entries in groups.items():
            self._shard_counters(s)[0].inc(len(entries))
        t0 = clock.now()
        by_shard = self._fan_out(m, backends, groups,
                                 deadline_s, timeout, priority, rid)
        self._m_fanout.observe(clock.now() - t0)
        out: list = [None] * len(ops)
        first_err: tuple | None = None  # (submission idx, exception)
        for s, entries in groups.items():
            result = by_shard[s]
            if isinstance(result, BaseException):
                pairs = [("err", result)] * len(entries)
            else:
                pairs = result
            acked = 0
            for (idx, _op), (status, val) in zip(entries, pairs):
                out[idx] = val
                if status == "ok":
                    acked += 1
                elif first_err is None or idx < first_err[0]:
                    first_err = (idx, val)
            if acked:
                self._shard_counters(s)[1].inc(acked)
        if first_err is not None and not return_exceptions:
            raise first_err[1]
        return out

    def call(self, op: tuple, rid: int = 0,
             deadline_s: float | None = None,
             timeout: float | None = None,
             priority: int | None = None):
        """Single-op closed loop (the `call_with_retry` surface):
        route, submit, return the result or raise its typed error."""
        return self.execute_batch(
            [op], deadline_s=deadline_s, timeout=timeout,
            priority=priority, rid=rid,
        )[0]

    def close(self) -> None:
        with self._lock:
            backends = list(self._backends.values())
            self._backends.clear()
        for b in backends:
            b.close()
