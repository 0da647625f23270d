"""Txn durability plane: participant intent journals + the
coordinator's durable decision log.

The port's copy of `node_replication_tpu/durable/txnlog.py`: the same
framing, JSON payloads and file names, so each package reads the
other's journals and decision files, byte for byte.

Two tiny stores compose the crash-proofness of the 2PC layer
(`shard/txn.py`) out of disciplines the repo already trusts:

- `TxnIntentLog` — one append-only file per participant, framed
  exactly like the WAL (`u32 length | u32 crc32(payload) | payload`,
  `durable/wal.py`): a torn tail (crash mid-append) silently
  truncates — the record was never acknowledged to anyone — while a
  COMPLETE record with a bad CRC raises `TxnLogCorruptError`; crashes
  are expected, bit rot is loud. Payloads are JSON of three kinds:
  `intent` (the prepared sub-batch; the fsync of this record IS the
  yes-vote — a participant that voted can always re-derive what it
  promised), `commit-begin` (the shard WAL tail at the instant the
  participant starts applying — the dedup fence recovery scans from,
  so a crash between apply and resolve can never double-apply), and
  `resolved` (commit/abort outcome; releases the intent). Reopen
  compacts in memory: unresolved intents reload (the participant
  rebuilds their key locks), resolved outcomes are retained as an
  id → outcome index so re-driven `commit`/`abort` verbs stay
  idempotent across restarts.

- `DecisionLog` — the coordinator's decision store: one
  `dec-<txn>.json` per transaction written via `durable_publish`
  (atomic tmp + fsync + rename: fsync-before-ack, exactly the
  `durability="batch"` contract), plus the coordinator generation
  file `coord-epoch.json`. The PRESENCE of a complete decision file
  is the commit point; its ABSENCE, for a transaction stamped with a
  dead coordinator generation, means **presumed abort**. `bump_epoch`
  is the "dead generation" fence: every coordinator (re)start bumps
  it durably, so a participant holding an undecided intent from an
  older generation may abort without hearing from anyone — the
  feed-epoch fencing argument (`repl/feed.py`), replayed at the
  transaction layer.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib

from node_replication_torch.durable.wal import (
    WalError,
    _fsync_dir,
    durable_publish,
)

#: coordinator generation file inside a decision directory
EPOCH_FILENAME = "coord-epoch.json"

#: txn ids are path components (`dec-<txn>.json`) — restrict them
_TXN_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,120}$")

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)


class TxnLogCorruptError(WalError):
    """A COMPLETE intent-log or decision record failed validation.

    Torn tails are NOT this error (a crash mid-append truncates
    silently — nothing was promised on that record); a complete frame
    whose CRC or JSON does not check out is bit rot or tampering, and
    recovery must stop rather than guess at what was promised."""

    def __init__(self, path: str, offset: int, detail: str):
        super().__init__(
            f"corrupt txn record in {path} at byte {offset}: {detail}"
        )
        self.path = path
        self.offset = offset
        self.detail = detail


def _check_txn_id(txn: str) -> str:
    if not _TXN_ID_RE.match(txn):
        raise ValueError(f"invalid txn id {txn!r}")
    return txn


class TxnIntentLog:
    """One participant's append-only intent journal (CRC-framed)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        #: unresolved intents: txn -> {"gen", "ops", "commit_begin"}
        self._intents: dict[str, dict] = {}
        #: resolved outcomes: txn -> "commit" | "abort" (kept so a
        #: re-driven verb after restart stays idempotent)
        self._resolved: dict[str, str] = {}
        self.truncated_bytes = 0
        self._recover()
        self._f = open(path, "ab")

    # -------------------------------------------------------- recovery

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        off = 0
        while off < len(buf):
            if off + _HEADER.size > len(buf):
                break  # torn header: crash mid-append
            ln, crc = _HEADER.unpack_from(buf, off)
            end = off + _HEADER.size + ln
            if end > len(buf):
                break  # torn payload: crash mid-append
            payload = buf[off + _HEADER.size:end]
            if zlib.crc32(payload) != crc:
                raise TxnLogCorruptError(self.path, off, "CRC mismatch")
            try:
                rec = json.loads(payload.decode())
            except ValueError as e:
                raise TxnLogCorruptError(
                    self.path, off, f"bad JSON payload: {e}"
                ) from e
            self._fold(rec)
            off = end
        if off < len(buf):
            self.truncated_bytes = len(buf) - off
            with open(self.path, "r+b") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(os.path.dirname(self.path) or ".")

    def _fold(self, rec: dict) -> None:
        kind, txn = rec["kind"], rec["txn"]
        if kind == "intent":
            self._intents[txn] = {
                "gen": int(rec["gen"]),
                "ops": [tuple(op) for op in rec["ops"]],
                "commit_begin": None,
            }
        elif kind == "commit-begin":
            info = self._intents.get(txn)
            if info is not None:
                info["commit_begin"] = int(rec["t0"])
        elif kind == "resolved":
            self._intents.pop(txn, None)
            self._resolved[txn] = rec["outcome"]

    # --------------------------------------------------------- appends

    def _append(self, rec: dict) -> None:
        payload = json.dumps(rec, sort_keys=True).encode()
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        os.fsync(self._f.fileno())  # the vote/outcome IS the fsync
        self._fold(rec)

    def journal_intent(self, txn: str, gen: int, ops) -> None:
        """Durably record the prepared sub-batch. Returning from this
        call IS the yes-vote: the participant can crash at any later
        point and still re-derive what it promised to apply."""
        self._append({
            "kind": "intent", "txn": _check_txn_id(txn),
            "gen": int(gen), "ops": [list(op) for op in ops],
        })

    def journal_commit_begin(self, txn: str, t0: int) -> None:
        """Record the shard WAL tail before applying: recovery scans
        `[t0, tail)` for the intent's ops, so a crash between apply
        and resolve re-applies only what is provably missing."""
        self._append({"kind": "commit-begin", "txn": txn,
                      "t0": int(t0)})

    def journal_resolved(self, txn: str, outcome: str) -> None:
        if outcome not in ("commit", "abort"):
            raise ValueError(f"unknown outcome {outcome!r}")
        self._append({"kind": "resolved", "txn": txn,
                      "outcome": outcome})

    # ---------------------------------------------------------- lookup

    def unresolved(self) -> dict[str, dict]:
        """Prepared-but-undecided intents (shallow copies)."""
        return {t: dict(i) for t, i in self._intents.items()}

    def intent(self, txn: str) -> dict | None:
        info = self._intents.get(txn)
        return dict(info) if info is not None else None

    def outcome(self, txn: str) -> str | None:
        return self._resolved.get(txn)

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class TxnDecision(dict):
    """One decision document: `{"txn", "outcome", "shards"}`."""


class DecisionLog:
    """The coordinator's durable decision + generation store."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _dec_path(self, txn: str) -> str:
        return os.path.join(self.directory,
                            f"dec-{_check_txn_id(txn)}.json")

    # ------------------------------------------------------- decisions

    def publish(self, txn: str, outcome: str, shards=()) -> None:
        """Durably publish the decision (atomic tmp + fsync + rename).
        This is the commit point: a caller future may resolve ONLY
        after this returns — the 2PC twin of fsync-before-ack."""
        if outcome not in ("commit", "abort"):
            raise ValueError(f"unknown outcome {outcome!r}")
        durable_publish(self._dec_path(txn), json.dumps({
            "txn": txn, "outcome": outcome,
            "shards": [int(s) for s in shards],
        }, sort_keys=True).encode())

    def load(self, txn: str) -> TxnDecision | None:
        """The decision document, or None when none was published —
        which, for a dead coordinator generation, means presumed
        abort."""
        path = self._dec_path(txn)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        try:
            return TxnDecision(json.loads(raw.decode()))
        except ValueError as e:
            # durable_publish guarantees complete documents; a torn
            # or hand-edited one must stop recovery, not presume abort
            raise TxnLogCorruptError(path, 0,
                                     f"bad decision JSON: {e}") from e

    def outcome(self, txn: str) -> str | None:
        d = self.load(txn)
        return d["outcome"] if d is not None else None

    def decisions(self) -> list[TxnDecision]:
        """Every published decision (coordinator-restart re-drive)."""
        out = []
        for fn in sorted(os.listdir(self.directory)):
            if fn.startswith("dec-") and fn.endswith(".json"):
                d = self.load(fn[len("dec-"):-len(".json")])
                if d is not None:
                    out.append(d)
        return out

    # ----------------------------------------------------- generations

    def epoch(self) -> int:
        """Current coordinator generation (0 when never bumped)."""
        path = os.path.join(self.directory, EPOCH_FILENAME)
        try:
            with open(path, "rb") as f:
                return int(json.loads(f.read().decode())["epoch"])
        except FileNotFoundError:
            return 0
        except (ValueError, KeyError) as e:
            raise TxnLogCorruptError(path, 0,
                                     f"bad epoch file: {e}") from e

    def bump_epoch(self) -> int:
        """Durably advance the generation; every coordinator
        (re)start calls this, fencing presumed-abort for all older
        undecided transactions."""
        e = self.epoch() + 1
        durable_publish(
            os.path.join(self.directory, EPOCH_FILENAME),
            json.dumps({"epoch": e}).encode(),
        )
        return e
