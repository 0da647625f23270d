"""Atomic cross-shard transactions: presumed-abort 2PC over the
sharded fleet.

The port's copy of `node_replication_tpu/shard/txn.py`, over the port's
`durable/txnlog.py` (whose journals and decision files are the
reference's bytes) and its `durable/wal.py` (whose `WalRecord.ops()`
yields Python ints, as the dedup scan compares them).

`ShardRouter.execute_batch` keeps CNR's multi-log contract — per-shard
sub-batches commit independently, no cross-shard rollback. This module
adds the missing guarantee ON TOP, composing mechanisms the repo
already trusts into two-phase commit:

- **prepare** (`TxnParticipant.prepare`): the participant fences the
  caller's map version and every op's congruence class (the
  `LocalBackend` door checks), refuses keys locked by OTHER prepared
  transactions (`TxnConflict` — a prepared intent blocks conflicting
  KEYS, not the shard), then journals the sub-batch as a CRC-framed
  intent record (`durable/txnlog.py:TxnIntentLog`) and fsyncs it.
  Returning from the fsync IS the yes-vote — the `maybe_executed`
  honesty shape: once voted, the participant can crash and still
  re-derive exactly what it promised.
- **decide** (`TxnCoordinator`): all-yes ⇒ the coordinator durably
  publishes the commit decision (`DecisionLog.publish`, atomic tmp +
  fsync + rename) BEFORE any caller-visible result resolves — the 2PC
  twin of `durability="batch"`'s fsync-before-ack (nrlint rule
  `txn-ack-before-decision` machine-checks the dominance). Any no-vote
  ⇒ publish abort (an accelerator only: ABSENCE of a decision for a
  dead coordinator generation already means abort) and roll the
  prepared participants back.
- **commit/abort** (phase 2): version-fenced verbs on
  `LocalBackend`/`SocketShardClient`/`ShardServer`. Commit journals
  `commit-begin` with the shard WAL tail, applies the intent through
  the shard's own durable frontend (fsync-before-ack acks), then
  journals `resolved` and releases the locks. Both verbs are
  idempotent across re-drives and restarts (the intent log retains
  resolved outcomes).

**Recovery** is decision-lookup, not dialogue:

- A restarted participant reloads unresolved intents (locks rebuilt),
  and `resolve_in_doubt` consults the decision store: a commit
  decision re-applies the intent — deduplicated by scanning the shard
  WAL from the journaled `commit-begin` position, so a crash between
  apply and resolve can never double-apply; an abort decision (or NO
  decision from a coordinator generation older than the current
  epoch) drops it. An undecided intent from the LIVE generation stays
  in doubt, its keys stay locked.
- A restarted coordinator bumps the durable generation
  (`DecisionLog.bump_epoch` — the fence that makes presumed abort
  sound) and re-drives every published commit decision
  (`TxnCoordinator.recover`); participants it cannot reach re-home
  through the same published-map refresh the router uses.

Zero cost when unused (the `obs_port=None` discipline): a
single-shard "transaction" degrades to a plain routed batch, and the
non-txn submit path's only tax is one `has_locks()` flag read.
"""

from __future__ import annotations

import itertools
import os
import threading

from concurrent.futures import Future

from node_replication_torch.analysis.locks import make_lock
from node_replication_torch.durable.txnlog import DecisionLog, TxnIntentLog
from node_replication_torch.fault.inject import fault_hook
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.serve.errors import (
    FrontendClosed,
    ServeError,
    ShardUnavailable,
    TxnAborted,
    TxnConflict,
    TxnInDoubt,
    WrongShard,
)
from node_replication_torch.utils.clock import get_clock
from node_replication_torch.utils.trace import get_tracer


def _op_matches(stored: tuple, wanted: tuple) -> bool:
    """Does a WAL-stored op (args zero-padded to the log's arg width)
    carry the same opcode + args as an intent op?"""
    if not stored or stored[0] != wanted[0]:
        return False
    w = tuple(wanted[1:])
    s = tuple(stored[1:])
    if len(s) < len(w):
        return False
    return s[:len(w)] == w and all(x == 0 for x in s[len(w):])


class TxnParticipant:
    """One shard's 2PC participant: intent journal + key locks.

    Rides the shard's OWN serving stack: prepared intents apply
    through the shard's `ServeFrontend` (durable, ship-before-ack
    acks — a committed sub-batch survives exactly like any other
    write), and the intent journal lives next to the shard's WAL.
    Restart-safe by construction: reopening the journal rebuilds the
    locks of every prepared-but-undecided transaction.
    """

    def __init__(self, shard: int, frontend, shard_map, directory: str,
                 decisions: DecisionLog | None = None, wal=None,
                 apply_timeout_s: float = 10.0):
        self.shard = int(shard)
        self._frontend = frontend
        self._map = shard_map
        self._wal = wal
        self._decisions = decisions
        self.apply_timeout_s = float(apply_timeout_s)
        # commit applies the intent through the duck-typed frontend
        # under this lock (the conflict fence must not open mid-apply),
        # so the nestings are declared:
        # nrcheck: lock-order TxnParticipant._lock -> _SubmissionQueue._lock — commit submits the intent's ops under the participant lock
        # nrcheck: lock-order TxnParticipant._lock -> ServeFuture._cond — and waits for their futures there
        # nrcheck: lock-order TxnParticipant._lock -> WriteAheadLog._lock — commit reads the WAL's tail (and a re-driven one its records) there
        self._lock = make_lock("TxnParticipant._lock")
        path = directory
        if not path.endswith(".log"):
            path = os.path.join(directory, "txn-intents.log")
        self.log = TxnIntentLog(path)
        #: key -> holding txn id (the conflict fence). Rebuilt from
        #: the journal's unresolved intents on every (re)open.
        self._locked: dict[int, str] = {}
        for txn, info in self.log.unresolved().items():
            for op in info["ops"]:
                self._locked[int(op[1])] = txn
        reg = get_registry()
        self._m_prepared = reg.counter(f"shard.s{self.shard}.txn_prepared")
        self._m_committed = reg.counter(
            f"shard.s{self.shard}.txn_committed"
        )
        self._m_aborted = reg.counter(f"shard.s{self.shard}.txn_aborted")
        self._m_conflicts = reg.counter(
            f"shard.s{self.shard}.txn_conflicts"
        )

    # ------------------------------------------------------ wiring

    def set_frontend(self, frontend, wal=None) -> None:
        """Re-home onto a promoted/recovered frontend (+ its WAL)."""
        with self._lock:
            self._frontend = frontend
            if wal is not None:
                self._wal = wal

    def set_map(self, m) -> None:
        with self._lock:
            self._map = m

    def update_version(self, m) -> None:
        self.set_map(m)

    # ------------------------------------------------- conflict fence

    def has_locks(self) -> bool:
        """One flag read — the non-txn path's ENTIRE cost when no
        transaction is in flight (`LocalBackend.submit_batch` gates
        the per-op conflict scan on it)."""
        return bool(self._locked)

    def check_conflicts(self, ops) -> None:
        """Refuse any op on a locked key with retryable `TxnConflict`
        (zero log effect; the lock clears when the txn resolves)."""
        with self._lock:
            for op in ops:
                if len(op) < 2:
                    continue
                holder = self._locked.get(int(op[1]))
                if holder is not None:
                    self._m_conflicts.inc()
                    raise TxnConflict(int(op[1]), holder)

    # ------------------------------------------------------- phase one

    def prepare(self, txn: str, gen: int, ops, peer_version: int) -> bool:
        """Vote on the sub-batch. A True return means the yes-vote is
        DURABLE (the intent record is fsynced) and the keys are
        locked; every refusal is typed and has zero log effect."""
        with self._lock:
            m = self._map
            if peer_version != m.version:
                raise WrongShard(-1, self.shard, self.shard, m.version,
                                 peer_version=peer_version)
            ops = [tuple(op) for op in ops]
            for op in ops:
                owner = m.shard_of_op(op)
                if owner != self.shard:
                    raise WrongShard(op[1], self.shard, owner,
                                     m.version,
                                     peer_version=peer_version)
            prior = self.log.outcome(txn)
            if prior is not None:
                # a re-driven prepare after this participant already
                # resolved: commit means the work is done; abort means
                # the coordinator generation died — refuse loudly
                if prior == "commit":
                    return True
                raise TxnAborted(txn)
            if self.log.intent(txn) is not None:
                return True  # duplicate prepare: already voted yes
            for op in ops:
                holder = self._locked.get(int(op[1]))
                if holder is not None and holder != txn:
                    self._m_conflicts.inc()
                    raise TxnConflict(int(op[1]), holder)
            self.log.journal_intent(txn, gen, ops)
            for op in ops:
                self._locked[int(op[1])] = txn
            self._m_prepared.inc()
        get_tracer().emit("txn-prepare", shard=self.shard, txn=txn,
                          ops=len(ops))
        # after the durable vote, before the reply: a kill here is the
        # prepared-but-unacked participant the in-doubt story covers
        fault_hook("txn-prepare", self.shard)
        return True

    # ------------------------------------------------------- phase two

    def commit(self, txn: str, peer_version: int | None = None) -> list:
        """Apply the prepared intent; returns per-op results in intent
        order. Idempotent: a re-driven commit of a resolved txn
        returns `[]` without touching the log."""
        with self._lock:
            if peer_version is not None:
                m = self._map
                if peer_version != m.version:
                    raise WrongShard(-1, self.shard, self.shard,
                                     m.version,
                                     peer_version=peer_version)
            prior = self.log.outcome(txn)
            if prior == "commit":
                return []
            if prior == "abort":
                raise ServeError(
                    f"txn {txn} already aborted on shard "
                    f"{self.shard}; commit refused"
                )
            info = self.log.intent(txn)
            if info is None:
                raise ServeError(
                    f"txn {txn} was never prepared on shard "
                    f"{self.shard}"
                )
            # a journaled commit-begin fence means an earlier apply
            # attempt started (it may have appended ops before dying):
            # a re-driven commit — the coordinator-restart path — must
            # dedup against the WAL exactly like recovery does. Fresh
            # commits carry no fence and skip the scan.
            return self._apply_locked(
                txn, info, dedup=info.get("commit_begin") is not None)

    def abort(self, txn: str, peer_version: int | None = None) -> None:
        """Drop the intent (zero log effect) and release its locks.
        Idempotent; unknown transactions are a no-op (presumed
        abort needs no record)."""
        with self._lock:
            info = self.log.intent(txn)
            if info is None:
                return
            self.log.journal_resolved(txn, "abort")
            self._release_locked(txn, info)
            self._m_aborted.inc()
        get_tracer().emit("txn-abort", shard=self.shard, txn=txn)

    def status(self, txn: str) -> str:
        with self._lock:
            if self.log.intent(txn) is not None:
                return "prepared"
            out = self.log.outcome(txn)
            if out == "commit":
                return "committed"
            if out == "abort":
                return "aborted"
            return "unknown"

    # -------------------------------------------------------- recovery

    def resolve_in_doubt(self, decisions: DecisionLog | None = None,
                         epoch: int | None = None) -> dict[str, str]:
        """Resolve every unresolved intent by decision lookup: a
        commit decision applies it (deduplicated against the shard
        WAL), an abort decision — or NO decision from a generation
        older than `epoch` — presumed-aborts it, and an undecided
        intent from the live generation stays `"in-doubt"` with its
        keys locked. Returns txn → outcome."""
        dec = decisions or self._decisions
        if dec is None:
            raise ValueError(
                "resolve_in_doubt needs a DecisionLog (constructor "
                "`decisions=` or the `decisions` argument)"
            )
        if epoch is None:
            epoch = dec.epoch()
        out: dict[str, str] = {}
        with self._lock:
            for txn, info in list(self.log.unresolved().items()):
                outcome = dec.outcome(txn)
                if outcome == "commit":
                    self._apply_locked(txn, info, dedup=True)
                    out[txn] = "commit"
                elif outcome == "abort" or info["gen"] < epoch:
                    # explicit abort, or presumed: the coordinator
                    # generation that owned this intent is dead and
                    # never published — it can never decide commit now
                    self.log.journal_resolved(txn, "abort")
                    self._release_locked(txn, info)
                    self._m_aborted.inc()
                    out[txn] = "abort"
                else:
                    out[txn] = "in-doubt"
        if out:
            get_tracer().emit("txn-resolve", shard=self.shard,
                              resolved=out)
        return out

    # -------------------------------------------------------- internals

    def _release_locked(self, txn: str, info: dict) -> None:
        for op in info["ops"]:
            if self._locked.get(int(op[1])) == txn:
                del self._locked[int(op[1])]

    def _apply_locked(self, txn: str, info: dict, dedup: bool) -> list:
        """Apply the intent through the shard's durable frontend
        (caller holds the lock — commits are rare and the hold keeps
        the conflict fence trivially correct). `dedup=True` (recovery)
        skips ops already present in the WAL at/after the journaled
        `commit-begin` position, so a crash between apply and resolve
        never double-applies."""
        ops = [tuple(op) for op in info["ops"]]
        for op in ops:
            # re-verify the congruence at the door (the fleet-level
            # LogMapper invariant): the intent was fenced at prepare,
            # but a commit re-driven after a reshard must not apply a
            # moved key through the wrong shard's frontend
            owner = self._map.shard_of_op(op)
            if owner != self.shard:
                raise WrongShard(int(op[1]), self.shard, owner,
                                 self._map.version)
        need = [True] * len(ops)
        if info.get("commit_begin") is None:
            t0 = self._wal.tail if self._wal is not None else 0
            self.log.journal_commit_begin(txn, t0)
        elif dedup:
            need = self._missing_mask(ops, int(info["commit_begin"]))
        results: list = [None] * len(ops)
        try:
            with self._frontend.staging():
                staged = [
                    (i, self._frontend.submit(ops[i]))
                    for i in range(len(ops)) if need[i]
                ]
            for i, fut in staged:
                results[i] = fut.result(self.apply_timeout_s)
        except FrontendClosed as e:
            # mid-promotion/teardown: the intent survives, the locks
            # hold, and recovery (or a re-driven commit against the
            # re-homed frontend) finishes the job
            raise ShardUnavailable(self.shard, cause=e,
                                   maybe_executed=True) from e
        # between the durable acks above and the resolved record
        # below: THE mid-commit crash window the dedup scan exists for
        fault_hook("txn-commit", self.shard)
        self.log.journal_resolved(txn, "commit")
        self._release_locked(txn, info)
        self._m_committed.inc()
        get_tracer().emit("txn-commit", shard=self.shard, txn=txn,
                          ops=len(ops))
        return results

    def _missing_mask(self, ops: list, t0: int) -> list:
        """Which intent ops are NOT already applied: scan the shard
        WAL from the `commit-begin` fence, consuming one stored match
        per intent op. Sound because the keys were locked the whole
        time — no other writer can have appended an identical op in
        the window."""
        if self._wal is None:
            return [True] * len(ops)
        need = [True] * len(ops)
        start = max(int(t0), self._wal.base)
        for rec in self._wal.records(start):
            for stored in rec.ops():
                for i in range(len(ops)):
                    if need[i] and _op_matches(stored, ops[i]):
                        need[i] = False
                        break
        return need

    def close(self) -> None:
        self.log.close()


class TxnCoordinator:
    """Presumed-abort 2PC coordinator riding a `ShardRouter`.

        coord = TxnCoordinator(router, decision_dir)
        coord.execute_txn([(HM_PUT, k0, a), (HM_PUT, k1, b)])

    Construction durably bumps the coordinator generation
    (`DecisionLog.bump_epoch`) — the fence that lets participants
    presume abort for every undecided intent of an older generation.
    `execute_txn` is the synchronous surface; `submit_txn` returns a
    future resolved by a background drive (the decision publish
    dominates the resolve — nrlint rule `txn-ack-before-decision`).
    A restarted coordinator calls `recover()` to re-drive published
    commit decisions (idempotent at the participants).
    """

    def __init__(self, router, decision_dir: str, name: str = "coord",
                 max_rehome_attempts: int = 8,
                 rehome_backoff_s: float = 0.01):
        self.router = router
        self.name = str(name)
        self.decisions = DecisionLog(decision_dir)
        self.gen = self.decisions.bump_epoch()
        self.max_rehome_attempts = int(max_rehome_attempts)
        self.rehome_backoff_s = float(rehome_backoff_s)
        self._seq = itertools.count(1)
        self._lock = make_lock("TxnCoordinator._lock")
        reg = get_registry()
        self._m_committed = reg.counter("txn.committed")
        self._m_aborted = reg.counter("txn.aborted")
        self._m_in_doubt = reg.counter("txn.in_doubt")
        self._m_single = reg.counter("txn.single_shard")
        self._h_commit_s = reg.histogram("txn.commit_s")

    def _txn_id(self) -> str:
        with self._lock:
            return f"{self.name}.g{self.gen}.{next(self._seq)}"

    # ----------------------------------------------------------- drive

    def execute_txn(self, ops, timeout: float | None = None) -> list:
        """Atomically apply `ops` across shards; returns per-op
        results in submission order. Raises `TxnAborted` (zero log
        effect anywhere — whole-txn retry is exactly-once safe) or
        `TxnInDoubt` (decision durable, some participant unreachable —
        recovery enforces it; do not blindly retry)."""
        clock = get_clock()
        t0 = clock.now()
        ops = [tuple(op) for op in ops]
        groups = self.router.map.split_batch(ops)
        if len(groups) <= 1:
            # single-shard: the shard's own batch is already atomic
            # (one combiner round, one WAL append) — no 2PC cost
            self._m_single.inc()
            return self.router.execute_batch(ops, timeout=timeout)
        txn = self._txn_id()
        shards = sorted(groups)
        sub = {s: [op for _i, op in groups[s]] for s in shards}
        prepared: list[int] = []
        try:
            for s in shards:
                self._verb_rehomed(s, "prepare", txn, ops=sub[s],
                                   timeout=timeout)
                prepared.append(s)
                # coordinator-side crash window: some participants
                # prepared, no decision — presumed abort must clean up
                fault_hook("txn-prepare", s)
        except ServeError as e:
            # publish the abort as an ACCELERATOR (absence already
            # means abort once this generation dies), then roll back
            # the prepared participants best-effort
            self.decisions.publish(txn, "abort", shards=shards)
            for s in prepared:
                try:
                    self._verb_rehomed(s, "abort", txn, timeout=timeout)
                except ServeError:
                    pass  # presumed abort resolves it later
            self._m_aborted.inc()
            raise TxnAborted(txn, cause=e) from e
        # THE commit point: durable decision BEFORE anything resolves
        self.decisions.publish(txn, "commit", shards=shards)
        fault_hook("txn-decide", -1)
        out = self._commit_all(txn, groups, sub, timeout)
        self._m_committed.inc()
        self._h_commit_s.observe(clock.now() - t0)
        return out

    def submit_txn(self, ops) -> Future:
        """Asynchronous surface: a `Future` resolved after the durable
        decision + phase 2 (failures surface as `TxnAborted` /
        `TxnInDoubt` on the future)."""
        fut: Future = Future()
        t = threading.Thread(target=self._run_txn, args=(list(ops), fut),
                             name=f"txn-coord-{self.name}", daemon=True)
        t.start()
        return fut

    def _run_txn(self, ops, fut: Future) -> None:
        # `execute_txn` publishes the durable decision before
        # returning, so the resolve below is decision-dominated
        try:
            result = self.execute_txn(ops)
        except BaseException as e:
            fut.set_exception(e)
            return
        fut.set_result(result)

    # -------------------------------------------------------- recovery

    def recover(self, timeout: float | None = None) -> dict:
        """Coordinator-restart re-drive: every published COMMIT
        decision is re-sent to its participants (idempotent — a
        participant that already resolved returns immediately).
        Construction already bumped the generation, so every
        undecided intent of the dead generations presumed-aborts at
        the participants' own `resolve_in_doubt`."""
        redriven = failed = 0
        for d in self.decisions.decisions():
            if d.get("outcome") != "commit":
                continue
            for s in d.get("shards", ()):
                try:
                    self._verb_rehomed(int(s), "commit", d["txn"],
                                       timeout=timeout)
                    redriven += 1
                except ServeError:
                    failed += 1
        report = {"gen": self.gen, "redriven": redriven,
                  "failed": failed}
        get_tracer().emit("txn-recover", **report)
        return report

    # -------------------------------------------------------- internals

    def _commit_all(self, txn: str, groups: dict, sub: dict,
                    timeout) -> list:
        total = sum(len(g) for g in groups.values())
        out: list = [None] * total
        for s in sorted(groups):
            try:
                vals = self._verb_rehomed(s, "commit", txn,
                                          timeout=timeout)
            except ServeError as e:
                self._m_in_doubt.inc()
                raise TxnInDoubt(txn, decision="commit",
                                 cause=e) from e
            if vals == [] and len(groups[s]) > 0:
                # idempotent replay of an already-resolved commit:
                # results were delivered (and lost) once; slots stay
                # None — the WRITES are guaranteed, the values gone
                continue
            for (idx, _op), v in zip(groups[s], vals):
                out[idx] = v
        return out

    def _verb_rehomed(self, shard: int, verb: str, txn: str,
                      ops=None, timeout=None):
        """One txn verb with the `call_with_retry` re-homing story:
        `WrongShard` refreshes the published map and retries (the
        participant fenced a stale version); a retryable
        `ShardUnavailable` backs off and retries for the IDEMPOTENT
        verbs (commit/abort), but fails prepare fast — an unreachable
        participant cannot vote, and presumed abort is the cheap
        outcome."""
        clock = get_clock()
        last: ServeError | None = None
        for attempt in range(self.max_rehome_attempts):
            try:
                return self.router.txn_call(shard, verb, txn, self.gen,
                                            ops=ops, timeout=timeout)
            except WrongShard as e:
                last = e
                self.router.refresh_map()
            except ShardUnavailable as e:
                last = e
                if verb == "prepare":
                    # an unreachable (or sent-but-unanswered)
                    # participant cannot be counted as a yes-vote;
                    # fail fast — execute_txn publishes the abort, so
                    # even a vote that WAS durably journaled before
                    # the failure resolves by decision lookup
                    raise
                self.router.refresh_map()
                clock.sleep(self.rehome_backoff_s * (attempt + 1))
        raise last
