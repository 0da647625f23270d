"""Checkpoint/resume and recovery-by-replay.

The port of `node_replication_tpu/core/checkpoint.py`. A snapshot file
is the reference's byte for byte: the same npz keys in the same order,
the ring planes and int64 cursors with the reference's dtypes and
shapes (`interop.py:log_to_numpy`), the state leaves in sorted-key
order (`utils/tree.py:tree_leaves`, `jax.tree`'s order), and the same
blake2b manifest digest. So a snapshot written by either package loads
in the other.

The reference has no checkpoint subsystem; its recovery model is structural
(SURVEY.md §5): replica state is reconstructable from a deterministic
`Default` by replaying the log from head — `Log::reset` exists only for
bench reuse (`nr/src/log.rs:582-611`) and `D: Default` is required
precisely so replay-from-scratch is well-defined
(`nr/examples/stack.rs:30-35`). This module makes both halves first-class
for the TPU build, where jobs are preempted routinely:

- `save_snapshot` / `load_snapshot` — durable npz snapshots of the log ring
  + cursors + replica states (numpy container: dependency-free and
  readable anywhere; swap in orbax for sharded async checkpoints when the
  fleet outgrows one host).
- `recover_states` — the reference's recovery model, compiled: start every
  replica from `init_state()` (or a snapshot taken at a known position)
  and replay `[base_pos, tail)` through the same vmapped scan used for
  live replay. Determinism of `Dispatch` transitions makes the result
  bit-identical to the lost states.

The RUNTIME consumers of this recovery model:

- `fault/` (`fault/repair.py`): a quarantined replica is rebuilt live —
  donor snapshot at the donor's ltail, then replay to tail — turning
  recover-by-replay from an offline utility into the repair half of the
  detect/quarantine/repair lifecycle (serve failover rides it through
  `ReplicaLifecycleManager`).
- `durable/` (`durable/recovery.py`): the CRASH-time consumer — on
  process restart the newest valid snapshot loaded here is the base,
  and the write-ahead log (`durable/wal.py`) supplies the tail
  `[snapshot_pos, durable_tail)` that replays through the same
  dispatch scan, making a kill -9 or preemption restart bit-identical.

Durability discipline: `save_snapshot` fsyncs the tmp file before the
atomic `os.replace` and fsyncs the parent directory after it (a crash
can never leave a published-but-empty snapshot), and every payload is
sealed with a blake2b manifest digest that `load_snapshot` verifies —
truncation, bit rot, or missing fields raise the typed
`SnapshotCorruptError` so recovery can fall back to an older snapshot
instead of folding garbage into a fleet.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from node_replication_torch.core.log import (
    LogSpec,
    LogState,
    log_catchup_all,
)
from node_replication_torch.core.replica import replicate_state
from node_replication_torch.interop import log_from_numpy, log_to_numpy
from node_replication_torch.obs.metrics import get_registry
from node_replication_torch.ops.encoding import Dispatch
from node_replication_torch.utils.trace import span
from node_replication_torch.utils.tree import tree_leaves, tree_unflatten

PyTree = Any

_SPEC_FIELDS = ("capacity", "n_replicas", "arg_width", "gc_slack")

# Manifest key holding the payload digest; never part of the digest.
_DIGEST_KEY = "manifest_digest"


class SnapshotCorruptError(RuntimeError):
    """The snapshot failed integrity validation (digest mismatch,
    truncated archive, missing fields). Typed so recovery
    (`durable/recovery.py`) can fall back to an older snapshot instead
    of crashing on a bare numpy/zipfile error."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"corrupt snapshot {path}: {detail}")
        self.path = path
        self.detail = detail


def _payload_digest(payload: dict) -> np.ndarray:
    """blake2b over every payload entry (key + dtype + shape + bytes,
    key-sorted) — order-independent of dict construction, sensitive to
    any bit of any array."""
    import hashlib

    h = hashlib.blake2b(digest_size=32)
    for key in sorted(payload):
        if key == _DIGEST_KEY:
            continue
        arr = np.ascontiguousarray(np.asarray(payload[key]))
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def save_snapshot(path: str, spec: LogSpec, log: LogState,
                  states: PyTree) -> None:
    """Write a durable snapshot: spec + log ring/cursors + replica states.

    States may be any tree of tensors; the tree structure is rebuilt at
    load from the flattened leaf order plus the structure of the
    caller's template, so save/load pairs must use the same Dispatch.
    """
    t0 = time.perf_counter()
    # the host readbacks below wait for the device, so the span covers
    # real device drain + serialization, not the enqueue
    with span("checkpoint-save", path=path, tail=int(log.tail)):
        leaves = tree_leaves(states)
        ring = log_to_numpy(log)
        payload = {
            "spec": np.asarray([getattr(spec, f) for f in _SPEC_FIELDS],
                               np.int64),
            "log_opcodes": ring["opcodes"],
            "log_args": ring["args"],
            "log_head": ring["head"],
            "log_tail": ring["tail"],
            "log_ctail": ring["ctail"],
            "log_ltails": ring["ltails"],
            "n_state_leaves": np.int64(len(leaves)),
        }
        for i, leaf in enumerate(leaves):
            payload[f"state_{i}"] = np.ascontiguousarray(
                leaf.detach().cpu().numpy())
        payload[_DIGEST_KEY] = _payload_digest(payload)
        tmp = f"{path}.{os.getpid()}.tmp"
        # publish durably: fsync the payload BEFORE the atomic rename
        # and the directory entry AFTER it — otherwise a crash between
        # replace and writeback publishes a name pointing at nothing
        # (machine-checked by nrlint `non-durable-publish`)
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(
            os.path.dirname(os.path.abspath(path)), os.O_RDONLY
        )
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    get_registry().histogram("checkpoint.save_s").observe(
        time.perf_counter() - t0
    )


def _open_snapshot(path: str):
    """np.load with zip/format failures mapped to the typed error."""
    import zipfile

    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise SnapshotCorruptError(
            path, f"unreadable archive ({type(e).__name__}: {e})"
        ) from e


def peek_spec(path: str) -> LogSpec:
    """Read only the LogSpec from a snapshot (owns the `_SPEC_FIELDS`
    encoding, so callers never index the raw array). Raises
    `SnapshotCorruptError` on truncation or missing manifest fields."""
    with _open_snapshot(path) as z:
        try:
            if _DIGEST_KEY not in z.files:
                raise SnapshotCorruptError(
                    path, "missing manifest digest"
                )
            spec_row = z["spec"]
            if spec_row.shape != (len(_SPEC_FIELDS),):
                raise SnapshotCorruptError(
                    path, f"spec field has shape {spec_row.shape}"
                )
            return LogSpec(
                **dict(zip(_SPEC_FIELDS, (int(v) for v in spec_row)))
            )
        except KeyError as e:
            raise SnapshotCorruptError(
                path, f"missing field {e.args[0]!r}"
            ) from e


def load_snapshot(path: str, states_template: PyTree, device=None
                  ) -> tuple[LogSpec, LogState, PyTree]:
    """Load a snapshot; `states_template` supplies the tree structure
    (e.g. `replicate_state(d.init_state(device), R)`), and the tensors
    land on `device` (default: the template's first leaf's device).
    The payload's blake2b manifest digest is recomputed and verified —
    mismatch, truncation, or missing fields raise
    `SnapshotCorruptError`."""
    if device is None:
        device = tree_leaves(states_template)[0].device
    t0 = time.perf_counter()
    import zipfile

    with span("checkpoint-load", path=path), _open_snapshot(path) as z:
        try:
            # np.load is lazy: per-entry reads are where a truncated
            # or bit-flipped archive actually surfaces
            payload = {k: z[k] for k in z.files}
        except (KeyError, ValueError, OSError, EOFError,
                zipfile.BadZipFile) as e:
            raise SnapshotCorruptError(
                path, f"truncated payload ({type(e).__name__}: {e})"
            ) from e
        if _DIGEST_KEY not in payload:
            raise SnapshotCorruptError(path, "missing manifest digest")
        want = payload[_DIGEST_KEY]
        got = _payload_digest(payload)
        if not np.array_equal(want, got):
            raise SnapshotCorruptError(
                path, "manifest digest mismatch (payload corrupted)"
            )
        missing = [
            k for k in ("spec", "log_opcodes", "log_args", "log_head",
                        "log_tail", "log_ctail", "log_ltails",
                        "n_state_leaves")
            if k not in payload
        ]
        if missing:
            raise SnapshotCorruptError(
                path, f"missing fields {missing}"
            )
        spec = LogSpec(**dict(zip(_SPEC_FIELDS,
                                  (int(v) for v in payload["spec"]))))
        log = log_from_numpy({
            name: payload[f"log_{name}"]
            for name in ("opcodes", "args", "head", "tail", "ctail",
                         "ltails")
        }, device)
        n = int(payload["n_state_leaves"])
        try:
            leaves = [torch.from_numpy(np.array(payload[f"state_{i}"]))
                      .to(device) for i in range(n)]
        except KeyError as e:
            raise SnapshotCorruptError(
                path, f"missing state leaf {e.args[0]!r}"
            ) from e
    get_registry().histogram("checkpoint.load_s").observe(
        time.perf_counter() - t0
    )
    if len(leaves) != len(tree_leaves(states_template)):
        raise SnapshotCorruptError(
            path, f"{len(leaves)} state leaves, the template has "
            f"{len(tree_leaves(states_template))}"
        )
    return spec, log, tree_unflatten(states_template, leaves)


def recover_states(
    dispatch: Dispatch,
    spec: LogSpec,
    log: LogState,
    base_states: PyTree | None = None,
    base_pos: int | None = None,
    window: int = 256,
) -> tuple[LogState, PyTree]:
    """Rebuild replica states by replaying the log (the recovery model).

    `base_states`/`base_pos` resume from a snapshot taken at logical
    position `base_pos`. By default recovery starts from `init_state()` at
    position 0 — valid while the ring still physically holds every entry
    of `[0, tail)`, i.e. `tail <= capacity` (GC moves `head` logically but
    only a wrap overwrites slots). Past that point a base snapshot is
    required. Returns `(log, states)` with every `ltails[r]` = tail.
    """
    device = log.tail.device
    if base_states is None:
        base_states = replicate_state(
            dispatch.init_state(device), spec.n_replicas
        )
    start = 0 if base_pos is None else int(base_pos)
    if int(log.tail) - start > spec.capacity:
        raise ValueError(
            f"entries [{start}, {int(log.tail) - spec.capacity}) have been "
            f"overwritten by ring wrap; recovery needs a base snapshot at "
            f"position >= {int(log.tail) - spec.capacity}"
        )
    log = log._replace(
        ltails=torch.full((spec.n_replicas,), start, dtype=torch.int64,
                          device=device)
    )
    # Combined catch-up (`log_catchup_all`): recovery replays at
    # combined speed when the model provides it, scan otherwise — the
    # reference recovers through the same hot exec loop it always runs
    # (`nr/src/log.rs:473-524`), and so does this. Pure recovery has no
    # response consumers, so skip the O(R x window) response re-index.
    states = base_states
    t0 = time.perf_counter()
    rounds = 0
    with span("recover", start=start, tail=int(log.tail),
              window=window) as sp:
        while int(log.ltails.min()) < int(log.tail):
            log, states, _ = log_catchup_all(spec, dispatch, log, states,
                                             window, need_resps=False)
            rounds += 1
        sp.add(rounds=rounds)
        sp.fence(log, states)
    reg = get_registry()
    reg.histogram("checkpoint.recover_s").observe(
        time.perf_counter() - t0
    )
    reg.counter("checkpoint.recover_rounds").inc(rounds)
    return log, states
