"""Pure-numpy oracle twins of the bundled models (the port's copy of
`node_replication_tpu/sim/oracle.py`).

The differential half of the property harness (`sim/properties.py`):
each oracle reimplements one model's transition semantics on host
numpy arrays, line-for-line against the model (`models/*.py`), so a
simulated run can check BOTH

- every acked response against the oracle's response at the same
  logical position (the sequential-consistency differential — the
  harness serializes submissions, so log order == submission order),
- the final device state bit-for-bit against the oracle's arrays
  (`arrays()` mirrors the model's state leaf names, shapes, and
  dtypes exactly).

Keeping the oracles numpy-only is the point: they share NO code with
the system under test (no torch, no `Dispatch`, no scan/window
engines, no kernels), so an engine bug cannot cancel itself out in the
check.

Op encoding matches the wire form the wrappers take: `(opcode,
*args)` host tuples, write and read opcode namespaces separate (the
model-module constants: HM_PUT/HM_GET, ST_PUSH/ST_PEEK, ...).
"""

from __future__ import annotations

import numpy as np


class Oracle:
    """One model's host-side twin. `apply` mutates and returns the
    response; `read` answers a read opcode; `arrays()` exposes the
    exact state-dict mirror; `copy()` forks (crash branches)."""

    model = "?"

    def apply(self, op: tuple) -> int:
        raise NotImplementedError

    def read(self, op: tuple) -> int:
        raise NotImplementedError

    def arrays(self) -> dict:
        raise NotImplementedError

    def copy(self) -> "Oracle":
        raise NotImplementedError


class HashmapOracle(Oracle):
    """`models/hashmap.py`: dense table, PUT/REMOVE/GET, `k % K`."""

    model = "hashmap"

    def __init__(self, n_keys: int):
        self.n = int(n_keys)
        self.values = np.zeros(self.n, np.int32)
        self.present = np.zeros(self.n, np.bool_)

    def apply(self, op):
        code, k = int(op[0]), int(op[1]) % self.n
        if code == 1:  # HM_PUT
            self.values[k] = np.int32(op[2])
            self.present[k] = True
            return 0
        if code == 2:  # HM_REMOVE
            was = int(self.present[k])
            self.values[k] = 0
            self.present[k] = False
            return was
        raise ValueError(f"unknown hashmap write opcode {code}")

    def read(self, op):
        k = int(op[1]) % self.n  # HM_GET
        return int(self.values[k]) if self.present[k] else -1

    def arrays(self):
        return {"values": self.values, "present": self.present}

    def copy(self):
        o = HashmapOracle(self.n)
        o.values = self.values.copy()
        o.present = self.present.copy()
        return o


class StackOracle(Oracle):
    """`models/stack.py`: fixed-capacity buffer + top cursor. Note the
    model's exact quirks: an overflowing push leaves the buffer
    untouched and responds -1; pop leaves the popped slot's bytes in
    place (only the cursor moves) — `arrays()` must mirror both for
    the bit-identity check to be honest."""

    model = "stack"

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.buf = np.zeros(self.cap, np.int32)
        self.top = 0

    def apply(self, op):
        code = int(op[0])
        if code == 1:  # ST_PUSH
            if self.top < self.cap:
                self.buf[self.top] = np.int32(op[1])
                self.top += 1
                return self.top
            return -1
        if code == 2:  # ST_POP
            if self.top > 0:
                self.top -= 1
                return int(self.buf[self.top])
            return -1
        raise ValueError(f"unknown stack write opcode {code}")

    def read(self, op):
        code = int(op[0])
        if code == 1:  # ST_PEEK
            return int(self.buf[self.top - 1]) if self.top > 0 else -1
        if code == 2:  # ST_LEN
            return self.top
        raise ValueError(f"unknown stack read opcode {code}")

    def arrays(self):
        return {"buf": self.buf,
                "top": np.asarray(self.top, np.int32)}

    def copy(self):
        o = StackOracle(self.cap)
        o.buf = self.buf.copy()
        o.top = self.top
        return o


class QueueOracle(Oracle):
    """`models/queue.py`: bounded FIFO ring with monotone head/tail
    cursors (modulo indexing; dequeued slots keep their bytes)."""

    model = "queue"

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.buf = np.zeros(self.cap, np.int32)
        self.head = 0
        self.tail = 0

    def apply(self, op):
        code = int(op[0])
        if code == 1:  # Q_ENQ
            n = self.tail - self.head
            if n < self.cap:
                self.buf[self.tail % self.cap] = np.int32(op[1])
                self.tail += 1
                return n + 1
            return -1
        if code == 2:  # Q_DEQ
            if self.tail > self.head:
                val = int(self.buf[self.head % self.cap])
                self.head += 1
                return val
            return -1
        raise ValueError(f"unknown queue write opcode {code}")

    def read(self, op):
        code = int(op[0])
        if code == 1:  # Q_FRONT
            if self.tail > self.head:
                return int(self.buf[self.head % self.cap])
            return -1
        if code == 2:  # Q_LEN
            return self.tail - self.head
        raise ValueError(f"unknown queue read opcode {code}")

    def arrays(self):
        return {
            "buf": self.buf,
            "head": np.asarray(self.head, np.int32),
            "tail": np.asarray(self.tail, np.int32),
        }

    def copy(self):
        o = QueueOracle(self.cap)
        o.buf = self.buf.copy()
        o.head = self.head
        o.tail = self.tail
        return o


class SeqRegOracle(Oracle):
    """`models/seqreg.py`: per-slot fetch-and-set (resp = previous
    value), the serve-layer sequence oracle."""

    model = "seqreg"

    def __init__(self, n_slots: int):
        self.n = int(n_slots)
        self.values = np.zeros(self.n, np.int32)

    def apply(self, op):
        s = int(op[1]) % self.n  # SR_SET
        old = int(self.values[s])
        self.values[s] = np.int32(op[2])
        return old

    def read(self, op):
        return int(self.values[int(op[1]) % self.n])  # SR_GET

    def arrays(self):
        return {"values": self.values}

    def copy(self):
        o = SeqRegOracle(self.n)
        o.values = self.values.copy()
        return o


_FACTORIES = {
    "hashmap": HashmapOracle,
    "stack": StackOracle,
    "queue": QueueOracle,
    "seqreg": SeqRegOracle,
}


def make_oracle(model: str, size: int) -> Oracle:
    """Build the oracle twin of `model` at table/capacity `size`."""
    try:
        return _FACTORIES[model](size)
    except KeyError:
        raise ValueError(
            f"no oracle for model {model!r} "
            f"(have: {', '.join(sorted(_FACTORIES))})"
        ) from None
