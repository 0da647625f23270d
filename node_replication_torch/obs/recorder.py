"""Flight recorder: structured JSONL events + fence-accurate timing spans.

The port's copy of `node_replication_tpu/obs/recorder.py`. A
process-wide `Tracer` appends JSONL events (`{"ts", "mono", "event",
...fields}`) to a file, collects them in an unbounded buffer, or keeps
the last N in a ring (flight-recorder mode).

Spans: `with span("name", **fields) as sp:` times a section and emits
`<name>` on exit with the fields given, those added by `sp.add(...)`,
and:

- `t0_ns`, `t1_ns`: `time.perf_counter_ns()` at entry and exit (the
  monotonic clock a device trace can be mapped onto), and
  `duration_s`, their difference in seconds;
- `id`: unique in the process; `parent`: the `id` of the span open
  around it on the same thread (a thread-local stack), or None;
- `fenced`: whether the span fenced its device work (below).

A span opened with a `round=` field (`round=None` until the position
is known, then `sp.add(round=pos)`) holds its descendants' events and
emits them at its own exit, each stamped with its `round`, then its
own event: the spans of one combiner round share an identifier
(`core/replica.py:execute_mut_batch`'s `mut-batch`, `round` = the
round's first log position; `core/cnr.py`'s, the entries appended to
all logs before the batch). While a torch profiler records in the
process, such a span also enters a profiler record of its name, so the
profiler's trace places each round on the trace's own clock (and its
descendants, by their offsets from it).

CUDA launches return before the device finishes, so a span around
device work measures the enqueue unless it fences: opt into
fence-accurate spans with `NR_TPU_TRACE_FENCE=1` (or
`get_tracer().fence_spans = True`) and tell the span what to fence:

    with span("exec-round") as sp:
        log, states = run_device_work(...)
        sp.fence(log, states)          # fenced at exit when opted in

At exit the span runs `utils/fence.py:fence()` over the registered
trees before taking the end timestamp; the event carries `fenced: true`.

Disabled by default: `emit` is one branch, and `span` is one flag
check that returns a shared no-op span, reading no clock, building no
record and making no generator. Enable with `NR_TPU_TRACE=<path>`
(file), `NR_TPU_TRACE=mem` (in-memory; bound it with
`NR_TPU_TRACE_RING=<n>`), or `get_tracer().enable(...)`.

Per-record sampling: `NR_TPU_TRACE_SAMPLE=1/N` (or `N`) keeps the
replication plane's per-record hop events only for positions with
`pos % N == 0` (`pos_sampled`), the same records in every process.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
from typing import Any

from node_replication_torch.analysis.locks import make_lock


class _NullSpan:
    """Shared do-nothing span for the disabled path (no allocation)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **fields: Any) -> None:
        pass

    def fence(self, *trees: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self):
        self._lock = make_lock("Tracer._lock")
        self._fh = None
        self._buffer: "collections.deque[dict] | list[dict] | None" = None
        #: total events ever emitted to the current sink: with
        #: `len(buffer)` it locates the ring's window in the global
        #: event sequence (`events_since`, the exporter's cursor)
        self._emitted = 0
        self.enabled = False
        self.fence_spans = (
            os.environ.get("NR_TPU_TRACE_FENCE", "") == "1"
        )

    def enable(self, path: str | None = None,
               ring: int | None = None) -> None:
        """Write events to `path`; with `path=None` buffer in memory —
        unbounded by default, or the last `ring` events when given."""
        with self._lock:
            if self._fh:
                self._fh.close()
            self._emitted = 0
            if path:
                self._fh = open(path, "a", buffering=1)
                self._buffer = None
            else:
                self._fh = None
                self._buffer = (
                    collections.deque(maxlen=int(ring))
                    if ring else []
                )
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.close()
            self._fh = None
            self._buffer = None
            self.enabled = False

    def emit(self, event: str, **fields: Any) -> None:
        # racy-but-benign fast path: one word read; worst case one
        # event races an enable/disable
        if not self.enabled:
            return
        rec = {
            "ts": time.time(),  # nrlint: disable=wall-clock-time — correlation field; `mono` below is the ordering clock
            "mono": time.monotonic(),
            "event": event,
            **fields,
        }
        self._write((rec,))

    def _write(self, recs) -> None:
        """Append finished records to the sink, in order."""
        with self._lock:
            if self._fh is not None:
                for rec in recs:
                    self._fh.write(json.dumps(rec) + "\n")
                self._emitted += len(recs)
            elif self._buffer is not None:
                self._buffer.extend(recs)
                self._emitted += len(recs)

    @property
    def buffered(self) -> bool:
        """True in memory/ring mode, the modes `events()`/
        `events_since()` (and so exporter scrapes) serve from. A
        file-mode tracer exports nothing: the file is the export."""
        with self._lock:
            return self._buffer is not None

    def events(self) -> list[dict]:
        """Buffered events (memory/ring mode only), oldest first."""
        with self._lock:
            return list(self._buffer or [])

    def events_since(self, seq: int) -> tuple[int, list[dict]]:
        """Incremental read of the memory/ring buffer: the events after
        cursor `seq` (0 for "from the start"; a previous call's
        returned cursor otherwise). Returns `(new_cursor, events)`.
        Events the ring evicted before they were read are gone
        (flight-recorder semantics). File-mode tracers return
        `(cursor, [])`: the file is the export."""
        with self._lock:
            buf = list(self._buffer or [])
            total = self._emitted
        missed = total - int(seq)
        if missed <= 0:
            return total, []
        return total, buf[max(0, len(buf) - missed):]


_tracer = Tracer()
_env = os.environ.get("NR_TPU_TRACE")
if _env:
    _ring = os.environ.get("NR_TPU_TRACE_RING")
    if _env in ("mem", ":mem:"):
        _tracer.enable(None, ring=int(_ring) if _ring else None)
    else:
        _tracer.enable(_env)


def get_tracer() -> Tracer:
    return _tracer


def _parse_sample(spec: str | None) -> int:
    """`"1/N"` or `"N"` -> N (keep one record in N); anything
    unparsable or < 1 means no sampling (keep all)."""
    if not spec:
        return 1
    s = spec.strip()
    if "/" in s:
        s = s.split("/", 1)[1]
    try:
        n = int(s)
    except ValueError:
        return 1
    return n if n >= 1 else 1


_sample_n = _parse_sample(os.environ.get("NR_TPU_TRACE_SAMPLE"))


def trace_sample_n() -> int:
    """The configured per-record sampling modulus N (1 = keep all)."""
    return _sample_n


def set_trace_sample(n: int) -> None:
    """Override the sampling modulus at runtime (tests, notebooks)."""
    global _sample_n
    _sample_n = max(1, int(n))


def pos_sampled(pos: int) -> bool:
    """Should per-record trace events narrate the record at `pos`?

    Deterministic in the position alone (`pos % N == 0`), so every
    process in a fleet keeps the SAME records and a sampled record's
    cross-process hop chain (ship, relay, wire, apply: `repl/`) is
    complete, never partial. Callers still guard on `tracer.enabled`
    first; this only thins the per-record firehose."""
    return _sample_n <= 1 or int(pos) % _sample_n == 0


_ids = itertools.count(1)
_local = threading.local()
_new_span = object.__new__


def _profiler_record(event: str):
    """A torch profiler record named `event`, entered, while a profiler
    records in this process; else None. `_RecordFunctionFast` (a record
    made in C++) where torch has it, `record_function` otherwise."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    rec = (fast(event) if fast is not None
           else torch.profiler.record_function(event))
    rec.__enter__()
    return rec


class _Span:
    """A live span (tracer enabled): the context manager `span` builds
    and returns. Attach late fields with `add(...)`, register device
    trees to fence with `fence(...)`."""

    __slots__ = ("event", "fields", "fence_args", "id", "parent",
                 "sink", "held", "record", "t0_ns")

    def add(self, **fields: Any) -> None:
        self.fields.update(fields)

    def fence(self, *trees: Any) -> None:
        self.fence_args = trees

    def __enter__(self) -> "_Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        if stack:
            parent = stack[-1]
            self.parent = parent.id
            #: the innermost enclosing span that holds events
            self.sink = parent if parent.held is not None else parent.sink
        else:
            self.parent = self.sink = None
        self.id = next(_ids)
        stack.append(self)
        self.record = (None if self.held is None
                       else _profiler_record(self.event))
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t = _tracer
        fenced = False
        if t.fence_spans and self.fence_args is not None:
            from node_replication_torch.utils.fence import fence

            fence(*self.fence_args)
            fenced = True
        t1 = time.perf_counter_ns()
        if self.record is not None:
            self.record.__exit__(None, None, None)
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        rec = {
            "ts": time.time(),  # nrlint: disable=wall-clock-time — correlation field; `mono` below is the ordering clock
            "mono": time.monotonic(), "event": self.event,
            "duration_s": (t1 - self.t0_ns) * 1e-9, "fenced": fenced,
            "t0_ns": self.t0_ns, "t1_ns": t1, "id": self.id,
            "parent": self.parent, **self.fields,
        }
        held = self.held
        if held is not None:
            rnd = rec["round"]
            for r in held:
                if r.get("round") is None:
                    r["round"] = rnd
            held.append(rec)
            self.held = None
        sink = self.sink
        if sink is not None and sink.held is not None:
            if held is None:
                sink.held.append(rec)
            else:
                sink.held.extend(held)
        else:
            t._write((rec,) if held is None else held)
        return None


def span(event: str, **fields: Any):
    """Time a section: a context manager that emits `<event>` on exit
    (see module docstring). Disabled tracer: the shared no-op span."""
    if not _tracer.enabled:
        return _NULL_SPAN
    # set here, not in an `__init__`: a combiner round opens eight spans
    sp = _new_span(_Span)
    sp.event = event
    sp.fields = fields
    sp.fence_args = None
    #: descendants' events, held until the span knows its round
    sp.held = [] if "round" in fields else None
    return sp
