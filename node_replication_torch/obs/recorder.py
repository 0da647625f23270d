"""Flight recorder: structured JSONL events + fence-accurate timing spans.

The port's copy of `node_replication_tpu/obs/recorder.py`. A
process-wide `Tracer` appends JSONL events (`{"ts", "mono", "event",
...fields}`) to a file, collects them in an unbounded buffer, or keeps
the last N in a ring (flight-recorder mode).

Spans: `span("name", **fields)` times a section and emits `duration_s`
on exit. CUDA launches return before the device finishes, so a span
around device work measures the enqueue unless it fences: opt into
fence-accurate spans with `NR_TPU_TRACE_FENCE=1` (or
`get_tracer().fence_spans = True`) and tell the span what to fence:

    with span("exec-round") as sp:
        log, states = run_device_work(...)
        sp.fence(log, states)          # fenced at exit when opted in

At exit the span runs `utils/fence.py:fence()` over the registered
trees before taking the end timestamp; the event carries `fenced: true`.

Disabled by default: `emit` is one branch, and `span` yields a shared
no-op singleton without reading the clock. Enable with
`NR_TPU_TRACE=<path>` (file), `NR_TPU_TRACE=mem` (in-memory; bound it
with `NR_TPU_TRACE_RING=<n>`), or `get_tracer().enable(...)`.

Per-record sampling: `NR_TPU_TRACE_SAMPLE=1/N` (or `N`) keeps the
replication plane's per-record hop events only for positions with
`pos % N == 0` (`pos_sampled`), the same records in every process.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any

from node_replication_torch.analysis.locks import make_lock


class _Span:
    """Mutable per-span holder the `span` context manager yields: attach
    late fields with `add(...)`, register device trees to fence with
    `fence(...)`."""

    __slots__ = ("fields", "fence_args")

    def __init__(self):
        self.fields: dict[str, Any] = {}
        self.fence_args: tuple | None = None

    def add(self, **fields: Any) -> None:
        self.fields.update(fields)

    def fence(self, *trees: Any) -> None:
        self.fence_args = trees


class _NullSpan:
    """Shared do-nothing span for the disabled path (no allocation)."""

    __slots__ = ()

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
        # nrlint: disable=lock-discipline
        if not self.enabled:
            return
        rec = {
            "ts": time.time(),  # nrlint: disable=wall-clock-time — correlation field; `mono` below is the ordering clock
            "mono": time.monotonic(),
            "event": event,
            **fields,
        }
        with self._lock:
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._emitted += 1
            elif self._buffer is not None:
                self._buffer.append(rec)
                self._emitted += 1

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


@contextlib.contextmanager
def span(event: str, **fields: Any):
    """Time a section; emits `<event>` with `duration_s` on exit (see
    module docstring). Disabled tracer: yields a shared no-op span."""
    t = _tracer
    if not t.enabled:
        yield _NULL_SPAN
        return
    sp = _Span()
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        fenced = False
        if t.fence_spans and sp.fence_args is not None:
            from node_replication_torch.utils.fence import fence

            fence(*sp.fence_args)
            fenced = True
        dur = time.perf_counter() - t0
        t.emit(event, duration_s=dur, fenced=fenced, **fields,
               **sp.fields)
