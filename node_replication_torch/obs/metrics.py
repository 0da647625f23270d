"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of `node_replication_tpu/obs/metrics.py` (that
package's import turns on jax, so its jax-free modules cannot be
shared); instrument names are the reference's (`log.engine.*`,
`nr.exec.*`, `kernel.*`).

The metrics half of the observability layer (the trace/metrics split
production runtimes use; the flight recorder in `obs/recorder.py` is the
trace half). The reference's only numeric observability is the harness's
per-second throughput counters (`benches/mkbench.rs:755-761`); this module
generalizes that into named process-wide instruments the runtime hot paths
update:

- `Counter` — monotonically increasing int (`inc`).
- `Gauge` — last-write-wins float (`set`).
- `Histogram` — fixed exponential buckets with Prometheus-style
  interpolated percentiles (`observe`, `percentile`).

Cost contract: every instrument checks ONE flag (`registry.enabled`)
before touching its lock, so a disabled registry costs one attribute load
+ one branch per call site and allocates nothing — cheap enough to leave
instrumentation compiled into `_exec_round`/`combine` unconditionally.
Instrument handles are created once (at wrapper construction or module
import) and cached; `counter()`/`gauge()`/`histogram()` are get-or-create
and thread-safe.

Enable with `NR_TPU_METRICS=1` or `get_registry().enable()`. `snapshot()`
returns a plain-dict view suitable for JSON (`NodeReplicated.snapshot()`
and `MultiLogReplicated.snapshot()` embed it).
"""

from __future__ import annotations

import bisect
import os
import threading

from node_replication_torch.analysis.locks import make_lock

# Default histogram buckets for durations in seconds: 1us .. ~100s,
# roughly x4 per step (14 buckets; small enough to snapshot cheaply).
DURATION_BUCKETS_S = tuple(1e-6 * 4**i for i in range(14))

# Default buckets for counts (batch sizes, rounds): powers of two 1 .. 64Ki.
COUNT_BUCKETS = tuple(float(1 << i) for i in range(17))


class Counter:
    """Monotonic counter. `inc` is one branch when the registry is off."""

    __slots__ = ("name", "_reg", "_lock", "_value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self._lock = make_lock("Counter._lock")
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        # nrcheck: unshared — single int load, GIL-atomic; approximate
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snapshot(self):
        with self._lock:  # scrape path: exact, not approximate
            return self._value


class Gauge:
    """Last-write-wins value. `set` is one branch when the registry is off."""

    __slots__ = ("name", "_reg", "_value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self._value = float(v)  # single store: atomic under the GIL

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0

    def _snapshot(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile estimates.

    `buckets` are ascending upper bounds; observations above the last
    bound land in a +Inf overflow bucket. `percentile(p)` walks the
    cumulative counts and linearly interpolates within the winning bucket
    (the `histogram_quantile` estimator), clamped to the observed
    min/max so small-sample estimates never leave the data's range.
    """

    __slots__ = ("name", "_reg", "_lock", "_bounds", "_counts", "_count",
                 "_sum", "_min", "_max")

    def __init__(self, name: str, reg: "MetricsRegistry",
                 buckets=DURATION_BUCKETS_S):
        self.name = name
        self._reg = reg
        self._lock = make_lock("Histogram._lock")
        self._bounds = tuple(float(b) for b in buckets)
        if list(self._bounds) != sorted(set(self._bounds)):
            raise ValueError(f"{name}: bucket bounds must strictly ascend")
        self._counts = [0] * (len(self._bounds) + 1)  # + overflow
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        # nrcheck: unshared — single int load, GIL-atomic; approximate
        return self._count

    @property
    def sum(self) -> float:
        # nrcheck: unshared — single float load, GIL-atomic; approximate
        return self._sum

    def percentile(self, p: float) -> float:
        """Estimate the p-quantile (p in [0, 1]) from the bucket counts.

        Reads are deliberately lock-free: percentile() is an
        approximate estimator and may tear against a concurrent
        `observe`; the exact path is `_snapshot`, which holds the
        lock around the same arithmetic (`_snapshot_locked`).
        """
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"percentile {p} outside [0, 1]")
        if self._count == 0:  # nrcheck: unshared — approximate read
            return 0.0
        rank = p * self._count  # nrcheck: unshared — approximate read
        cum = 0
        # nrcheck: unshared — approximate read
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = (self._bounds[i] if i < len(self._bounds)
                      else self._max)  # nrcheck: unshared — approx read
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                # nrcheck: unshared — approximate read
                return max(self._min, min(self._max, est))
            cum += c
        return self._max  # nrcheck: unshared — approximate read

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")

    def _snapshot(self):
        # scrape path: hold the lock so count/sum/percentiles agree
        # with each other (the lock-free properties may tear; an
        # exported snapshot must not)
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            return self._snapshot_locked()

    # the lock is held (`_snapshot`); percentile() reads are exact here
    # guarded-by: _lock
    def _snapshot_locked(self):
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Named instruments behind one process-wide enable flag."""

    def __init__(self, enabled: bool = False):
        # nrcheck: lock-order MetricsRegistry._lock -> Counter._lock — reset() zeroes instruments under the registry lock
        # nrcheck: lock-order MetricsRegistry._lock -> Histogram._lock — reset() zeroes instruments under the registry lock
        self._lock = make_lock("MetricsRegistry._lock")
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self.enabled = bool(enabled)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _get_or_create(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, self), Counter
        )

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, self), Gauge)

    def histogram(self, name: str,
                  buckets=DURATION_BUCKETS_S) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, self, buckets), Histogram
        )

    def remove(self, name: str, instrument=None) -> bool:
        """Unregister an instrument so it stops appearing in
        `snapshot()` (and therefore in exporter scrapes). The retire
        path for per-entity instruments whose entity is gone — e.g. a
        serve replica's `serve.queue_depth.r<rid>` gauge after
        failover retires the replica (`ServeFrontend._fail_replica`);
        without removal every replica ever served haunts the registry
        forever. A still-cached handle keeps working but writes to a
        detached instrument; re-creating the name (`gauge(...)` etc.)
        registers a fresh one.

        Pass `instrument` to make the removal OWNED: the name is only
        dropped when the registered instrument IS that handle. Names
        are get-or-create and process-global, so two owners (two
        frontends serving the same rid in one process) can hold the
        same gauge — an unconditional remove by the first to retire
        would silently detach the survivor's live instrument.
        Returns True when something was removed."""
        with self._lock:
            cur = self._metrics.get(name)
            if cur is None:
                return False
            if instrument is not None and cur is not instrument:
                return False
            del self._metrics[name]
            return True

    def names(self) -> list[str]:
        """Registered instrument names (sorted; includes untouched
        instruments `snapshot()` would skip)."""
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every instrument (names and handles stay registered, so
        cached call-site handles remain valid)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()

    def snapshot(self) -> dict:
        """Plain-dict view of every non-empty instrument (JSON-safe)."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in sorted(items):
            v = m._snapshot()
            if v == 0 or v == 0.0 or (isinstance(v, dict)
                                      and not v.get("count")):
                continue  # keep snapshots readable: skip untouched
            out[name] = v
        return out


_registry = MetricsRegistry(
    enabled=os.environ.get("NR_TPU_METRICS", "") == "1"
)


def get_registry() -> MetricsRegistry:
    return _registry
