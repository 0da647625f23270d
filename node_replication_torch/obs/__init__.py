"""Observability layer: metrics, tracing, and the fleet plane.

The port's copy of `node_replication_tpu/obs/`, with the reference's
`__all__`.

Single-process half:

- `obs.metrics` — process-wide counters/gauges/histograms
  (`get_registry()`; enable with NR_TPU_METRICS=1).
- `obs.recorder` — the `Tracer` flight recorder and `span` timing
  context: each span event carries `t0_ns`/`t1_ns` (perf_counter_ns),
  `duration_s`, its `id` and its `parent`'s, and inside a combiner
  round's `mut-batch` span the round's `round` (enable with
  NR_TPU_TRACE=<path|mem>; fence-accurate spans with
  NR_TPU_TRACE_FENCE=1; per-record sampling with
  NR_TPU_TRACE_SAMPLE=1/N). `utils/trace.py` re-exports these.
- `obs.profile` — the host sampling profiler (`SamplingProfiler`,
  `host_budget`; `ServeConfig(profile_hz=...)`).
- `obs.report` — trace-report CLI:
  `python -m node_replication_torch.obs.report trace.jsonl [--json]`.

Fleet half (multi-process trees, `serve/` + `repl/`):

- `obs.export` — `MetricsExporter`: serve one process's registry
  snapshot + trace tail on a side port (CRC-framed JSON; Prometheus
  text via `python -m node_replication_torch.obs.export --scrape h:p`).
- `obs.collect` — `FleetCollector`: scrape N exporters into
  time-series rings + a merged `fleet.jsonl` whose events carry
  `node_id`/`role`/`t_fleet`; `obs.report`'s Fleet section joins it
  on `(pos, node_id)` into per-record cross-process hop timelines.
- `obs.top` — live fleet dashboard:
  `python -m node_replication_torch.obs.top --targets h:p1,h:p2`.
"""

from node_replication_torch.obs.metrics import (
    COUNT_BUCKETS,
    DURATION_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from node_replication_torch.obs.recorder import (
    Tracer,
    get_tracer,
    pos_sampled,
    set_trace_sample,
    span,
    trace_sample_n,
)

__all__ = [
    "COUNT_BUCKETS",
    "DURATION_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "get_registry",
    "get_tracer",
    "pos_sampled",
    "set_trace_sample",
    "span",
    "trace_sample_n",
]
