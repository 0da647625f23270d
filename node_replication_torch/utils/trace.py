"""Import alias for the flight recorder (`obs/recorder.py`), keeping the
reference's `from ...utils.trace import get_tracer, span, pos_sampled`
surface."""

from node_replication_torch.obs.recorder import (  # noqa: F401
    Tracer,
    get_tracer,
    pos_sampled,
    set_trace_sample,
    span,
    trace_sample_n,
)

__all__ = ["Tracer", "get_tracer", "pos_sampled", "set_trace_sample",
           "span", "trace_sample_n"]
