"""Import alias for the flight recorder (`obs/recorder.py`), keeping the
reference's `from ...utils.trace import get_tracer, span` surface."""

from node_replication_torch.obs.recorder import (  # noqa: F401
    Tracer,
    get_tracer,
    span,
)

__all__ = ["Tracer", "get_tracer", "span"]
