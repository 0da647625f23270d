"""serve/: concurrent batching frontend over the replicated log.

The port of `node_replication_tpu/serve/`: many OS-thread clients submit ops through
bounded per-replica admission queues; one elected worker per replica
drains its queue into an adaptive batch and executes it as a single
flat-combining round (`execute_mut_batch` on the wrapper, under the
reentrant combiner lock). Production edges — admission control with
typed `Overloaded` shedding, per-request deadlines, client
retry-with-backoff, graceful drain — live here; the replication core
stays untouched underneath.

    from node_replication_torch.serve import ServeFrontend, ServeConfig

    with ServeFrontend(nr, ServeConfig(queue_depth=128)) as fe:
        fut = fe.submit((HM_PUT, k, v), rid=0)
        value = fe.read((HM_GET, k), rid=0)
        ok = fut.result(timeout=1.0)
"""

from node_replication_torch.serve.client import (
    CircuitBreaker,
    RetryPolicy,
    call_with_retry,
)
from node_replication_torch.serve.errors import (
    CircuitOpen,
    DeadlineExceeded,
    FrontendClosed,
    NotPrimary,
    Overloaded,
    ReplicaFailed,
    ServeError,
    StaleRead,
)
from node_replication_torch.serve.frontend import (
    ServeConfig,
    ServeFrontend,
)
from node_replication_torch.serve.future import ServeFuture
from node_replication_torch.serve.overload import (
    BULK,
    CRITICAL,
    NORMAL,
    LagSource,
    OverloadConfig,
    OverloadGovernor,
)

__all__ = [
    "BULK",
    "CRITICAL",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "FrontendClosed",
    "LagSource",
    "NORMAL",
    "NotPrimary",
    "OverloadConfig",
    "OverloadGovernor",
    "Overloaded",
    "ReplicaFailed",
    "RetryPolicy",
    "ServeConfig",
    "ServeError",
    "ServeFrontend",
    "ServeFuture",
    "StaleRead",
    "call_with_retry",
]
