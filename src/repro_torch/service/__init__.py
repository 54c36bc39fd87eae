"""Online HVQ serving subsystem (scheduler → engine → delta merge).

Public API:
    HQIService / ServiceConfig / QueryHandle / ServiceHealth — the facade
    QueueFull / ResultPending / DeadlineExceeded / QueryError /
        ServiceReadOnly — the typed error surface (errors.py)
    MicroBatchScheduler — deadline/size-triggered micro-batching
    DeltaStore — live inserts + tombstone deletes + refresh fold
    ServiceTelemetry — p50/p99 latency, queue depth, dispatch accounting
"""
from .delta import DeltaStore, DeltaView  # noqa: F401
from .errors import (  # noqa: F401
    DeadlineExceeded,
    QueryError,
    QueueFull,
    ResultPending,
    ServiceReadOnly,
)
from .scheduler import MicroBatchScheduler, PendingQuery  # noqa: F401
from .service import (  # noqa: F401
    STORE_NOT_PORTED,
    HQIService,
    QueryHandle,
    ServiceConfig,
    ServiceHealth,
)
from .telemetry import FlushRecord, ServiceTelemetry  # noqa: F401
