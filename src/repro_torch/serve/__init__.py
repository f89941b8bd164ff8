"""Concurrent query serving with cross-query caching (DESIGN.md §12),
fault tolerance — deadlines, cooperative cancellation, degradation
ladder (DESIGN.md §13) — and overload control + warm-restart cache
snapshots (DESIGN.md §16)."""
from repro_torch.core.errors import (
    BackendError, DeadlineExceeded, QueryCancelled, QueryContext,
    ResourceExhausted,
)
from repro_torch.serve.server import (
    QueryServer, ServeConfig, ServerMetrics, ServerSaturated, Session,
)
from repro_torch.serve.snapshot import (
    load_snapshot, restore_if_present, write_snapshot,
)

__all__ = ["QueryServer", "ServeConfig", "ServerMetrics",
           "ServerSaturated", "Session", "QueryContext",
           "BackendError", "DeadlineExceeded", "QueryCancelled",
           "ResourceExhausted", "write_snapshot", "load_snapshot",
           "restore_if_present"]
