"""Session API: ServiceSpec -> KnnSession -> submit()/result()."""
from .handles import QueryHandle, TickHandle
from .session import KnnSession
from .sink import ResultSink, SinkState, StatsSink, TickAggregates
from .spec import COLLECT_MODES, ServiceSpec

__all__ = [
    "KnnSession",
    "ServiceSpec",
    "COLLECT_MODES",
    "QueryHandle",
    "TickHandle",
    "ResultSink",
    "StatsSink",
    "SinkState",
    "TickAggregates",
]
