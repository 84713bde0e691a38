"""Session API: ServiceSpec -> KnnSession -> submit()/result()."""
from .handles import QueryHandle, TickHandle
from .session import KnnSession
from .spec import ServiceSpec

__all__ = ["KnnSession", "QueryHandle", "ServiceSpec", "TickHandle"]
