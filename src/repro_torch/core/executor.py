"""QueryExecutor — the named SCAN-merge strategy the sweep dispatches to.

Counterpart of ``repro/core/executor.py``: the pipeline never selects
neighbours itself; every SCAN iteration hands its gathered window to the
executor, which calls the registered backend by name.
"""
from __future__ import annotations

import dataclasses

from ..kernels.fused_scan import PRECISIONS
from ..kernels.ops import get_scan_backend, scan_backend_names

__all__ = [
    "PRECISIONS",
    "QueryExecutor",
    "resolve_executor",
    "available_backends",
    "available_plans",
    "available_partitioners",
    "available_precisions",
    "resolve_plan",
]


def available_backends() -> tuple[str, ...]:
    return scan_backend_names()


def available_plans() -> tuple[str, ...]:
    from .plan import plan_names  # lazy: plan.py imports pipeline -> executor

    return plan_names()


def available_partitioners() -> tuple[str, ...]:
    from .balance import partitioner_names

    return partitioner_names()


def available_precisions() -> tuple[str, ...]:
    return PRECISIONS


def __getattr__(name):
    # ``resolve_plan`` is an alias of ``plan.resolve_plan``, resolved lazily
    # (plan.py imports this module) and returned as the same function object
    if name == "resolve_plan":
        from .plan import resolve_plan

        return resolve_plan
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class QueryExecutor:
    """A named SCAN-merge strategy plus the sweep's numeric mode."""

    backend: str = "dense_topk"
    precision: str = "fp32"

    def __post_init__(self):
        get_scan_backend(self.backend)  # fail fast on unknown names
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; one of {PRECISIONS}"
            )

    def scan_merge(self, qpos, cpos, cids, valid, best_d, best_i, *, k: int):
        """qpos (Q,2); cpos (Q,W,2); cids/valid (Q,W); best_d/best_i (Q,k)."""
        return get_scan_backend(self.backend)(
            qpos, cpos, cids, valid, best_d, best_i, k,
            precision=self.precision,
        )


def resolve_executor(backend, precision=None) -> QueryExecutor:
    """Name | QueryExecutor | None [+ precision] -> QueryExecutor."""
    if isinstance(backend, QueryExecutor):
        if precision is not None and precision != backend.precision:
            return dataclasses.replace(backend, precision=str(precision))
        return backend
    kw = {}
    if backend is not None:
        kw["backend"] = str(backend)
    if precision is not None:
        kw["precision"] = str(precision)
    return QueryExecutor(**kw)
