"""Partitioners — where the mesh plans cut their axes, in PyTorch.

Counterpart of ``repro/core/balance.py``.  A plan asks its
:class:`Partitioner` for contiguous split boundaries along the query axis (in
whole-chunk units, so shard boundaries coincide with chunk boundaries) and
the object axis (in Morton-sorted row units).  ``equal`` splits by count;
``cost_balanced`` balances each shard's estimated cost (a prefix sum and a
``searchsorted``, clamped to a per-shard capacity).

Boundaries only move shard ownership, never results.  They come from f32
sums (``cumsum`` here, the chunk cost sums in ``core/plan.py``), whose order
differs between XLA and PyTorch: they equal the reference's bit for bit
while every sum is exact (integer-valued and below 2**24).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

__all__ = [
    "Partitioner",
    "EqualPartitioner",
    "CostBalancedPartitioner",
    "balanced_boundaries",
    "equal_boundaries",
    "register_partitioner",
    "resolve_partitioner",
    "partitioner_names",
    "straggler_gap",
    "tenant_fair_weights",
]


def equal_boundaries(n_units: int, num_shards: int, device=None) -> torch.Tensor:
    """(R+1,) i32 equal-count boundaries: ``b[r] = min(r * ceil(n / R), n)``."""
    cap = -(-max(1, n_units) // num_shards)
    return torch.tensor([min(r * cap, n_units) for r in range(num_shards + 1)],
                        dtype=torch.int32, device=device)


def balanced_boundaries(costs: torch.Tensor, num_shards: int,
                        capacity: int) -> torch.Tensor:
    """Contiguous (R+1,) i32 boundaries with about equal cost per shard.

    The ideal boundary of shard prefix ``r`` is where the f32 cost prefix sum
    crosses ``r / R`` of the total (``searchsorted``, right side, so uniform
    costs give the equal split); it is then clamped so boundaries stay
    monotone, no shard exceeds ``capacity`` units and every unit is covered.
    The clamp recursion is unrolled over R, as in the reference.
    """
    n = costs.shape[0]
    if num_shards * capacity < n:
        raise ValueError(
            f"infeasible partition: {num_shards} shards x capacity "
            f"{capacity} < {n} units"
        )
    dev = costs.device
    cum = torch.cumsum(costs.to(torch.float32), 0)
    total = cum[-1]
    # divide by an f32 tensor: the card turns division by a Python float
    # into a reciprocal multiply, which rounds differently
    frac = (torch.arange(1, num_shards, dtype=torch.float32, device=dev)
            / torch.tensor(num_shards, dtype=torch.float32, device=dev))
    want = torch.searchsorted(cum, total * frac, right=True).to(torch.int32)
    bs = [torch.zeros((), dtype=torch.int32, device=dev)]
    for r in range(1, num_shards):
        lo = torch.clamp(bs[-1], min=n - (num_shards - r) * capacity)
        hi = torch.clamp(bs[-1] + capacity, max=r * capacity)
        bs.append(torch.minimum(torch.maximum(want[r - 1], lo), hi))
    bs.append(torch.tensor(n, dtype=torch.int32, device=dev))
    return torch.stack(bs)


def straggler_gap(shard_work) -> float:
    """max/mean per-shard work: 1.0 is balanced, R means one shard does all."""
    w = np.asarray(shard_work, np.float64)
    mean = w.mean()
    return float(w.max() / mean) if mean > 0 else 1.0


def tenant_fair_weights(tenant_ids) -> np.ndarray:
    """(R,) f32 per-row weights ``1 / count(tenant)`` from per-row tenant ids.

    Every tenant's total influence on the cost-balanced boundary seed is
    then the same, however many rows it registered (host-side numpy).
    """
    tid = np.asarray(tenant_ids, np.int64).reshape(-1)
    if tid.size == 0:
        return np.zeros((0,), np.float32)
    _, inv, counts = np.unique(tid, return_inverse=True, return_counts=True)
    return (1.0 / counts[inv]).astype(np.float32)


class Partitioner:
    """Interface: contiguous split boundaries for one axis of a plan."""

    name: ClassVar[str]

    def query_capacity(self, n_chunks: int, num_shards: int) -> int:
        """Most chunks one query shard may own."""
        raise NotImplementedError

    def object_capacity(self, n_rows: int, num_shards: int) -> int:
        """Most Morton-sorted object rows one object shard may own."""
        raise NotImplementedError

    def query_boundaries(self, chunk_costs, num_shards: int) -> torch.Tensor:
        """(R+1,) i32 chunk-unit boundaries from per-chunk cost estimates."""
        raise NotImplementedError

    def object_boundaries(self, row_costs, num_shards: int) -> torch.Tensor:
        """(R+1,) i32 row-unit boundaries from per-object cost estimates."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EqualPartitioner(Partitioner):
    """Equal-count contiguous splits."""

    name: ClassVar[str] = "equal"

    def query_capacity(self, n_chunks: int, num_shards: int) -> int:
        return -(-n_chunks // num_shards)

    def object_capacity(self, n_rows: int, num_shards: int) -> int:
        return -(-max(1, n_rows) // num_shards)

    def query_boundaries(self, chunk_costs, num_shards: int) -> torch.Tensor:
        return equal_boundaries(chunk_costs.shape[0], num_shards,
                                chunk_costs.device)

    def object_boundaries(self, row_costs, num_shards: int) -> torch.Tensor:
        return equal_boundaries(row_costs.shape[0], num_shards,
                                row_costs.device)


@dataclasses.dataclass(frozen=True)
class CostBalancedPartitioner(Partitioner):
    """Boundaries balance estimated cost; a query shard holds at most
    ``slack`` times its equal share.  ``ema_alpha`` weighs each tick's
    measured per-query candidate volume in the plans' cost EMA."""

    slack: float = 2.0
    ema_alpha: float = 0.25
    name: ClassVar[str] = "cost_balanced"

    def __post_init__(self):
        if self.slack < 1.0:
            raise ValueError(f"slack must be >= 1.0, got {self.slack}")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(
                f"ema_alpha must be in (0, 1], got {self.ema_alpha}"
            )

    def query_capacity(self, n_chunks: int, num_shards: int) -> int:
        equal = -(-max(1, n_chunks) // num_shards)
        return min(max(1, n_chunks), math.ceil(equal * self.slack))

    def object_capacity(self, n_rows: int, num_shards: int) -> int:
        # the object axis is count-balanced (plan._object_row_costs), so a
        # slice never exceeds its equal share: no slack
        return -(-max(1, n_rows) // num_shards)

    def query_boundaries(self, chunk_costs, num_shards: int) -> torch.Tensor:
        return balanced_boundaries(
            chunk_costs, num_shards,
            self.query_capacity(chunk_costs.shape[0], num_shards),
        )

    def object_boundaries(self, row_costs, num_shards: int) -> torch.Tensor:
        return balanced_boundaries(
            row_costs, num_shards,
            self.object_capacity(row_costs.shape[0], num_shards),
        )


_PARTITIONERS: dict = {}


def register_partitioner(name: str):
    """Decorator: register a Partitioner factory under ``name``."""

    def deco(factory):
        _PARTITIONERS[name] = factory
        return factory

    return deco


def partitioner_names() -> tuple[str, ...]:
    """Names accepted by ``resolve_partitioner`` / ``ServiceSpec.partitioner``."""
    return tuple(sorted(_PARTITIONERS))


register_partitioner("equal")(EqualPartitioner)
register_partitioner("cost_balanced")(CostBalancedPartitioner)


def resolve_partitioner(partitioner) -> Partitioner:
    """Name | Partitioner | None -> Partitioner (default: equal)."""
    if partitioner is None:
        return EqualPartitioner()
    if isinstance(partitioner, Partitioner):
        return partitioner
    try:
        factory = _PARTITIONERS[str(partitioner)]
    except KeyError:
        raise ValueError(
            f"unknown partitioner {partitioner!r}; registered: "
            f"{partitioner_names()}"
        ) from None
    return factory()
