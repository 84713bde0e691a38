"""ServiceSpec — the declarative description of one k-NN serving session.

Same fields and defaults as the reference's ``repro/api/spec.py``, and the
same eager validation.  Every plan, partitioner and merge backend runs; the
mesh plans lay ``mesh_shape`` logical shards onto the session's one device,
or, under a ``torch.distributed`` process group, one shard onto each rank
(``mesh_shape`` None: the world size).
Both maintenance modes and the three collect modes run (``"full"`` copies
the lists to the host, ``"stats"`` only the sink's aggregates, ``"none"``
nothing).  Both precisions run: ``"mixed"`` adds the bf16 prefilter to
every SCAN backend and gives fp32's lists bit for bit.
"""
from __future__ import annotations

import dataclasses

from ..core.ticks import EngineConfig, validate_engine_params

__all__ = ["ServiceSpec", "COLLECT_MODES"]

SIDE_DEFAULT = 22_500.0  # paper Table 1: squared region of side 22500 u

COLLECT_MODES = ("full", "stats", "none")


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """Everything a :class:`repro_torch.api.KnnSession` needs, declared up front."""

    k: int = 32
    th_quad: int = 192
    l_max: int = 8
    window: int = 256
    chunk: int = 8192
    rebuild_factor: float = 2.0
    region_pad: float = 1e-3
    backend: str = "dense_topk"
    plan: str = "single"
    mesh_shape: int | tuple[int, int] | None = None
    partitioner: str = "equal"
    precision: str = "fp32"
    merge: str = "dense_merge"
    maintenance: str = "rebuild"
    churn_budget: float = 0.25
    max_iters: int = 100_000
    origin: tuple[float, float] = (0.0, 0.0)
    side: float = SIDE_DEFAULT
    delta_pad: int = 1024
    collect: str = "full"

    def __post_init__(self):
        validate_engine_params(
            k=self.k, window=self.window, chunk=self.chunk,
            backend=self.backend, plan=self.plan, mesh_shape=self.mesh_shape,
            partitioner=self.partitioner, precision=self.precision,
            merge=self.merge, maintenance=self.maintenance,
            churn_budget=self.churn_budget,
        )
        if self.collect not in COLLECT_MODES:
            raise ValueError(
                f"unknown collect mode {self.collect!r}; one of {COLLECT_MODES}"
            )
        if self.side <= 0:
            raise ValueError(f"side must be > 0, got {self.side}")
        if len(self.origin) != 2:
            raise ValueError(f"origin must be an (x, y) pair, got {self.origin!r}")
        if self.delta_pad < 1:
            raise ValueError(f"delta_pad must be >= 1, got {self.delta_pad}")

    def engine_config(self) -> EngineConfig:
        """The EngineConfig subset of this spec (for core-layer consumers)."""
        return EngineConfig(
            k=self.k, th_quad=self.th_quad, l_max=self.l_max,
            window=self.window, chunk=self.chunk,
            rebuild_factor=self.rebuild_factor, region_pad=self.region_pad,
            backend=self.backend, plan=self.plan, mesh_shape=self.mesh_shape,
            partitioner=self.partitioner, precision=self.precision,
            merge=self.merge, maintenance=self.maintenance,
            churn_budget=self.churn_budget, max_iters=self.max_iters,
        )

    @classmethod
    def from_engine(
        cls,
        cfg: EngineConfig,
        *,
        origin: tuple[float, float] = (0.0, 0.0),
        side: float = SIDE_DEFAULT,
        delta_pad: int = 1024,
    ) -> "ServiceSpec":
        """Lift an EngineConfig (and the region's geometry) into a spec."""
        return cls(
            k=cfg.k, th_quad=cfg.th_quad, l_max=cfg.l_max, window=cfg.window,
            chunk=cfg.chunk, rebuild_factor=cfg.rebuild_factor,
            region_pad=cfg.region_pad, backend=cfg.backend, plan=cfg.plan,
            mesh_shape=cfg.mesh_shape, partitioner=cfg.partitioner,
            precision=cfg.precision, merge=cfg.merge,
            maintenance=cfg.maintenance, churn_budget=cfg.churn_budget,
            max_iters=cfg.max_iters,
            origin=(float(origin[0]), float(origin[1])), side=float(side),
            delta_pad=delta_pad,
        )
