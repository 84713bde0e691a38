"""Synthetic moving-object workloads (paper Sec. 5, Table 1), numpy only.

The port's own copy of the ``uniform`` and ``gaussian`` families of
``repro/data/generators.py``: the same draws from the same seed give the same
positions.  Defaults match Table 1: squared region of side 22500 u, max speed
200 u/tick, one query per object per tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WorkloadConfig", "MovingObjectWorkload", "make_workload"]

SIDE_DEFAULT = 22_500.0
MAX_SPEED_DEFAULT = 200.0
DISTRIBUTIONS = ("uniform", "gaussian")


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_objects: int = 100_000
    distribution: str = "uniform"  # uniform | gaussian
    side: float = SIDE_DEFAULT
    max_speed: float = MAX_SPEED_DEFAULT
    hotspots: int = 25  # gaussian: more hotspots -> closer to uniform
    hotspot_sigma_frac: float = 1.0 / 64.0  # sigma = side * frac
    seed: int = 0


class MovingObjectWorkload:
    """Stateful generator: ``positions()`` then ``advance()`` once per tick."""

    def __init__(self, cfg: WorkloadConfig):
        if cfg.distribution not in DISTRIBUTIONS:
            raise ValueError(f"unknown distribution {cfg.distribution!r}; "
                             f"the port has {DISTRIBUTIONS}")
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        n, side = cfg.n_objects, cfg.side
        if cfg.distribution == "uniform":
            self.pos = self.rng.uniform(0, side, size=(n, 2)).astype(np.float32)
        else:
            centers = self.rng.uniform(0, side, size=(cfg.hotspots, 2))
            which = self.rng.integers(0, cfg.hotspots, size=n)
            sigma = side * cfg.hotspot_sigma_frac
            self.pos = (
                centers[which] + self.rng.normal(0, sigma, size=(n, 2))
            ).astype(np.float32)
            self.pos = np.clip(self.pos, 0, side - 1e-3)
        self.vel = self._rand_vel(n)

    def _rand_vel(self, n: int) -> np.ndarray:
        ang = self.rng.uniform(0, 2 * np.pi, size=n)
        speed = self.rng.uniform(0, self.cfg.max_speed, size=n)
        return (speed[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)).astype(
            np.float32
        )

    def positions(self) -> np.ndarray:
        """Last known positions P at the end of the current tick: (N, 2) f32."""
        return self.pos

    def advance(self):
        """Move every object by one tick (<= max_speed displacement)."""
        cfg = self.cfg
        self.vel += self.rng.normal(0, 0.1 * cfg.max_speed,
                                    self.vel.shape).astype(np.float32)
        speed = np.linalg.norm(self.vel, axis=1, keepdims=True)
        fac = np.minimum(1.0, cfg.max_speed / np.maximum(speed, 1e-6))
        self.vel *= fac
        self.pos = self.pos + self.vel
        # reflect at region borders
        for d in (0, 1):
            below = self.pos[:, d] < 0
            above = self.pos[:, d] > cfg.side - 1e-3
            self.pos[below, d] = -self.pos[below, d]
            self.vel[below, d] = -self.vel[below, d]
            self.pos[above, d] = 2 * (cfg.side - 1e-3) - self.pos[above, d]
            self.vel[above, d] = -self.vel[above, d]
        self.pos = np.clip(self.pos, 0, cfg.side - 1e-3)

    def query_batch(self, rate: float = 1.0):
        """Queries for the tick: one per object (Table 1), centered at the issuer."""
        n = self.cfg.n_objects
        if rate >= 1.0:
            qid = np.arange(n, dtype=np.int32)
        else:
            m = max(1, int(n * rate))
            qid = self.rng.choice(n, size=m, replace=False).astype(np.int32)
        return self.pos[qid], qid


def make_workload(n_objects: int, distribution: str = "uniform", seed: int = 0,
                  **kw) -> MovingObjectWorkload:
    return MovingObjectWorkload(
        WorkloadConfig(n_objects=n_objects, distribution=distribution,
                       seed=seed, **kw)
    )
