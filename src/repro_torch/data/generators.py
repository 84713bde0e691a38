"""Synthetic moving-object workloads (paper Sec. 5, Table 1), numpy only.

The port's own copy of ``repro/data/generators.py``, draw for draw: the same
seed gives the same positions, tick after tick, bit for bit.  Five families:
the paper's three dataset families (Sowell et al. [2]) *uniform*, *gaussian*
(objects gathered around hotspots; skew set by the hotspot count) and *road
network* (objects moving along the edges of a jittered-grid network, which
stands in for the San Francisco edge file, DESIGN.md §9), and two presets of
the skew axis the paper's headline claim covers ("highly skewed spatial
distributions"):

* *zipf*: ``clusters`` hotspot centers whose populations follow a Zipf law
  with exponent ``zipf_a`` (most mass in one tiny region: deep trees, long
  scan intervals, maximally uneven equal-count shards);
* *hotspot_cluster*: a ``cluster_frac`` share of objects packed into
  ``clusters`` tight gaussian hotspots over a uniform background (dense
  islands in sparse seas).

Defaults match Table 1: squared region of side 22500 u, max speed 200 u/tick,
one query per object per tick (query rate 100 %).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WorkloadConfig", "MovingObjectWorkload", "make_workload"]

SIDE_DEFAULT = 22_500.0
MAX_SPEED_DEFAULT = 200.0


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_objects: int = 100_000
    # uniform | gaussian | network | zipf | hotspot_cluster
    distribution: str = "uniform"
    side: float = SIDE_DEFAULT
    max_speed: float = MAX_SPEED_DEFAULT
    hotspots: int = 25  # gaussian: more hotspots -> closer to uniform
    hotspot_sigma_frac: float = 1.0 / 64.0  # sigma = side * frac
    network_grid: int = 24  # network: grid nodes per side
    zipf_a: float = 1.6  # zipf: cluster-population exponent (higher = denser)
    clusters: int = 12  # zipf / hotspot_cluster: number of cluster centers
    cluster_frac: float = 0.75  # hotspot_cluster: share of objects clustered
    seed: int = 0


class MovingObjectWorkload:
    """Stateful generator: ``positions()`` then ``advance()`` once per tick."""

    def __init__(self, cfg: WorkloadConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        n, side = cfg.n_objects, cfg.side
        if cfg.distribution == "uniform":
            self.pos = self.rng.uniform(0, side, size=(n, 2)).astype(np.float32)
            self.vel = self._rand_vel(n)
        elif cfg.distribution == "gaussian":
            centers = self.rng.uniform(0, side, size=(cfg.hotspots, 2))
            which = self.rng.integers(0, cfg.hotspots, size=n)
            sigma = side * cfg.hotspot_sigma_frac
            self.pos = (
                centers[which] + self.rng.normal(0, sigma, size=(n, 2))
            ).astype(np.float32)
            self.pos = np.clip(self.pos, 0, side - 1e-3)
            self.vel = self._rand_vel(n)
        elif cfg.distribution == "zipf":
            # cluster populations ~ Zipf(zipf_a): rank-r cluster draws a
            # 1/r^a share of the objects — the partitioner stress preset
            centers = self.rng.uniform(0, side, size=(cfg.clusters, 2))
            weights = 1.0 / np.arange(1, cfg.clusters + 1) ** cfg.zipf_a
            which = self.rng.choice(
                cfg.clusters, size=n, p=weights / weights.sum()
            )
            sigma = side * cfg.hotspot_sigma_frac
            self.pos = (
                centers[which] + self.rng.normal(0, sigma, size=(n, 2))
            ).astype(np.float32)
            self.pos = np.clip(self.pos, 0, side - 1e-3)
            self.vel = self._rand_vel(n)
        elif cfg.distribution == "hotspot_cluster":
            # cluster_frac of the mass in `clusters` tight equal hotspots,
            # the rest a uniform background (dense islands in sparse seas)
            centers = self.rng.uniform(0, side, size=(cfg.clusters, 2))
            n_cl = int(round(n * cfg.cluster_frac))
            which = self.rng.integers(0, cfg.clusters, size=n_cl)
            sigma = side * cfg.hotspot_sigma_frac / 4.0
            clustered = centers[which] + self.rng.normal(0, sigma, (n_cl, 2))
            background = self.rng.uniform(0, side, size=(n - n_cl, 2))
            self.pos = np.concatenate([clustered, background]).astype(np.float32)
            self.pos = np.clip(self.pos, 0, side - 1e-3)
            self.vel = self._rand_vel(n)
        elif cfg.distribution == "network":
            self._init_network()
        else:
            raise ValueError(f"unknown distribution {cfg.distribution!r}")

    # ------------------------------------------------------------ helpers
    def _rand_vel(self, n: int) -> np.ndarray:
        ang = self.rng.uniform(0, 2 * np.pi, size=n)
        speed = self.rng.uniform(0, self.cfg.max_speed, size=n)
        return (speed[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)).astype(
            np.float32
        )

    def _init_network(self):
        cfg = self.cfg
        g = cfg.network_grid
        step = cfg.side / (g - 1)
        xs, ys = np.meshgrid(np.arange(g) * step, np.arange(g) * step)
        nodes = np.stack([xs.ravel(), ys.ravel()], 1)
        nodes += self.rng.uniform(-0.25 * step, 0.25 * step, nodes.shape)
        nodes = np.clip(nodes, 0, cfg.side - 1e-3).astype(np.float32)
        edges = []
        for r in range(g):
            for c in range(g):
                i = r * g + c
                if c + 1 < g:
                    edges.append((i, i + 1))
                if r + 1 < g:
                    edges.append((i, i + g))
        self.net_nodes = nodes
        self.net_edges = np.asarray(edges, np.int32)
        # incident edge list per node (for random turns)
        ne = len(edges)
        inc: list[list[int]] = [[] for _ in range(g * g)]
        for e, (a, b) in enumerate(edges):
            inc[a].append(e)
            inc[b].append(e)
        maxdeg = max(len(x) for x in inc)
        self.net_inc = np.full((g * g, maxdeg), -1, np.int32)
        self.net_deg = np.zeros(g * g, np.int32)
        for v, lst in enumerate(inc):
            self.net_deg[v] = len(lst)
            self.net_inc[v, : len(lst)] = lst
        n = cfg.n_objects
        self.obj_edge = self.rng.integers(0, ne, size=n).astype(np.int32)
        self.obj_t = self.rng.uniform(0, 1, size=n).astype(np.float32)
        self.obj_dir = self.rng.choice([-1.0, 1.0], size=n).astype(np.float32)
        self.obj_speed = self.rng.uniform(
            0.3 * cfg.max_speed, cfg.max_speed, size=n
        ).astype(np.float32)
        self.pos = self._network_positions()

    def _edge_len(self, e):
        a, b = self.net_edges[e, 0], self.net_edges[e, 1]
        return np.linalg.norm(self.net_nodes[a] - self.net_nodes[b], axis=-1)

    def _network_positions(self) -> np.ndarray:
        a = self.net_edges[self.obj_edge, 0]
        b = self.net_edges[self.obj_edge, 1]
        pa, pb = self.net_nodes[a], self.net_nodes[b]
        return (pa + self.obj_t[:, None] * (pb - pa)).astype(np.float32)

    # ------------------------------------------------------------ API
    def positions(self) -> np.ndarray:
        """Last known positions P at the end of the current tick: (N, 2) f32."""
        return self.pos

    def advance(self):
        """Move every object by one tick (<= max_speed displacement)."""
        cfg = self.cfg
        if cfg.distribution in ("uniform", "gaussian", "zipf", "hotspot_cluster"):
            # speed random-walk as in [2]: perturb velocity, clamp magnitude
            self.vel += self.rng.normal(0, 0.1 * cfg.max_speed, self.vel.shape).astype(
                np.float32
            )
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
        else:  # network
            elen = np.maximum(self._edge_len(self.obj_edge), 1e-6)
            self.obj_t += self.obj_dir * self.obj_speed / elen
            done_hi = self.obj_t >= 1.0
            done_lo = self.obj_t <= 0.0
            for mask, node_col in ((done_hi, 1), (done_lo, 0)):
                idx = np.nonzero(mask)[0]
                if idx.size == 0:
                    continue
                node = self.net_edges[self.obj_edge[idx], node_col]
                deg = self.net_deg[node]
                pick = (self.rng.random(idx.size) * deg).astype(np.int32)
                new_e = self.net_inc[node, pick]
                self.obj_edge[idx] = new_e
                # orient: start from `node`
                starts_at_node = self.net_edges[new_e, 0] == node
                self.obj_t[idx] = np.where(starts_at_node, 0.0, 1.0)
                self.obj_dir[idx] = np.where(starts_at_node, 1.0, -1.0)
            self.obj_t = np.clip(self.obj_t, 0.0, 1.0)
            self.pos = self._network_positions()

    def query_batch(self, rate: float = 1.0):
        """Queries for the tick: one per object (Table 1), centered at the issuer."""
        n = self.cfg.n_objects
        if rate >= 1.0:
            qid = np.arange(n, dtype=np.int32)
        else:
            m = max(1, int(n * rate))
            qid = self.rng.choice(n, size=m, replace=False).astype(np.int32)
        return self.pos[qid], qid


def make_workload(
    n_objects: int,
    distribution: str = "uniform",
    seed: int = 0,
    **kw,
) -> MovingObjectWorkload:
    return MovingObjectWorkload(
        WorkloadConfig(n_objects=n_objects, distribution=distribution, seed=seed, **kw)
    )
