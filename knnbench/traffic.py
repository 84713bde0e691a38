"""The benchmark's traffic: a frozen copy of the moving-object generator, the
stationary frame schedule, and the per-tick draws, all from ``--seed``.

``MovingObjectWorkload`` is a copy, draw for draw, of the port's
``data/generators.py`` (the paper's Sec. 5 families after Sowell et al.), kept
here so that no change to the program changes the yardstick.  One addition:
``centers`` fixes the hotspot centers of the gaussian, zipf and
hotspot_cluster families to a deployment's own list.  The generator still
draws its centers first, so every later draw is the original's, and with the
centers that seed 0 draws the output equals the original's bit for bit; a
deployment that lists its centers runs the same city under every seed, so the
seed changes which objects stand where, not how skewed the data is.

Numpy only: nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SIDE_DEFAULT = 22_500.0
MAX_SPEED_DEFAULT = 200.0
# draws made in set-up and cycled through by the window: enough distinct ticks
# that a run at today's speed never repeats one
DRAW_POOL = 256


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
    centers: tuple | None = None  # fixed (x, y) hotspot centers, or drawn


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
            centers = self._centers(cfg.hotspots)
            which = self.rng.integers(0, cfg.hotspots, size=n)
            sigma = side * cfg.hotspot_sigma_frac
            self.pos = (
                centers[which] + self.rng.normal(0, sigma, size=(n, 2))
            ).astype(np.float32)
            self.pos = np.clip(self.pos, 0, side - 1e-3)
            self.vel = self._rand_vel(n)
        elif cfg.distribution == "zipf":
            centers = self._centers(cfg.clusters)
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
            centers = self._centers(cfg.clusters)
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
    def _centers(self, count: int) -> np.ndarray:
        drawn = self.rng.uniform(0, self.cfg.side, size=(count, 2))
        if self.cfg.centers is None:
            return drawn
        fixed = np.asarray(self.cfg.centers, np.float64).reshape(-1, 2)
        if fixed.shape[0] != count:
            raise ValueError(f"{fixed.shape[0]} centers for {count} hotspots")
        return fixed

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
        """Last known positions at the end of the current tick: (N, 2) f32."""
        return self.pos

    def advance(self):
        """Move every object by one tick (<= max_speed displacement)."""
        cfg = self.cfg
        if cfg.distribution in ("uniform", "gaussian", "zipf", "hotspot_cluster"):
            self.vel += self.rng.normal(0, 0.1 * cfg.max_speed, self.vel.shape).astype(
                np.float32
            )
            speed = np.linalg.norm(self.vel, axis=1, keepdims=True)
            fac = np.minimum(1.0, cfg.max_speed / np.maximum(speed, 1e-6))
            self.vel *= fac
            self.pos = self.pos + self.vel
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
                starts_at_node = self.net_edges[new_e, 0] == node
                self.obj_t[idx] = np.where(starts_at_node, 0.0, 1.0)
                self.obj_dir[idx] = np.where(starts_at_node, 1.0, -1.0)
            self.obj_t = np.clip(self.obj_t, 0.0, 1.0)
            self.pos = self._network_positions()


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """An independent stream of draws for one purpose, from the run's seed.

    The objects themselves come from ``default_rng(seed)``, as the
    program's generator draws them for the same seed; the other draws take
    streams 1 and up.  Any whole number is a seed: negative ones are taken
    modulo 2**64.
    """
    return np.random.SeedSequence(seed % (1 << 64), spawn_key=(stream,))


def frame_of(step: int, frames: int) -> int:
    """The frame a tick plays: 0, 1, .., F-1, F-2, .., 1, 0, 1, .. (period
    2(F-1)), so every move is one generator step and every cycle repeats."""
    if frames == 1:
        return 0
    period = 2 * (frames - 1)
    r = step % period
    return r if r < frames else period - r


class Traffic:
    """Everything a run hands the program, made in set-up from the seed.

    ``positions[f]`` holds every object's position in frame ``f``; tick
    ``step`` plays ``frame_of(step)``.  Under ``report_share`` 1 every
    object reports each tick (a full snapshot); below it,
    ``report_ids(step)`` objects, a fresh draw from the seed for each of
    ``DRAW_POOL`` ticks, report their position in the tick's frame.
    ``sample_rows(step)`` are the query rows kept for the check.  Every
    object queries at the position the program holds for it, excluding
    itself.
    """

    def __init__(self, data: dict, mix: dict, seed: int, sample_rows: int):
        data = dict(data)
        if "centers" in data:
            data["centers"] = tuple(map(tuple, data["centers"]))
        cfg = WorkloadConfig(seed=seed % (1 << 64), **data)
        gen = MovingObjectWorkload(cfg)
        self.n = cfg.n_objects
        self.frames = mix["frames"]
        self.report_share = float(mix["report_share"])
        frames = [gen.positions().copy()]
        for _ in range(self.frames - 1):
            gen.advance()
            frames.append(gen.positions().copy())
        self.positions = np.stack(frames)  # (F, N, 2) f32
        self.report = None
        if self.report_share < 1.0:
            # disjoint blocks of one permutation after another
            m = max(1, int(round(self.report_share * self.n)))
            per_perm = self.n // m
            rng = np.random.default_rng(seed_sequence(seed, 1))
            blocks = []
            while len(blocks) < DRAW_POOL:
                perm = rng.permutation(self.n).astype(np.int32)
                blocks.extend(perm[: per_perm * m].reshape(per_perm, m))
            self.report = np.stack(blocks[:DRAW_POOL])
        rng = np.random.default_rng(seed_sequence(seed, 2))
        s = min(sample_rows, self.n)
        self.samples = np.stack([np.sort(rng.choice(self.n, s, replace=False))
                                 for _ in range(DRAW_POOL)])
        self._check_rng = np.random.default_rng(seed_sequence(seed, 3))

    @property
    def snapshot(self) -> bool:
        return self.report is None

    def frame(self, step: int) -> np.ndarray:
        return self.positions[frame_of(step, self.frames)]

    def report_ids(self, step: int) -> np.ndarray:
        """The objects that report in tick ``step`` (>= 1)."""
        return self.report[(step - 1) % DRAW_POOL]

    def sample_rows(self, step: int) -> np.ndarray:
        return self.samples[step % DRAW_POOL]

    def checked(self, count: int, limit: int) -> np.ndarray:
        """Which of ``count`` window ticks the check compares: all, or a draw
        of ``limit`` of them from the seed."""
        if count <= limit:
            return np.arange(count)
        return np.sort(self._check_rng.choice(count, limit, replace=False))

    def held_positions(self, steps):
        """Yield ``(step, positions)``: what the program held at each tick.

        A snapshot holds the tick's frame.  Under partial reports the build
        tick's frame is updated tick by tick by each tick's reports, replayed
        here after the window in the order the window handed them in.
        """
        held = None if self.snapshot else self.frame(0).copy()
        step = 0
        for s in sorted(set(int(s) for s in steps)):
            if held is None:
                yield s, self.frame(s)
                continue
            while step < s:
                step += 1
                ids = self.report_ids(step)
                held[ids] = self.frame(step)[ids]
            yield s, held
