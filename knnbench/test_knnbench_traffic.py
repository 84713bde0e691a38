"""The traffic: the frozen generator against the port's, the frame schedule
and the per-tick draws, all from the seed."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from knnbench.traffic import DRAW_POOL, Traffic, frame_of

BENCH = Path(__file__).resolve().parent


@pytest.mark.parametrize("dist", ["uniform", "gaussian", "network", "zipf",
                                  "hotspot_cluster"])
def test_frozen_generator_matches_the_ports_draw_for_draw(dist):
    from repro_torch.data.generators import make_workload

    from knnbench.traffic import MovingObjectWorkload, WorkloadConfig

    ours = MovingObjectWorkload(WorkloadConfig(n_objects=3000,
                                               distribution=dist, seed=9))
    port = make_workload(3000, dist, seed=9)
    for _ in range(4):
        np.testing.assert_array_equal(ours.positions(), port.positions())
        ours.advance()
        port.advance()


def test_fixed_centers_keep_every_later_draw():
    from knnbench.traffic import MovingObjectWorkload, WorkloadConfig

    centers = np.random.default_rng(0).uniform(0, 22500.0, (25, 2))
    a = MovingObjectWorkload(WorkloadConfig(n_objects=2000, seed=0,
                                            distribution="gaussian"))
    b = MovingObjectWorkload(WorkloadConfig(
        n_objects=2000, seed=0, distribution="gaussian",
        centers=tuple(map(tuple, centers))))
    np.testing.assert_array_equal(a.positions(), b.positions())
    c = MovingObjectWorkload(WorkloadConfig(
        n_objects=2000, seed=5, distribution="gaussian",
        centers=tuple(map(tuple, centers))))
    # another seed, the same city: every object lies near a fixed center
    near = np.linalg.norm(c.positions()[:, None] - centers[None], axis=2)
    assert near.min(1).max() < 6 * 22500 / 64


def test_uniform_config_is_table_1_at_the_ports_defaults():
    """Table 1's square, speed and k at 1M objects, and the port's
    ``ServiceSpec`` defaults but for the B1 backend, as ``assumed`` says."""
    from repro_torch.api import ServiceSpec

    conf = json.loads((BENCH / "configs" / "uniform_1m.json").read_text())
    assert conf["data"] == {"distribution": "uniform", "n_objects": 1_000_000,
                            "side": 22500.0, "max_speed": 200.0}
    default = ServiceSpec()
    assert conf["spec"]["backend"] == "fused_bucket"
    for key, value in conf["spec"].items():
        if key != "backend":
            assert getattr(default, key) == value, key


def test_frame_schedule_plays_forward_and_back():
    assert [frame_of(s, 8) for s in range(16)] == [
        0, 1, 2, 3, 4, 5, 6, 7, 6, 5, 4, 3, 2, 1, 0, 1]
    assert [frame_of(s, 1) for s in range(3)] == [0, 0, 0]


def _tiny(seed, share):
    data = {"distribution": "uniform", "n_objects": 5000}
    return Traffic(data, {"frames": 4, "report_share": share}, seed, 64)


@pytest.mark.parametrize("share", [1.0, 0.01])
def test_same_seed_same_traffic(share):
    a, b, c = _tiny(2**31 + 3, share), _tiny(2**31 + 3, share), _tiny(4, share)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert not np.array_equal(a.positions, c.positions)
    assert not np.array_equal(a.samples, c.samples)
    np.testing.assert_array_equal(a.checked(100, 10), b.checked(100, 10))
    if share < 1:
        np.testing.assert_array_equal(a.report, b.report)
        assert not np.array_equal(a.report, c.report)


def test_churn_draws_are_disjoint_fresh_blocks():
    t = _tiny(7, 0.01)
    assert t.report.shape == (DRAW_POOL, 50)
    assert all(np.unique(b).size == 50 for b in t.report)
    # consecutive ticks of one permutation report disjoint objects
    assert np.intersect1d(t.report_ids(1), t.report_ids(2)).size == 0


def test_held_positions_replay_the_reports():
    t = _tiny(8, 0.01)
    held = t.frame(0).copy()
    want = {}
    for step in range(1, 12):
        ids = t.report_ids(step)
        held[ids] = t.frame(step)[ids]
        want[step] = held.copy()
    for step, pos in t.held_positions([3, 11, 7]):
        np.testing.assert_array_equal(pos, want[step])
    snap = _tiny(8, 1.0)
    for step, pos in snap.held_positions([5]):
        np.testing.assert_array_equal(pos, snap.frame(5))
