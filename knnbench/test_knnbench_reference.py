"""The plain reference, the comparison and the control on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from knnbench import check
from knnbench.control import control_reading
from knnbench.references import knn_exact


def _numpy_knn(points, qpos, qid, k):
    """Exact k-NN by a lexicographic sort on (squared distance, id)."""
    out_i, out_d = [], []
    ids = np.arange(points.shape[0])
    for q, own in zip(qpos, qid):
        d2 = ((points - q) ** 2).sum(1)  # exact: small integer coordinates
        keep = ids != own
        order = np.lexsort((ids[keep], d2[keep]))[:k]
        out_i.append(ids[keep][order])
        out_d.append(np.sqrt(d2[keep][order]).astype(np.float32))
    return np.array(out_i, np.int32), np.array(out_d, np.float32)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_reference_matches_numpy_with_ties_and_self(k):
    # a 12 x 12 integer grid with every point twice: distances tie
    # everywhere, and each query's twin lies at distance 0
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1).reshape(-1, 2)
    pts = np.concatenate([g, g]).astype(np.float32)
    rows = np.arange(0, pts.shape[0], 7)
    want_i, want_d = _numpy_knn(pts, pts[rows], rows, k)
    got_i, got_d = knn_exact.knn(torch.tensor(pts), torch.tensor(pts[rows]),
                                 torch.tensor(rows), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert not (got_i.numpy() == rows[:, None]).any()
    assert check.rows_differ(got_i.numpy(), got_d.numpy(), want_i, want_d) == 0


def test_reference_blocks_agree(monkeypatch):
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(0, 22500, (3000, 2)).astype(np.float32))
    rows = torch.arange(0, 3000, 11)
    whole = knn_exact.knn(pts, pts[rows], rows, 16)
    monkeypatch.setattr(knn_exact, "BLOCK_ELEMS", 3000 * 5)
    blocked = knn_exact.knn(pts, pts[rows], rows, 16)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


def test_rows_differ_counts_ids_and_distance_bits():
    i = np.arange(12, dtype=np.int32).reshape(3, 4)
    d = np.linspace(1, 2, 12, dtype=np.float32).reshape(3, 4)
    i2, d2 = i.copy(), d.copy()
    i2[0, 1] += 100
    d2[2, 3] = np.nextafter(d2[2, 3], np.float32(9))
    assert check.rows_differ(i, d, i, d) == 0
    assert check.rows_differ(i2, d2, i, d) == 2
    assert check.rows_differ(i[:2], d[:2], i, d) == 3


def test_lists_bad_flags_each_kind_of_fault():
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 22500, (500, 2)).astype(np.float32)
    qid = np.arange(500, dtype=np.int32)
    idx, dist = knn_exact.knn(torch.tensor(pts), torch.tensor(pts),
                              torch.tensor(qid), 8)
    idx, dist = idx.numpy(), dist.numpy()
    assert check.lists_bad(pts, pts, qid, idx, dist, "cpu") == 0
    bad_i, bad_d = idx.copy(), dist.copy()
    bad_i[0, 0] = 0  # the issuer itself
    bad_i[1, 0] = 500  # out of range
    bad_d[2, 3] = np.nextafter(bad_d[2, 3], np.float32(0))  # not its distance
    bad_i[3, [2, 3]] = bad_i[3, [3, 2]]  # out of order
    bad_d[3, [2, 3]] = bad_d[3, [3, 2]]
    bad_i[4, 5] = bad_i[4, 4]  # a repeated id
    bad_d[4, 5] = bad_d[4, 4]
    assert check.lists_bad(pts, pts, qid, bad_i, bad_d, "cpu") == 5


def test_control_fails_the_check(tiny_root):
    """The bf16 reference in the program's place comes out not correct
    through the run's own comparison, on three seeds, where the fp32
    reference reads 0 (the harness's runs)."""
    for seed in (1, 2, 2**31 + 7):
        r = control_reading(tiny_root / "BENCHMARK.json",
                            "tiny_uniform.move_all", seed, 2, "cpu")
        assert r["rows_checked"] == 2 * 2000
        assert r["correct"] is False
        assert r["checks"]["rows_differ"]["value"] > r["checks"][
            "rows_differ"]["limit"]
