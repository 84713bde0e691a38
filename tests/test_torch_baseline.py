"""Parity: the port's brute-force baseline (K-NN_BASELINE) against JAX.

``knn_bruteforce`` and ``knn_bruteforce_chunked`` on the CPU against the
reference's jitted versions, ids and distances bit for bit: the reference's
compiled distance is ``fma(dy, dy, dx*dx)``, its ``lax.top_k`` on ``-d2``
orders equal distances by index (a stable sort), and its square root is
correctly rounded.  Covered: the query's own object excluded (``qid``), ties
between coincident objects, fewer objects than k, and a ragged last chunk.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baseline as jb
from repro_torch.core import baseline as tb

torch.set_num_threads(2)


def _bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _points(n, seed, side=22_500.0):
    """Uniform objects; a few on one spot (equal distances to any query)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, side, (n, 2)).astype(np.float32)
    pts[1:min(n, 9)] = pts[0]
    return pts


@pytest.mark.parametrize("n,k", [(600, 8), (600, 32), (5, 8), (1, 4)])
def test_knn_bruteforce_matches_jax(n, k):
    """Self-exclusion by ``qid`` (with -2 for no exclusion), N < k padding."""
    pts = _points(n, seed=n + k)
    rng = np.random.default_rng(k)
    q = 24
    qpos = np.concatenate([pts[: min(n, q // 2)],
                           rng.uniform(0, 22_500, (q - min(n, q // 2), 2))]
                          ).astype(np.float32)
    qid = np.full(q, -2, np.int32)
    qid[: min(n, q // 2)] = np.arange(min(n, q // 2))
    ji, jd = jb.knn_bruteforce(jnp.asarray(pts), jnp.asarray(qpos),
                               jnp.asarray(qid), k)
    ti, td = tb.knn_bruteforce(torch.tensor(pts), torch.tensor(qpos),
                               torch.tensor(qid), k)
    _bits_equal(ji, ti.numpy(), "ids")
    _bits_equal(jd, td.numpy(), "distances")
    own = ti.numpy()[: min(n, q // 2)]
    assert not (own == qid[: min(n, q // 2), None]).any()
    if n < k:
        assert (ti.numpy()[:, n:] == -1).all()
        assert np.isinf(td.numpy()[:, n:]).all()


@pytest.mark.parametrize("nq,chunk", [(100, 32), (64, 64), (7, 2048)])
def test_knn_bruteforce_chunked_matches_jax(nq, chunk):
    """A ragged last chunk (100 = 3 x 32 + 4), an even split, one short
    chunk; every query excludes its own object."""
    pts = _points(1000, seed=nq)
    rows = np.random.default_rng(nq).choice(1000, nq, replace=False)
    qid = rows.astype(np.int32)
    ji, jd = jb.knn_bruteforce_chunked(pts, pts[rows], qid, k=16,
                                       chunk=chunk)
    ti, td = tb.knn_bruteforce_chunked(pts, pts[rows], qid, k=16,
                                       chunk=chunk, device="cpu")
    _bits_equal(ji, ti, "ids")
    _bits_equal(jd, td, "distances")
    assert ti.dtype == np.int32 and td.dtype == np.float32


def test_knn_bruteforce_chunked_without_qid():
    """``qid=None`` excludes nothing: a query on an object finds it first."""
    pts = _points(300, seed=3)
    qpos = pts[10:20].copy()
    ji, jd = jb.knn_bruteforce_chunked(pts, qpos, k=4, chunk=8)
    ti, td = tb.knn_bruteforce_chunked(pts, qpos, k=4, chunk=8, device="cpu")
    _bits_equal(ji, ti)
    _bits_equal(jd, td)
    assert (td[:, 0] == 0).all()


def test_knn_bruteforce_chunked_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _points(50, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.knn_bruteforce_chunked(pts, pts[:4], k=2)
