"""Parity: the PyTorch port's quadtree build against the JAX reference.

Every comparison is bitwise (``np.array_equal``, tolerance 0) on the six
fields ``tests/test_maintenance.py`` compares, plus origin and side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from repro_torch.testing import given, settings, strategies as st

from repro.core import quadtree as jq
from repro_torch import convert
from repro_torch.core import quadtree as tq

torch.set_num_threads(2)

SIDE = 1000.0
FIELDS = ("pos", "ids", "codes", "starts", "pyramid", "leaf_level")


def _assert_index_equal(jidx, tidx, fields=FIELDS + ("origin", "side")):
    for f in fields:
        a = np.asarray(getattr(jidx, f))
        b = getattr(tidx, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _points(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    if kind == "clustered":
        pts = rng.normal(SIDE / 3, SIDE / 40, (n, 2))
        return np.clip(pts, 0, SIDE - 1e-3).astype(np.float32)
    # duplicates and points on / past the region's edges
    pts = rng.uniform(0, SIDE, (n, 2)).astype(np.float32)
    pts[: n // 4] = pts[0]
    pts[n // 4: n // 4 + 4] = [[0, 0], [SIDE, SIDE], [-1, 5], [5, SIDE + 1]]
    return pts


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
@pytest.mark.parametrize("l_max,th", [(5, 8), (7, 64)])
def test_build_index_matches_jax(kind, l_max, th):
    pts = _points(kind, 3000, seed=l_max)
    origin = np.asarray([0.0, 0.0], np.float32)
    jidx = jq.build_index(jnp.asarray(pts), jnp.asarray(origin), SIDE,
                          l_max=l_max, th_quad=th)
    tidx = tq.build_index(torch.tensor(pts), torch.tensor(origin), SIDE,
                          l_max=l_max, th_quad=th)
    _assert_index_equal(jidx, tidx)


def test_reindex_and_rebuild_zmap_match_jax():
    """Stage (ii) re-sort into a stale partition, then the z_map re-derive."""
    pts = _points("uniform", 3000, seed=1)
    moved = _points("clustered", 3000, seed=2)
    origin = np.zeros(2, np.float32)
    jidx = jq.build_index(jnp.asarray(pts), jnp.asarray(origin), SIDE,
                          l_max=6, th_quad=16)
    tidx = tq.build_index(torch.tensor(pts), torch.tensor(origin), SIDE,
                          l_max=6, th_quad=16)
    jre = jq.reindex_objects(jidx, jnp.asarray(moved))
    tre = tq.reindex_objects(tidx, torch.tensor(moved))
    _assert_index_equal(jre, tre)
    _assert_index_equal(jq.rebuild_zmap(jre), tq.rebuild_zmap(tre))
    # rebuild_zmap over the re-sorted index == a fresh build of the moved set
    _assert_index_equal(
        jq.build_index(jnp.asarray(moved), jnp.asarray(origin), SIDE,
                       l_max=6, th_quad=16),
        tq.rebuild_zmap(tre))


def test_leaf_of_points_matches_jax():
    pts = _points("clustered", 2000, seed=3)
    q = _points("duplicates", 500, seed=4)
    jidx = jq.build_index(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=6,
                          th_quad=12)
    tidx = tq.build_index(torch.tensor(pts), torch.zeros(2), SIDE, l_max=6,
                          th_quad=12)
    for a, b in zip(jq.leaf_of_points(jidx, jnp.asarray(q)),
                    tq.leaf_of_points(tidx, torch.tensor(q))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_convert_carries_the_reference_index():
    """convert.py: JAX fields as numpy -> port index -> numpy, unchanged."""
    pts = _points("uniform", 1000, seed=5)
    jidx = jq.build_index(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=5,
                          th_quad=8)
    fields = {f: np.asarray(getattr(jidx, f)) for f in convert.INDEX_FIELDS}
    tidx = convert.index_from_numpy(fields, l_max=5, th_quad=8, device="cpu")
    _assert_index_equal(jidx, tidx)
    back = convert.index_to_numpy(tidx)
    assert back["l_max"] == 5 and back["th_quad"] == 8
    for f in convert.INDEX_FIELDS:
        np.testing.assert_array_equal(back[f], fields[f])
    with pytest.raises(ValueError, match="ids"):
        convert.index_from_numpy(dict(fields, ids=fields["ids"].astype(
            np.int64)), l_max=5, th_quad=8, device="cpu")


@pytest.mark.parametrize("lo,own,capo", [(0, 750, 750), (750, 750, 750),
                                         (2250, 746, 750), (1000, 0, 750)])
def test_local_pyramid_from_starts_matches_jax(lo, own, capo):
    """One object shard's pyramid, derived from the global offsets, with the
    window's surplus rows counted at the clone code."""
    pts = _points("duplicates", 2996, seed=3)
    idx = tq.build_index(torch.tensor(pts), torch.zeros(2), SIDE, l_max=5,
                         th_quad=8)
    codes = np.asarray(idx.codes)
    clone = int(codes[min(max(lo + own - 1, 0), codes.size - 1)])
    want = jq.local_pyramid_from_starts(jnp.asarray(idx.starts.numpy()), lo,
                                        own, clone, capo, 5)
    got = tq.local_pyramid_from_starts(idx.starts, lo, own, clone, capo, 5)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# The reference's property tests (tests/test_quadtree.py), same names and
# strategies: each drawn point set is indexed by both packages.
pointsets = st.lists(
    st.tuples(st.floats(0, 999.9), st.floats(0, 999.9)), min_size=1,
    max_size=300)


def _both(points, l_max=5, th=8):
    pts = np.asarray(points, np.float32)
    jidx = jq.build_index(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=l_max,
                          th_quad=th)
    tidx = tq.build_index(torch.tensor(pts), torch.zeros(2), SIDE,
                          l_max=l_max, th_quad=th)
    _assert_index_equal(jidx, tidx)
    return pts, jidx, tidx


def _leaves(idx):
    """Leaves as (key, level, span), walking the fine cells."""
    ll = idx.leaf_level.numpy()
    leaves, c = [], 0
    while c < len(ll):
        span = 4 ** (idx.l_max - int(ll[c]))
        leaves.append((c, int(ll[c]), span))
        c += span
    return leaves


@settings(max_examples=25, deadline=None)
@given(pointsets, st.integers(2, 6), st.integers(2, 32))
def test_leaves_partition_domain_and_objects(points, l_max, th):
    """Every index field equal to JAX's; the leaves tile the domain and
    their intervals the objects, each leaf above l_max holding <= th."""
    _, _, idx = _both(points, l_max, th)
    leaves = _leaves(idx)
    assert sum(s for _, _, s in leaves) == 4**idx.l_max
    starts = idx.starts.numpy()
    total = 0
    for key, lvl, span in leaves:
        cnt = starts[key + span] - starts[key]
        total += cnt
        if lvl < idx.l_max:
            assert cnt <= th, (key, lvl, cnt)
    assert total == len(points)
    for level in range(idx.l_max + 1):
        np.testing.assert_array_equal(
            idx.level_counts(level).numpy(),
            np.bincount(idx.codes.numpy() >> (2 * (idx.l_max - level)),
                        minlength=4**level))


@settings(max_examples=25, deadline=None)
@given(pointsets)
def test_leaf_alignment_and_zmap(points):
    """Leaves aligned; ``leaf_of_points`` equal to JAX's, and each point's
    leaf holds its fine cell."""
    pts, jidx, idx = _both(points)
    for key, lvl, span in _leaves(idx):
        assert key % span == 0
    key, lvl = tq.leaf_of_points(idx, torch.tensor(pts))
    for a, b in zip(jq.leaf_of_points(jidx, jnp.asarray(pts)), (key, lvl)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    from repro_torch.core import morton as tm

    fine = tm.morton_encode_points(torch.tensor(pts), idx.origin, idx.side,
                                   idx.l_max).numpy()
    span = 4 ** (idx.l_max - lvl.numpy())
    assert ((key.numpy() <= fine) & (fine < key.numpy() + span)).all()
    np.testing.assert_array_equal(idx.leaf_level.numpy()[fine], lvl.numpy())
