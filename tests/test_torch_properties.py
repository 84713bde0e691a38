"""The reference's property harness over the port, and the port held to JAX.

The seven properties of ``tests/test_properties.py`` (the composition law of
DESIGN.md §12-§16: every plan x partitioner x precision x maintenance x
tenant cell gives the ``single`` plan's bits) run through
``repro_torch.properties`` on the CPU, with the reference's shapes, draws and
example counts.  The mesh plans run 4 logical shards (``sharded`` 4,
``object_sharded`` 4, ``hybrid`` ``default_hybrid_shape(4)``), each under both
partitioners.  For every drawn cloud of the first three properties the port's
``single`` ``dense_topk`` lists must also equal the JAX package's bit for bit,
which by the law holds the whole port grid to JAX.  Hypothesis draws through
the port's deterministic fallback (``repro_torch.testing``) where the real
wheel is absent.  ``chip_smoke.py``'s ``properties`` phase runs the same
harness on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from repro_torch.testing import given, settings, strategies as st

from repro.core import build_index as jax_build_index
from repro.core import knn_query_batch_chunked as jax_knn
from repro_torch import properties as P
from repro_torch.testing import draws

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _no_autograd():
    # the harness makes thousands of tiny tensors: skip autograd's tracking
    with torch.inference_mode():
        yield


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _matches_jax(pts, qpos, qid, lists, *, k, l_max=5, th_quad=8):
    """The port's single dense_topk lists == the JAX package's, bitwise."""
    idx = jax_build_index(jnp.asarray(pts), jnp.zeros(2), P.SIDE,
                          l_max=l_max, th_quad=th_quad)
    ii, dd, _ = jax_knn(idx, qpos, qid, k=k, window=16, chunk=16,
                        backend="dense_topk", plan="single")
    _bits_equal(lists[0], np.asarray(ii), "ids vs JAX")
    _bits_equal(lists[1], np.asarray(dd), "dists vs JAX")


def test_grid_and_draws_follow_the_reference():
    """4 logical shards on every mesh plan, both partitioners; the fallback
    draws the reference's examples (the same per-test seed)."""
    assert P.PLAN_GRID[0] == ("single", None, "equal")
    assert {(p, m) for p, m, _ in P.PLAN_GRID[1:]} == {
        ("sharded", 4), ("object_sharded", 4), ("hybrid", (2, 2))}
    assert all({part for p, _, part in P.PLAN_GRID if p == plan}
               == {"equal", "cost_balanced"}
               for plan in ("sharded", "object_sharded", "hybrid"))
    from repro.testing import given as ref_given
    from repro.testing import settings as ref_settings

    for name, (strats, n) in P.PROPERTIES.items():
        seen = []

        def record(*example):
            seen.append(example)

        record.__name__ = name  # the shim seeds from the test's name
        ref_settings(max_examples=n)(
            ref_given(*_ref_strategies(name))(record))()
        assert draws(name, strats, n) == seen, name


def _ref_strategies(name):
    """The reference's strategies of property ``name``, from its shim."""
    from repro.testing import strategies as rst

    cloud = (rst.integers(0, 10_000), rst.integers(0, 2), rst.integers(1, 6),
             rst.floats(1.2, 3.5))
    return {
        "test_full_matrix_bit_identical": cloud,
        "test_mixed_precision_bit_identical": cloud,
        "test_fewer_objects_than_k_all_plans": (
            rst.integers(0, 10_000), rst.integers(1, 7), rst.integers(1, 3)),
        "test_maintenance_axis_bit_identical": (
            rst.integers(0, 10_000), rst.integers(0, 2), rst.integers(1, 4),
            rst.floats(1.2, 3.5)),
        "test_server_axis_bit_identical": cloud,
    }[name]


@settings(max_examples=6, deadline=None)
@given(
    st.integers(min_value=0, max_value=10_000),  # seed
    st.integers(min_value=0, max_value=2),       # family
    st.integers(min_value=1, max_value=6),       # dup_every
    st.floats(min_value=1.2, max_value=3.5),     # zipf_a
)
def test_full_matrix_bit_identical(seed, family, dup_every, zipf_a):
    """Every plan x partitioner == that backend's single bits, for every
    backend; backends agree at rtol 1e-6; dense_topk meets the kd-tree by
    the reference's rule and equals JAX's single lists bitwise."""
    pts, qpos, qid, singles, _ = P.full_matrix(
        seed, family, dup_every, zipf_a, device="cpu")
    _matches_jax(pts, qpos, qid, singles["dense_topk"], k=6)


@settings(max_examples=4, deadline=None)
@given(
    st.integers(min_value=0, max_value=10_000),  # seed
    st.integers(min_value=0, max_value=2),       # family
    st.integers(min_value=1, max_value=6),       # dup_every
    st.floats(min_value=1.2, max_value=3.5),     # zipf_a
)
def test_mixed_precision_bit_identical(seed, family, dup_every, zipf_a):
    """precision="mixed" == fp32 single, bitwise, for every backend across
    the grid, with fused_multi on the object-axis plans."""
    pts, qpos, qid, singles, _ = P.mixed_matrix(
        seed, family, dup_every, zipf_a, device="cpu")
    _matches_jax(pts, qpos, qid, singles["dense_topk"], k=6)


@settings(max_examples=5, deadline=None)
@given(
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=1, max_value=7),       # n < k = 8
    st.integers(min_value=1, max_value=3),       # dup_every
)
def test_fewer_objects_than_k_all_plans(seed, n, dup_every):
    """n < k: (-1, inf) padding identical across the grid, including object
    shards that hold only sentinel rows; equal to JAX's single lists."""
    pts, qid, singles, _ = P.fewer_objects_than_k(seed, n, dup_every,
                                                  device="cpu")
    _matches_jax(pts, pts, qid, singles["dense_topk"], k=8, l_max=4,
                 th_quad=4)


@settings(max_examples=3, deadline=None)
@given(
    st.integers(min_value=0, max_value=10_000),  # seed
    st.integers(min_value=0, max_value=2),       # family
    st.integers(min_value=1, max_value=4),       # dup_every
    st.floats(min_value=1.2, max_value=3.5),     # zipf_a
)
def test_maintenance_axis_bit_identical(seed, family, dup_every, zipf_a):
    """incremental == rebuild, lists and every index array, at every tick
    of the reference's motion script, across the grid."""
    P.maintenance_axis(seed, family, dup_every, zipf_a, device="cpu")


def test_mover_crosses_moving_cost_balanced_boundary():
    """A mover crosses a cost_balanced object-shard boundary on the tick
    the boundary moves; the splice still gives the rebuild's bits."""
    P.mover_crosses_boundary(device="cpu")


@settings(max_examples=3, deadline=None)
@given(
    st.integers(min_value=0, max_value=10_000),  # seed
    st.integers(min_value=0, max_value=2),       # family
    st.integers(min_value=1, max_value=6),       # dup_every
    st.floats(min_value=1.2, max_value=3.5),     # zipf_a
)
def test_server_axis_bit_identical(seed, family, dup_every, zipf_a):
    """A 3-tenant server == 3 solo sessions, bitwise, at every tick across
    the grid under both invalidations; the unchanged tick computes no row."""
    P.server_axis(seed, family, dup_every, zipf_a, device="cpu")


@pytest.mark.parametrize("r", [2, 3, 8])
def test_pipeline_r_way_partition_composes(r):
    """R local quadtrees over the equal partition's slices, tree-merged ==
    the single plan's bits (89 objects: a short last slice; ties)."""
    P.r_way_partition(r, device="cpu")
