"""Parity: the port's list merges against the JAX package, on the CPU.

The plain versions of the two merge kernels (B2 ``merge_topk_multi``, B3
``merge_topk_lists``) and ``tree_merge_lists`` under every MERGE backend are
held against the reference's Pallas kernels in interpret mode, on the edge
rows of ``chip_smoke.merge_inputs`` (ties across lists, empty and partly
filled lists).  Every comparison is bitwise (``np.array_equal`` on the raw
bits, tolerance 0).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import merge_topk as jmt
from repro.kernels import ops as jops
from repro_torch.kernels import merge_topk as tmt
from repro_torch.kernels import ops as tops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import merge_inputs  # noqa: E402

torch.set_num_threads(2)

Q, K = 64, 6


def _bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _pair_equal(j, t, what=""):
    _bits_equal(j[0], t[0].numpy(), f"{what} distances")
    _bits_equal(j[1], t[1].numpy(), f"{what} ids")


@pytest.mark.parametrize("r", [1, 2, 4])
def test_merge_topk_multi_plain_matches_pallas(r):
    d, i = merge_inputs(r, Q, K, "cpu", seed=r)
    d_cat = d.transpose(0, 1).reshape(Q, r * K).contiguous()
    i_cat = i.transpose(0, 1).reshape(Q, r * K).contiguous()
    want = jmt.merge_topk_multi(jnp.asarray(d_cat.numpy()),
                                jnp.asarray(i_cat.numpy()), k=K,
                                interpret=True)
    _pair_equal(want, tmt.merge_topk_multi_ref(d_cat, i_cat, k=K), "ref")
    before = tmt.merge_topk_multi.launches
    _pair_equal(want, tmt.merge_topk_multi(d_cat, i_cat, k=K), "wrapper")
    assert tmt.merge_topk_multi.launches == before  # CPU: no kernel
    # the two-sort merge of the dense_merge backend gives the same bits
    _pair_equal(want, tops.topk_select_ref(d_cat, i_cat, K), "two-sort")


@pytest.mark.parametrize("r,k", [(8, 128), (5, 130)])
def test_merge_topk_multi_wide_plain_matches_pallas(r, k):
    """Past a row of 512, where the card's wide merge takes the row level
    by level (R = 8 at k = 128 is ``object_sharded`` 8's row; R = 5 carries
    a tail list): the plain version and the wrapper equal the Pallas kernel
    on ``chip_smoke.merge_inputs``' edge rows."""
    q = 16
    d, i = merge_inputs(r, q, k, "cpu", seed=r + k, inf_ids=True)
    d_cat = d.transpose(0, 1).reshape(q, r * k).contiguous()
    i_cat = i.transpose(0, 1).reshape(q, r * k).contiguous()
    want = jmt.merge_topk_multi(jnp.asarray(d_cat.numpy()),
                                jnp.asarray(i_cat.numpy()), k=k,
                                interpret=True)
    _pair_equal(want, tmt.merge_topk_multi_ref(d_cat, i_cat, k=k), "ref")
    before = tmt.merge_topk_multi.launches
    _pair_equal(want, tmt.merge_topk_multi(d_cat, i_cat, k=k), "wrapper")
    assert tmt.merge_topk_multi.launches == before  # CPU: no kernel


@pytest.mark.parametrize("r,k", [(1, 6), (3, 6), (5, 12), (8, 33)])
def test_merge_inputs_meet_the_kernels_precondition(r, k):
    """Every list of ``chip_smoke.merge_inputs`` (all its edge bands) is
    ascending under (d2, id) with its +inf entries, of any id, at the tail:
    what the card's merge kernels rest on."""
    d, i = merge_inputs(r, Q, k, "cpu", seed=r + k, inf_ids=True)
    fin = torch.isfinite(d)
    assert not (~fin[..., :-1] & fin[..., 1:]).any(), "+inf before a finite"
    a = (d[..., :-1], i[..., :-1])
    b = (d[..., 1:], i[..., 1:])
    ascending = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))
    assert (ascending | ~fin[..., 1:]).all()
    # the bands the kernels' edge cases need are there
    e = Q // 16
    assert (~fin[:, 6 * e:7 * e] & (i[:, 6 * e:7 * e] != -1)).any()
    if r > 1:
        assert torch.equal(i[0, 5 * e:6 * e], i[1, 5 * e:6 * e])


@pytest.mark.parametrize("c,k", [(10, 4), (13, 6)])
def test_merge_topk_multi_plain_takes_any_row_on_the_cpu(c, k):
    """The card's kernel needs R whole lists of k; the plain version on the
    CPU keeps the reference's general semantics (the k smallest of any
    row), bit for bit against the Pallas kernel."""
    d, i = merge_inputs(1, Q, c, "cpu", seed=c, inf_ids=True)
    d, i = d[0], i[0]
    want = jmt.merge_topk_multi(jnp.asarray(d.numpy()), jnp.asarray(i.numpy()),
                                k=k, interpret=True)
    _pair_equal(want, tmt.merge_topk_multi(d, i, k=k), "wrapper")


@pytest.mark.parametrize("ka,kb,k", [(6, 6, 6), (4, 6, 6), (6, 6, 9)])
def test_merge_topk_lists_plain_matches_pallas(ka, kb, k):
    d, i = merge_inputs(2, Q, 6, "cpu", seed=ka + kb + k)
    args = (d[0, :, :ka].contiguous(), i[0, :, :ka].contiguous(),
            d[1, :, :kb].contiguous(), i[1, :, :kb].contiguous())
    want = jmt.merge_topk_lists(*(jnp.asarray(a.numpy()) for a in args),
                                k=k, interpret=True)
    _pair_equal(want, tmt.merge_topk_lists_ref(*args, k=k), "ref")
    _pair_equal(want, tmt.merge_topk_lists(*args, k=k), "wrapper")


@pytest.mark.parametrize("merge", ["dense_merge", "fused_merge", "fused_multi"])
@pytest.mark.parametrize("r", [1, 2, 3, 5, 8])
def test_tree_merge_lists_matches_jax(r, merge):
    d, i = merge_inputs(r, Q - 4, K, "cpu", seed=10 + r)  # Q pads to Q_TILE
    want = jops.tree_merge_lists(jnp.asarray(d.numpy()),
                                 jnp.asarray(i.numpy()), k=K, merge=merge)
    got = tops.tree_merge_lists(d, i, k=K, merge=merge)
    _pair_equal(want, got, merge)
    # any tree gives the union's k smallest: the single R-way selection
    flat = (d.transpose(0, 1).reshape(Q - 4, r * K),
            i.transpose(0, 1).reshape(Q - 4, r * K))
    _pair_equal(want, tops.topk_select_ref(*flat, K), "union")


@pytest.mark.parametrize("merge", ["dense_merge", "fused_merge", "fused_multi"])
def test_binary_merge_backends_on_ragged_lists(merge):
    """The binary MERGE contract takes lists narrower (and wider) than k:
    the fused ops slice to k columns, ``fused_multi`` pads to k."""
    d, i = merge_inputs(2, Q, 8, "cpu", seed=3)
    args = (d[0, :, :3].contiguous(), i[0, :, :3].contiguous(), d[1], i[1])
    want = jops.get_merge_backend(merge)(
        *(jnp.asarray(a.numpy()) for a in args), K)
    _pair_equal(want, tops.get_merge_backend(merge)(*args, K), merge)


def test_merge_registry_names_and_errors():
    assert tops.merge_backend_names() == jops.merge_backend_names()
    with pytest.raises(ValueError, match="unknown merge backend"):
        tops.get_merge_backend("nope")
    with pytest.raises(ValueError, match="at least one shard list"):
        tops.tree_merge_lists(torch.zeros((0, 8, K)),
                              torch.zeros((0, 8, K), dtype=torch.int32), k=K)
    d, i = merge_inputs(2, 12, K, "cpu")
    with pytest.raises(ValueError, match="multiple of Q_TILE"):
        tmt.merge_topk_multi(d[0], i[0], k=K)
    with pytest.raises(ValueError, match="must be torch.int32"):
        tmt.merge_topk_lists(d[0, :8], i[0, :8].long(), d[1, :8], i[1, :8],
                             k=K)
