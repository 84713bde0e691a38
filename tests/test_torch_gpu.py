"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, where there is no
CUDA card.  On a machine with one (JAX is not needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import fused_scan as tfs
from repro_torch.kernels import merge_topk as tmt
from repro_torch.kernels.ops import _lex_sort_merge, topk_select_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import kernel_inputs, merge_inputs  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run this file on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32])
def test_fused_scan_kernel_matches_plain_and_exact(cuda, k):
    """Bitwise equal to the plain version and to the exact two-sort merge,
    on the edge rows of ``chip_smoke.kernel_inputs`` (bucket-edge lists
    included for k >= 5)."""
    args = kernel_inputs(256, 64, k, cuda, seed=k)
    before = tfs.fused_scan_merge.launches
    out_d, out_i = tfs.fused_scan_merge(*args, k=k)
    ref_d, ref_i = tfs.fused_scan_merge_ref(*args, k=k)
    torch.cuda.synchronize()
    assert tfs.fused_scan_merge.launches == before + 1
    assert torch.equal(out_d, ref_d) and torch.equal(out_i, ref_i)
    qpos = torch.stack(args[:2], 1)
    cpos = torch.stack(args[2:4], 2)
    lex_d, lex_i = _lex_sort_merge(qpos, cpos, *args[4:], k)
    assert torch.equal(out_d, lex_d) and torch.equal(out_i, lex_i)


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("r,k", [(1, 8), (3, 20), (4, 32), (8, 32)])
def test_merge_topk_multi_kernel_matches_plain_and_two_sort(cuda, r, k):
    """B2, bitwise, on ``chip_smoke.merge_inputs``'s edge rows."""
    d, i = merge_inputs(r, 1024, k, cuda, seed=r)
    d_cat = d.transpose(0, 1).reshape(1024, r * k).contiguous()
    i_cat = i.transpose(0, 1).reshape(1024, r * k).contiguous()
    before = tmt.merge_topk_multi.launches
    out = tmt.merge_topk_multi(d_cat, i_cat, k=k)
    torch.cuda.synchronize()
    assert tmt.merge_topk_multi.launches == before + 1
    assert _same(out, tmt.merge_topk_multi_ref(d_cat, i_cat, k=k))
    assert _same(out, topk_select_ref(d_cat, i_cat, k))


@pytest.mark.gpu
@pytest.mark.parametrize("ka,kb,k", [(32, 32, 32), (20, 32, 32), (8, 8, 12)])
def test_merge_topk_lists_kernel_matches_plain_and_two_sort(cuda, ka, kb, k):
    """B3, bitwise, lists narrower than k and k wider than the row too."""
    d, i = merge_inputs(2, 1024, max(ka, kb), cuda, seed=ka + kb)
    args = (d[0, :, :ka].contiguous(), i[0, :, :ka].contiguous(),
            d[1, :, :kb].contiguous(), i[1, :, :kb].contiguous())
    before = tmt.merge_topk_lists.launches
    out = tmt.merge_topk_lists(*args, k=k)
    torch.cuda.synchronize()
    assert tmt.merge_topk_lists.launches == before + 1
    assert _same(out, tmt.merge_topk_lists_ref(*args, k=k))
    two = topk_select_ref(torch.cat([args[0], args[2]], 1),
                          torch.cat([args[1], args[3]], 1), k)
    # the two-sort merge is as wide as the row when k exceeds it
    assert _same(tuple(o[:, :two[0].shape[1]] for o in out), two)
