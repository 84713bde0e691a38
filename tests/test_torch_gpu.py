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
from repro_torch.kernels.ops import _lex_sort_merge

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import kernel_inputs  # noqa: E402


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
