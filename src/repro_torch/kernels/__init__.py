"""Kernel layer: the hand-written CUDA kernels, their plain versions, backends.

The public names follow ``repro/kernels/__init__.py``: the padding wrappers
(``*_op``), the plain versions the kernels are held against (``*_ref``), the
mixed-precision prefilter and the SCAN / MERGE registries.  The CUDA sources
are built at first use (``build.py``), never at import.
"""
from .bucket_kselect import bucket_kselect_ref
from .delta_splice import (
    gather_splice,
    merge_ranks,
    searchsorted_pairs,
    sparse_splice_plan,
    splice_payload,
)
from .merge_topk import merge_topk_lists_ref
from .ops import (
    bucket_kselect_op,
    fused_scan_merge_op,
    get_merge_backend,
    get_scan_backend,
    merge_backend_names,
    merge_topk_lists_op,
    multi_merge_lists_op,
    pairwise_dist_op,
    register_merge_backend,
    register_scan_backend,
    scan_backend_names,
    topk_select_op,
    topk_select_ref,
    tree_merge_lists,
)
from .pairwise_dist import pairwise_dist_ref
from .refine import MIXED_WIDEN, mixed_prune_keep

__all__ = [
    "bucket_kselect_op",
    "fused_scan_merge_op",
    "merge_topk_lists_op",
    "multi_merge_lists_op",
    "pairwise_dist_op",
    "topk_select_op",
    "MIXED_WIDEN",
    "mixed_prune_keep",
    "bucket_kselect_ref",
    "merge_topk_lists_ref",
    "pairwise_dist_ref",
    "topk_select_ref",
    "get_scan_backend",
    "register_scan_backend",
    "scan_backend_names",
    "get_merge_backend",
    "register_merge_backend",
    "merge_backend_names",
    "tree_merge_lists",
    "merge_ranks",
    "searchsorted_pairs",
    "splice_payload",
    "sparse_splice_plan",
    "gather_splice",
]
