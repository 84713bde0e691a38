"""Roofline terms from the port's own record of a step: its collectives,
FLOPs and bytes, with an H100's published rates.

Counterpart of ``repro/launch/hlo_stats.py``.  The reference parses the
collectives out of XLA's post-partitioning HLO text; the port has no HLO:
:func:`collective_stats` takes the collectives a recording dispatch mode
saw one rank issue (``launch/dryrun.py``: each a ``c10d_functional`` op
and its result tensor) and sums, per kind, their count and the bytes of
each one's result on that rank (the reference's rule: result-shape bytes,
per device).  Kinds keep the reference's names.

``HW`` holds one NVIDIA H100 SXM's data-sheet figures (dense rates, at the
full 700 W limit): 989 TFLOP/s in bf16 on the tensor cores, HBM3 at
3.35 TB/s, and NVLink 4 at 450 GB/s a direction (18 links of 25 GB/s a
direction each; ``link_bw``, where the reference takes one TPU ICI link).
A roofline from them is an estimate for such a card, not a measurement.
"""
from __future__ import annotations

__all__ = ["collective_stats", "roofline_terms", "HW", "COLLECTIVE_KINDS"]

HW = {
    "card": "NVIDIA H100 80GB HBM3 (SXM)",
    "power_limit_w": 700.0,
    "peak_flops": 989e12,  # bf16 dense, tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "link_bw": 450e9,  # B/s, NVLink 4, one direction, all links
}

# c10d_functional op -> the reference's (HLO) collective name
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_stats(records) -> dict:
    """Sum result bytes and counts per collective kind over ``records``,
    ``(op name, result bytes)`` pairs (the op's name as
    ``c10d_functional`` spells it, e.g. ``all_gather_into_tensor``)."""
    bytes_by_kind: dict[str, int] = {}
    count_by_kind: dict[str, int] = {}
    for op, nbytes in records:
        kind = COLLECTIVE_KINDS.get(op, op)
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0) + int(nbytes)
        count_by_kind[kind] = count_by_kind.get(kind, 0) + 1
    return {
        "bytes_by_kind": bytes_by_kind,
        "count_by_kind": count_by_kind,
        "total_bytes": sum(bytes_by_kind.values()),
        "total_count": sum(count_by_kind.values()),
    }


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, n_chips: int, *,
                   model_flops: float | None = None) -> dict:
    """The three roofline terms, in seconds (the reference's formulae).

    ``flops``, ``bytes_accessed`` and ``collective_bytes`` are one rank's
    (the dry run counts each rank's local shapes)."""
    compute_s = flops / HW["peak_flops"]
    memory_s = bytes_accessed / HW["hbm_bw"]
    collective_s = collective_bytes / HW["link_bw"]
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "n_chips": n_chips,
    }
    dom = max(compute_s, memory_s, collective_s)
    terms["dominant"] = ("compute" if dom == compute_s
                         else "memory" if dom == memory_s else "collective")
    terms["bound_s"] = dom
    if model_flops is not None:
        terms["model_flops"] = model_flops
        terms["useful_flops_ratio"] = model_flops / max(flops * n_chips, 1.0)
    return terms
