"""Top-k routed mixture-of-experts FFN (granite-moe, qwen3-moe), in PyTorch.

Counterpart of ``repro/models/moe.py``: the sorted dispatch with its
inverse index.  Per batch row the (token, choice) pairs are sorted stably by
expert, each expert keeps its first ``cap`` pairs, and ``inv_token[e*C+c]``
names the token of slot c of expert e (the dummy zero row ``S`` for an
unfilled or dropped slot, gate 0).  Dispatch is a gather of those rows into
an (E, C, d) buffer, the experts run as batched einsums, and the combine is
a scatter-add of the gated outputs back to their tokens.

The router's top-k takes ties to the lowest expert index, as
``lax.top_k`` does (a stable descending sort; ``torch.topk`` promises no
order on ties).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Init, init_linear

__all__ = ["init_moe", "moe_logical", "moe_ffn"]


def init_moe(init: Init, d: int, ff: int, n_experts: int, dtype,
             lead: tuple = ()):
    return {
        "router": init_linear(init, d, n_experts, torch.float32, lead=lead),
        "w_in": init.normal((*lead, n_experts, d, ff), d ** -0.5, dtype),
        "w_gate": init.normal((*lead, n_experts, d, ff), d ** -0.5, dtype),
        "w_out": init.normal((*lead, n_experts, ff, d), ff ** -0.5, dtype),
    }


def moe_logical():
    return {
        "router": ("embed", None),
        "w_in": ("expert", "embed", "ff"),
        "w_gate": ("expert", "embed", "ff"),
        "w_out": ("expert", "ff", "embed"),
    }


def _top_k(probs, k: int):
    """The k largest along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25):
    """x (B, S, d) -> ((B, S, d), router logits (B*S, E))."""
    b, s, d = x.shape
    logits = x.reshape(-1, d).float() @ params["router"].float()
    probs = torch.softmax(logits.reshape(b, s, n_experts), dim=-1)
    gate, expert = _top_k(probs, top_k)  # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # slots per expert and batch row: Python's round, at least 1
    cap = int(max(1, round(s * top_k / n_experts * capacity_factor)))
    n_slots = n_experts * cap
    dev = x.device
    # per batch row: the pairs sorted stably by expert
    flat_e = expert.reshape(b, -1)  # (B, S*k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    token_of = order // top_k
    counts = F.one_hot(flat_e, n_experts).sum(1)  # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = torch.arange(s * top_k, device=dev) - torch.gather(
        starts, 1, sorted_e)
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, n_slots)  # drop bin
    gates_sorted = torch.gather(gate.reshape(b, -1), 1, order)
    inv_token = torch.full((b, n_slots + 1), s, dtype=torch.int64,
                           device=dev).scatter_(1, slot, token_of)[:, :n_slots]
    gate_slot = torch.zeros((b, n_slots + 1), dtype=torch.float32,
                            device=dev).scatter_(1, slot,
                                                 gates_sorted)[:, :n_slots]

    x_pad = torch.cat([x, torch.zeros((b, 1, d), dtype=x.dtype, device=dev)],
                      dim=1)
    rows = torch.arange(b, device=dev)[:, None]
    xd = x_pad[rows, inv_token].reshape(b, n_experts, cap, d)  # (B, E, C, d)

    h = torch.einsum("becd,edf->becf", xd, params["w_in"].to(x.dtype))
    g = torch.einsum("becd,edf->becf", xd, params["w_gate"].to(x.dtype))
    h = F.silu(g) * h
    y_e = torch.einsum("becf,efd->becd", h, params["w_out"].to(x.dtype))

    # combine: the gated outputs scatter-added back to their tokens
    contrib = (y_e * gate_slot.reshape(b, n_experts, cap, 1).to(y_e.dtype)
               ).reshape(b, n_slots, d)
    y = torch.zeros((b, s + 1, d), dtype=y_e.dtype, device=dev)
    y.index_put_((rows, inv_token), contrib, accumulate=True)
    return y[:, :s], logits
