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

On a rank mesh (DTensor inputs) the reference's constraints lay the slots
on ``expert``: the routing is per batch row, so it runs on each rank's own
rows (replicated over ``model``); the dispatch gathers each rank's
experts' slots from its rows, and the combine scatter-adds them into a
partial sum over the expert ranks.  Those three regions are sorts,
gathers and scatters DTensor lays out no strategy for, so each runs on the
local shards (``local_map``) with the layouts the constraints give.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist import constrain, einsum, rank_rules, reshape, shard_range
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


def _route(probs, top_k: int, cap: int):
    """Per batch row: the slot tables ``inv_token`` (the token of each
    expert slot, ``S`` for an empty one) and ``gate_slot``, each
    (B, E*cap)."""
    b, s, n_experts = probs.shape
    gate, expert = _top_k(probs, top_k)  # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    n_slots = n_experts * cap
    dev = probs.device
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
    return inv_token, gate_slot


def _dispatch(x, inv3):
    """The slot rows: (B, S, d), (B, E, C) -> (B, E, C, d); an empty slot
    reads the zero row ``S``."""
    b, _, d = x.shape
    x_pad = torch.cat([x, torch.zeros((b, 1, d), dtype=x.dtype,
                                      device=x.device)], dim=1)
    rows = torch.arange(b, device=x.device)[:, None]
    return x_pad[rows, inv3.reshape(b, -1)].reshape(*inv3.shape, d)


def _experts(xd, w_in, w_gate, w_out):
    """The experts' SwiGLU on their slots: (B, E, C, d) -> (B, E, C, d)."""
    h = torch.einsum("becd,edf->becf", xd, w_in)
    g = torch.einsum("becd,edf->becf", xd, w_gate)
    h = F.silu(g) * h
    return torch.einsum("becf,efd->becd", h, w_out)


def _combine(y_e, inv3, gate3, s: int):
    """The gated slot outputs scatter-added back to their tokens:
    (B, E, C, d) -> (B, S, d)."""
    b, n_experts, cap, d = y_e.shape
    contrib = (y_e * gate3.reshape(b, n_experts, cap, 1).to(y_e.dtype)
               ).reshape(b, n_experts * cap, d)
    rows = torch.arange(b, device=y_e.device)[:, None]
    y = torch.zeros((b, s + 1, d), dtype=y_e.dtype, device=y_e.device)
    y.index_put_((rows, inv3.reshape(b, -1)), contrib, accumulate=True)
    return y[:, :s]


def _partial_where_sharded(placements, sharded):
    """``placements`` with ``Partial()`` on every mesh dimension where
    ``sharded`` shards the slots (expert or capacity)."""
    return tuple(Partial() if isinstance(q, Shard) and q.dim in (1, 2)
                 else p for p, q in zip(placements, sharded))


def _local(fn, out_placements, in_grad_placements=None):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=None,
                     in_grad_placements=in_grad_placements)


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25):
    """x (B, S, d) -> ((B, S, d), router logits (B*S, E); over DTensors
    (B, S, E))."""
    b, s, d = x.shape
    lr = rank_rules() if isinstance(x, DTensor) else None
    if lr is None:
        logits = x.reshape(-1, d).float() @ params["router"].float()
        probs = torch.softmax(logits.reshape(b, s, n_experts), dim=-1)
    else:
        # (B, S, E): flattening a batch and a sequence sharded on two mesh
        # dimensions is a strided shard DTensor cannot cast
        logits = einsum("bsd,de->bse", x.float(), params["router"].float())
        probs = torch.softmax(logits, dim=-1)
    # slots per expert and batch row: Python's round, at least 1
    cap = int(max(1, round(s * top_k / n_experts * capacity_factor)))
    if lr is None:
        inv_token, gate_slot = _route(probs, top_k, cap)
        inv3 = inv_token.reshape(b, n_experts, cap)
        gate3 = gate_slot.reshape(b, n_experts, cap)
        xd = _dispatch(x, inv3)  # (B, E, C, d)
    else:
        # the routing on each rank's rows, replicated over the rest
        rows = lr.placements(("batch", None, None), (b, s, n_experts))
        probs = probs.redistribute(probs.device_mesh, rows)
        slots = lr.placements(("batch", None), (b, n_experts * cap))
        inv_token, gate_slot = _local(
            lambda p: _route(p, top_k, cap), (slots, slots))(probs)
        # the slot table is integer: no gradient flows through it
        inv_token = inv_token.detach()
        # the tables laid in the expert layout first, so that the gather
        # below is local to each expert rank
        inv3 = constrain(reshape(inv_token, b, n_experts, cap),
                         ("batch", "expert", "expert_cap"))
        x = x.redistribute(x.device_mesh, lr.placements(
            ("batch", None, None), (b, s, d)))
        grad_x = _partial_where_sharded(x.placements, inv3.placements)
        xd = _local(_dispatch, (inv3.placements,),
                    in_grad_placements=(grad_x, inv3.placements))(x, inv3)
    xd = constrain(xd, ("batch", "expert", "expert_cap", None))
    ws = [params[k].to(x.dtype) for k in ("w_in", "w_gate", "w_out")]
    if lr is None:
        y_e = _experts(xd, *ws)
    else:
        # each rank runs its experts on its slots, the weights gathered
        # over the other mesh dimensions (DTensor's own strategy for the
        # batched einsums views a non-contiguous local gradient)
        pl, grad = [], []
        for q in xd.placements:
            pl.append(Shard(0) if q.is_shard(1) else Replicate())
            grad.append(pl[-1] if not q.is_shard() or q.is_shard(1)
                        else Partial())
        ws = [w.redistribute(w.device_mesh, tuple(pl)) for w in ws]
        y_e = _local(_experts, (xd.placements,), in_grad_placements=(
            xd.placements,) + (tuple(grad),) * 3)(xd, *ws)
    y_e = constrain(y_e, ("batch", "expert", "expert_cap", None))

    # combine: the gated outputs scatter-added back to their tokens (a
    # partial sum over the expert ranks)
    if lr is None:
        y = _combine(y_e, inv3, gate3, s)
    else:
        # the gate table stays whole over the expert ranks and each takes
        # its slots' gates here (laying it out on ``expert`` would gather
        # its gradient along dimension 1, which faults under torch 2.11
        # with gloo on CUDA tensors): its gradient is a partial sum
        mesh = inv3.device_mesh
        edims = [i for i, q in enumerate(inv3.placements) if q.is_shard(1)]
        cdims = [i for i, q in enumerate(inv3.placements) if q.is_shard(2)]
        out = _partial_where_sharded(
            lr.placements(("batch", None, None), (b, s, d)), inv3.placements)
        grad_gate = _partial_where_sharded(gate_slot.placements,
                                           inv3.placements)

        def combine(ye, iv, gt):
            e0, ne = shard_range(mesh, edims, n_experts)
            c0, nc = shard_range(mesh, cdims, cap)
            gt = gt.reshape(gt.shape[0], n_experts, cap)
            return _combine(ye, iv, gt[:, e0:e0 + ne, c0:c0 + nc], s)

        y = _local(combine, (out,), in_grad_placements=(
            y_e.placements, inv3.placements, grad_gate))(y_e, inv3, gate_slot)
    y = constrain(y, ("batch", "seq", None))
    return y, logits
