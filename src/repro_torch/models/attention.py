"""GQA / sliding-window / cross attention with KV-cache decode paths, in
PyTorch.

Counterpart of ``repro/models/attention.py``, in its order of operations:
plain einsums and a softmax in f32 (no fused attention kernel, whose
numerics would differ).  Weights: wq (d, Hq, dh), wk/wv (d, Hkv, dh), wo
(Hq, dh, d).  The KV cache of one layer is (k, v), each (B, S, Hkv, dh).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..dist import constrain, einsum, reshape, shard_range
from .layers import Init, apply_rope, init_linear, rope

__all__ = [
    "init_attn",
    "attn_logical",
    "attention",
    "attention_with_kv",
    "project_memory_kv",
    "attention_decode",
    "init_cache",
]

NEG_INF = -1e30


def init_attn(init: Init, d: int, n_heads: int, n_kv: int, d_head: int,
              dtype, lead: tuple = ()):
    return {
        "wq": init_linear(init, d, (n_heads, d_head), dtype, lead=lead),
        "wk": init_linear(init, d, (n_kv, d_head), dtype, lead=lead),
        "wv": init_linear(init, d, (n_kv, d_head), dtype, lead=lead),
        "wo": init.normal((*lead, n_heads, d_head, d),
                          (n_heads * d_head) ** -0.5, dtype),
    }


def attn_logical():
    return {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv", None),
        "wv": ("embed", "kv", None),
        "wo": ("heads", None, "embed"),
    }


def _proj(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` (over DTensors, ``dist.einsum``)."""
    return einsum("bsd,dhk->bshk", x, w)


def _proj_qkv(params, x, xk):
    q = _proj(x, params["wq"].to(x.dtype))
    k = _proj(xk, params["wk"].to(x.dtype))
    v = _proj(xk, params["wv"].to(x.dtype))
    return q, k, v


def _attend(q, k, v, mask):
    """Softmax attention: q (B,Sq,Hq,dh), k/v (B,Skv,Hkv,dh), GQA by
    head-group reshape -> (B,Sq,Hq,dh)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q = q.reshape(b, sq, hkv, g, dh)
    # the scores in f32 (the reference's preferred_element_type)
    scores = torch.einsum("bqhgk,bshk->bhgqs", q.float(), k.float()) * (
        dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", p, v)
    return out.reshape(b, sq, hq, dh)


def _attend_laid(q, k, v, mask):
    """:func:`_attend` on DTensors, each rank on its own rows, heads and
    query positions (the reference's scores einsum is left to GSPMD;
    DTensor's strides the flattened batch).  Per mesh dimension: where q
    or k shards the batch both do; q keeps a heads or query-sequence
    shard, k and v its heads shard only where q shards the heads alike,
    and replicate otherwise.  Each rank's query heads read their own KV
    heads (GQA), and the causal mask's rows are the rank's positions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    qp, kp = [], []
    for a, c in zip(q.placements, k.placements):
        if a.is_shard(0) or c.is_shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif a.is_shard(2) or a.is_shard(1):
            qp.append(a)
            kp.append(c if a.is_shard(2) and c.is_shard(2) else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    qdims = [i for i, p in enumerate(qp) if p.is_shard(2)]
    kdims = [i for i, p in enumerate(kp) if p.is_shard(2)]
    if kdims and (kdims != qdims or hq % hkv):
        kp = [Replicate() if p.is_shard(2) else p for p in kp]
        kdims = []
    sdims = [i for i, p in enumerate(qp) if p.is_shard(1)]
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    sq = q.shape[1]

    def local(ql, kl, vl):
        qo, hq_l = shard_range(mesh, qdims, hq)
        ko, _ = shard_range(mesh, kdims, hkv)
        so, sq_l = shard_range(mesh, sdims, sq)
        m = mask if mask is None or not sdims else mask[..., so:so + sq_l, :]
        if hq_l % g == 0:  # whole groups: their own KV heads
            lo, n = qo // g - ko, hq_l // g
        elif g % hq_l == 0:  # part of one group: its one KV head
            lo, n = qo // g - ko, 1
        else:  # a KV head for each query head
            idx = torch.arange(qo, qo + hq_l, device=ql.device) // g - ko
            return _attend(ql, kl.index_select(2, idx),
                           vl.index_select(2, idx), m)
        return _attend(ql, kl[:, :, lo:lo + n], vl[:, :, lo:lo + n], m)

    # k and v's gradients: partial sums where q shards what they replicate
    kg = tuple(c if c.is_shard() else Partial() if a.is_shard() else c
               for a, c in zip(qp, kp))
    return local_map(local, out_placements=(tuple(qp),), in_placements=None,
                     in_grad_placements=(tuple(qp), kg, kg))(q, k, v)


def _scores_to_out(params, q, k, v, mask):
    """q (B,Sq,Hq,dh), k/v (B,Skv,Hkv,dh); GQA by head-group reshape."""
    b, sq, hq, dh = q.shape
    if isinstance(q, DTensor):
        out = _attend_laid(q, k, v, mask)
    else:
        out = _attend(q, k, v, mask)
    out = constrain(reshape(out, b, sq, hq, dh),
                    ("batch", "act_seq", "heads", None))
    return einsum("bqhk,hkd->bqd", out, params["wo"].to(out.dtype))


def _causal_mask(sq: int, skv: int, window: int | None, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None, None, :, :]  # (1,1,1,Sq,Skv)


def attention(params, x, *, n_heads: int, n_kv: int, d_head: int,
              rope_theta: float, causal: bool = True,
              window: int | None = None, memory=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    ``memory``: if given, cross-attention over it (no mask, no rope on
    memory).  Returns (out, (k, v)): the kv pair for cache seeding.
    """
    b, s, _ = x.shape
    xk = memory if memory is not None else x
    q, k, v = _proj_qkv(params, x, xk)
    if memory is None:
        cos, sin = rope(torch.arange(s, device=x.device), d_head, rope_theta,
                        x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        mask = _causal_mask(s, s, window, x.device) if causal else None
    else:
        mask = None
    q = constrain(q, ("batch", "act_seq", "heads", None))
    k = constrain(k, ("batch", "act_kv_seq", "kv", None))
    v = constrain(v, ("batch", "act_kv_seq", "kv", None))
    out = _scores_to_out(params, q, k, v, mask)
    return out, (k, v)


def attention_with_kv(params, x, k, v, *, n_heads: int, n_kv: int,
                      d_head: int):
    """Cross-attention against precomputed memory k/v (the decode path:
    encoder or image memory is static while decoding, so its k/v are
    projected once, by :func:`project_memory_kv`)."""
    q = _proj(x, params["wq"].to(x.dtype))
    q = constrain(q, ("batch", "act_seq", "heads", None))
    return _scores_to_out(params, q, k.to(x.dtype), v.to(x.dtype), None)


def project_memory_kv(params, mem):
    """Project cross-attention memory k/v once (prefill-time seeding)."""
    k = _proj(mem, params["wk"].to(mem.dtype))
    v = _proj(mem, params["wv"].to(mem.dtype))
    return k, v


def init_cache(batch: int, n_kv: int, max_len: int, d_head: int, dtype,
               device=None):
    """Ring/linear KV cache for one layer: (k, v) of (B, S, Hkv, dh)."""
    shape = (batch, max_len, n_kv, d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x, cache, pos, *, n_heads: int, n_kv: int,
                     d_head: int, rope_theta: float,
                     window: int | None = None):
    """One-token decode: x (B, 1, d); cache (k, v) (B, Smax, Hkv, dh); pos
    an int.

    With ``window`` the cache is a ring buffer of size window: slot ``pos %
    Smax``, and once ``pos >= Smax`` every slot is valid.  As the
    reference's ``dynamic_update_slice``, a slot past the cache is clamped
    to its last row.  Returns (out (B,1,d), new_cache); the cache passed
    in is not written.
    """
    ck, cv = cache
    smax = ck.shape[1]
    pos = int(pos)
    q, k, v = _proj_qkv(params, x, x)
    cos, sin = rope(torch.tensor([pos], device=x.device), d_head, rope_theta,
                    x.dtype)  # (1, dh/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = pos % smax if window is not None else pos
    slot = min(max(slot, 0), smax - 1)
    ck = ck.clone()
    cv = cv.clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    kpos = torch.arange(smax, device=x.device)
    valid = kpos <= pos
    if window is not None:
        # ring buffer: after the wrap every slot holds one of the last Smax
        # positions
        valid = valid | (pos >= smax)
    mask = valid[None, None, None, None, :]
    out = _scores_to_out(params, q, ck, cv, mask)
    return out, (ck, cv)
