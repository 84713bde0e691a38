"""Shared primitive layers: norms, MLPs, RoPE (pure functional), in PyTorch.

Counterpart of ``repro/models/layers.py``.  Params are plain nested dicts of
tensors.  ``constrain`` (``repro_torch.dist``) sits at the reference's
sites: a DTensor redistribution on a rank mesh, the identity on one
device.  ``*_logical`` functions return the parameter tree with
logical-axes tuples at the leaves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..dist import constrain, einsum, shard_range

__all__ = [
    "rms_norm",
    "init_linear",
    "dense",
    "init_mlp",
    "mlp_logical",
    "mlp",
    "rope",
    "apply_rope",
    "cross_entropy_loss",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
# the most f32 elements one random draw makes at a time, so that a
# full-width init needs one slab of f32 beside its leaves, not a leaf
_DRAW_ELEMS = 1 << 28


class Init:
    """Draws parameter leaves from one ``torch.Generator``.

    Every random leaf is drawn in f32 and then cast, as the reference
    draws them, slab by slab along its leading axis.  On the ``meta``
    device nothing is drawn: the leaves carry shapes and dtypes only.
    """

    def __init__(self, generator: torch.Generator | None, device,
                 place=None):
        self.generator = generator
        self.device = torch.device(device)
        # each leaf, as it is made, goes through ``place`` (one whole leaf
        # at a time: ``models.init_params`` keeps a rank's shard)
        self.place = place or (lambda t: t)

    def _draw(self, shape, dtype, fill):
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if self.device.type == "meta" or out.numel() == 0:
            return self.place(out)
        flat = out if out.ndim > 1 else out.view(-1, 1)
        rows = max(1, _DRAW_ELEMS // max(1, math.prod(flat.shape[1:])))
        for i in range(0, flat.shape[0], rows):
            blk = flat[i:i + rows]
            blk.copy_(fill(torch.empty(blk.shape, dtype=torch.float32,
                                       device=self.device)))
        return self.place(out)

    def normal(self, shape, scale: float, dtype, shift: float = 0.0):
        """``normal(shape) * scale + shift`` in f32, cast to ``dtype``."""
        def fill(buf):
            buf.normal_(generator=self.generator)
            buf.mul_(scale)
            return buf.add_(shift) if shift else buf
        return self._draw(tuple(shape), dtype, fill)

    def uniform(self, shape, scale: float, shift: float, dtype):
        """``uniform[0, 1)(shape) * scale + shift`` in f32, cast."""
        def fill(buf):
            return buf.uniform_(generator=self.generator).mul_(scale).add_(
                shift)
        return self._draw(tuple(shape), dtype, fill)

    def full(self, shape, value: float, dtype):
        return self.place(torch.full(tuple(shape), value, dtype=dtype,
                                     device=self.device))


def rms_norm(x, scale, eps: float = 1e-5):
    """RMS norm in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def init_linear(init: Init, d_in: int, d_out, dtype,
                scale: float | None = None, lead: tuple = ()):
    """A ``(*lead, d_in, d_out)`` weight, normal times ``d_in ** -0.5``
    (or ``scale``)."""
    shape = (d_in, d_out) if isinstance(d_out, int) else (d_in, *d_out)
    s = scale if scale is not None else d_in ** -0.5
    return init.normal((*lead, *shape), s, dtype)


def dense(x, w):
    """``x @ w`` with ``w`` cast to ``x``'s dtype, f32 accumulation (the
    GEMMs of both devices accumulate bf16 products in f32), the result in
    ``x``'s dtype.  DTensors multiply their shards (``dist.einsum``)."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        lead = "abcefgh"[:x.ndim - 1]
        return einsum(f"{lead}d,dz->{lead}z", x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------- MLP


def init_mlp(init: Init, d: int, ff: int, activation: str, dtype,
             lead: tuple = ()):
    p = {
        "w_in": init_linear(init, d, ff, dtype, lead=lead),
        "w_out": init_linear(init, ff, d, dtype, lead=lead),
    }
    if activation == "swiglu":
        p["w_gate"] = init_linear(init, d, ff, dtype, lead=lead)
    return p


def mlp_logical(activation: str):
    p = {"w_in": ("embed", "ff"), "w_out": ("ff", "embed")}
    if activation == "swiglu":
        p["w_gate"] = ("embed", "ff")
    return p


def mlp(params, x, activation: str):
    h = dense(x, params["w_in"])
    if activation == "swiglu":
        g = dense(x, params["w_gate"])
        h = F.silu(g) * h
    elif activation == "relu2":  # squared ReLU (nemotron / Primer)
        h = torch.square(torch.relu(h))
    else:  # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, ("batch", "act_seq", "ff"))
    return dense(h, params["w_out"])


# ---------------------------------------------------------------- RoPE


def rope(positions, d_head: int, theta: float, dtype=torch.float32):
    """positions (...,) -> (cos, sin) of shape (..., d_head//2)."""
    half = d_head // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, dh//2) or (S, dh//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- loss


def _label_logit(logits, labels):
    """Each position's logit of its label: (B, S, V), (B, S) -> (B, S)."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def embed_sharded(table, tokens):
    """The rows of a DTensor table ``(V, d)`` for ``tokens``: the table
    gathered whole along ``d`` (the ``embed`` dimension, FSDP) and kept
    sharded along the vocabulary, each rank reads the tokens inside its
    slice (zero rows elsewhere), a partial sum over the vocab ranks (the
    reference leaves the gather to GSPMD)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, v = table.device_mesh, table.shape[0]
    vdims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    table = table.redistribute(mesh, tuple(
        Shard0 if i in vdims else Replicate()
        for i, Shard0 in enumerate(table.placements)))
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = tuple(Replicate() if i in vdims else p
                 for i, p in enumerate(tokens.placements))
    tokens = tokens.redistribute(mesh, rows)

    def look(w, tk):
        off, width = shard_range(mesh, vdims, v)
        tk = tk.long() - off
        inside = (tk >= 0) & (tk < width)
        out = w[torch.where(inside, tk, 0)]
        return torch.where(inside[..., None], out, 0.0)

    out = tuple(Partial() if i in vdims else p for i, p in enumerate(rows))
    # the table's gradient on a rank holds its own tokens' rows: a partial
    # sum over the mesh dimensions that shard the tokens
    grad = tuple(p if i in vdims else Partial() if rows[i].is_shard()
                 else p for i, p in enumerate(table.placements))
    return local_map(look, out_placements=(out,), in_placements=None,
                     in_grad_placements=(grad, rows))(table, tokens)


def _label_logit_sharded(logits, labels):
    """:func:`_label_logit` over a DTensor: the labels laid as the logits'
    rows, each rank picks the labels inside its slice of the vocabulary
    (zero elsewhere): a partial sum over the vocab ranks, if any."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, v, vdim = logits.device_mesh, logits.shape[-1], logits.ndim - 1
    vdims = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    rows = tuple(Replicate() if i in vdims else p
                 for i, p in enumerate(logits.placements))
    labels = labels.redistribute(mesh, rows)

    def pick(lg, lb):
        off, width = shard_range(mesh, vdims, v)
        lb = lb.long() - off
        inside = (lb >= 0) & (lb < width)
        got = torch.gather(lg, -1, torch.where(inside, lb, 0)[..., None])
        return torch.where(inside, got[..., 0], 0.0)

    out = tuple(Partial() if i in vdims else p for i, p in enumerate(rows))
    return local_map(pick, out_placements=(out,), in_placements=None,
                     in_grad_placements=(logits.placements, rows))(
                         logits, labels)


def _logsumexp_laid(logits):
    """``logsumexp`` over the last (vocab) dimension of a DTensor: each
    rank's maximum over its slice, their maximum (a max reduction), each
    rank's sum of ``exp(x - max)``, their sum, and its log plus the max.
    DTensor's own logsumexp over a sharded dimension is not used (torch
    2.11 faults in it on the card)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    rows = tuple(Replicate() if p.is_shard(vdim) else p
                 for p in logits.placements)
    top = tuple(Partial("max") if p.is_shard(vdim) else p
                for p in logits.placements)
    total = tuple(Partial() if p.is_shard(vdim) else p
                  for p in logits.placements)
    m = local_map(lambda lg: lg.detach().amax(-1), out_placements=(top,),
                  in_placements=None)(logits).redistribute(mesh, rows)
    s = local_map(lambda lg, mx: torch.exp(lg - mx[..., None]).sum(-1),
                  out_placements=(total,), in_placements=None,
                  in_grad_placements=(logits.placements, rows))(logits, m)
    return torch.log(s.redistribute(mesh, rows)) + m


def cross_entropy_loss(logits, labels, mask=None):
    """Mean next-token cross entropy; logits (B, S, V) cast to f32.  Over
    a DTensor the label logits are picked on each rank's rows and slice of
    the vocabulary, and summed (the reference leaves the gather to GSPMD;
    DTensor's gather builds its gradient at the global shape)."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        lse = _logsumexp_laid(logits)
        ll = _label_logit_sharded(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = _label_logit(logits, labels)
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
