"""Cross-pod gradient compression (int8 + error feedback), in PyTorch.

Counterpart of ``repro/train/compression.py``.  The ``pod`` axis is a
``torch.distributed`` process group: each rank quantizes every gradient leaf
to int8 with a per-leaf amax scale, the int8 payload and the f32 scale go by
``all_gather``, and every rank dequantizes and takes the mean over the pods
in rank order.  No float reduction runs in flight, so every rank holds the
same bits.

A leaf laid over a pod's ``(data, model)`` ranks (a DTensor, the cross-pod
step with a ``model`` dimension above 1) is exchanged shard by shard: its
scale is the leaf's amax, the max of the shards' maxima over the pod's
ranks (exact in any order), each rank quantizes, keeps its residual and
dequantizes its own shard, and the rank at ``(p, d, m)`` gathers from every
``(p', d, m)``.  The means and the new errors come back laid as the
gradients, so no rank holds a whole leaf, and each element's bits are those
of the whole-leaf exchange.

The arithmetic is the one XLA's CPU program gives the reference (read from
its compiled text): the scale is ``amax * f32(1/127)`` (a division by a
constant becomes a multiply by its reciprocal), the residual is
``fma(-q, scale, g)``, and the mean is ``q_0 s_0``, then ``fma(q_r, s_r,
acc)`` for the later ranks, times ``f32(1/npod)``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..runtime import fma
from .optimizer import _recip, tree_leaves, tree_map, tree_unflatten

__all__ = ["crosspod_mean_int8", "crosspod_mean", "init_error_feedback"]

f32 = torch.float32


def init_error_feedback(params):
    """f32 zeros of the parameters' shapes; a DTensor parameter's laid as
    it is (each rank holds its shard)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)


def _quantize(g, amax=None):
    """(int8 payload, f32 scale) of ``g``; ``amax``: the leaf's max of
    ``|g|`` where ``g`` is one shard of it."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    amax = amax + torch.tensor(1e-12, dtype=f32, device=g.device)
    scale = amax * _recip(127, g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _gather(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def rank_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks, each rank's f32 copy
    gathered and summed in rank order on every rank, times ``f32(1/n)``.
    A DTensor's shards are averaged, and the mean laid as ``t``."""
    if isinstance(t, DTensor):
        return _laid_as(rank_mean(t.to_local(), group), t)
    return pods_mean(_exchange(group)(t.float()))


def _laid_as(local: torch.Tensor, ref: DTensor) -> DTensor:
    """This rank's shard ``local`` as a DTensor laid as ``ref``."""
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _exchange(group):
    """The gather of one value over ``group`` (the world when None), or a
    single pod's own value where no process group is initialised."""
    if not dist.is_initialized():
        return lambda t: [t]
    return lambda t: _gather(t, group)


def crosspod_mean_int8(grads, err, group=None):
    """Per-leaf int8 all-gather mean over ``group`` (the ``pod`` ranks; the
    world when None) with error feedback.  Returns (mean_grads, new_err)."""
    return int8_mean(grads, err, _exchange(group))


def _residual(g, e, amax=None):
    """(q, scale, new err) of one pod's leaf (or of its shard, with the
    leaf's ``amax``): int8 payload, f32 scale and the residual carried
    forward."""
    g = g.float() + e
    q, scale = _quantize(g, amax)
    return q, scale.reshape(1), fma(-q.float(), scale, g)


def _dequant_mean(qs, ss):
    """The mean of the pods' dequantized leaves, in pod order."""
    acc = qs[0].float() * ss[0]
    for qr, sr in zip(qs[1:], ss[1:]):
        acc = fma(qr.float(), sr, acc)
    return acc * _recip(len(qs), acc.device)


def int8_mean(grads, err, gather):
    """:func:`crosspod_mean_int8` over ``gather`` (a value -> the list of
    every pod's value, in rank order).  DTensor leaves: on their shards
    (:func:`_laid_int8_mean`)."""
    if isinstance(tree_leaves(grads)[0], DTensor):
        return _laid_int8_mean(grads, err, gather)
    means, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        q, scale, new_e = _residual(g, e)
        errs.append(new_e)
        means.append(_dequant_mean(gather(q), gather(scale)))  # int8, f32
    return tree_unflatten(grads, means), tree_unflatten(err, errs)


def _laid_int8_mean(grads, err, gather):
    """:func:`int8_mean` of DTensor leaves laid on one pod's ranks, each
    rank on its shards: the leaves' amaxes (of ``g + e``) in one max
    reduction over the pod's mesh, then each shard quantized with its
    leaf's scale, its residual kept and the pods' shards gathered and
    dequantized."""
    gs, es = tree_leaves(grads), tree_leaves(err)
    amax = torch.stack([torch.max(torch.abs(g.to_local().float()
                                            + e.to_local()))
                        for g, e in zip(gs, es)])
    mesh = gs[0].device_mesh
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(i))
    means, errs = [], []
    for i, (g, e) in enumerate(zip(gs, es)):
        q, scale, new_e = _residual(g.to_local(), e.to_local(), amax[i])
        errs.append(_laid_as(new_e, g))
        means.append(_laid_as(_dequant_mean(gather(q), gather(scale)), g))
    return tree_unflatten(grads, means), tree_unflatten(err, errs)


def int8_mean_pods(grads: list, errs: list):
    """:func:`crosspod_mean_int8` with every pod's gradients in this
    process (a logical ``pod`` axis): (mean_grads, [each pod's new err]),
    the same bits as the ranks'."""
    means, new = [], [[] for _ in grads]
    for leaves in zip(*(tree_leaves(g) for g in grads),
                      *(tree_leaves(e) for e in errs)):
        n = len(grads)
        parts = [_residual(g, e) for g, e in zip(leaves[:n], leaves[n:])]
        means.append(_dequant_mean([p[0] for p in parts],
                                   [p[1] for p in parts]))
        for pod, p in enumerate(parts):
            new[pod].append(p[2])
    return (tree_unflatten(grads[0], means),
            [tree_unflatten(errs[0], e) for e in new])


def pods_mean(values: list) -> torch.Tensor:
    """The f32 mean of one value a pod, summed in pod order, times
    ``f32(1/n)``: :func:`rank_mean`'s arithmetic in one process."""
    acc = values[0].float()
    for x in values[1:]:
        acc = acc + x.float()
    return acc * _recip(len(values), acc.device)


def crosspod_mean(grads, group=None):
    """Uncompressed baseline: the f32 mean over ``group``'s ranks."""
    return tree_map(lambda g: rank_mean(g, group), grads)
