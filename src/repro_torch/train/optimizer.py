"""AdamW on plain parameter trees with f32 moments and a global-norm clip,
in PyTorch.

Counterpart of ``repro/train/optimizer.py``, with the arithmetic XLA's CPU
program of the reference gives it (read from its compiled text):

- the warmup divides by a constant, which XLA turns into a multiply by its
  f32 reciprocal; the learning rate is ``warm * lr``;
- ``m2 = fma(b1, m, (1 - b1) * g)`` and ``v2 = fma(b2, v, (1 - b2) * g * g)``,
  ``1 - b1`` taken in double and rounded once, as the reference's Python
  float is;
- ``mhat / (sqrt(vhat) + eps)`` becomes ``m2 / (bc1 * (sqrt(vhat) + eps))``;
- ``delta = fma(p, wd, that)`` and the new ``p = fma(-lr, delta, p)``.

On identical inputs the update is bitwise the reference's on the CPU.  The
steps update their trees in place, leaf by leaf and a stacked leaf layer by
layer along its leading axis (:func:`_slices`), with the clip's scale
applied inside: at full width no second f32 tree of gradients and no f32
temporary of a whole stacked leaf is made.  The arithmetic per element is
the reference's.  :func:`adamw_update` and :func:`clip_by_global_norm` keep
the reference's functional form.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from ..runtime import fma, sqrt

__all__ = ["OptConfig", "init_opt", "adamw_update", "global_norm",
           "clip_by_global_norm"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in the reference's
    order, by ``leaves``."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    return fill(tree)


# the most elements of a 2-D leaf the optimizer takes at once
_SLICE_ELEMS = 1 << 24


def _slices(t: torch.Tensor):
    """A leaf as views the optimizer walks one at a time: a stacked matrix
    (3 or more dims) layer by layer along its leading axis, a large 2-D
    leaf (an embedding) in blocks of rows, else whole."""
    if t.dim() >= 3:
        return t.unbind(0)
    if t.dim() == 2 and t.numel() > _SLICE_ELEMS:
        return t.split(max(1, _SLICE_ELEMS // t.shape[1]))
    return (t,)


def init_opt(params):
    """Zero moments in f32 of the parameters' shapes (a DTensor leaf's
    moments take its layout) and an int32 step, a plain scalar on every
    rank."""
    first = _local(tree_leaves(params)[0])
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=f32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=f32), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree):
    """sqrt of the sum of squares over the leaves, each leaf's sum in f32
    (slice by slice, :func:`_slices`), the leaves added in the reference's
    order.  Over DTensor leaves: :func:`_laid_norm`."""
    leaves = tree_leaves(tree)
    if any(isinstance(leaf, DTensor) for leaf in leaves):
        return _laid_norm(leaves)
    total = None
    for leaf in leaves:
        for s in _slices(leaf):
            sq = torch.sum(torch.square(s.float()))
            total = sq if total is None else total + sq
    return sqrt(total)


def _laid_norm(leaves):
    """The global norm of DTensor leaves: each rank sums the squares of
    its shard of each leaf (slice by slice), counting a leaf that is
    replicated over a mesh dimension only at coordinate 0 there; one
    partial-sum reduction over the mesh gives every rank the same
    per-leaf sums, which are added in the reference's order.  A plain
    tensor on every rank."""
    from torch.distributed.tensor import Partial

    mesh = next(x for x in leaves if isinstance(x, DTensor)).device_mesh
    coord = mesh.get_coordinate()
    sums = []
    for leaf in leaves:
        local, own = leaf, all(c == 0 for c in coord)
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            own = all(p.is_shard() or c == 0
                      for p, c in zip(leaf.placements, coord))
        total = torch.zeros((), dtype=f32, device=local.device)
        if own:
            for s in _slices(local):
                total = total + torch.sum(torch.square(s.float()))
        sums.append(total)
    per_leaf = DTensor.from_local(torch.stack(sums), mesh,
                                  [Partial()] * mesh.ndim,
                                  run_check=False).full_tensor()
    total = per_leaf[0]
    for x in per_leaf[1:]:
        total = total + x
    return sqrt(total)


def _clip_scale(gn, max_norm: float):
    num = torch.tensor(max_norm, dtype=f32, device=gn.device)
    return torch.clamp(num / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _recip(n: int, device) -> torch.Tensor:
    """The f32 reciprocal of a constant, as XLA folds ``x / n``."""
    return (torch.tensor(1.0, dtype=f32, device=device)
            / torch.tensor(float(n), dtype=f32, device=device))


def _schedule(cfg: OptConfig, step):
    warm = torch.clamp((step + 1).float()
                       * _recip(max(cfg.warmup_steps, 1), step.device),
                       max=1.0)
    return warm * torch.tensor(cfg.lr, dtype=f32, device=step.device)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def adamw_step_(params, grads, opt, cfg: OptConfig, scale=None):
    """One AdamW step written into ``params`` and ``opt``'s tensors (grads
    multiplied by ``scale`` first when given, as the clip does); returns
    ``(params, opt)``, ``opt`` with its new step counter."""
    step = opt["step"] + 1
    dev = step.device
    lr = _schedule(cfg, step)

    def c(x):
        return torch.tensor(x, dtype=f32, device=dev)

    b1, b2, eps, wd = c(cfg.b1), c(cfg.b2), c(cfg.eps), c(cfg.weight_decay)
    c1, c2 = c(1 - cfg.b1), c(1 - cfg.b2)
    sf = step.float()
    bc1 = 1 - b1 ** sf
    bc2 = 1 - b2 ** sf
    neg_lr = -lr
    if isinstance(scale, DTensor):
        scale = scale.full_tensor()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        # DTensor leaves of one layout: the update runs on this rank's
        # shards, element for element the one-device arithmetic
        p, g, m, v = (_local(t) for t in (p, g, m, v))
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            g32 = gs.float()
            if scale is not None:
                g32 = g32 * scale
            m2 = fma(b1, ms, c1 * g32)
            v2 = fma(b2, vs, (c2 * g32) * g32)
            p32 = ps.float()
            delta = fma(p32, wd, m2 / (bc1 * (sqrt(v2 / bc2) + eps)))
            ps.copy_(fma(neg_lr, delta, p32).to(ps.dtype))
            ms.copy_(m2)
            vs.copy_(v2)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}


def adamw_update(params, grads, opt, cfg: OptConfig):
    """One AdamW step; grads may be any float dtype (accumulated in f32).
    Returns new trees; the inputs are left as they were."""
    params = tree_map(torch.clone, params)
    opt = {"m": tree_map(torch.clone, opt["m"]),
           "v": tree_map(torch.clone, opt["v"]), "step": opt["step"]}
    return adamw_step_(params, grads, opt, cfg)
