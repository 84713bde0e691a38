"""Train-step builders: the plain step, its data-parallel form on
``torch.distributed`` ranks, and the cross-pod variant, in PyTorch.

Counterpart of ``repro/train/step.py``.  The step is a plain function on
the parameter tree: ``torch.autograd.grad`` of ``loss_fn`` over the leaves,
the global-norm clip and AdamW (``train/optimizer.py``).  It writes the new
values into the ``params`` and ``opt`` tensors it is given and returns them:
at full width a second copy of the state would not fit beside the first.

- ``make_train_step(cfg, opt_cfg, accum, mesh=None)``: on one device, or,
  given a rank mesh whose ``data`` dimension has more than one rank and
  whose ``model`` dimension has one, each rank takes its contiguous shard
  of the batch rows and the ranks' f32 gradients and losses are gathered
  and averaged in rank order on every rank (what the reference's GSPMD
  step computes on a ``(data, 1)`` mesh), so every rank takes the same
  optimizer step.  With a ``model`` dimension above 1 the step is laid by
  the rule tables (tensor parallelism, ``--data D --model M``): the
  parameters and optimizer state are DTensors laid by the rule tables
  (``init_params(..., mesh=)``, ``dist.distribute_tree``; ``embed`` on
  ``data`` too, FSDP), the batch
  by ``launch.specs``' input layout, DTensor issues the collectives, the
  global norm sums each leaf's shard once over the mesh, and AdamW runs
  on each rank's shards with the clip inside, as on one device.
- ``make_train_step_crosspod``: each rank of the ``pod`` dimension takes
  its pod's rows of axis 0, and the gradients cross the pods through
  ``train/compression.py`` (int8 with error feedback, or f32).  Within a
  pod the step is ``make_train_step``'s over the pod's ``(data, model)``
  ranks: data-parallel with a ``model`` dimension of 1, laid by the rule
  tables on the pod's mesh ``mesh["data", "model"]`` above 1 (the
  reference's pod-manual ``shard_map`` with ``data`` and ``model`` left
  to GSPMD), the exchange then running on each rank's shards.  On a
  logical mesh (no process group) the pods run one after another in this
  process, with the ranks' arithmetic.

Both accumulate ``accum`` contiguous microbatches in f32
(``x.reshape(accum, -1, ...)[i]``); with ``accum == 1`` the gradients keep
the parameters' dtype, as the reference's do.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..dist import current_rules, is_rank_mesh, lay, use_rules
from ..launch.mesh import pod_mesh
from ..models import loss_fn
from .compression import (crosspod_mean, crosspod_mean_int8, int8_mean,
                          int8_mean_pods, pods_mean, rank_mean)
from .optimizer import (OptConfig, _clip_scale, adamw_step_, global_norm,
                        tree_leaves, tree_map, tree_unflatten)

__all__ = ["make_train_step", "make_train_step_crosspod", "grads_and_loss"]

f32 = torch.float32


def _value_and_grad(params, cfg: ModelConfig, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the forward never reads (the hybrid's one trailing block when
    # none trail) has a zero gradient, as in the reference
    grads = [torch.zeros_like(p) if g is None else _as_param(g, p)
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _as_param(g, p):
    """A DTensor gradient laid as its parameter (a partial sum reduced, a
    replicated leaf's shards taken); plain ones as they are."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def grads_and_loss(params, cfg: ModelConfig, batch, accum: int = 1):
    """(loss, grads) with optional sequential microbatch accumulation."""
    if accum <= 1:
        return _value_and_grad(params, cfg, batch)

    def micro(i):
        return {k: x.reshape(accum, -1, *x.shape[1:])[i]
                for k, x in batch.items()}

    first = tree_leaves(params)[0]
    loss_acc = torch.zeros((), dtype=f32, device=first.device)
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)
    for i in range(accum):
        loss, grads = _value_and_grad(params, cfg, micro(i))
        loss_acc = loss_acc + loss
        for a, g in zip(tree_leaves(g_acc), tree_leaves(grads)):
            a.add_(g.float())
        del grads
    scale = torch.tensor(1.0 / accum, dtype=f32, device=first.device)
    for a in tree_leaves(g_acc):
        a.mul_(scale)
    return loss_acc * scale, g_acc


def _rows(batch, n: int, i: int):
    """Shard ``i`` of ``n`` contiguous shards of every leaf's axis 0."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {k!r}: {x.shape[0]} rows do not split "
                             f"into {n} shards")
    return {k: x.reshape(n, -1, *x.shape[1:])[i] for k, x in batch.items()}


def _dim(mesh, name: str) -> tuple[int, int, object]:
    """(size, this rank's coordinate, group) of a mesh dimension; (1, 0,
    None) where the mesh has no such dimension or is logical."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if name not in names or not hasattr(mesh, "get_group"):
        return 1, 0, None
    i = names.index(name)
    size = mesh.shape[i]
    if size == 1:
        return 1, 0, None
    return size, mesh.get_coordinate()[i], mesh.get_group(name)


def laid(mesh) -> bool:
    """Whether a step on ``mesh`` is laid by the rule tables: a rank mesh
    with a ``model`` dimension above 1."""
    return is_rank_mesh(mesh) and _dim(mesh, "model")[0] > 1


def lay_batch(batch, mesh):
    """The whole batch, which every rank holds, laid by ``launch.specs``'
    input layout (each rank keeps its shard; DTensors pass through)."""
    from ..launch.specs import INPUT_LOGICAL

    lr = current_rules()
    return {k: x if isinstance(x, DTensor) else lay(
        x, lr.placements(INPUT_LOGICAL[k], tuple(x.shape)), mesh)
        for k, x in batch.items()}


def _scalar(t) -> torch.Tensor:
    """A replicated or partial DTensor scalar as a plain tensor, the same
    on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _laid_step(cfg, opt_cfg, accum, mesh, overrides):
    """The train step laid by the rule tables over ``mesh``'s ranks."""
    from torch.distributed.tensor.experimental import implicit_replication

    def step(params, opt, batch):
        bound = current_rules() is not None and current_rules().mesh == mesh
        with (contextlib.nullcontext() if bound
              else use_rules(mesh, overrides)), implicit_replication():
            loss, grads = grads_and_loss(params, cfg, lay_batch(batch, mesh),
                                         accum)
            params, opt, gnorm = _clip_and_update(params, opt, grads,
                                                  opt_cfg)
            loss = _scalar(loss)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return step


def _data_parallel(params, cfg, batch, accum, mesh):
    """(loss, grads) of this rank's ``data`` shard, averaged over the
    ``data`` ranks (f32) when there is more than one."""
    n, r, group = _dim(mesh, "data")
    if n == 1:
        return grads_and_loss(params, cfg, batch, accum)
    loss, grads = grads_and_loss(params, cfg, _rows(batch, n, r), accum)
    return (rank_mean(loss, group),
            tree_map(lambda g: rank_mean(g, group), grads))


def _clip_and_update(params, opt, grads, opt_cfg: OptConfig):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, opt_cfg.clip_norm)
    params, opt = adamw_step_(params, grads, opt, opt_cfg, scale)
    return params, opt, gnorm


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, accum: int = 1,
                    mesh=None, overrides=None):
    """(params, opt, batch) -> (params, opt, metrics), updating in place.
    ``mesh``: a rank mesh (``launch.mesh.make_local_mesh`` under a process
    group) whose ``data`` ranks share the batch; None on one device.  With
    a ``model`` dimension above 1 the parameters and optimizer state are
    laid trees (``init_params(..., mesh=)``, ``dist.distribute_tree``) and
    ``overrides`` rebind the
    rule table where no scope is bound to ``mesh`` already."""
    if laid(mesh):
        return _laid_step(cfg, opt_cfg, accum, mesh, overrides)

    def step(params, opt, batch):
        loss, grads = _data_parallel(params, cfg, batch, accum, mesh)
        params, opt, gnorm = _clip_and_update(params, opt, grads, opt_cfg)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_train_step_crosspod(cfg: ModelConfig, opt_cfg: OptConfig, mesh, *,
                             compress: bool = True, accum: int = 1):
    """The step on ``pod`` ranks with an explicit (optionally int8)
    cross-pod gradient exchange: (params, opt, err, batch) -> (params, opt,
    err, metrics), updating in place.  ``mesh`` is a ``("pod", "data",
    "model")`` mesh (``make_local_mesh(data, model, pod)``); the batch is
    the whole batch, of which each pod takes its rows of axis 0 and, within
    the pod, each ``data`` rank its shard.  State gains ``err``
    (``init_error_feedback``) when compressing: on a rank mesh each rank's
    own tree, on a logical mesh a list of one tree a pod.  With a ``model``
    dimension above 1 the parameters, optimizer state and ``err`` are laid
    trees on the pod's mesh ``launch.mesh.pod_mesh(mesh)``
    (``init_params(..., mesh=pod_mesh(mesh))``), one replica a pod, and
    the exchange runs on each rank's shards."""
    names = tuple(getattr(mesh, "mesh_dim_names", ()) or ())
    if "pod" in names and not hasattr(mesh, "get_group"):
        return _logical_crosspod(cfg, opt_cfg, mesh.shape[names.index("pod")],
                                 compress, accum)
    npod, pod, group = _dim(mesh, "pod")
    if laid(mesh):
        sub = pod_mesh(mesh)

        def pod_grads(params, batch):
            from torch.distributed.tensor.experimental import \
                implicit_replication

            _check_laid(params, sub)
            # the batch's rows on the pod's data ranks, as the reference
            # rebinds them inside its pod-manual region
            with use_rules(sub, {"batch": "data"}), implicit_replication():
                loss, grads = grads_and_loss(params, cfg,
                                             lay_batch(batch, sub), accum)
                return _scalar(loss), grads
    else:
        def pod_grads(params, batch):
            return _data_parallel(params, cfg, batch, accum, mesh)

    def step(params, opt, err, batch):
        rows = _rows(batch, npod, pod) if npod > 1 else batch
        loss, grads = pod_grads(params, rows)
        if npod > 1:
            if compress:
                grads, err = crosspod_mean_int8(grads, err, group)
            else:
                grads = crosspod_mean(grads, group)
            loss = rank_mean(loss, group)
        elif compress:  # one pod: the quantizer still runs, as on 1 device
            grads, err = int8_mean(grads, err, lambda t: [t])
        else:
            grads = tree_map(lambda g: g.float(), grads)
        params, opt, gnorm = _clip_and_update(params, opt, grads, opt_cfg)
        return params, opt, err, {"loss": loss, "grad_norm": gnorm}

    return step


def _check_laid(params, sub):
    """Refuse parameters that are not laid on the pod's mesh ``sub``."""
    for p in tree_leaves(params):
        if not isinstance(p, DTensor) or p.device_mesh != sub:
            raise ValueError(
                "make_train_step_crosspod with a model dimension above 1 "
                "takes parameters laid on the pod's mesh (init_params(..., "
                f"mesh=pod_mesh(mesh))), got a leaf on "
                f"{getattr(p, 'device_mesh', 'no mesh')}")


def _logical_crosspod(cfg, opt_cfg, npod: int, compress: bool, accum: int):
    """The cross-pod step with ``npod`` logical pods in this process."""

    def step(params, opt, err, batch):
        if compress and len(err) != npod:
            raise ValueError(f"a logical mesh of {npod} pods takes a list "
                             f"of {npod} error trees, got {len(err)}")
        losses, grads = [], []
        for p in range(npod):
            loss, g = grads_and_loss(params, cfg, _rows(batch, npod, p),
                                     accum)
            losses.append(loss)
            grads.append(g)
        if compress:
            mean, err = int8_mean_pods(grads, err)
        else:
            mean = tree_unflatten(grads[0], [
                pods_mean(list(leaves))
                for leaves in zip(*(tree_leaves(g) for g in grads))])
        del grads
        params, opt, gnorm = _clip_and_update(params, opt, mean, opt_cfg)
        return params, opt, err, {"loss": pods_mean(losses),
                                  "grad_norm": gnorm}

    return step
