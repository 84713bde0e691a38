"""Tensors laid onto a ``DeviceMesh`` by the logical rules, as DTensors.

The reference lays parameters and inputs with ``NamedSharding``s built by
the rule tables, pins activations with ``constrain`` and lets XLA's GSPMD
insert the collectives.  The port's counterpart is DTensor
(``torch.distributed.tensor``): a spec entry becomes a placement
(:meth:`~repro_torch.dist.sharding.LogicalRules.placements`), ``constrain``
becomes ``redistribute``, and DTensor's sharding propagation issues the
``c10d_functional`` collectives.

Without a rule scope bound to a ``DeviceMesh`` every function here leaves
plain tensors as they are: one device, a logical mesh and the k-NN plans
never meet a DTensor.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .sharding import DEFAULT_RULES, LogicalRules, current_rules

__all__ = [
    "constrain",
    "einsum",
    "is_rank_mesh",
    "lay",
    "distribute_leaf",
    "distribute_tree",
    "local_bytes",
    "full_tree",
    "whole",
    "rank_rules",
    "replicate",
    "reshape",
    "shard_range",
]


def is_rank_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` over ranks (a logical mesh of
    :mod:`repro_torch.launch.mesh` is not)."""
    return mesh is not None and hasattr(mesh, "get_group")


def rank_rules(mesh=None) -> LogicalRules | None:
    """The active rule table where it is bound to a ``DeviceMesh`` (and to
    ``mesh``, when given), else None."""
    lr = current_rules()
    if lr is None or not is_rank_mesh(lr.mesh):
        return None
    if mesh is not None and lr.mesh != mesh:
        return None
    return lr


def constrain(x, logical_axes):
    """Lay ``x`` out by logical axis names (the reference's
    ``with_sharding_constraint``): ``x.redistribute`` to the placements the
    active rules give, where a rule scope is bound to a ``DeviceMesh`` and
    ``x`` is a DTensor; the identity otherwise (plain tensors, a logical
    mesh, no scope).  The reference's ``_manual_axes_active`` escape has no
    counterpart: the port runs no manual-axis regions."""
    if not isinstance(x, DTensor):
        return x
    lr = rank_rules(x.device_mesh)
    if lr is None:
        return x
    want = lr.placements(logical_axes, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` for two operands; over DTensors each rank
    multiplies its own shards (the reference leaves the product to GSPMD;
    DTensor's own einsum strides flattened dimensions, or shards them
    unevenly, where its views then fail).

    Per mesh dimension, in order of preference: a dimension only ``a``
    carries (the activations' batch or sequence) stays sharded and ``b`` is
    gathered; a dimension both carry to the output, or both contract,
    stays sharded on both (a contracted one gives a partial sum); a
    dimension only ``b`` carries (the weights' heads or features) stays
    sharded and ``a`` is gathered; a contracted dimension one of them
    shards is sharded on the other too.  Partial inputs are reduced
    first."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    a = _as_laid(a, mesh)
    b = _as_laid(b, mesh)
    shared = set(la) & set(lb)
    pa, pb, po, ga, gb = [], [], [], [], []
    for qa, qb in zip(a.placements, b.placements):
        ca = la[qa.dim] if qa.is_shard() else None
        cb = lb[qb.dim] if qb.is_shard() else None
        if ca is not None and ca not in shared:
            pick = ca
        elif ca is not None and ca == cb:
            pick = ca
        elif cb is not None and cb not in shared:
            pick = cb
        else:
            pick = ca or cb
        if pick is None:
            pa.append(Replicate()); pb.append(Replicate())
            po.append(Replicate()); ga.append(Replicate())
            gb.append(Replicate())
            continue
        pa.append(Shard(la.index(pick)) if pick in la else Replicate())
        pb.append(Shard(lb.index(pick)) if pick in lb else Replicate())
        po.append(Shard(out.index(pick)) if pick in out else Partial())
        # an operand that does not carry the sharded dimension gets a
        # partial gradient
        ga.append(pa[-1] if pick in la else Partial())
        gb.append(pb[-1] if pick in lb else Partial())
    a = a.redistribute(mesh, pa)
    b = b.redistribute(mesh, pb)
    return local_map(lambda x, y: torch.einsum(eq, x, y),
                     out_placements=(tuple(po),), in_placements=None,
                     in_grad_placements=(tuple(ga), tuple(gb)))(a, b)


def _as_laid(t, mesh):
    """A DTensor on ``mesh`` with partial sums reduced (a plain tensor
    replicated)."""
    if not isinstance(t, DTensor):
        return replicate(t, mesh)
    if any(p.is_partial() for p in t.placements):
        return t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                     for p in t.placements])
    return t


def _kept_dims(old, new) -> set:
    """The dimensions of a ``reshape`` from ``old`` to ``new`` that come
    through whole (same size at the same flat offset)."""
    starts, acc = {}, 1
    for e, n in enumerate(new):
        starts[acc, n] = e
        acc *= n
    kept, acc = set(), 1
    for d, n in enumerate(old):
        if (acc, n) in starts:
            kept.add(d)
        acc *= n
    return kept


def reshape(x, *shape):
    """``x.reshape(shape)``.  A DTensor whose shards a split or merged
    dimension cannot keep evenly (heads sharded finer than the groups they
    split into) is first replicated along those dimensions, then along all,
    where DTensor refuses the view: the reference's GSPMD lays such a
    reshape itself."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    try:
        return x.reshape(shape)
    except RuntimeError:
        pass
    new = torch.Size(shape) if -1 not in shape else torch.empty(
        x.shape, device="meta").reshape(shape).shape
    kept = _kept_dims(tuple(x.shape), tuple(new))
    pl = tuple(Replicate() if p.is_shard() and p.dim not in kept else p
               for p in x.placements)
    try:
        return x.redistribute(x.device_mesh, pl).reshape(shape)
    except RuntimeError:
        return x.redistribute(x.device_mesh, [Replicate()] * len(
            x.placements)).reshape(shape)


def shard_range(mesh, dims, n: int) -> tuple[int, int]:
    """(offset, width) of this rank's part of a dimension of ``n`` that
    the mesh dimensions ``dims`` shard evenly, nested in mesh order."""
    coord = mesh.get_coordinate()
    off, width = 0, n
    for i in dims:
        width //= mesh.size(i)
        off += coord[i] * width
    return off, width


def _local_slice(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t``: each ``Shard(d)`` in
    mesh order takes its coordinate's even part of dimension ``d``."""
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            step = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * step, step)
    return local


def lay(t: torch.Tensor, placements, mesh):
    """The whole tensor ``t`` as a DTensor on ``mesh`` with
    ``placements``: every rank holds ``t`` and keeps its own shard (a
    copy), so no collective runs."""
    local = _local_slice(t, placements, mesh).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_leaf(t: torch.Tensor, logical_axes, mesh, rules=None):
    """:func:`lay` by ``logical_axes`` under ``rules`` (default the active
    table where it is bound to ``mesh``, else ``DEFAULT_RULES``)."""
    if rules is None:
        rules = rank_rules(mesh) or LogicalRules(mesh, DEFAULT_RULES)
    return lay(t, rules.placements(logical_axes, tuple(t.shape)), mesh)


def distribute_tree(tree, logical_tree, mesh, rules=None):
    """A tree of whole tensors laid leaf by leaf onto ``mesh`` by
    ``logical_tree`` (``models.param_logical(cfg)``): the counterpart of
    the reference's ``specs._with_sharding``.  Where the whole tree would
    not fit beside its shards, lay each leaf as it is made
    (``init_params(..., mesh=)``, ``convert.params_from_numpy(...,
    mesh=)``)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, logical_tree[k], mesh, rules)
                for k, v in tree.items()}
    return distribute_leaf(tree, logical_tree, mesh, rules)


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree: a DTensor leaf's local shard, a
    plain leaf whole."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def whole(t):
    """A DTensor gathered whole on every rank (every rank takes part), a
    plain tensor as it is.  Each mesh dimension, innermost first, gathers
    its shards along dimension 0 of a contiguous copy (or sums a partial
    one) with a plain collective of its group: DTensor's own
    ``full_tensor`` of a shard past dimension 0 faults in gloo on CUDA
    tensors under torch 2.11."""
    if not isinstance(t, DTensor):
        return t
    import torch.distributed as dist

    mesh, local = t.device_mesh, t.to_local()
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if p.is_shard():
            part = local.movedim(p.dim, 0).contiguous()
            out = torch.empty((mesh.size(i) * part.shape[0],
                               *part.shape[1:]), dtype=part.dtype,
                              device=part.device)
            dist.all_gather_into_tensor(out, part, group=mesh.get_group(i))
            local = out.movedim(0, p.dim)
        elif p.is_partial():
            local = local.clone()
            dist.all_reduce(local, group=mesh.get_group(i))
    return local.contiguous()


def full_tree(tree):
    """Every DTensor leaf gathered whole (:func:`whole`; every rank takes
    part), plain leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(full_tree(v) for v in tree)
    return whole(tree)


def replicate(t, mesh):
    """A tensor every rank holds whole, as a replicated DTensor."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
