"""Logical-axis sharding rules, in PyTorch.

Counterpart of ``repro/dist/sharding.py``.  A rule table maps each logical
axis name (``"batch"``, ``"query"``, ...) to zero or more mesh dimension
names; :meth:`LogicalRules.spec` turns the logical axes of one tensor into a
spec: a tuple with one entry per tensor dimension, each ``None``
(replicated), a mesh dimension name, or a tuple of names, the entries of
JAX's ``PartitionSpec``.

Spec construction applies three fixups, in order:
  1. **missing-axis filter**: mesh dimensions absent from the bound mesh are
     dropped (a ``("query",)`` mesh ignores the ``"object"`` binding);
  2. **dedup**: a mesh dimension shards at most one tensor dimension; the
     first binding wins;
  3. **divisibility fallback**: a mesh dimension whose size does not divide
     the tensor dimension is dropped (the dimension replicates instead).

The rules read only a mesh's ``mesh_dim_names`` and ``shape``, so they bind
to a ``torch.distributed.device_mesh.DeviceMesh`` and to the logical mesh of
:mod:`repro_torch.launch.mesh` alike, with or without a process group.
:meth:`LogicalRules.placements` turns a spec into DTensor placements, one a
mesh dimension: what :mod:`repro_torch.dist.layout` lays tensors by.

Not ported: ``shard_map_compat`` (a JAX-version shim; the port's plans run
one rank program per grid cell).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping

__all__ = [
    "DEFAULT_RULES",
    "SPATIAL_RULES",
    "LogicalRules",
    "current_rules",
    "logical_to_spec",
    "spec_placements",
    "use_rules",
]

# logical name -> mesh dimension | tuple of mesh dimensions | None (replicate)
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,
    "kv_seq": None,
    "act_kv_seq": None,
    "img": None,
    "embed": "data",
    "heads": "model",
    "kv": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": "model",
    "conv": None,
}

# The k-NN tick meshes name up to two dimensions: ``("query",)`` (the
# sharded plan), ``("object",)`` (the object-sharded plan) and the 2-D
# ``("query", "object")`` hybrid mesh.  The missing-axis fixup makes one
# table serve all three.  ``"cell"`` stays reserved.
SPATIAL_RULES: dict[str, str | tuple[str, ...] | None] = {
    "query": "query",
    "object": "object",
    "cell": None,
}


class LogicalRules:
    """A rule table bound to a mesh (what :func:`current_rules` returns)."""

    def __init__(self, mesh, rules: Mapping[str, str | tuple | None]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, logical_axes, shape=None) -> tuple:
        """One entry per logical axis: None, a mesh dimension name, or a
        tuple of them; ``shape`` (optional) enables the divisibility fixup."""
        axis_sizes = dict(zip(self.mesh.mesh_dim_names,
                              tuple(self.mesh.shape)))
        used: set[str] = set()
        entries = []
        for d, name in enumerate(logical_axes):
            binding = self.rules.get(name) if name is not None else None
            if binding is None:
                entries.append(None)
                continue
            if isinstance(binding, str):
                binding = (binding,)
            kept = []
            prod = 1
            for ax in binding:
                if ax not in axis_sizes or ax in used:  # filter + dedup
                    continue
                if shape is not None and shape[d] % (prod * axis_sizes[ax]):
                    continue  # divisibility fallback: replicate instead
                kept.append(ax)
                used.add(ax)
                prod *= axis_sizes[ax]
            entries.append(None if not kept
                           else kept[0] if len(kept) == 1 else tuple(kept))
        return tuple(entries)

    def placements(self, logical_axes, shape=None) -> tuple:
        """The spec as DTensor placements (:func:`spec_placements`)."""
        return spec_placements(self.spec(logical_axes, shape),
                               self.mesh.mesh_dim_names)


def spec_placements(spec, mesh_dim_names) -> tuple:
    """A spec as DTensor placements, one per mesh dimension: ``Shard(d)``
    on each mesh dimension that entry ``d`` names, ``Replicate()`` on the
    rest.  An entry naming several mesh dimensions (``("pod", "data")``)
    shards its tensor dimension over them in mesh order, as the
    ``PartitionSpec`` does; the entry must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a)
                for a in ((entry,) if isinstance(entry, str) else entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} lists the mesh "
                             f"dimensions out of the mesh's order "
                             f"{tuple(names)}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


_local = threading.local()


def current_rules() -> LogicalRules | None:
    """The active rule table, or None outside any :func:`use_rules` scope."""
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(mesh, overrides: Mapping[str, str | tuple | None] | None = None):
    """Bind ``DEFAULT_RULES`` (and per-experiment overrides) to ``mesh``."""
    merged = dict(DEFAULT_RULES)
    if overrides:
        merged.update(overrides)
    prev = current_rules()
    _local.rules = LogicalRules(mesh, merged)
    try:
        yield _local.rules
    finally:
        _local.rules = prev


def logical_to_spec(logical_axes, shape=None) -> tuple:
    """Logical axes (and an optional shape for divisibility) -> spec."""
    lr = current_rules()
    if lr is None:
        raise RuntimeError("logical_to_spec needs an active use_rules(mesh) "
                           "scope")
    return lr.spec(logical_axes, shape)
