"""Distribution utilities of the port: the logical-axis sharding rules and
the activation constraints.

Counterpart of ``repro/dist``.  ``use_rules(mesh, overrides)`` binds the
logical -> mesh dimension table to a mesh (a ``DeviceMesh`` or a logical
mesh of :mod:`repro_torch.launch.mesh`); :func:`logical_to_spec` reads it.
Model code calls ``constrain(x, logical_axes)`` at layer boundaries: a
DTensor ``redistribute`` under a scope bound to a ``DeviceMesh``, the
identity otherwise (:mod:`repro_torch.dist.layout`, with the helpers that
lay parameter trees onto a mesh).  ``shard_map_compat`` belongs to JAX and
is not ported.
"""
from __future__ import annotations

from .layout import (constrain, distribute_leaf, distribute_tree, einsum,
                     full_tree,
                     is_rank_mesh, lay, local_bytes, rank_rules,
                     replicate, reshape, shard_range, whole)
from .sharding import (
    DEFAULT_RULES,
    SPATIAL_RULES,
    LogicalRules,
    current_rules,
    logical_to_spec,
    spec_placements,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "SPATIAL_RULES",
    "LogicalRules",
    "constrain",
    "current_rules",
    "distribute_leaf",
    "distribute_tree",
    "einsum",
    "full_tree",
    "is_rank_mesh",
    "lay",
    "local_bytes",
    "logical_to_spec",
    "rank_rules",
    "replicate",
    "reshape",
    "shard_range",
    "spec_placements",
    "use_rules",
    "whole",
]
