"""Distribution utilities of the port: the logical-axis sharding rules.

Counterpart of ``repro/dist``.  ``use_rules(mesh, overrides)`` binds the
logical -> mesh dimension table to a mesh (a ``DeviceMesh`` or a logical
mesh of :mod:`repro_torch.launch.mesh`); :func:`logical_to_spec` reads it.
The reference's ``constrain`` belongs to the LM harness and
``shard_map_compat`` to JAX; neither is ported.
"""
from __future__ import annotations

from .sharding import (
    DEFAULT_RULES,
    SPATIAL_RULES,
    LogicalRules,
    current_rules,
    logical_to_spec,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "SPATIAL_RULES",
    "LogicalRules",
    "current_rules",
    "logical_to_spec",
    "use_rules",
]
