"""Carry index state between the JAX reference and the port.

The system has no weights: its state is the quadtree index.  These helpers
turn the reference's ``QuadtreeIndex`` fields, given as numpy arrays (for
example ``{f: np.asarray(getattr(idx, f)) for f in INDEX_FIELDS}``), into the
port's :class:`~repro_torch.core.quadtree.QuadtreeIndex` on a device, and
back, so both sweeps can run against one index.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.quadtree import INDEX_FIELDS, QuadtreeIndex
from .runtime import resolve_device

__all__ = ["INDEX_FIELDS", "index_from_numpy", "index_to_numpy"]

_DTYPES = {
    "origin": np.float32, "side": np.float32, "pos": np.float32,
    "ids": np.int32, "codes": np.int32, "starts": np.int32,
    "leaf_level": np.int32, "pyramid": np.int32,
}


def index_from_numpy(fields: Mapping, *, l_max: int, th_quad: int,
                     device=None) -> QuadtreeIndex:
    """numpy fields (the names in ``INDEX_FIELDS``) -> the port's index."""
    dev = resolve_device(device)
    tensors = {}
    for name in INDEX_FIELDS:
        arr = np.asarray(fields[name])
        if arr.dtype != _DTYPES[name]:
            raise ValueError(f"index field {name!r} must be {_DTYPES[name]}, "
                             f"got {arr.dtype}")
        tensors[name] = torch.tensor(arr, device=dev)
    return QuadtreeIndex(**tensors, l_max=int(l_max), th_quad=int(th_quad))


def index_to_numpy(index: QuadtreeIndex) -> dict[str, np.ndarray]:
    """The port's index -> numpy fields (plus ``l_max`` and ``th_quad``)."""
    out = {name: getattr(index, name).cpu().numpy() for name in INDEX_FIELDS}
    out["l_max"] = index.l_max
    out["th_quad"] = index.th_quad
    return out
