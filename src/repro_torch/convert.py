"""Carry state between the JAX reference and the port.

The k-NN system has no weights: its state is the quadtree index.  These
helpers turn the reference's ``QuadtreeIndex`` fields, given as numpy arrays
(for example ``{f: np.asarray(getattr(idx, f)) for f in INDEX_FIELDS}``),
into the port's :class:`~repro_torch.core.quadtree.QuadtreeIndex` on a
device, and back, so both sweeps can run against one index.

The LM harness's weights cross as a nested dict of numpy arrays with the
reference's tree (:func:`params_from_numpy`, :func:`params_to_numpy`), and
its optimizer state (``m``, ``v`` and ``step``) the same way
(:func:`opt_from_numpy`, :func:`opt_to_numpy`).
numpy has no bfloat16 without ``ml_dtypes``, so a leaf arrives as float32
(exact for every bf16 value) or as the uint16 bits of a bf16 array, and
takes the dtype the port's own tree gives it.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.quadtree import INDEX_FIELDS, QuadtreeIndex
from .runtime import resolve_device

__all__ = ["INDEX_FIELDS", "index_from_numpy", "index_to_numpy",
           "params_from_numpy", "params_to_numpy", "opt_from_numpy",
           "opt_to_numpy"]

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


def params_from_numpy(tree: Mapping, cfg, device=None, mesh=None) -> dict:
    """A reference parameter tree of numpy leaves -> the port's, on
    ``device``.

    Every leaf of ``init_params(cfg)``'s tree must be there, with its
    shape; a float32 leaf is cast to the port leaf's dtype (bf16 where
    ``cfg.param_dtype`` says so, f32 where the reference keeps f32), a
    uint16 leaf is read as bf16 bits.  Given a ``DeviceMesh``, each leaf
    keeps this rank's shard as it lands, laid by ``param_logical(cfg)``
    (``dist.distribute_leaf``): a tree of DTensors.
    """
    from .models import init_params  # the LM package, for LM trees only

    return _tree_from_numpy(tree, init_params(cfg, device="meta"),
                            resolve_device(device), "params",
                            _laying(cfg, mesh))


def opt_from_numpy(opt: Mapping, cfg, device=None, mesh=None) -> dict:
    """The reference's optimizer state (``{"m", "v", "step"}``, numpy
    leaves) -> the port's, on ``device``: ``m`` and ``v`` float32 trees of
    the parameters' shapes (laid as the parameters on a ``DeviceMesh``),
    ``step`` an int32 scalar."""
    from .models import init_params

    dev = resolve_device(device)
    spec = init_params(cfg, device="meta")
    f32 = _retype(spec, torch.float32)
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt['step']: {step.dtype}{step.shape}, want an "
                         "int32 scalar")
    place = _laying(cfg, mesh)
    return {"m": _tree_from_numpy(opt["m"], f32, dev, "opt['m']", place),
            "v": _tree_from_numpy(opt["v"], f32, dev, "opt['v']", place),
            "step": torch.tensor(step, device=dev)}


def _laying(cfg, mesh):
    """The logical-axes tree of ``cfg``'s parameters where ``mesh`` is a
    ``DeviceMesh`` to lay them on, else None."""
    from .dist import is_rank_mesh
    from .models import param_logical

    return (param_logical(cfg), mesh) if is_rank_mesh(mesh) else None


def opt_to_numpy(opt) -> dict:
    """The port's optimizer state -> numpy (float32 moments, int32 step)."""
    return {"m": params_to_numpy(opt["m"]), "v": params_to_numpy(opt["v"]),
            "step": np.asarray(opt["step"].cpu().numpy(), np.int32)}


def _retype(spec, dtype):
    if isinstance(spec, dict):
        return {k: _retype(v, dtype) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=dtype, device="meta")


def _tree_from_numpy(tree: Mapping, spec, dev, name: str,
                     place=None) -> dict:
    """numpy leaves -> tensors of ``spec``'s tree and dtypes on ``dev``;
    ``name`` heads the errors.  ``place``: ``(logical tree, mesh)`` to
    keep each leaf's shard on this rank as it lands."""
    from .dist import distribute_leaf

    logical, mesh = place or (None, None)

    def walk(src, ref, path, axes=None):
        if isinstance(ref, dict):
            if not isinstance(src, Mapping) or set(src) != set(ref):
                got = sorted(src) if isinstance(src, Mapping) else type(src)
                raise ValueError(f"{name}{path}: keys {got}, want "
                                 f"{sorted(ref)}")
            return {k: walk(src[k], ref[k], f"{path}[{k!r}]",
                            None if axes is None else axes[k]) for k in ref}
        arr = np.asarray(src)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}{path}: shape {arr.shape}, want "
                             f"{tuple(ref.shape)}")
        if arr.dtype == np.uint16:
            if ref.dtype != torch.bfloat16:
                raise ValueError(f"{name}{path}: bf16 bits for a "
                                 f"{ref.dtype} leaf")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif arr.dtype == np.float32:
            t = torch.from_numpy(arr.copy()).to(ref.dtype)
        else:
            raise ValueError(f"{name}{path}: dtype {arr.dtype}; float32 or "
                             "uint16 bf16 bits")
        if axes is not None:
            return distribute_leaf(t.to(dev), axes, mesh)
        return t.to(dev)

    return walk(tree, spec, "", logical)


def params_to_numpy(params) -> dict:
    """The port's parameter tree -> float32 numpy leaves (exact for bf16
    and f32 leaves), in the reference's tree."""
    if isinstance(params, Mapping):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
