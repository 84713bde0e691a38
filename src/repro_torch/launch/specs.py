"""Abstract input, parameter and state specs of the LM harness: shapes,
dtypes and specs, with nothing allocated.

Counterpart of ``repro/launch/specs.py``.  A spec leaf is a
:class:`SpecLeaf` ``(shape, dtype, spec)``, the counterpart of
``jax.ShapeDtypeStruct(..., sharding=NamedSharding(mesh, spec))``: the
spec is the active rule table's (:func:`repro_torch.dist.logical_to_spec`),
a tuple with the ``PartitionSpec``'s entries.  ``input_specs`` gives every
model input of an (arch x shape) cell; ``abstract_train_state`` and
``abstract_decode_state`` the parameters, the optimizer state and the
decode caches, their shapes from ``init_params(cfg, device="meta")`` and
``init_decode_state(..., device="meta")``.  They run inside
``dist.use_rules(mesh)``, on a logical mesh or a ``DeviceMesh`` alike.

:func:`materialize` turns a spec tree into DTensors on a ``DeviceMesh``:
local shards of the leaves' dtypes, on ``meta`` or under a
``FakeTensorMode`` (the dry run).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..dist import current_rules, logical_to_spec, spec_placements
from ..models import init_decode_state, init_params, param_logical

__all__ = [
    "INPUT_LOGICAL",
    "SpecLeaf",
    "input_specs",
    "abstract_params",
    "abstract_train_state",
    "abstract_decode_state",
    "shard_struct",
    "lay_decode_state",
    "materialize",
    "spec_paths",
]


@dataclasses.dataclass(frozen=True)
class SpecLeaf:
    """A leaf's global shape, dtype and spec (one entry a dimension)."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple


def _check_scope():
    assert current_rules() is not None, \
        "input_specs must run inside dist.use_rules(mesh)"


def shard_struct(shape, dtype, logical_axes) -> SpecLeaf:
    _check_scope()
    shape = tuple(int(s) for s in shape)
    return SpecLeaf(shape, dtype, logical_to_spec(logical_axes, shape))


# the logical axes of the full-sequence inputs (train and prefill)
INPUT_LOGICAL = {
    "tokens": ("batch", "seq"),
    # stub frontends: precomputed speech-frame / patch embeddings
    "frames": ("batch", "kv_seq", None),
    "img": ("batch", "img", None),
}


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Model inputs for one cell.  train/prefill: full sequences; decode:
    one new token (the KV cache / recurrent state lives in the decode
    state)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": shard_struct((b, 1), torch.int32, ("batch", None))}
    out = {"tokens": shard_struct((b, s), torch.int32,
                                  INPUT_LOGICAL["tokens"])}
    if cfg.family == "encdec":
        out["frames"] = shard_struct((b, s, cfg.d_model), torch.bfloat16,
                                     INPUT_LOGICAL["frames"])
    if cfg.family == "vlm":
        out["img"] = shard_struct((b, cfg.n_img_tokens, cfg.d_model),
                                  torch.bfloat16, INPUT_LOGICAL["img"])
    return out


def _with_sharding(tree, logical_tree, dtype=None):
    """Meta leaves -> spec leaves by the logical-axes tree."""
    if isinstance(tree, dict):
        return {k: _with_sharding(v, logical_tree[k], dtype)
                for k, v in tree.items()}
    return shard_struct(tree.shape, dtype or tree.dtype, logical_tree)


def abstract_params(cfg: ModelConfig):
    _check_scope()
    return _with_sharding(init_params(cfg, device="meta"),
                          param_logical(cfg))


def abstract_train_state(cfg: ModelConfig):
    """(params, opt): the moments take the parameters' specs in float32
    (``init_opt``'s dtype), ``step`` an int32 scalar, replicated."""
    _check_scope()
    meta = init_params(cfg, device="meta")
    logical = param_logical(cfg)
    params = _with_sharding(meta, logical)
    opt = {
        "m": _with_sharding(meta, logical, torch.float32),
        "v": _with_sharding(meta, logical, torch.float32),
        "step": SpecLeaf((), torch.int32, ()),
    }
    return params, opt


_DECODE_LOGICAL = {
    # kv caches: (layers, batch, kv_seq, kv_heads, head_dim)
    "kv": (None, "cache_batch", "kv_seq", "kv", None),
    "shared_kv": (None, "cache_batch", "kv_seq", "kv", None),
    "self_kv": (None, "cache_batch", "kv_seq", "kv", None),
    "cross_self_kv": (None, "cache_batch", "kv_seq", "kv", None),
    "cross_kv": (None, "cache_batch", "kv_seq", "kv", None),
}


def _decode_axes(names, ndim: int) -> tuple:
    """The reference's logical axes of one decode-state leaf, by the dict
    keys on its path."""
    kv_name = next((n for n in names if n in _DECODE_LOGICAL), None)
    if kv_name is not None:
        if ndim == 5:
            return _DECODE_LOGICAL[kv_name]
        # stacked differently (e.g. vlm grouped kv): batch then seq
        return tuple([None] * (ndim - 4)
                     + ["cache_batch", "kv_seq", "kv", None])
    if "img" in names or "mem" in names:
        return ("batch", "kv_seq", None)
    if ndim >= 2:
        # recurrent states: (layers..., batch, ...) -> batch on the DP axes
        lead = ndim - _state_tail(names, ndim)
        return tuple([None] * (lead - 1) + ["cache_batch"]
                     + [None] * (ndim - lead))
    return tuple([None] * ndim)


def _state_tail(names, ndim: int) -> int:
    """How many trailing dims follow the batch dim for recurrent state
    leaves."""
    # groups: (G, every, B, ...) -> 2 leading; trailing/blocks: (L, B, ...)
    if "groups" in names:
        return ndim - 3
    return ndim - 2


def abstract_decode_state(cfg: ModelConfig, shape: ShapeCell):
    """The decode state of one cell (``init_decode_state``'s tree of
    dicts and tuples) as spec leaves."""
    _check_scope()
    b, s = shape.global_batch, shape.seq_len
    meta = init_decode_state(cfg, b, s, mem_len=min(s, 4096), device="meta")

    def walk(t, names):
        if isinstance(t, dict):
            return {k: walk(v, names + [k]) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, names + [""]) for v in t)
        return shard_struct(t.shape, t.dtype, _decode_axes(names, t.ndim))

    return walk(meta, [])


def lay_decode_state(state, mesh):
    """A decode state (``init_decode_state``'s tree, seeded or not) laid
    onto the ``DeviceMesh`` ``mesh`` by :func:`abstract_decode_state`'s
    layout under the active rules: caches ``kv`` on ``model``,
    ``cache_batch`` on ``data``.  Plain leaves keep this rank's shard,
    DTensor leaves are redistributed."""
    from torch.distributed.tensor import DTensor

    from ..dist import current_rules, lay

    lr = current_rules()

    def walk(t, names):
        if isinstance(t, dict):
            return {k: walk(v, names + [k]) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, names + [""]) for v in t)
        pl = lr.placements(_decode_axes(names, t.ndim), tuple(t.shape))
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return lay(t, pl, mesh)

    return walk(state, [])


def spec_paths(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a tree of dicts and tuples, each path spelled
    as ``jax.tree_util.keystr`` spells it (``['kv'][0]``)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(spec_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(spec_paths(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def materialize(tree, mesh, device=None):
    """Spec leaves -> DTensors on the ``DeviceMesh`` ``mesh``: each rank's
    local shard made by ``torch.empty`` on ``device`` (on ``meta`` or under
    an active ``FakeTensorMode`` nothing is allocated)."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(tree, dict):
        return {k: materialize(v, mesh, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(materialize(v, mesh, device) for v in tree)
    pl = spec_placements(tree.spec, mesh.mesh_dim_names)
    local = list(tree.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = torch.empty(local, dtype=tree.dtype, device=device)
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(tree.shape),
                              stride=_contiguous_stride(tree.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
