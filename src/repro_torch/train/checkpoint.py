"""Fault-tolerant checkpointing: atomic, step-indexed, in PyTorch.

Counterpart of ``repro/train/checkpoint.py``, with its layout and its keys:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, committed by renaming a
``.tmp`` directory, so a torn write is never taken for a checkpoint;
``restore_latest`` picks the newest complete step.  A leaf's key is its
path of dict keys joined by ``||``.

Arrays are saved as host numpy.  numpy has no bfloat16 without
``ml_dtypes``, and the reference's files hold a bf16 leaf as its 16 bits
(numpy dtype ``V2``): the port writes a bf16 leaf so and reads a ``V2``
leaf as bf16 bits, so a checkpoint written by either package restores into
the port bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch.distributed.tensor import DTensor

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step"]

_SEP = "||"


def _items(tree, path=()):
    """(key path, leaf) pairs of a tree of dicts, lists and leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, (*path, str(i)))
    else:
        yield _SEP.join(path), tree


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16).view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like, device) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a void leaf of {arr.dtype.itemsize} bytes is "
                             "not bf16 bits")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    dtype = like.dtype if torch.is_tensor(like) else t.dtype
    if isinstance(like, DTensor):
        # a laid leaf: the whole leaf read, this rank's shard kept
        from ..dist import lay

        local = like.to_local()
        return lay(t.to(dtype).to(device or local.device), like.placements,
                   like.device_mesh)
    dev = device if device is not None else (
        like.device if torch.is_tensor(like) else "cpu")
    return t.to(dtype).to(dev)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {key: _to_numpy(leaf) for key, leaf in _items(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "n_arrays": len(arrays), **(extra or {})}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree, device=None):
    """Restore into the structure and dtypes of ``like_tree``, each leaf on
    ``device`` (default: the like leaf's device); a DTensor like leaf
    keeps this rank's shard of the whole leaf, laid as it is."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, (*path, str(k))) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, (*path, str(i)))
                                  for i, v in enumerate(tree))
            return _from_numpy(data[_SEP.join(path)], tree, device)

        return walk(like_tree, ())


def restore_latest(directory: str, like_tree, device=None):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore_checkpoint(directory, step, like_tree, device), step
