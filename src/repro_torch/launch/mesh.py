"""Meshes of the port's execution plans, with or without a process group.

Counterpart of ``repro/launch/mesh.py``.  A mesh names the dimensions a plan
lays its shards on (``("query",)``, ``("object",)``, ``("query",
"object")``) and their sizes.

- **No process group**: the mesh is a :class:`LogicalMesh`, names and sizes
  over the one device a session runs on; the plan runs its grid cells one
  after another there.
- **Under an initialised process group** (``torch.distributed``): the mesh
  is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks,
  row-major, one grid cell per rank.  Its size must equal the world size
  (the reference takes the first n of more devices; a rank that owns no
  cell would have nothing to run).

``None`` for a size means every device: the world's ranks under a process
group, else the session's one device.  :func:`init_from_env` sets up the
process group from the environment ``python -m torch.distributed.run``
sets.  :func:`make_production_mesh` is the LM harness's 16x16 (or
2x16x16) mesh: logical without a process group, over the ranks of one of
exactly 256 (or 512) ranks, fake or real (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

__all__ = [
    "LogicalMesh",
    "make_production_mesh",
    "make_local_mesh",
    "pod_mesh",
    "make_query_mesh",
    "make_object_mesh",
    "make_spatial_mesh",
    "default_hybrid_shape",
    "world_size",
    "mesh_cell",
    "init_from_env",
]


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Dimension names and sizes over one device: no process group."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def world_size() -> int | None:
    """Ranks of the initialised process group, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def _count(num_devices: int | None) -> int:
    if num_devices is None:
        return world_size() or 1
    return int(num_devices)


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device_type: str | None = None):
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    world = world_size()
    if world is None:
        return LogicalMesh(names, shape)
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"a {names} mesh of shape {shape} lays {n} ranks, "
                         f"but the process group has {world}: the mesh size "
                         "must equal the world size")
    from torch.distributed.device_mesh import DeviceMesh

    # the mesh only names the ranks and builds their groups; the tensors a
    # plan gathers stay on their own device (gloo carries CUDA tensors too).
    # DTensors take the mesh's device type, so a model laid on the card
    # asks for "cuda" whatever the backend
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` with ``"pod"`` in front.  Under a process group its
    world must be exactly 256 (512) ranks; any other size raises, naming
    both numbers."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1,
                    device_type: str | None = None):
    """A small ``("data", "model")`` (or ``("pod", "data", "model")``) mesh.
    ``device_type``: the device of the DTensors laid on a rank mesh (default
    ``cuda`` under NCCL, else ``cpu``)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def pod_mesh(mesh):
    """The ``(data, model)`` mesh of this rank's pod: ``mesh["data",
    "model"]`` of a ``("pod", "data", "model")`` rank mesh (the ranks that
    share this rank's ``pod`` coordinate), the mesh itself where it has no
    ``pod`` dimension."""
    if "pod" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return mesh
    return mesh["data", "model"]


def make_query_mesh(num_devices: int | None = None):
    """The 1-D ``("query",)`` mesh of the sharded plan."""
    return _mesh((_count(num_devices),), ("query",))


def make_object_mesh(num_devices: int | None = None):
    """The 1-D ``("object",)`` mesh of the object-sharded plan."""
    return _mesh((_count(num_devices),), ("object",))


def make_spatial_mesh(query: int, objects: int):
    """The 2-D ``("query", "object")`` mesh of the hybrid plan, row-major:
    rank ``i * objects + j`` owns query shard ``i`` and object slice ``j``."""
    return _mesh((int(query), int(objects)), ("query", "object"))


def default_hybrid_shape(num_devices: int | None = None) -> tuple[int, int]:
    """Most balanced ``(query, object)`` factorization, ``query <= object``:
    8 -> (2, 4), 6 -> (2, 3), primes -> (1, n).  ``None`` is every device."""
    n = _count(num_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    q = max(d for d in range(1, int(n**0.5) + 1) if n % d == 0)
    return (q, n // q)


def mesh_cell(mesh) -> tuple[int, int] | None:
    """This rank's ``(query, object)`` cell of a rank mesh (a missing
    dimension counts 0), or None for a logical mesh."""
    if isinstance(mesh, LogicalMesh):
        return None
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord.get("query", 0), coord.get("object", 0)


def init_from_env(device: str = "cuda"):
    """Join the process group ``python -m torch.distributed.run`` describes.

    Returns None when the launcher's environment (``RANK``, ``WORLD_SIZE``)
    is absent.  Otherwise ``(device, backend)``: on the CPU gloo; on the
    card NCCL with ``cuda:{LOCAL_RANK}`` when every local rank has a card of
    its own, else gloo with ranks sharing the cards (``cuda:0`` on one).
    """
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    from ..runtime import resolve_device

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        if cards >= local_world:
            backend = "nccl"
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend)
    return dev, backend
