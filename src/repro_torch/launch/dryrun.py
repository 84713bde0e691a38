"""Multi-pod dry run of the LM harness: lay every (arch x shape x mesh) cell
onto a fake process group of 256 or 512 ranks and trace one rank's step.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's jitted step against the production mesh of host
placeholder devices and reads XLA's memory and cost analyses and the
collectives in its HLO.  The port has no compiler to ask: it lays the
abstract state (``launch/specs.py``) onto the production mesh of a
``fake`` process group (``torch.distributed``'s testing backend: every
collective returns at once, nothing crosses a wire) as DTensors whose
local shards are fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage), and runs rank 0's program of the step -- ``make_train_step``,
``forward(..., logits_last_only=True)`` or ``decode_step`` -- under a
recording dispatch mode.  No device is used, by design, as the reference
uses placeholder devices.

What the record counts, all of it one rank's (its local shapes, not
DTensor's global ones):

- ``cost.flops``: the FLOPs of every local aten op
  (``torch.utils.flop_counter``'s formulas: matrix products, attention);
- ``cost.bytes_accessed``: the bytes each local op reads and writes (its
  tensor inputs and outputs; views move nothing).  Eager PyTorch fuses
  nothing, so that is what the port moves;
- ``collectives``: the ``c10d_functional`` collectives the rank issues, by
  kind, with each result's bytes (``hlo_stats.collective_stats``);
- ``memory.argument_size_in_bytes``: the local shards of the arguments;
  ``temp_size_in_bytes``: the peak of the bytes the step's own tensors
  hold at once, tracked by the same dispatch mode (a storage counts from
  the op that makes it until the last tensor seen on it is freed; views
  of an argument count nothing).  ``MemTracker`` is not used: it also
  counts the global-shape tensors of DTensor's sharding propagation.

The ops DTensor runs on global-shape fake tensors to propagate shardings
are not counted.  The port's layer loops are Python, so the full-depth
run sees every layer; the depth-1 and depth-2 runs are kept as the
reference keeps them (``cost`` extrapolates from them, ``raw_full_depth``
is the full count).  ``trace_s`` replaces ``lower_s`` and ``compile_s``.

The mesh's device type is ``cpu`` (the fake group's), where DTensor lays
a ``Shard(i) -> Shard(j)`` move as an all-gather, not an all-to-all.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.jsonl
  ... --override kv_seq=model --override seq=model
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeCell
from ..dist import use_rules
from ..models import decode_step, forward
from ..train import OptConfig, make_train_step
from .hlo_stats import COLLECTIVE_KINDS, collective_stats, roofline_terms
from .mesh import make_production_mesh
from .specs import (abstract_decode_state, abstract_train_state, input_specs,
                    materialize)

__all__ = ["LONG_OK", "cell_skip_reason", "default_overrides", "depth_units",
           "with_depth", "run_cell", "fake_group", "main"]

# long_500k requires sub-quadratic attention; pure full-attention archs skip
# it (DESIGN.md §5).  SWA / SSM / hybrid run it.
LONG_OK = {"h2o_danube_3_4b", "zamba2_7b", "rwkv6_3b"}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeCell) -> str | None:
    if shape.name == "long_500k" and cfg.arch_id not in LONG_OK:
        return "long_500k skipped: pure full (quadratic) attention arch"
    return None


def default_overrides(cfg: ModelConfig, shape: ShapeCell,
                      model_axis: int = 16) -> dict:
    """Arch-adaptive logical bindings (the reference's).

    When the head count does not divide the model axis (granite 24H,
    deepseek/yi 56H), attention scores cannot shard on heads: fall back to
    sequence parallelism (q-sequence -> 'model') for full-sequence kinds so
    the (S x S) score tile shards instead of replicating.
    """
    ov = {}
    if (shape.kind != "decode" and cfg.family != "ssm"
            and cfg.n_heads % model_axis != 0):
        # heads can't shard -> shard the q-sequence inside attention
        # instead (scores tile shards on q rows) and the residual stream
        # alongside
        ov["seq"] = "model"
        ov["act_seq"] = "model"
    if shape.kind != "decode" and cfg.sp_residual:
        # Megatron-SP: residual seq-sharded; blocks gather once at entry
        # and reduce-scatter at exit (act_seq stays unsharded)
        ov["seq"] = "model"
    if shape.kind == "decode":
        # weights-stationary decode: per-token activations are tiny --
        # replicate them instead of re-gathering FSDP-sharded weights every
        # token; caches stay on 'cache_batch'
        ov["batch"] = None
    return ov


def depth_units(cfg: ModelConfig):
    """(layers-per-unit, n_units) for linear cost extrapolation over
    depth (the reference's units)."""
    if cfg.family == "hybrid":
        u = cfg.shared_attn_every + 1
        return u, cfg.n_layers / u
    if cfg.family == "vlm":
        return cfg.cross_attn_every, cfg.n_layers / cfg.cross_attn_every
    if cfg.family == "encdec":
        return 1, cfg.n_enc_layers  # one unit = 1 enc + 1 dec layer
    return 1, cfg.n_layers


def with_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """Reduced-depth config with unrolled layer scans (the reference's;
    the port's loops are Python, so ``scan_unroll`` changes nothing)."""
    u, _ = depth_units(cfg)
    if cfg.family == "encdec":
        return dataclasses.replace(
            cfg, n_enc_layers=units, n_dec_layers=units, n_layers=2 * units,
            scan_unroll=True)
    return dataclasses.replace(cfg, n_layers=u * units, scan_unroll=True)


# ops that move no bytes: they make a tensor without writing it, or read
# metadata only
_NO_BYTES = {"empty", "empty_strided", "empty_like", "device", "detach",
             "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
             "sym_stride", "sym_numel", "wait_tensor"}


class _Recorder(TorchDispatchMode):
    """Counts one rank's local ops: FLOPs, bytes, collectives and the live
    bytes of the step's own storages.  Ops with DTensor arguments are
    passed on (``NotImplemented``) to DTensor, whose local ops come back
    here; ops DTensor runs to propagate shardings are skipped while
    ``paused``."""

    def __init__(self, arguments):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.paused = 0
        self.live = 0
        self.peak = 0
        self._count = {}  # storage key -> live tensors seen on it
        self._size = {}
        self._args = {self._key(t) for t in arguments}

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    @staticmethod
    def _nbytes(t) -> int:
        return t.numel() * t.element_size()

    def _track(self, t):
        key = self._key(t)
        if key in self._args:
            return
        if key not in self._count:
            self._count[key] = 0
            self._size[key] = t.untyped_storage().nbytes()
            self.live += self._size[key]
            self.peak = max(self.peak, self.live)
        self._count[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        self._count[key] -= 1
        if self._count[key] == 0:
            del self._count[key]
            self.live -= self._size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if any(t.device.type == "meta" for t in ins + outs):
            return out
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in COLLECTIVE_KINDS:
                self.collectives.append(
                    (name, sum(self._nbytes(o) for o in outs)))
        else:
            f = self.flop_registry.get(func.overloadpacket)
            if f is not None:
                self.flops += f(*args, **kwargs, out_val=out)
            if not func.is_view and name not in _NO_BYTES:
                self.bytes += sum(self._nbytes(t) for t in ins + outs)
        if not func.is_view:
            for o in outs:
                self._track(o)
        return out


@contextlib.contextmanager
def _outside_propagation(rec: _Recorder):
    """Pause ``rec`` while DTensor runs an op on global-shape fake tensors
    to propagate its shardings."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def paused(self, *args, **kwargs):
        rec.paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            rec.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _local_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _local_leaves(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _trace_cell(cfg: ModelConfig, shape: ShapeCell, accum: int, mesh):
    """Lay one cell's abstract state on ``mesh`` as fake DTensors and run
    rank 0's step under a recorder: (recorder, argument bytes, output
    bytes, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
        if shape.kind == "train":
            params, opt = abstract_train_state(cfg)
            params, opt = materialize((params, opt), mesh, "cpu")
            opt["step"] = opt["step"].to_local()
            batch = materialize(input_specs(cfg, shape), mesh, "cpu")
            args = (params, opt, batch)
            step = make_train_step(cfg, OptConfig(), accum=accum, mesh=mesh)

            def run():
                return step(params, opt, batch)
        elif shape.kind == "prefill":
            params, _ = abstract_train_state(cfg)
            params = materialize(params, mesh, "cpu")
            batch = materialize(input_specs(cfg, shape), mesh, "cpu")
            args = (params, batch)

            def run():
                with torch.no_grad():
                    return forward(params, cfg, batch,
                                   logits_last_only=True)[0]
        else:
            params, _ = abstract_train_state(cfg)
            params = materialize(params, mesh, "cpu")
            state = materialize(abstract_decode_state(cfg, shape), mesh,
                                "cpu")
            tok = materialize(input_specs(cfg, shape)["tokens"], mesh, "cpu")
            args = (params, state, tok)

            def run():
                with torch.no_grad():
                    return decode_step(params, cfg, state, tok,
                                       shape.seq_len - 1)[0:2]
        arg_leaves = _local_leaves(args)
        rec = _Recorder(arg_leaves)
        t0 = time.perf_counter()
        with _outside_propagation(rec), rec:
            out = run()
        seconds = time.perf_counter() - t0
        argument = sum(_Recorder._nbytes(t) for t in arg_leaves)
        arg_keys = {_Recorder._key(t) for t in arg_leaves}
        output = sum(_Recorder._nbytes(t) for t in _local_leaves(out)
                     if _Recorder._key(t) not in arg_keys)
        del out
    return rec, argument, output, seconds


def _cost(rec: _Recorder) -> dict:
    coll = collective_stats(rec.collectives)
    return {"flops": float(rec.flops), "bytes_accessed": float(rec.bytes),
            "collective_bytes": float(coll["total_bytes"]),
            "collectives": coll}


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks (this process is rank
    0), unless one of that size is already up."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is up; the cell needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: dict | None = None, accum: int = 1,
             cfg: ModelConfig | None = None, shape: ShapeCell | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record (the reference's keys where their meaning carries
    over).  ``cfg``, ``shape`` and ``mesh_shape`` (``(data, model)`` or
    ``(pod, data, model)``) replace the named config, shape and the
    production mesh: a smaller fake group for tests."""
    cfg = cfg or get_config(arch)
    shape = shape or next(s for s in SHAPES if s.name == shape_name)
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "kind": shape.kind, "overrides": overrides or {}}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        return rec
    model_axis = mesh_shape[-1] if mesh_shape else 16
    merged = default_overrides(cfg, shape, model_axis)
    merged.update(overrides or {})
    overrides = merged
    rec["overrides"] = overrides

    world = (int(torch.tensor(mesh_shape).prod()) if mesh_shape
             else 512 if multi_pod else 256)
    with fake_group(world):
        if mesh_shape:
            from .mesh import make_local_mesh

            names = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = make_local_mesh(**dict(zip(names, mesh_shape)))
        else:
            mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size()
        with use_rules(mesh, overrides):
            full, argument, output, trace_s = _trace_cell(cfg, shape, accum,
                                                          mesh)
            u, n_units = depth_units(cfg)
            c1 = _cost(_trace_cell(with_depth(cfg, 1), shape, accum,
                                   mesh)[0])
            c2 = _cost(_trace_cell(with_depth(cfg, 2), shape, accum,
                                   mesh)[0])

    rec["status"] = "ok"
    rec["trace_s"] = round(trace_s, 1)
    rec["memory"] = {
        "argument_size_in_bytes": argument,
        "output_size_in_bytes": output,
        "temp_size_in_bytes": full.peak,
        "bytes_per_device": argument + full.peak,
    }

    def extrap(key):
        return c1[key] + (n_units - 1.0) * (c2[key] - c1[key])

    flops = extrap("flops")
    bytes_accessed = extrap("bytes_accessed")
    coll_bytes = extrap("collective_bytes")
    rec["cost"] = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "collective_bytes": coll_bytes,
        "raw_full_depth": _cost(full),
        "depth1": {k: c1[k] for k in ("flops", "bytes_accessed",
                                      "collective_bytes")},
        "depth2": {k: c2[k] for k in ("flops", "bytes_accessed",
                                      "collective_bytes")},
        "n_units": n_units,
    }
    # schedule shape (kinds/counts) at 2 units, as the reference
    rec["collectives"] = c2["collectives"]

    # MODEL_FLOPS: 6·N·D train, 2·N·D forward-only (D = tokens this step)
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = (6 if shape.kind == "train" else 2) * n_active * tokens
    rec["model_flops"] = float(mf)
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = n_active
    rec["roofline"] = roofline_terms(flops, bytes_accessed, coll_bytes,
                                     n_chips, model_flops=mf)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--override", action="append", default=[],
                    help="logical=mesh_axis rebinding, e.g. "
                         "--override kv_seq=model")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = None if v in ("", "none", "None") else (
            tuple(v.split("+")) if "+" in v else v)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for s in SHAPES:
                cells.append((arch, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    ok = True
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               overrides=overrides or None, accum=args.accum)
            except Exception as e:
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                ok = False
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"# {arch} {shape} {rec['mesh']}: "
                      f"compute={r['compute_s']:.4f}s "
                      f"memory={r['memory_s']:.4f}s "
                      f"collective={r['collective_s']:.4f}s "
                      f"dominant={r['dominant']} "
                      f"useful={r.get('useful_flops_ratio', 0):.3f} "
                      f"(trace {rec['trace_s']}s)", file=sys.stderr,
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
