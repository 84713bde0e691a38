"""The dry run (``repro_torch.launch.dryrun``) on a fake process group of 8
ranks, a ``(data, model) = (2, 4)`` mesh, with smoke configs: dense
(yi_34b), moe with 8 experts and top-2 (qwen3_moe_235b_a22b, the
reference's own reduced dry-run cell) and ssm (rwkv6_3b).

The reference's dry run cannot be held against: on this JAX its sharded
step raises while lowering (ROADMAP §C).  So the cells are held by what
must hold of any rank's program:

- every cell records collectives, and its FLOPs are one rank's (the
  ``(1, 1)`` mesh counts the whole step);
- a dense block adds two all-reduces on a rank: the partial sums over
  ``model`` of the attention's output projection and the MLP's down
  projection (the closed form, from the 1- and 2-layer prefills);
- the argument bytes are the sum of the local shards the specs lay out;
- the depth-1/depth-2 extrapolation equals the full-depth count;
- ``long_500k`` is skipped for a full-attention architecture and runs for
  the SSM, by the reference's rule.

The cells run in one subprocess: the fake group must not outlive them in a
test worker.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.dist import use_rules
from repro_torch.launch.dryrun import default_overrides
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.launch.specs import (abstract_train_state, input_specs,
                                      spec_paths)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
TIMEOUT_S = 300

TRAIN = ShapeCell("t", 16, 8, "train")
PREFILL = ShapeCell("p", 16, 8, "prefill")
DECODE = ShapeCell("d", 64, 8, "decode")
# the reference's reduced cells (tests/test_dist.py)
MOE_TRAIN = ShapeCell("t", 32, 8, "train")


def _moe():
    return dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"),
                               n_experts=8, top_k=2)


def _dense(layers: int):
    return dataclasses.replace(get_smoke_config("yi_34b"), n_layers=layers)


def _cells():
    """name -> (arch, cfg, shape, mesh shape)."""
    ssm = get_smoke_config("rwkv6_3b")
    return {
        "dense_train": ("yi_34b", _dense(2), TRAIN, MESH),
        "dense_decode": ("yi_34b", _dense(2), DECODE, MESH),
        "dense_prefill1": ("yi_34b", _dense(1), PREFILL, MESH),
        "dense_prefill2": ("yi_34b", _dense(2), PREFILL, MESH),
        "dense_train4": ("yi_34b", _dense(4), TRAIN, MESH),
        "dense_train_one": ("yi_34b", _dense(2), TRAIN, (1, 1)),
        "moe_train": ("qwen3_moe_235b_a22b", _moe(), MOE_TRAIN, MESH),
        "moe_decode": ("qwen3_moe_235b_a22b", _moe(), DECODE, MESH),
        "ssm_train": ("rwkv6_3b", ssm, TRAIN, MESH),
        "ssm_long": ("rwkv6_3b", ssm, ShapeCell("long_500k", 524_288, 1,
                                                "decode"), MESH),
        "dense_long": ("yi_34b", _dense(2), ShapeCell("long_500k", 524_288,
                                                      1, "decode"), MESH),
    }


def _main(out_path: str):
    """The subprocess: every cell's record, as JSON."""
    from repro_torch.launch.dryrun import run_cell

    recs = {}
    for name, (arch, cfg, shape, mesh) in _cells().items():
        recs[name] = run_cell(arch, shape.name, cfg=cfg, shape=shape,
                              mesh_shape=mesh)
    Path(out_path).write_text(json.dumps(recs))


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "recs.json"
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "import test_torch_dryrun as D\n"
            f"D._main({str(out)!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", ["dense_train", "dense_decode",
                                  "moe_train", "moe_decode", "ssm_train",
                                  "ssm_long"])
def test_cells_record_collectives(recs, name):
    rec = recs[name]
    assert rec["status"] == "ok", rec
    assert rec["collectives"]["total_count"] > 0
    assert rec["cost"]["raw_full_depth"]["collectives"]["total_count"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["bytes_per_device"] == (mem["argument_size_in_bytes"]
                                       + mem["temp_size_in_bytes"])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["n_chips"] == math.prod(MESH)


def test_flops_are_one_ranks(recs):
    """On 8 ranks a rank does less than half the step's FLOPs and the
    ranks together no fewer than one rank alone."""
    one = recs["dense_train_one"]["cost"]["raw_full_depth"]["flops"]
    eight = recs["dense_train"]["cost"]["raw_full_depth"]["flops"]
    assert recs["dense_train_one"]["collectives"]["total_count"] == 0
    assert eight < one / 2
    assert eight * math.prod(MESH) >= one


def test_dense_block_adds_two_all_reduces(recs):
    """Closed form: a dense block's prefill issues two all-reduces on a
    rank (the attention's output projection and the MLP's down projection
    sum their ``model`` shards); nothing else per layer is a partial sum."""
    one, two = (recs[f"dense_prefill{n}"]["cost"]["raw_full_depth"]
                ["collectives"]["count_by_kind"] for n in (1, 2))
    assert two.get("all-reduce", 0) - one.get("all-reduce", 0) == 2


def test_argument_bytes_are_the_local_shards(recs):
    """``argument_size_in_bytes`` of the dense train cell is the sum of
    the local shards of the params, the moments, the step and the batch as
    the specs lay them (each sharded dimension divided by its mesh
    dimensions' sizes)."""
    cfg = _dense(2)
    mesh = LogicalMesh(("data", "model"), MESH)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    with use_rules(mesh, default_overrides(cfg, TRAIN, MESH[-1])):
        params, opt = abstract_train_state(cfg)
        batch = input_specs(cfg, TRAIN)
    total = 0
    for leaf in spec_paths({"p": params, "o": opt, "b": batch}).values():
        n = math.prod(leaf.shape)
        for entry in leaf.spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[ax]
        total += n * leaf.dtype.itemsize
    assert recs["dense_train"]["memory"]["argument_size_in_bytes"] == total


def test_depth_extrapolation_equals_full_count(recs):
    """The port's layer loops are Python, so the full-depth count sees
    every layer: the reference's extrapolation from 1 and 2 layers equals
    it for the 4-layer dense step."""
    cost = recs["dense_train4"]["cost"]
    assert cost["n_units"] == 4
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert cost[key] == cost["raw_full_depth"][key], key


def test_long_500k_by_the_reference_rule(recs):
    skip = recs["dense_long"]
    assert skip["status"] == "skip"
    assert skip["reason"] == \
        "long_500k skipped: pure full (quadratic) attention arch"
    assert recs["ssm_long"]["status"] == "ok"
