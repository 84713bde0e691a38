"""Parity: the port's abstract specs and the dry run's pure functions
against the JAX package, on the CPU.

One JAX subprocess on 512 forced host devices dumps, for every
architecture x shape on the 16x16 and 2x16x16 production meshes, the
``(path, shape, dtype, spec entries)`` of every leaf of
``abstract_train_state``, ``input_specs`` and ``abstract_decode_state``,
and the outputs of ``launch/dryrun.py``'s ``cell_skip_reason``,
``default_overrides``, ``depth_units`` and ``with_depth``.  The reference's
``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so only that
subprocess imports it.  The port's specs run on its logical production
mesh (no process group) and must equal the reference's entry for entry.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.dist import use_rules
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import LogicalMesh, make_production_mesh
from repro_torch.launch.specs import (abstract_decode_state,
                                      abstract_train_state, input_specs,
                                      spec_paths)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": False, "2x16x16": True}
TIMEOUT_S = 240

_JAX = r"""
import dataclasses, json, sys
import jax
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.dist import use_rules
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (abstract_decode_state, abstract_train_state,
                                input_specs)


def entries(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = [list(e) if isinstance(e, tuple) else e
                for e in leaf.sharding.spec]
        spec += [None] * (len(leaf.shape) - len(spec))
        out[jax.tree_util.keystr(path)] = [list(leaf.shape),
                                           str(leaf.dtype), spec]
    return out


specs, fns = {}, {}
for name, multi in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        with use_rules(mesh):
            params, opt = abstract_train_state(cfg)
            specs[f"{name}/{arch}/params"] = entries(params)
            specs[f"{name}/{arch}/opt"] = entries(opt)
            for s in SHAPES:
                specs[f"{name}/{arch}/{s.name}/inputs"] = entries(
                    input_specs(cfg, s))
                specs[f"{name}/{arch}/{s.name}/decode"] = entries(
                    abstract_decode_state(cfg, s))
for arch in ARCH_IDS:
    cfg = get_config(arch)
    fns[f"{arch}/depth_units"] = list(D.depth_units(cfg))
    for u in (1, 2):
        fns[f"{arch}/with_depth{u}"] = dataclasses.asdict(
            D.with_depth(cfg, u))
    for s in SHAPES:
        fns[f"{arch}/{s.name}/skip"] = D.cell_skip_reason(cfg, s)
        for m in (16, 4):
            fns[f"{arch}/{s.name}/overrides{m}"] = D.default_overrides(
                cfg, s, m)
fns["LONG_OK"] = sorted(D.LONG_OK)
json.dump({"specs": specs, "fns": fns}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", _JAX, str(out)], env=env,
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _entries(tree) -> dict:
    out = {}
    for path, leaf in spec_paths(tree).items():
        spec = [list(e) if isinstance(e, tuple) else e for e in leaf.spec]
        out[path] = [list(leaf.shape), str(leaf.dtype).replace("torch.", ""),
                     spec]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(reference, mesh_name, arch):
    """Every leaf of the port's train state, inputs and decode state for
    ``arch`` on the production mesh: the reference's shape, dtype and spec
    entries, and no leaf more or less."""
    want = reference["specs"]
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    assert isinstance(mesh, LogicalMesh)
    cfg = get_config(arch)
    with use_rules(mesh):
        params, opt = abstract_train_state(cfg)
        got = {f"{mesh_name}/{arch}/params": _entries(params),
               f"{mesh_name}/{arch}/opt": _entries(opt)}
        for s in SHAPES:
            got[f"{mesh_name}/{arch}/{s.name}/inputs"] = _entries(
                input_specs(cfg, s))
            got[f"{mesh_name}/{arch}/{s.name}/decode"] = _entries(
                abstract_decode_state(cfg, s))
    for key, leaves in got.items():
        assert leaves == want[key], key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_functions_match_reference(reference, arch):
    """``cell_skip_reason``, ``default_overrides`` (model axis 16 and 4),
    ``depth_units`` and ``with_depth`` (1 and 2 units) equal the
    reference's for ``arch`` at every shape."""
    want = reference["fns"]
    cfg = get_config(arch)
    assert list(tdry.depth_units(cfg)) == want[f"{arch}/depth_units"]
    for u in (1, 2):
        assert dataclasses.asdict(tdry.with_depth(cfg, u)) == \
            want[f"{arch}/with_depth{u}"]
    for s in SHAPES:
        assert tdry.cell_skip_reason(cfg, s) == want[f"{arch}/{s.name}/skip"]
        for m in (16, 4):
            got = {k: list(v) if isinstance(v, tuple) else v
                   for k, v in tdry.default_overrides(cfg, s, m).items()}
            assert got == want[f"{arch}/{s.name}/overrides{m}"]
    assert sorted(tdry.LONG_OK) == want["LONG_OK"]


def test_production_mesh_sizes():
    """Without a process group the production meshes are logical, of the
    reference's names and sizes."""
    assert make_production_mesh() == LogicalMesh(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == LogicalMesh(
        ("pod", "data", "model"), (2, 16, 16))
