"""The port stands alone: importing it pulls in neither JAX nor ``repro``."""
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    expected = {m.name for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")], "repro_torch.")}
    assert int(n_modules) == len(expected) >= 15
    assert {"repro_torch.testing", "repro_torch.properties",
            "repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.launch.mesh"} <= expected
    archs = {p.stem for p in (ROOT / "src" / "repro" / "configs").glob(
        "*.py")} - {"__init__", "base"}
    assert len(archs) == 10
    assert {"repro_torch.configs", "repro_torch.configs.base",
            *(f"repro_torch.configs.{a}" for a in archs),
            "repro_torch.models", *(f"repro_torch.models.{m}" for m in (
                "layers", "attention", "moe", "ssm", "model"))} <= expected
    assert {"repro_torch.train", *(f"repro_torch.train.{m}" for m in (
        "optimizer", "step", "checkpoint", "compression")),
        "repro_torch.data.lm", "repro_torch.launch.train"} <= expected
    assert {"repro_torch.dist.layout", *(f"repro_torch.launch.{m}" for m in (
        "specs", "dryrun", "hlo_stats"))} <= expected
    assert leaked == "[]", leaked


def _public_names(path: Path) -> set:
    """A module's ``__all__``, else its top-level public functions and
    upper-case constants, read from its source (importing the reference's
    ``launch/dryrun.py`` would set ``XLA_FLAGS`` in this process)."""
    import ast

    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return {e.value for e in node.value.elts}
    names = {n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}
    names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if getattr(t, "id", "").isupper()
              and not t.id.startswith("_")}
    return names


@pytest.mark.parametrize("module", ["specs", "hlo_stats", "dryrun", "mesh"])
def test_launch_names_match_reference(module):
    """The reference's public names of ``repro.launch.{specs, hlo_stats,
    dryrun, mesh}`` and ``repro.dist`` exist in the port's counterparts
    (``specs._DECODE_LOGICAL`` and ``_state_tail`` too)."""
    port = importlib.import_module(f"repro_torch.launch.{module}")
    want = _public_names(ROOT / "src" / "repro" / "launch" / f"{module}.py")
    assert want and want <= set(dir(port)), want - set(dir(port))
    if module == "specs":
        assert {"_DECODE_LOGICAL", "_state_tail"} <= set(dir(port))
    import repro_torch.dist as tdist

    ref_dist = _public_names(ROOT / "src" / "repro" / "dist" /
                             "__init__.py") - {"shard_map_compat"}
    assert ref_dist <= set(tdist.__all__), ref_dist - set(tdist.__all__)


def test_public_names_match_reference():
    """The reference's public names of ``repro.core``, ``repro.kernels``
    (less ``default_interpret``: the port has no interpret mode),
    ``repro.core.executor``, ``repro.configs``, ``repro.models`` and
    ``repro.train`` (less ``shard_map_compat``, a shim over JAX versions)
    all exist in the port, the last three exactly; each module of
    ``repro.models`` has its counterpart's names; ``executor.resolve_plan`` is
    ``plan.resolve_plan`` itself; ``level_counts`` equals the reference's
    at every level of one index."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    import repro.configs as rcfg
    import repro.core as rc
    import repro.core.executor as rex
    import repro.kernels as rk
    import repro.models as rm
    import repro.train as rt
    import repro_torch.configs as tcfg
    import repro_torch.core as tc
    import repro_torch.core.executor as tex
    import repro_torch.kernels as tk
    import repro_torch.models as tm
    import repro_torch.train as tt
    from repro_torch.core import plan as tplan

    assert set(rc.__all__) <= set(tc.__all__)
    assert set(rk.__all__) - {"default_interpret"} <= set(tk.__all__)
    assert set(rex.__all__) <= set(tex.__all__)
    assert set(rcfg.__all__) == set(tcfg.__all__)
    assert set(rm.__all__) == set(tm.__all__)
    assert set(rt.__all__) - {"shard_map_compat"} == set(tt.__all__)
    for sub in ("layers", "attention", "moe", "ssm", "model"):
        ref = importlib.import_module(f"repro.models.{sub}")
        port = importlib.import_module(f"repro_torch.models.{sub}")
        assert set(ref.__all__) <= set(port.__all__), sub
    for mod in (tc, tk, tex, tcfg, tm, tt):
        missing = [name for name in mod.__all__ if not hasattr(mod, name)]
        assert not missing, (mod.__name__, missing)
    assert tex.resolve_plan is tplan.resolve_plan
    assert tc.available_plans() == tplan.plan_names() == rc.available_plans()
    assert (tc.available_partitioners() == tc.partitioner_names()
            == rc.available_partitioners())
    with pytest.raises(AttributeError):
        tex.no_such_name  # noqa: B018

    pts = np.random.default_rng(0).uniform(0, 1000, (700, 2)).astype(
        np.float32)
    jidx = rc.build_index(jnp.asarray(pts), jnp.zeros(2), 1000.0, l_max=5,
                          th_quad=8)
    tidx = tc.build_index(torch.tensor(pts), torch.zeros(2), 1000.0,
                          l_max=5, th_quad=8)
    for level in range(6):
        np.testing.assert_array_equal(np.asarray(jidx.level_counts(level)),
                                      tidx.level_counts(level).numpy())


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither JAX nor the reference package."""
    src = (ROOT / "chip_smoke.py").read_text()
    for banned in ("import jax", "from jax", "import repro\n", "from repro ",
                   "from repro."):
        assert banned not in src, banned


_EXAMPLES_PROBE = """
import importlib.util, pathlib, sys
paths = sorted(pathlib.Path('examples_torch').glob('*.py'))
for p in paths:
    spec = importlib.util.spec_from_file_location('example_' + p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(paths), leaked)
"""


def test_examples_import_no_jax_and_no_reference():
    """The port's examples load the port alone: neither JAX nor ``repro``
    is imported by any of them, nor named in their source."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True, check=True)
    n_examples, leaked = out.stdout.strip().split(" ", 1)
    assert int(n_examples) == 4
    assert (ROOT / "examples_torch" / "train_lm.py").exists()
    assert leaked == "[]", leaked
    for path in (ROOT / "examples_torch").glob("*.py"):
        src = path.read_text()
        for banned in ("import jax", "from jax", "import repro\n",
                       "from repro ", "from repro.", "XLA_FLAGS"):
            assert banned not in src, (path.name, banned)
