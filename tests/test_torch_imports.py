"""The port stands alone: importing it pulls in neither JAX nor ``repro``."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

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
    assert leaked == "[]", leaked


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
    assert int(n_examples) == 2
    assert leaked == "[]", leaked
    for path in (ROOT / "examples_torch").glob("*.py"):
        src = path.read_text()
        for banned in ("import jax", "from jax", "import repro\n",
                       "from repro ", "from repro.", "XLA_FLAGS"):
            assert banned not in src, (path.name, banned)
