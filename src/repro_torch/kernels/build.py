"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface.  A library is built at first use, from the checkout's sources
only, into ``build/torch_kernels/`` at the repository root, under a name keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so a fresh checkout builds once and an edited source or header rebuilds.
``build_all`` starts one ``nvcc`` per source at once.  :func:`build_seconds`
counts the seconds this process has spent building, which the session
reports as a tick's ``compile_s``.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``--fmad=false`` so that no multiply
and add is contracted behind the source's back; the kernels spell every fused
multiply-add they want as ``__fmaf_rn``.  Never ``--use_fast_math`` or
``-ftz=true``: the kernels are held bit for bit against their plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "library_path", "build_all",
           "load", "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_scan.cu", "merge_topk.cu", "pairwise_dist.cu",
           "topk_select.cu", "bucket_kselect.cu", "nav_walk.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}
# wall seconds this process spent in nvcc builds (the libraries it loads are
# process-wide too)
_BUILT_S = [0.0]


def build_seconds() -> float:
    """Seconds this process has spent building kernels so far."""
    return _BUILT_S[0]


def build_dir() -> Path:
    """``build/torch_kernels`` under the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: str) -> Path:
    """The built library of ``source``, keyed by a hash of the source, every
    shared header under ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return build_dir() / f"{Path(source).stem}-{tag}.so"


def _start(source: str, verbose: bool):
    out = library_path(source)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job, verbose: bool):
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {out.name}:\n{log}")
    if verbose and log:
        print(log.rstrip())
    os.replace(tmp, out)


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Build every source that is not built yet, all ``nvcc`` runs in parallel."""
    t0 = time.perf_counter()
    jobs = [_start(s, verbose) for s in SOURCES]
    for job in jobs:
        if job is not None:
            _finish(job, verbose)
    if any(jobs):
        _BUILT_S[0] += time.perf_counter() - t0
    return {s: library_path(s) for s in SOURCES}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed (cached)."""
    lib = _LOADED.get(source)
    if lib is None:
        t0 = time.perf_counter()
        job = _start(source, False)
        if job is not None:
            _finish(job, False)
            _BUILT_S[0] += time.perf_counter() - t0
        lib = ctypes.CDLL(str(library_path(source)))
        _LOADED[source] = lib
    return lib
