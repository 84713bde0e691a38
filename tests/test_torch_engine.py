"""Parity: the port's evaluation entry points against the JAX package.

``TickEngine`` (the deprecation shim over a session), ``ServiceSpec``'s
``engine_config`` / ``from_engine``, the plan drivers behind
``knn_query_batch_chunked`` and its pipeline delegate, the sequential
``KDTree`` and the two examples of ``examples_torch/``.  Inputs come from the
same seeds through both packages' generators (held equal by
``test_torch_workloads.py``).  Every comparison of lists and counters is
bitwise (``np.array_equal`` on the raw bits, tolerance 0); ``candidates`` is
an f32 sum whose order differs between XLA and PyTorch, so it is compared
exactly only where every partial sum is an integer below 2**24
(:func:`_exact`).  The reference lays ``object_sharded`` onto a mesh of
devices, so that call runs once in a subprocess on 4 forced host devices.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as rdata
from repro.api import ServiceSpec as JaxSpec
from repro.core import EngineConfig as JaxConfig
from repro.core import KDTree as JaxKDTree
from repro.core import TickEngine as JaxEngine
from repro.core import build_index as jbuild
from repro.core import knn_query_batch_chunked as jchunked
from repro_torch.api import ServiceSpec
from repro_torch.convert import index_to_numpy
from repro_torch.core import (EngineConfig, KDTree, TickEngine, build_index,
                              knn_query_batch_chunked)
from repro_torch.core import pipeline as tpipeline
from repro_torch.data import make_workload

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N = 2000
SMALL = dict(k=8, l_max=6, th_quad=32, window=64, chunk=512)
PROBE = dict(k=8, window=64, chunk=512)
SIDE = 22_500.0


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def _exact(candidates) -> bool:
    """Integer counts summed in f32 are exact in any order below 2**24."""
    return float(candidates) < 2**24


def _engines(**cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (JaxEngine(JaxConfig(**cfg)),
                TickEngine(EngineConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("family,backend,rate", [
    ("network", "fused_bucket", 1.0),
    ("network", "dense_topk", 0.5),
    ("zipf", "fused_bucket", 1.0),
    ("hotspot_cluster", "fused_bucket", 1.0),
])
def test_tick_engine_run_matches_jax(family, backend, rate):
    """Three ticks of ``TickEngine.run`` on a skewed family: lists, qids,
    iterations, rebuild decisions, maintenance modes, shard counters and
    the index after the last tick; candidates where the sum is exact."""
    je, te = _engines(backend=backend, **SMALL)
    seen = []
    jr = je.run(rdata.make_workload(N, family, seed=1), 3, query_rate=rate)
    tr = te.run(make_workload(N, family, seed=1), 3, query_rate=rate,
                on_tick=seen.append)
    assert seen == tr and te.history == tr and te.tick == 3
    for t, (a, b) in enumerate(zip(jr, tr)):
        _bits(a.nn_idx, b.nn_idx, f"idx {t}")
        _bits(a.nn_dist, b.nn_dist, f"dist {t}")
        _bits(a.qids, b.qids, f"qids {t}")
        _bits(a.shard_iterations, b.shard_iterations, f"shard iters {t}")
        assert (a.tick, a.iterations, a.rebuilt, a.maintenance) == (
            b.tick, b.iterations, b.rebuilt, b.maintenance), t
        assert _exact(a.candidates) and a.candidates == b.candidates, t
    assert te.executor.backend == je.executor.backend == backend
    assert te.plan.name == je.plan.name == "single"
    ours = index_to_numpy(te.index)
    for field in ("pos", "ids", "codes", "starts", "leaf_level", "pyramid"):
        _bits(np.asarray(getattr(je.index, field)), ours[field], field)


def test_tick_engine_warns_and_needs_a_card_unless_told(monkeypatch):
    with pytest.warns(DeprecationWarning, match="KnnSession"):
        engine = TickEngine(EngineConfig(**SMALL), origin=(5.0, 6.0),
                            side=900.0, device="cpu")
    assert engine.session.spec == ServiceSpec.from_engine(
        EngineConfig(**SMALL), origin=(5.0, 6.0), side=900.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TickEngine(EngineConfig())
    index = build_index(torch.zeros((4, 2)), (0.0, 0.0), SIDE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn_query_batch_chunked(index, np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="lives on cpu"):
        knn_query_batch_chunked(index, np.zeros((2, 2), np.float32),
                                device="meta")


def test_engine_config_round_trips_match_jax():
    """``engine_config()`` and ``from_engine()`` carry every field, as the
    reference's do; ``EngineConfig`` has the reference's fields and
    defaults."""
    ours = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    for kw in ({}, dict(k=5, th_quad=20, l_max=6, window=16, chunk=64,
                        rebuild_factor=1.5, backend="fused_bucket",
                        plan="hybrid", mesh_shape=(2, 3),
                        partitioner="cost_balanced", precision="mixed",
                        merge="fused_multi", maintenance="incremental",
                        churn_budget=0.5, max_iters=77, origin=(1.0, 2.0),
                        side=500.0, delta_pad=32)):
        spec = ServiceSpec(**kw)
        cfg = spec.engine_config()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JaxSpec(**kw).engine_config())
        back = ServiceSpec.from_engine(cfg, origin=spec.origin,
                                       side=spec.side,
                                       delta_pad=spec.delta_pad)
        assert back == spec
        assert dataclasses.asdict(back) == dataclasses.asdict(
            JaxSpec.from_engine(JaxSpec(**kw).engine_config(),
                                origin=spec.origin, side=spec.side,
                                delta_pad=spec.delta_pad))


def _probe_inputs():
    """A zipf world at its second tick, and its indexes in both packages."""
    w = make_workload(N, "zipf", seed=2)
    w.advance()
    pos = w.positions()
    return (pos, build_index(torch.tensor(pos), (0.0, 0.0), SIDE, l_max=6,
                             th_quad=32),
            jbuild(jnp.asarray(pos), jnp.zeros(2), SIDE, l_max=6, th_quad=32))


def _same_stats(a, b):
    assert (a.iterations, a.leaves_visited) == (b.iterations,
                                                b.leaves_visited)
    assert _exact(a.candidates) and a.candidates == b.candidates


@pytest.mark.parametrize("backend,with_qid", [("fused_bucket", True),
                                              ("dense_topk", False)])
def test_knn_query_batch_chunked_single_matches_jax(backend, with_qid):
    """numpy in, numpy out; ``qid=None`` marks external queries; the batch
    (2,000 rows) pads to whole chunks and is stripped; ``with_aux`` gives
    the reference's host ``PlanAux``."""
    pos, index, jindex = _probe_inputs()
    qid = np.arange(N, dtype=np.int32) if with_qid else None
    ji, jd, js, jaux = jchunked(jindex, pos, qid, backend=backend,
                               with_aux=True, **PROBE)
    ti, td, ts, taux = knn_query_batch_chunked(index, pos, qid,
                                               backend=backend,
                                               with_aux=True, device="cpu",
                                               **PROBE)
    _bits(np.asarray(ji), ti, "idx")
    _bits(np.asarray(jd), td, "dist")
    assert ti.shape == (N, PROBE["k"])
    _same_stats(js, ts)
    assert taux.stats == ts
    for field in ("shard_candidates", "shard_iterations", "qcost_next",
                  "object_bounds"):
        _bits(getattr(jaux, field), getattr(taux, field), field)
    # the pipeline's delegate is the same driver
    di, dd, ds = tpipeline.knn_query_batch_chunked(
        index, pos, qid, backend=backend, device="cpu", **PROBE)
    _bits(ti, di)
    _bits(td, dd)
    assert ds == ts


def _jax_object_probe(out_path):
    """The reference's side of the object-axis probe (4 host devices)."""
    import jax

    assert jax.device_count() == 4, jax.device_count()
    pos, _, jindex = _probe_inputs()
    qid = np.arange(N, dtype=np.int32)
    out = {}
    for part in ("equal", "cost_balanced"):
        ii, dd, st, aux = jchunked(
            jindex, pos, qid, backend="fused_bucket", plan="object_sharded",
            num_devices=4, merge="fused_multi", partitioner=part,
            with_aux=True, **PROBE)
        rec = {"idx": ii, "dist": dd, "iterations": st.iterations,
               "candidates": np.float32(st.candidates),
               "leaves_visited": st.leaves_visited,
               "shard_candidates": aux.shard_candidates,
               "shard_iterations": aux.shard_iterations,
               "qcost_next": aux.qcost_next,
               "object_bounds": aux.object_bounds}
        for key, v in rec.items():
            out[f"{part}/{key}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_probe") / "out.npz"
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=4'\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_engine as T\n"
        f"T._jax_object_probe({str(out)!r})\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    return dict(np.load(out))


@pytest.mark.parametrize("partitioner", ["equal", "cost_balanced"])
def test_object_axis_probe_matches_single_and_jax_aux(jax_probe,
                                                      partitioner):
    """``object_sharded`` 4 with ``fused_multi`` and ``with_aux`` (the
    straggler-gap probe): its lists equal the port's ``single`` plan and
    the reference's mesh run; its counters and aux equal the reference's."""
    pos, index, _ = _probe_inputs()
    qid = np.arange(N, dtype=np.int32)
    si, sd, _ = knn_query_batch_chunked(index, pos, qid,
                                        backend="fused_bucket",
                                        device="cpu", **PROBE)
    oi, od, ost, aux = knn_query_batch_chunked(
        index, pos, qid, backend="fused_bucket", plan="object_sharded",
        num_devices=4, merge="fused_multi", partitioner=partitioner,
        with_aux=True, device="cpu", **PROBE)
    _bits(si, oi, "idx vs single")
    _bits(sd, od, "dist vs single")
    ref = {k.split("/", 1)[1]: v for k, v in jax_probe.items()
           if k.startswith(partitioner + "/")}
    _bits(ref["idx"], oi, "idx vs jax")
    _bits(ref["dist"], od, "dist vs jax")
    assert (int(ref["iterations"]), int(ref["leaves_visited"])) == (
        ost.iterations, ost.leaves_visited)
    assert _exact(ost.candidates)
    assert np.float32(ost.candidates) == ref["candidates"]
    for field in ("shard_candidates", "shard_iterations", "qcost_next",
                  "object_bounds"):
        _bits(ref[field], getattr(aux, field), field)
    assert aux.shard_candidates.size == 4


def test_tick_engine_never_uses_the_host_chunk_driver(monkeypatch):
    """The reference's serving contract: ``process_tick`` never routes
    through the pipeline's host chunk driver or the one-batch sweep."""

    def boom(*a, **k):  # pragma: no cover - fails the test if reached
        raise AssertionError("host chunk driver used inside process_tick")

    monkeypatch.setattr(tpipeline, "knn_query_batch_chunked", boom)
    monkeypatch.setattr(tpipeline, "knn_query_batch", boom)
    _, engine = _engines(k=4, th_quad=16, l_max=5, window=32, chunk=256)
    results = engine.run(make_workload(600, "network", seed=1), ticks=2)
    assert len(results) == 2
    assert results[0].nn_dist.shape == (600, 4)
    assert np.isfinite(results[1].nn_dist).all()


def test_kdtree_matches_jax_and_the_sweep():
    """The port's ``KDTree`` equals the reference's bit for bit (tree and
    answers) on a network world whose objects pile onto nodes; the sweep's
    lists agree with it by the reference's own rule (distances within
    rtol 1e-5, atol 1e-3; id sets equal strictly below the k-th)."""
    w = make_workload(N, "network", seed=6)
    w.advance()
    w.advance()
    pos = w.positions()
    rows = np.random.default_rng(0).choice(N, 400, replace=False)
    ours, theirs = KDTree(pos), JaxKDTree(pos)
    for field in ("idx", "split_dim", "split_val", "left", "right", "lo",
                  "hi", "bb_min", "bb_max"):
        _bits(getattr(theirs, field), getattr(ours, field), field)
    ri, rd = ours.query_batch(pos[rows], 8, qid=rows)
    ji, jd = theirs.query_batch(pos[rows], 8, qid=rows)
    _bits(ji, ri)
    _bits(jd, rd)
    index = build_index(torch.tensor(pos), (0.0, 0.0), SIDE, l_max=6,
                        th_quad=32)
    ii, dd, _ = knn_query_batch_chunked(index, pos[rows], rows,
                                        backend="fused_bucket",
                                        device="cpu", **PROBE)
    np.testing.assert_allclose(dd, rd, rtol=1e-5, atol=1e-3)
    for r in range(rows.size):
        kth = rd[r, 7]
        want = set(ri[r][rd[r] < kth * (1 - 1e-6)].tolist()) - {-1}
        got = set(ii[r][dd[r] < kth * (1 - 1e-6)].tolist()) - {-1}
        assert want == got, r
    assert (dd[:, 0] == 0).sum() > 10  # rows that tie at distance 0


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--objects", "2000"]),
    ("moving_objects_service", ["--distribution", "network",
                                "--backend", "fused_bucket"]),
    ("moving_objects_service", ["--distribution", "zipf", "--plan", "hybrid",
                                "--mesh", "2x2", "--merge", "fused_multi",
                                "--partitioner", "cost_balanced",
                                "--ingest", "delta", "--churn", "0.1",
                                "--maintenance", "incremental",
                                "--overlap"]),
    ("moving_objects_service", ["--distribution", "hotspot_cluster",
                                "--tenants", "2", "--ingest", "delta",
                                "--invalidation", "spatial",
                                "--collect", "stats"]),
])
def test_examples_run_on_the_cpu(name, argv, capsys):
    if name != "quickstart":
        argv = argv + ["--objects", "1500", "--ticks", "3", "--chunk",
                       "512"]
    assert _example(name).main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("matches brute force" if name == "quickstart"
            else "steady state") in out


def test_service_example_has_every_flag_of_the_reference():
    """Every flag of ``examples/moving_objects_service.py`` with its
    choices and default, plus ``--device``."""
    def flags(mod):
        parser = None

        class Stop(Exception):
            pass

        def grab(self, *a, **k):
            nonlocal parser
            parser = self
            raise Stop

        import argparse
        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            mod._parse_args()
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return {a.option_strings[0]: (a.default, a.choices)
                for a in parser._actions if a.option_strings[0] != "-h"}

    spec = importlib.util.spec_from_file_location(
        "reference_service", ROOT / "examples" / "moving_objects_service.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ours, theirs = flags(_example("moving_objects_service")), flags(ref)
    assert ours.pop("--device") == ("cuda", None)
    assert ours == theirs
