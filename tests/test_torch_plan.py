"""Parity: the port's mesh plans and object-sharded session against JAX.

The reference lays its plans onto a mesh of devices, so it runs once, in a
module-scoped subprocess on 8 forced host devices
(``--xla_force_host_platform_device_count=8``, as ``tests/test_plan.py``
does), and writes its results to an ``.npz``; the port runs the same inputs
on the CPU, every shard on the one device.  Every comparison is bitwise
(``np.array_equal`` on the raw bits, tolerance 0):

- ids and distances, always;
- per-shard candidates and iterations, object bounds and the cost EMA: the
  query boundaries come from f32 sums of per-query costs, whose order
  differs between XLA and PyTorch.  The inputs here keep every such sum
  exact (integer estimates, dyadic EMA values and weights, far below
  2**24), which :func:`_sums_exact` checks before the counters are compared;
- the session's rebuild decisions, maintenance modes and ``object_shards``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.core import plan as tplan
from repro_torch.core.executor import resolve_executor
from repro_torch.core.pipeline import default_max_nav
from repro_torch.core.quadtree import build_index
from repro_torch.data.generators import make_workload

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIDE, L_MAX, TH = 1000.0, 5, 16
K, WINDOW, CHUNK, N = 6, 32, 64, 700

# (name, plan, mesh_shape, partitioner, merge, data family, ticks)
CASES = [
    ("sh3_eq", "sharded", 3, "equal", None, "uniform", 1),
    ("sh3_cb", "sharded", 3, "cost_balanced", None, "gaussian", 2),
    ("os3_eq_dense", "object_sharded", 3, "equal", "dense_merge", "ties", 2),
    ("os3_cb_fmerge", "object_sharded", 3, "cost_balanced", "fused_merge",
     "gaussian", 1),
    ("os4_eq_fmulti", "object_sharded", 4, "equal", "fused_multi", "uniform",
     1),
    ("os4_cb_fmulti", "object_sharded", 4, "cost_balanced", "fused_multi",
     "ties", 2),
    ("hy23_eq_fmerge", "hybrid", [2, 3], "equal", "fused_merge", "gaussian",
     1),
    ("hy23_cb_dense", "hybrid", [2, 3], "cost_balanced", "dense_merge",
     "uniform", 1),
    ("hy23_cb_fmulti", "hybrid", [2, 3], "cost_balanced", "fused_multi",
     "ties", 2),
]
# tick 0: no cost history, local trees built; tick 1: the EMA of tick 0,
# boundary weights, local trees derived from the global order
TICKS = (("rebuild", False), ("skip", True))

SESSION_SPEC = dict(k=K, window=WINDOW, chunk=CHUNK, l_max=L_MAX, th_quad=TH,
                    side=SIDE, backend="dense_topk", rebuild_factor=1.2,
                    delta_pad=64, plan="object_sharded", mesh_shape=4,
                    partitioner="cost_balanced", merge="fused_multi")
SESSION_TICKS = 6
CENTER = np.array([500.0, 500.0], np.float32)


def _positions(family, n, seed):
    if family == "ties":  # a coarse grid: coincident objects, equal distances
        g = np.random.default_rng(seed)
        return (g.integers(0, 40, (n, 2)) * 25.0).astype(np.float32)
    return make_workload(n, family, seed=seed, side=SIDE).positions()


def _inputs():
    """Every input of both runs, made here from seeds with numpy."""
    inp = {}
    for fam in ("uniform", "gaussian", "ties"):
        inp[f"pos/{fam}"] = _positions(fam, N, seed=len(fam))
    g = np.random.default_rng(7)
    inp["weights"] = g.choice(np.float32([0.25, 0.5, 1.0, 2.0]), 4 * N)
    n = 600
    pos = _positions("uniform", n, seed=3).copy()
    inp["s/pos"] = pos.copy()
    inp["s/ext"] = g.uniform(0, SIDE, (30, 2)).astype(np.float32)
    inp["s/probe"] = np.arange(n, dtype=np.int32)
    for t in range(SESSION_TICKS):
        if t in (2, 5):
            continue  # nothing moves: the next tick skips the reindex
        if t == 3:  # a third of the objects collapse toward the centre
            ids = g.choice(n, n // 3, replace=False).astype(np.int32)
            new = CENTER + 0.02 * (pos[ids] - CENTER)
        else:
            ids = g.choice(n, n // 20, replace=False).astype(np.int32)
            new = (pos[ids] + g.uniform(-20, 20, (ids.size, 2))).clip(
                0, SIDE - 1)
        ids = np.concatenate([ids, ids[:3]])  # duplicates: the last one wins
        new = np.concatenate([new, new[:3] + 1]).astype(np.float32)
        pos[ids] = new
        inp[f"s/ids{t}"], inp[f"s/new{t}"] = ids, new
    return inp


def _drive_session(session, inp):
    """The session script both packages run: deltas, a skip tick, a drift
    rebuild, and ``object_shards`` after every tick."""
    pos = inp["s/pos"]
    n = pos.shape[0]
    session.ingest_objects(pos)
    session.register_queries(pos[: n // 2], np.arange(n // 2, dtype=np.int32))
    session.register_queries(inp["s/ext"])
    out = {}
    for t in range(SESSION_TICKS):
        h = session.submit()
        r = h.result()
        rec = {"idx": r.nn_idx, "dist": r.nn_dist, "iterations": r.iterations,
               "candidates": r.candidates, "rebuilt": r.rebuilt,
               "rebuilt_post": h.rebuilt_post, "maintenance": r.maintenance,
               "shard_candidates": r.shard_candidates,
               "shard_iterations": r.shard_iterations,
               "shards": session.object_shards(inp["s/probe"])}
        for key, v in rec.items():
            out[f"s/t{t}/{key}"] = np.asarray(v)
        if f"s/ids{t}" in inp:
            session.update_objects(inp[f"s/ids{t}"], inp[f"s/new{t}"])
    return out


def _weights(inp, name, rows):
    """The boundary weights of case ``name``'s weighted tick: its own, where
    the inputs carry them, else the shared draw."""
    return inp.get(f"weights/{name}", inp["weights"])[:rows]


def _jax_main(in_path, out_path, cases=CASES):
    """The reference's side, run in the subprocess (8 host devices): the
    plan ``cases`` and the session."""
    import jax
    import jax.numpy as jnp

    from repro.api import KnnSession as JaxSession
    from repro.api import ServiceSpec as JaxSpec
    from repro.core import plan as jplan
    from repro.core.executor import resolve_executor as jexec
    from repro.core.quadtree import build_index as jbuild

    assert jax.device_count() == 8, jax.device_count()
    inp = dict(np.load(in_path))
    out = {}
    for name, plan, mesh, part, merge, fam, n_ticks in cases:
        pts = inp[f"pos/{fam}"]
        idx = jbuild(jnp.asarray(pts), jnp.zeros(2), SIDE, l_max=L_MAX,
                     th_quad=TH)
        p = jplan.resolve_plan(plan, num_devices=mesh, partitioner=part,
                               merge=merge)
        qp, qi = jplan.pad_queries(pts, np.arange(N, dtype=np.int32),
                                   p.pad_multiple(CHUNK))
        qcost = jnp.zeros((qp.shape[0],), jnp.float32)
        for t, (mode, weighted) in enumerate(TICKS[:n_ticks]):
            w = _weights(inp, name, qp.shape[0]) if weighted else None
            ii, dd, aux = jplan.run_plan_device(
                idx, jnp.asarray(qp), jnp.asarray(qi), qcost,
                None if w is None else jnp.asarray(w), k=K, window=WINDOW,
                chunk=CHUNK, max_nav=default_max_nav(L_MAX), max_iters=100_000,
                executor=jexec("dense_topk"), plan=p, maintenance=mode)
            rec = {"idx": ii, "dist": dd, "iterations": aux.stats.iterations,
                   "candidates": aux.stats.candidates,
                   "shard_candidates": aux.shard_candidates,
                   "shard_iterations": aux.shard_iterations,
                   "qcost_next": aux.qcost_next,
                   "object_bounds": aux.object_bounds}
            for key, v in rec.items():
                out[f"{name}/t{t}/{key}"] = np.asarray(v)
            qcost = aux.qcost_next
    out.update(_drive_session(JaxSession(JaxSpec(**SESSION_SPEC)), inp))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, computed once in a subprocess."""
    d = tmp_path_factory.mktemp("jax_plans")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=8'\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_plan as T\n"
        f"T._jax_main({str(d / 'in.npz')!r}, {str(d / 'out.npz')!r})\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    return inp, dict(np.load(d / "out.npz"))


def _bits_equal(a, b, what=""):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        assert a.dtype == b.dtype, what
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    np.testing.assert_array_equal(a, b, err_msg=what)


def _sums_exact(*arrays) -> bool:
    """True if every f32 sum over these values is exact in any order: all
    are multiples of one power of two 2**-m, and their total magnitude in
    those units stays below 2**24."""
    vals = np.concatenate([np.abs(np.asarray(a, np.float64)).ravel()
                           for a in arrays])
    for m in range(12):
        units = vals * 2.0**m
        if np.all(units == np.floor(units)):
            return units.sum() < 2**24
    return False


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_matches_jax(ref, case):
    inp, out = ref
    name, plan, mesh, part, merge, fam, n_ticks = case
    mesh = tuple(mesh) if isinstance(mesh, list) else mesh
    pts = inp[f"pos/{fam}"]
    idx = build_index(torch.tensor(pts), torch.zeros(2), SIDE, l_max=L_MAX,
                      th_quad=TH)
    p = tplan.resolve_plan(plan, num_devices=mesh, partitioner=part,
                           merge=merge)
    qp, qi = tplan.pad_queries(pts, np.arange(N, dtype=np.int32),
                               p.pad_multiple(CHUNK))
    qcost = torch.zeros(qp.shape[0])
    for t, (mode, weighted) in enumerate(TICKS[:n_ticks]):
        w = inp["weights"][: qp.shape[0]] if weighted else None
        ii, dd, aux = p.run(
            idx, torch.tensor(qp), torch.tensor(qi), qcost, k=K,
            window=WINDOW, chunk=CHUNK, max_nav=default_max_nav(L_MAX),
            max_iters=100_000, executor=resolve_executor("dense_topk"),
            qweight=None if w is None else torch.tensor(w), maintenance=mode)
        key = f"{name}/t{t}/"
        _bits_equal(out[key + "idx"], ii.numpy(), key + "idx")
        _bits_equal(out[key + "dist"], dd.numpy(), key + "dist")
        # the estimates are integers, the EMA of integer counts with alpha
        # 1/4 is dyadic, the weights are powers of two
        assert _sums_exact(qcost.numpy(), [WINDOW, N],
                           [] if w is None else w), key
        for f in ("shard_candidates", "shard_iterations", "qcost_next",
                  "object_bounds"):
            _bits_equal(out[key + f], getattr(aux, f).numpy(), key + f)
        _bits_equal(out[key + "iterations"], aux.stats.iterations.numpy())
        _bits_equal(out[key + "candidates"], aux.stats.candidates.numpy())
        nr = 2 if plan == "hybrid" else mesh
        assert aux.shard_candidates.shape == (nr * (3 if plan == "hybrid"
                                                    else 1),)
        qcost = aux.qcost_next


def test_object_sharded_session_matches_jax(ref):
    """Deltas (routed by owning shard), a skip tick, a forced drift rebuild
    and ``object_shards``, tick for tick."""
    inp, out = ref
    got = _drive_session(KnnSession(ServiceSpec(**SESSION_SPEC), device="cpu"),
                         inp)
    assert got.keys() == {k for k in out if k.startswith("s/")}
    for key, want in out.items():
        if key.startswith("s/"):
            _bits_equal(want, got[key], key)
    modes = [str(got[f"s/t{t}/maintenance"]) for t in range(SESSION_TICKS)]
    assert "skip" in modes and "rebuild" in modes, modes
    assert any(got[f"s/t{t}/rebuilt_post"] for t in range(SESSION_TICKS))


def test_ema_chain_matches_jax():
    """Twelve chained EMA steps over integer counts, as the session feeds
    them: the reference compiles ``(1-a)*prev + a*measured`` to
    ``fma(1-a, prev, a*measured)``; the unfused form first differs on tick
    7 here."""
    import jax

    from repro.core import plan as jplan

    g = np.random.default_rng(12)
    rows = 1 << 16
    j_ema = jax.jit(jplan._ema_next, static_argnums=2)
    jprev = tprev = np.zeros(rows, np.float32)
    for tick in range(12):
        measured = g.integers(0, 5000, rows).astype(np.float32)
        jprev = np.asarray(j_ema(jprev, measured, 0.25))
        tprev = tplan._ema_next(torch.tensor(tprev), torch.tensor(measured),
                                0.25).numpy()
        _bits_equal(jprev, tprev, f"tick {tick}")


def test_plan_registry_and_errors():
    assert tplan.plan_names() == ("hybrid", "object_sharded", "sharded",
                                  "single")
    assert tplan.resolve_plan("hybrid", num_devices=6).describe().startswith(
        "plan=hybrid mesh=(2, 3)")
    assert tplan.resolve_plan("object_sharded").num_devices == 1
    assert tplan.resolve_plan("hybrid").object_axis_size == 1
    with pytest.raises(ValueError, match="1-D mesh"):
        tplan.resolve_plan("sharded", num_devices=(2, 2))
    with pytest.raises(ValueError, match="unknown merge backend"):
        tplan.resolve_plan("object_sharded", num_devices=2, merge="nope")
    with pytest.raises(ValueError, match="unknown partitioner"):
        tplan.resolve_plan("sharded", num_devices=2, partitioner="nope")
    assert json.dumps(tplan.default_hybrid_shape(8)) == "[2, 4]"
