"""Parity: the mesh plans laid onto ``torch.distributed`` ranks, and the
port's logical-axis sharding rules, against the JAX package.

Each grid cell runs in a gloo process of its own on the CPU (a ``file://``
store under the test's temporary directory, no TCP port), one rank per
cell; every rank must end each tick with the bits of JAX's mesh plan (the
module-scoped subprocess on 8 forced host devices of
``tests/test_torch_plan.py``, run here for these cases only) and of the
port's logical-shard plan: ids, distances, per-shard counters, the cost
EMA, the object bounds, and the session's rebuild decisions.  A
four-tenant ``KnnServer`` replicated on every rank of the 4- and 6-rank
worlds must give each tenant's rows and each tick's counters of the
port's logical-shard server.  Tolerance 0 (``np.array_equal`` on the raw
bits).  The rule tables are held entry for entry against the reference's
``PartitionSpec``.
"""
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_plan as T
from repro_torch.api import KnnSession, ServiceSpec
from repro_torch.core import plan as tplan
from repro_torch.core.executor import resolve_executor
from repro_torch.core.pipeline import default_max_nav
from repro_torch.core.quadtree import build_index
from repro_torch.dist import (SPATIAL_RULES, LogicalRules, logical_to_spec,
                              use_rules)
from repro_torch.launch import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
# (name, plan, mesh_shape, partitioner, merge, data family, ticks), as
# test_torch_plan.CASES; tick 1 of sh3_cb_empty weighs the Morton-first
# corner so that query shard 0 owns no chunk
CASES = [
    ("sh3_cb_empty", "sharded", 3, "cost_balanced", None, "uniform", 2),
    ("os4_cb_fmulti", "object_sharded", 4, "cost_balanced", "fused_multi",
     "ties", 2),
    ("hy23_cb_fmerge", "hybrid", [2, 3], "cost_balanced", "fused_merge",
     "gaussian", 2),
]
# world size -> what its ranks run; the 4-rank world also probes the mesh
WORLDS = {3: ["sh3_cb_empty"],
          4: ["os4_cb_fmulti", "session", "mesh", "driver", "server",
              "driver_tenants"],
          6: ["hy23_cb_fmerge", "server"]}
# world size -> the spec of its four-tenant server (plan, mesh_shape,
# partitioner, merge)
SERVER_PLANS = {4: ("object_sharded", 4, "equal", "fused_multi"),
                6: ("hybrid", [2, 3], "cost_balanced", "fused_merge")}
SERVER_COUNTERS = ("rows_total", "rows_unique", "rows_computed",
                   "dedup_hit_rows", "cache_hit_rows", "epoch", "rebuilt")
SERVER_TENANTS = 4
SERVER_DUPS = 45  # tenant 0's duplicates of tenant 1's first rows
SPAWN_TIMEOUT_S = 300


def _inputs():
    inp = T._inputs()
    w = np.ones((4 * T.N,), np.float32)
    pts = inp["pos/uniform"]
    corner = (pts[:, 0] < 125) & (pts[:, 1] < 125)
    w[: T.N][corner] = 256.0
    inp["weights/sh3_cb_empty"] = w
    return inp


def _plan_ticks(case, inp):
    """One case's ticks through the port (whatever mesh the plan lays):
    {"t{t}/{field}": array}."""
    name, plan, mesh, part, merge, fam, n_ticks = case
    mesh = tuple(mesh) if isinstance(mesh, list) else mesh
    pts = inp[f"pos/{fam}"]
    idx = build_index(torch.tensor(pts), torch.zeros(2), T.SIDE,
                      l_max=T.L_MAX, th_quad=T.TH)
    p = tplan.resolve_plan(plan, num_devices=mesh, partitioner=part,
                           merge=merge)
    qp, qi = tplan.pad_queries(pts, np.arange(T.N, dtype=np.int32),
                               p.pad_multiple(T.CHUNK))
    qcost = torch.zeros(qp.shape[0])
    out = {}
    for t, (mode, weighted) in enumerate(T.TICKS[:n_ticks]):
        w = T._weights(inp, name, qp.shape[0]) if weighted else None
        ii, dd, aux = p.run(
            idx, torch.tensor(qp), torch.tensor(qi), qcost, k=T.K,
            window=T.WINDOW, chunk=T.CHUNK, max_nav=default_max_nav(T.L_MAX),
            max_iters=100_000, executor=resolve_executor("dense_topk"),
            qweight=None if w is None else torch.tensor(w), maintenance=mode)
        rec = {"idx": ii, "dist": dd, "iterations": aux.stats.iterations,
               "candidates": aux.stats.candidates,
               "shard_candidates": aux.shard_candidates,
               "shard_iterations": aux.shard_iterations,
               "qcost_next": aux.qcost_next,
               "object_bounds": aux.object_bounds}
        for key, v in rec.items():
            out[f"t{t}/{key}"] = v.numpy()
        qcost = aux.qcost_next
    return out


def _server(world: int):
    """World ``world``'s four-tenant server on the CPU: spatial
    invalidation, the stab budget ``chip_smoke.py``'s server path takes at
    1M objects scaled to ``T.N`` (2 rows)."""
    from repro_torch.serve import KnnServer

    plan, mesh, part, merge = SERVER_PLANS[world]
    spec = ServiceSpec(k=T.K, window=T.WINDOW, chunk=T.CHUNK, l_max=T.L_MAX,
                       th_quad=T.TH, side=T.SIDE, backend="dense_topk",
                       rebuild_factor=1.5, plan=plan,
                       mesh_shape=tuple(mesh) if isinstance(mesh, list)
                       else mesh, partitioner=part, merge=merge)
    return KnnServer(spec, device="cpu", invalidation="spatial",
                     stab_budget=4096 * T.N // 1_000_000)


def _drive_server(server, inp) -> dict:
    """The server script every rank and the logical run take:
    ``{"server/t{t}/{field}": array}`` with each tick's counters, the
    entries its deltas evicted, its query shards' iterations and every
    tenant's rows.

    Tenant i registers one query at each object ``i::4`` (qid = the id),
    tenant 0 also ``SERVER_DUPS`` duplicates of tenant 1's rows.  Ticks:
    0 the build; 1 unchanged (every row from the cache: no submit); 2
    tenant 2 moves ``N // 500`` rows (the stab: fewer rows computed than
    one chunk); 3 tenant 3 moves ``N // 100`` (over the budget: the epoch
    clears); 4 tenant 1 teleports every object into one cluster (the drift
    rebuild) and is still in flight when 5 tenant 0 moves one row and
    submits."""
    pos = inp["pos/uniform"].copy()
    n = pos.shape[0]
    g = np.random.default_rng(11)
    server.ingest_objects(pos)
    qid = np.arange(n, dtype=np.int32)
    tenants = [server.admit(f"tenant-{i}") for i in range(SERVER_TENANTS)]
    rows = [qid[i::SERVER_TENANTS] for i in range(SERVER_TENANTS)]
    for tn, r in zip(tenants, rows):
        tn.register_queries(pos[r], r)
    tenants[0].register_queries(pos[rows[1][:SERVER_DUPS]],
                                rows[1][:SERVER_DUPS])
    cluster = (g.normal(0, 25, (n, 2)) + T.SIDE / 2).astype(
        np.float32).clip(0, T.SIDE - 1)
    out = {}

    def move(tn, m):
        ids = g.choice(n, m, replace=False).astype(np.int32)
        new = (pos[ids] + g.uniform(-15, 15, (m, 2))).clip(
            0, T.SIDE - 1).astype(np.float32)
        pos[ids] = new
        tn.update_objects(ids, new)

    def read(t, st, evicted):
        res = st.result()
        rec = {f: getattr(res, f) for f in SERVER_COUNTERS}
        rec["evicted"] = evicted
        rec["submitted"] = res.inner is not None
        rec["shard_iterations"] = (np.zeros((0,), np.int32) if res.inner
                                   is None else res.inner.shard_iterations)
        for i, tn in enumerate(tenants):
            ii, dd, qq = st.result_for_tenant(tn)
            rec.update({f"idx{i}": ii, f"dist{i}": dd, f"qid{i}": qq})
        for key, v in rec.items():
            out[f"server/t{t}/{key}"] = np.asarray(v)

    def tick(t, mover=None, m=0):
        inval0 = server.cache.stats.invalidations
        if mover is not None:
            move(tenants[mover], m)
        read(t, server.submit(), server.cache.stats.invalidations - inval0)

    tick(0)
    tick(1)
    tick(2, 2, n // 500)
    tick(3, 3, n // 100)
    inval0 = server.cache.stats.invalidations
    pos[:] = cluster
    tenants[1].update_objects(qid, cluster)
    st4 = server.submit()
    evicted4 = server.cache.stats.invalidations - inval0
    move(tenants[0], 1)
    st5 = server.submit()
    read(4, st4, evicted4)
    read(5, st5, server.cache.stats.invalidations - inval0 - evicted4)
    server.session.finalize_pending()
    return out


def _mesh_probe(world: int) -> dict:
    """``None`` takes the world; a mesh of another size raises."""
    out = {"none_1d": tplan.resolve_plan("object_sharded").num_devices,
           "none_hybrid": np.asarray(tmesh.default_hybrid_shape()),
           "describe": tplan.resolve_plan("sharded").describe()}
    for shape in (world - 1, (2, 3)):
        try:
            tplan.resolve_plan("hybrid" if isinstance(shape, tuple)
                               else "object_sharded", num_devices=shape)
            out[f"mismatch {shape}"] = "no error"
        except ValueError as e:
            out[f"mismatch {shape}"] = str(e)
    return out


def _rank_main(rank: int, world: int, store: str, in_path: str,
               out_path: str):
    """One rank: join the gloo group, run this world's jobs, save outputs."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=120))
    inp = dict(np.load(in_path))
    out = {}
    for job in WORLDS[world]:
        if job == "session":
            got = T._drive_session(
                KnnSession(ServiceSpec(**T.SESSION_SPEC), device="cpu"), inp)
        elif job == "mesh":
            got = {f"mesh/{k}": v for k, v in _mesh_probe(world).items()}
        elif job == "driver":  # the knn driver in a process group
            from repro_torch.launch.serve import main as serve_main

            got = {"driver/rc": serve_main([
                "knn", "--objects", "600", "--ticks", "2", "--chunk", "256",
                "--l-max", "5", "--th-quad", "16", "--plan", "hybrid",
                "--partitioner", "cost_balanced", "--device", "cpu"])}
        elif job == "driver_tenants":  # it raises if the ranks' lists differ
            from repro_torch.launch.serve import main as serve_main

            got = {"driver_tenants/rc": serve_main([
                "knn", "--objects", "600", "--ticks", "3", "--chunk", "256",
                "--l-max", "5", "--th-quad", "16", "--plan",
                "object_sharded", "--tenants", "4", "--device", "cpu"])}
        elif job == "server":
            got = _drive_server(_server(world), inp)
        else:
            case = next(c for c in CASES if c[0] == job)
            got = {f"{job}/{k}": v for k, v in _plan_ticks(case, inp).items()}
        out.update(got)
    dist.destroy_process_group()
    np.savez(out_path, **out)


def _spawn_world(world: int, d: Path):
    """Start ``world`` rank processes; returns their Popen handles."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_dist as D\n"
        "D._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
        "sys.argv[4], sys.argv[5])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    store = d / f"store{world}"
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(store),
         str(d / "in.npz"), str(d / f"w{world}_r{r}.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _join(procs, deadline: float, what: str):
    """Wait for every process by the deadline; kill all and fail otherwise."""
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{what}: a process did not finish in time")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, (what, log[-4000:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the three rank worlds, run side by side:
    (inputs, JAX outputs, {world: [each rank's outputs]})."""
    d = tmp_path_factory.mktemp("dist_plans")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=8'\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_dist as D, test_torch_plan as T\n"
        f"T._jax_main({str(d / 'in.npz')!r}, {str(d / 'out.npz')!r}, "
        "cases=D.CASES)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        for world in WORLDS:
            _join(_spawn_world(world, d), deadline,
                  f"{world} ranks")
    finally:
        _join([jax_proc], deadline, "the JAX mesh plans")
    ranks = {w: [dict(np.load(d / f"w{w}_r{r}.npz")) for r in range(w)]
             for w in WORLDS}
    return inp, dict(np.load(d / "out.npz")), ranks


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rank_plan_matches_jax_and_logical(runs, case):
    """Every rank's ticks equal JAX's mesh plan and the logical shards."""
    inp, ref, ranks = runs
    name, plan, mesh, *_ = case
    world = next(w for w, jobs in WORLDS.items() if name in jobs)
    logical = _plan_ticks(case, inp)
    assert len(logical) == 8 * case[6]
    if name == "sh3_cb_empty":  # the weighted tick: shard 0 owns no chunk
        assert logical["t1/shard_iterations"][0] == 0
        assert np.all(logical["t0/shard_iterations"] > 0)
    for r, got in enumerate(ranks[world]):
        for key, want in logical.items():
            T._bits_equal(ref[f"{name}/{key}"], want, f"JAX {name}/{key}")
            T._bits_equal(want, got[f"{name}/{key}"], f"rank {r} {key}")


def test_rank_session_matches_jax_and_logical(runs):
    """SESSION_SPEC's six ticks (deltas routed by owning shard, a skip
    tick, a drift rebuild, ``object_shards``) on 4 ranks."""
    inp, ref, ranks = runs
    logical = T._drive_session(
        KnnSession(ServiceSpec(**T.SESSION_SPEC), device="cpu"), inp)
    for key, want in logical.items():
        T._bits_equal(ref[key], want, f"JAX {key}")
        for r, got in enumerate(ranks[4]):
            T._bits_equal(want, got[key], f"rank {r} {key}")
    assert any(logical[f"s/t{t}/rebuilt_post"]
               for t in range(T.SESSION_TICKS))


@pytest.mark.parametrize("world", sorted(SERVER_PLANS))
def test_rank_server_matches_logical(runs, world):
    """A four-tenant server replicated on every rank of the 4-rank
    (``object_sharded`` 4) and 6-rank (``hybrid`` (2, 3) ``cost_balanced``)
    worlds: each rank's per-tenant rows and each tick's counters equal the
    logical-shard server's bit for bit (tolerance 0), over the build, a
    pure-cache tick, a stab, an epoch clear, a drift rebuild overlapped by
    the next submit, and a tick of fewer rows than one chunk."""
    inp, _, ranks = runs
    logical = _drive_server(_server(world), inp)
    assert len(logical) == 6 * (len(SERVER_COUNTERS) + 3
                                + 3 * SERVER_TENANTS)
    for r, got in enumerate(ranks[world]):
        for key, want in logical.items():
            T._bits_equal(want, got[key], f"rank {r} {key}")

    def at(t, f):
        return logical[f"server/t{t}/{f}"]

    n = T.N
    assert at(0, "rows_computed") == n and at(0, "dedup_hit_rows") == \
        SERVER_DUPS
    assert not at(1, "submitted") and at(1, "cache_hit_rows") == \
        n + SERVER_DUPS
    assert 0 < at(2, "rows_computed") == at(2, "evicted") < T.CHUNK
    assert at(2, "epoch") == at(1, "epoch") and at(3, "epoch") == \
        at(2, "epoch") + 1 and at(3, "rows_computed") == n
    assert at(4, "rebuilt"), "the teleport tick did not rebuild"
    if world == 6:  # a query shard owns none of tick 2's rows
        its = at(2, "shard_iterations").reshape(2, 3)
        assert (its == 0).all(1).any() and its.any(), its


def test_rank_mesh_takes_the_world_and_rejects_other_sizes(runs):
    """Under a process group ``None`` is the world size (the ``knn`` driver's
    hybrid plan lays (2, 2) and its ranks agree); a mesh of another size
    raises and names both numbers; without one a mesh is logical."""
    for got in runs[2][4]:
        assert int(got["mesh/none_1d"]) == 4
        assert got["mesh/none_hybrid"].tolist() == [2, 2]
        assert "devices=4 backend=gloo" in str(got["mesh/describe"])
        for shape, n in (("3", 3), ("(2, 3)", 6)):
            msg = str(got[f"mesh/mismatch {shape}"])
            assert f"lays {n} ranks" in msg and "has 4" in msg, msg
        assert int(got["driver/rc"]) == 0
        assert int(got["driver_tenants/rc"]) == 0
    assert tmesh.world_size() is None
    assert tmesh.make_spatial_mesh(2, 3) == tmesh.LogicalMesh(
        ("query", "object"), (2, 3))
    assert tmesh.default_hybrid_shape() == (1, 1)
    assert tplan.default_hybrid_shape is tmesh.default_hybrid_shape
    assert "devices=1" in tplan.resolve_plan("hybrid",
                                             num_devices=6).describe()


def _jax_spec(mesh_shape, names, rules, axes, shape):
    """The reference's ``LogicalRules.spec``, on a mesh of these names and
    sizes (it reads only ``axis_names`` and ``devices.shape``)."""
    from repro.dist.sharding import LogicalRules as JaxRules

    fake = SimpleNamespace(axis_names=names, devices=np.empty(mesh_shape))
    return JaxRules(fake, rules).spec(axes, shape)


def _same_spec(jax_spec, spec):
    assert len(spec) == len(jax_spec), (jax_spec, spec)
    for a, b in zip(jax_spec, spec):
        assert a == b and type(a) is type(b), (jax_spec, spec)


def test_rules_divisibility_dedup_and_missing_axis_match_reference():
    """``tests/test_dist.py``'s three cases, on both packages' 1x1 meshes."""
    from jax.sharding import PartitionSpec as P

    from repro.dist import logical_to_spec as jspec
    from repro.dist import use_rules as juse
    from repro.launch.mesh import make_local_mesh

    jmesh, mesh = make_local_mesh(data=1, model=1), tmesh.make_local_mesh(1, 1)
    cases = [({}, ("batch", "heads"), (8, 24)),
             ({"expert": "model", "expert_cap": "model", "ff": "model"},
              ("expert", "expert_cap", "ff"), (4, 4, 4)),
             ({}, ("batch",), (8,))]
    for overrides, axes, shape in cases:
        with juse(jmesh, overrides):
            want = jspec(axes, shape)
        with use_rules(mesh, overrides):
            got = logical_to_spec(axes, shape)
        assert isinstance(want, P)
        _same_spec(want, got)
    with use_rules(mesh, cases[1][0]):
        assert logical_to_spec(cases[1][1], cases[1][2]) == ("model", None,
                                                              None)


SPATIAL_AXES = [(("query", None), (8, 6)), (("object", "cell"), (12, 5)),
                (("query", "object"), (6, 8)), (("object", "query"), (6, 8)),
                (("cell", "query", "object"), (3, 4, 9)),
                (("query", "query"), (16, 16)), (("object",), None)]


@pytest.mark.parametrize("mesh_shape,names", [
    ((4,), ("object",)), ((4,), ("query",)), ((2, 3), ("query", "object")),
    ((1, 8), ("query", "object"))])
def test_spatial_rules_match_reference(mesh_shape, names):
    """``SPATIAL_RULES`` on (4,), (2, 3) and (1, 8) meshes: the spec of
    every listed axes/shape pair equals the reference's, entry for entry."""
    mesh = tmesh.LogicalMesh(names, mesh_shape)
    for axes, shape in SPATIAL_AXES:
        want = _jax_spec(mesh_shape, names, SPATIAL_RULES, axes, shape)
        _same_spec(want, LogicalRules(mesh, SPATIAL_RULES).spec(axes, shape))
