"""Parity: the int8 cross-pod train step laid over a ``("pod", "data",
"model")`` rank mesh with a ``model`` dimension above 1, against the JAX
package, on the CPU.

- ``make_train_step_crosspod`` on 4 gloo ranks, mesh (2, 1, 2), with
  ``compress`` on and off, and on 8 gloo ranks, mesh (2, 2, 2) (the
  reference's own test mesh), int8 with ``accum=2``: two steps of yi_34b
  smoke from the reference's init, each pod's parameters, optimizer state
  and error feedback laid on the pod's ``(data, model)`` mesh, against the
  reference's jitted step on the same mesh shape over forced host devices
  (one JAX subprocess on 8): loss and grad norm per step within
  ``CURVE_RTOL`` (a row-parallel product sums its halves in another order
  than one device does); the error feedback after the first step within one
  quantization scale an element, at most ``MAX_Q_FLIPS`` elements a full
  scale apart; each laid leaf's local shape (parameters, moments, error
  feedback) the parameter's shard shape, so no rank holds a whole leaf.
- the laid exchange alone (``crosspod_mean_int8``, ``crosspod_mean``) on
  the (2, 1, 2) ranks, on identical per-pod gradients, bitwise the
  reference's whole-leaf exchange, with a leaf whose amax lies only in
  ``model`` rank 1's shard (a per-shard scale gives other int8 bits there);
  the means and new errors come back as shards; whole parameters are
  refused on the laid mesh.
- the (2, 1, 2) ranks against the port's logical (2, 1, 1) pods (whole
  model a pod, in this process) within the same tolerances.

Spawning follows ``tests/test_torch_train_dist.py``: a ``file://`` store
under the test's temporary directory, no TCP port.  The JAX subprocess
writes the reference's init first; the 4 and 8 ranks start from it while
the reference compiles its steps and the logical pods run here.
"""
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_local_mesh
from test_torch_train_dist import _flat, _join, _np_tree, _tree_of

ROOT = Path(__file__).resolve().parents[1]
ARCH = "yi_34b"
BATCH, SEQ, STEPS = 8, 16, 2
CURVE_RTOL = 2e-5
MAX_Q_FLIPS = 8
SPAWN_TIMEOUT_S = 240
# (tag, (pod, data, model), compress, accum); the 4-rank spawn runs the
# first two, the 8-rank one the third
CASES = (("212_int8", (2, 1, 2), True, 1),
         ("212_f32", (2, 1, 2), False, 1),
         ("222_int8", (2, 2, 2), True, 2))
# the exchange's leaves: (shape, the dimension laid on ``model``)
EXCHANGE = {"a": ((8, 30), 0), "b": ((6, 40), 1), "c": ((50,), None)}


def _inputs():
    g = np.random.default_rng(13)
    out = {"tokens": g.integers(0, 128, (BATCH, SEQ)).astype(np.int32)}
    for name, (shape, _) in EXCHANGE.items():
        out[f"g/{name}"] = (g.normal(0, 1, (2, *shape))
                            * g.choice([1, 1e-3], (2, *shape))
                            ).astype(np.float32)
        out[f"e/{name}"] = g.normal(0, 1e-3, (2, *shape)).astype(np.float32)
    # leaf "a": both pods' amax lies in rows 4..7 only, model rank 1's shard
    out["g/a"][:, 6, 3] = np.float32([9.5, -7.25])
    return out


def _jax_main(in_path: str, out_path: str):
    """The reference on 8 forced host devices: the cross-pod step on each
    case's mesh, pod 0's gradient scales, and the whole-leaf exchange."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.dist import shard_map_compat, use_rules
    from repro.models import init_params
    from jax.sharding import NamedSharding

    from repro.train import (OptConfig, crosspod_mean, crosspod_mean_int8,
                             grads_and_loss, init_error_feedback, init_opt,
                             make_train_step_crosspod)

    inp = dict(np.load(in_path))
    cfg = get_smoke_config(ARCH)
    params0 = init_params(cfg, jax.random.PRNGKey(0))
    out = _flat(jax.tree.map(np.asarray, params0), "init")
    # the init first, whole, for the ranks to start from
    init = Path(out_path).with_name("init.npz")
    np.savez(init.with_name("init.tmp.npz"), **out)
    os.replace(init.with_name("init.tmp.npz"), init)
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    for tag, shape, compress, accum in CASES:
        mesh = jax.make_mesh(shape, ("pod", "data", "model"))
        # replicated as the step returns them: one compile a case
        params, opt, err = jax.device_put(
            (params0, init_opt(params0), init_error_feedback(params0)),
            NamedSharding(mesh, P()))
        with use_rules(mesh):
            step = jax.jit(make_train_step_crosspod(
                cfg, OptConfig(lr=1e-3, warmup_steps=5), mesh,
                compress=compress, accum=accum))
            for i in range(STEPS):
                params, opt, err, m = step(params, opt, err, batch)
                out[f"{tag}/loss{i}"] = np.float32(m["loss"])
                out[f"{tag}/gnorm{i}"] = np.float32(m["grad_norm"])
                if compress and i == 0:
                    out.update(_flat(jax.tree.map(np.asarray, err),
                                     f"{tag}/err0"))
        if compress:  # the bound on the error feedback: pod 0's scales
            scales = jax.jit(lambda p, b: jax.tree.map(
                lambda g: (jnp.max(jnp.abs(g)) + 1e-12) / 127.0,
                grads_and_loss(p, cfg, b, accum)[1]))(
                params0, {"tokens": batch["tokens"][: BATCH // 2]})
            out.update(_flat(jax.tree.map(np.asarray, scales),
                             f"{tag}/scale"))
    names = sorted(EXCHANGE)
    exch = shard_map_compat(
        lambda g, e: (crosspod_mean_int8({k: g[k][0] for k in names},
                                         {k: e[k][0] for k in names}, "pod"),
                      crosspod_mean({k: g[k][0] for k in names}, "pod")),
        mesh=jax.make_mesh((2,), ("pod",)),
        in_specs=({k: P("pod") for k in names},
                  {k: P("pod") for k in names}),
        out_specs=(({k: P() for k in names}, {k: P("pod") for k in names}),
                   {k: P() for k in names}),
        axis_names={"pod"}, check_vma=False)
    (mean, err), plain = jax.jit(exch)(
        {k: inp[f"g/{k}"] for k in names}, {k: inp[f"e/{k}"] for k in names})
    for k in names:
        out[f"exchange/int8/{k}"] = np.asarray(mean[k])
        out[f"exchange/err/{k}"] = np.asarray(err[k]).reshape(
            inp[f"e/{k}"].shape)
        out[f"exchange/f32/{k}"] = np.asarray(plain[k])
    np.savez(out_path, **out)


def _shard_shape(t) -> tuple:
    """The shape of this rank's shard of a DTensor: each ``Shard(d)``
    divides dimension ``d`` by its mesh dimension's size."""
    shape = list(t.shape)
    for i, p in enumerate(t.placements):
        if p.is_shard():
            shape[p.dim] //= t.device_mesh.size(i)
    return tuple(shape)


def _local_shapes_ok(trees: dict, params) -> dict:
    """Per tree, whether each leaf is a DTensor laid as its parameter whose
    local shape is the parameter's shard shape, and the leaves laid on
    ``model`` (split there): {name: [ok, n_model_leaves]}."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.optimizer import tree_leaves

    model = list(tree_leaves(params)[0].device_mesh.mesh_dim_names).index(
        "model")
    out = {}
    for name, tree in trees.items():
        ok, split = True, 0
        for p, t in zip(tree_leaves(params), tree_leaves(tree)):
            ok &= (isinstance(t, DTensor) and t.placements == p.placements
                   and tuple(t.to_local().shape) == _shard_shape(p))
            split += p.placements[model].is_shard()
        out[name] = [bool(ok), split]
    return out


def _crosspod_steps(inp, ref, mesh, cases) -> dict:
    """``STEPS`` cross-pod steps of each case from the reference's init on
    ``mesh`` (a rank mesh: laid on the pod's mesh where ``model`` > 1; a
    logical one: the pods in this process): {name: numpy}, the error
    feedback after the first step gathered whole (pod 0's on a logical
    mesh), and on a laid mesh the local-shape checks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import full_tree
    from repro_torch.launch.mesh import pod_mesh
    from repro_torch.train import (OptConfig, init_error_feedback, init_opt,
                                   make_train_step_crosspod)
    from repro_torch.train.step import laid

    cfg = get_smoke_config(ARCH)
    logical = not hasattr(mesh, "get_group")
    sub = pod_mesh(mesh) if laid(mesh) else None
    batch = {"tokens": torch.tensor(inp["tokens"])}
    out = {}
    for tag, _, compress, accum in cases:
        params = params_from_numpy(_tree_of(ref, "init"), cfg, device="cpu",
                                   mesh=sub)
        opt = init_opt(params)
        err = init_error_feedback(params)
        if logical:
            err = [err, init_error_feedback(params)]
        step = make_train_step_crosspod(
            cfg, OptConfig(lr=1e-3, warmup_steps=5), mesh, compress=compress,
            accum=accum)
        for i in range(STEPS):
            params, opt, err, m = step(params, opt, err, batch)
            out[f"{tag}/loss{i}"] = np.float32(m["loss"])
            out[f"{tag}/gnorm{i}"] = np.float32(m["grad_norm"])
            if compress and i == 0:
                out.update(_flat(_np_tree(full_tree(
                    err[0] if logical else err)), f"{tag}/err0"))
        if sub is not None:
            shapes = _local_shapes_ok({"params": params, "m": opt["m"],
                                       "v": opt["v"], "err": err}
                                      if compress else
                                      {"params": params, "m": opt["m"],
                                       "v": opt["v"]}, params)
            for name, (ok, split) in shapes.items():
                out[f"{tag}/local_ok/{name}"] = np.bool_(ok)
                out[f"{tag}/model_leaves/{name}"] = np.int64(split)
    return out


def _exchange(inp, mesh) -> dict:
    """The laid exchange on this rank: each leaf of this rank's pod laid
    on the pod's mesh (``EXCHANGE``'s dimension on ``model``), int8 and
    f32, gathered whole; and whether every mean and new error is a shard
    of its gradient's shape."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import full_tree, lay
    from repro_torch.launch.mesh import pod_mesh
    from repro_torch.train import crosspod_mean, crosspod_mean_int8

    sub = pod_mesh(mesh)
    pod = mesh.get_coordinate()[0]
    group = mesh.get_group("pod")

    def laid_tree(prefix):
        return {k: lay(torch.tensor(inp[f"{prefix}/{k}"][pod]),
                       (Replicate(), Replicate() if d is None else Shard(d)),
                       sub) for k, (_, d) in EXCHANGE.items()}

    g, e = laid_tree("g"), laid_tree("e")
    mean, err = crosspod_mean_int8(g, e, group)
    plain = crosspod_mean(g, group)
    out = {}
    for name, tree in (("int8", mean), ("err", err), ("f32", plain)):
        for k, t in tree.items():
            out[f"exchange/shard_ok/{name}/{k}"] = np.bool_(
                t.placements == g[k].placements
                and tuple(t.to_local().shape) == _shard_shape(g[k]))
        out.update(_flat(_np_tree(full_tree(tree)), f"exchange/{name}"))
    return out


def _refuses_whole_params(inp, ref, mesh) -> bool:
    """Whether the laid step refuses parameters that are not laid on the
    pod's mesh (whole ones), naming ``pod_mesh``, before any collective."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import (OptConfig, init_error_feedback, init_opt,
                                   make_train_step_crosspod)

    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(_tree_of(ref, "init"), cfg, device="cpu")
    step = make_train_step_crosspod(cfg, OptConfig(), mesh)
    try:
        step(params, init_opt(params), init_error_feedback(params),
             {"tokens": torch.tensor(inp["tokens"])})
    except ValueError as e:
        return "pod_mesh" in str(e)
    return False


def _rank_main(rank: int, world: int, store: str, in_path: str,
               out_dir: str):
    """One rank of the (2, 1, 2) (4 ranks) or (2, 2, 2) (8 ranks) mesh."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    inp = dict(np.load(in_path))
    ref = dict(np.load(Path(out_dir) / "init.npz"))
    cases = [c for c in CASES if np.prod(c[1]) == world]
    pods, data, model = cases[0][1]
    mesh = make_local_mesh(data=data, model=model, pod=pods)
    out = _crosspod_steps(inp, ref, mesh, cases)
    if world == 4:
        out.update(_exchange(inp, mesh))
        out["refused"] = np.bool_(_refuses_whole_params(inp, ref, mesh))
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"w{world}r{rank}.npz", **out)


def _spawn(world: int, d: Path, env) -> list:
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "import test_torch_train_xpod as X\n"
            f"X._rank_main(int(sys.argv[1]), {world}, sys.argv[2], "
            "sys.argv[3], sys.argv[4])\n")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(d / f"store{world}"),
         str(d / "in.npz"), str(d)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4 and 8 ranks (from its init, once it is
    written) and the logical pods here, side by side: (inputs, JAX
    outputs, {world: [each rank's outputs]}, the logical pods'
    outputs)."""
    d = tmp_path_factory.mktemp("train_xpod")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=8'\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_train_xpod as X\n"
        f"X._jax_main({str(d / 'in.npz')!r}, {str(d / 'jax.npz')!r})\n")
    ref = subprocess.Popen([sys.executable, "-c", code],
                           env=dict(env, JAX_PLATFORMS="cpu"), cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    # the ranks start from the reference's init as soon as it is written,
    # while the reference compiles its steps
    while not (d / "init.npz").exists():
        if ref.poll() is not None or time.monotonic() > deadline:
            _join([ref], deadline, "the JAX init")
            pytest.fail("the JAX subprocess wrote no init")
        time.sleep(0.1)
    procs = _spawn(4, d, env) + _spawn(8, d, env)
    torch.set_num_threads(1)
    logical = _crosspod_steps(inp, dict(np.load(d / "init.npz")),
                              make_local_mesh(data=1, model=1, pod=2),
                              [c for c in CASES if c[1] == (2, 1, 2)])
    _join([ref], deadline, "the JAX cross-pod steps")
    _join(procs, deadline, "4 and 8 ranks")
    want = dict(np.load(d / "jax.npz"))
    ranks = {w: [dict(np.load(d / f"w{w}r{r}.npz")) for r in range(w)]
             for w in (4, 8)}
    return inp, want, ranks, logical


def _world(tag: str) -> int:
    return next(int(np.prod(s)) for t, s, _, _ in CASES if t == tag)


def _curve_close(got: dict, want: dict, tag: str):
    for i in range(STEPS):
        for key in (f"{tag}/loss{i}", f"{tag}/gnorm{i}"):
            np.testing.assert_allclose(got[key], want[key], rtol=CURVE_RTOL,
                                       err_msg=key)


def _err_close(got: dict, want: dict, scales: dict, tag: str):
    """The error feedback after the first step within one scale an
    element, at most ``MAX_Q_FLIPS`` elements a full scale apart."""
    prefix = f"{tag}/err0/"
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    flips = 0
    for key in keys:
        scale = scales[f"{tag}/scale/" + key[len(prefix):]]
        d = np.abs(got[key] - want[key])
        assert d.max() <= scale * (1 + 1e-5), (key, d.max(), scale)
        flips += int(np.sum(d > scale / 2))
    assert flips <= MAX_Q_FLIPS, flips


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_laid_crosspod_step_matches_jax_mesh(runs, tag):
    """Every rank reports the same loss and grad norm each step, within
    ``CURVE_RTOL`` of the reference's step on the same mesh shape; with
    int8, the error feedback (gathered whole) within one scale an element
    of the reference's; each laid leaf's local shape is its shard's, and
    leaves laid on ``model`` exist."""
    _, want, ranks, _ = runs
    got = ranks[_world(tag)]
    for r in got[1:]:
        for i in range(STEPS):
            for key in (f"{tag}/loss{i}", f"{tag}/gnorm{i}"):
                assert r[key] == got[0][key], key
    _curve_close(got[0], want, tag)
    if tag.endswith("int8"):
        _err_close(got[0], want, want, tag)
    for r in got:
        oks = [k for k in r if k.startswith(f"{tag}/local_ok/")]
        assert len(oks) == (4 if tag.endswith("int8") else 3)
        for k in oks:
            assert r[k], k
            assert r[k.replace("local_ok", "model_leaves", 1)] > 0, k


@pytest.mark.parametrize("kind", ["int8", "f32"])
def test_laid_exchange_is_bitwise_the_whole_leaf_exchange(runs, kind):
    """``crosspod_mean_int8`` (mean and each pod's residual) and
    ``crosspod_mean`` on gradients laid on the pod's ``(1, 2)`` mesh equal
    the reference's whole-leaf exchange bit for bit on every rank, leaf
    ``a`` (its amax only in ``model`` rank 1's shard) included; each mean
    and new error is laid as its gradient, a shard on every rank."""
    inp, want, ranks, _ = runs
    a = inp["g/a"]
    for pod in range(2):  # the input is the case it claims to be
        assert np.abs(a[pod, :4]).max() < np.abs(a[pod, 4:]).max()
    names = ("int8", "err") if kind == "int8" else ("f32",)
    for rank, got in enumerate(ranks[4]):
        pod = rank // 2
        for name in names:
            for k in EXCHANGE:
                ref = want[f"exchange/{name}/{k}"]
                if name == "err":
                    ref = ref[pod]
                np.testing.assert_array_equal(
                    got[f"exchange/{name}/{k}"].view(np.int32),
                    ref.view(np.int32), err_msg=f"{name}/{k} rank {rank}")
                assert got[f"exchange/shard_ok/{name}/{k}"], (name, k, rank)


@pytest.mark.parametrize("tag", ["212_int8", "212_f32"])
def test_laid_ranks_match_logical_pods(runs, tag):
    """The (2, 1, 2) ranks against the port's logical (2, 1, 1) pods (the
    whole model a pod, in one process): loss and grad norm within
    ``CURVE_RTOL``, the error feedback within one scale an element."""
    _, want, ranks, logical = runs
    _curve_close(ranks[4][0], logical, tag)
    if tag.endswith("int8"):
        _err_close(ranks[4][0], logical, want, tag)


def test_laid_step_refuses_whole_params(runs):
    """On a (2, 1, 2) mesh the step refuses parameters that are not laid
    on the pod's mesh, on every rank."""
    _, _, ranks, _ = runs
    assert all(r["refused"] for r in ranks[4])
