"""Parity: the LM harness's training steps on ``torch.distributed`` ranks
against the JAX package, on the CPU.

- ``make_train_step_crosspod`` on 2 gloo ranks (a ``("pod", "data",
  "model")`` mesh of shape (2, 1, 1)), ``compress`` on and off, two steps
  of yi_34b smoke from the reference's init, against the reference's
  jitted step on the same mesh over 2 forced host devices (one JAX
  subprocess): loss and grad norm per step within ``CURVE_RTOL``; the
  error feedback after the first step within one quantization scale an
  element (a gradient an ulp apart can put ``g / scale`` on the other side
  of a ``.5``), with at most ``MAX_Q_FLIPS`` such elements;
  ``crosspod_mean_int8`` and ``crosspod_mean`` on identical gradients
  bitwise the reference's.
- the same step on a logical (2, 1, 1) mesh, the pods in turn in one
  process, bitwise the ranks';
- ``repro_torch.launch.train --data 2`` on 2 gloo ranks against the
  port's one-rank run on the whole batch: loss and grad norm per step
  within ``CURVE_RTOL`` (the batch mean is summed in another order).

Spawning follows ``tests/test_torch_dist.py``: a ``file://`` store under
the test's temporary directory, no TCP port; the JAX subprocess and the
ranks run side by side.
"""
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_local_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCH = "yi_34b"
BATCH, SEQ, STEPS = 8, 16, 2
CURVE_RTOL = 2e-5
MAX_Q_FLIPS = 8
SPAWN_TIMEOUT_S = 240
DP_ARGS = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "8",
           "--seq", "16", "--log-every", "100", "--device", "cpu"]


def _inputs():
    g = np.random.default_rng(11)
    return {"tokens": g.integers(0, 128, (BATCH, SEQ)).astype(np.int32),
            # identical per-pod gradients for the exchange alone
            "g": (g.normal(0, 1, (2, 300))
                  * g.choice([1, 1e-3], (2, 300))).astype(np.float32),
            "e": g.normal(0, 1e-3, (2, 300)).astype(np.float32)}


def _flat(tree, prefix):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def _jax_main(in_path: str, out_path: str):
    """The reference on a (2, 1, 1) mesh of 2 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.dist import shard_map_compat, use_rules
    from repro.models import init_params, loss_fn
    from repro.train import (OptConfig, crosspod_mean, crosspod_mean_int8,
                             init_error_feedback, init_opt,
                             make_train_step_crosspod)

    inp = dict(np.load(in_path))
    cfg = get_smoke_config(ARCH)
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
    out = {}
    params0 = init_params(cfg, jax.random.PRNGKey(0))
    out.update(_flat(jax.tree.map(np.asarray, params0), "init"))
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    # pod 0's gradient scales: the error feedback's bound
    g0 = jax.grad(lambda p: loss_fn(p, cfg, {"tokens": batch["tokens"][
        : BATCH // 2]}))(params0)
    out.update(_flat(jax.tree.map(
        lambda g: (jnp.max(jnp.abs(g)) + 1e-12) / 127.0, g0), "scale"))
    for compress in (True, False):
        tag = "int8" if compress else "f32"
        params, opt = params0, init_opt(params0)
        err = init_error_feedback(params)
        with use_rules(mesh):
            step = jax.jit(make_train_step_crosspod(
                cfg, OptConfig(lr=1e-3, warmup_steps=5), mesh,
                compress=compress))
            for i in range(STEPS):
                params, opt, err, m = step(params, opt, err, batch)
                out[f"{tag}/loss{i}"] = np.float32(m["loss"])
                out[f"{tag}/gnorm{i}"] = np.float32(m["grad_norm"])
                if compress:
                    out.update(_flat(jax.tree.map(np.asarray, err),
                                     f"{tag}/err{i}"))
    exch = shard_map_compat(
        lambda g, e: (crosspod_mean_int8({"w": g[0]}, {"w": e[0]}, "pod"),
                      crosspod_mean({"w": g[0]}, "pod")),
        mesh=jax.make_mesh((2,), ("pod",)), in_specs=(P("pod"), P("pod")),
        out_specs=(({"w": P()}, {"w": P("pod")}), {"w": P()}),
        axis_names={"pod"}, check_vma=False)
    (mean, err), plain = jax.jit(exch)(inp["g"], inp["e"])
    out["exchange/int8"] = np.asarray(mean["w"])
    out["exchange/err"] = np.asarray(err["w"]).reshape(2, -1)
    out["exchange/f32"] = np.asarray(plain["w"])
    np.savez(out_path, **out)


def _rank_main(rank: int, world: int, store: str, in_path: str,
               out_dir: str):
    """One rank: the cross-pod steps, the exchange alone, then the
    launcher with ``--data 2``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import crosspod_mean, crosspod_mean_int8

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    inp = dict(np.load(in_path))
    out = _crosspod_steps(inp, dict(np.load(Path(out_dir) / "init.npz")),
                          make_local_mesh(data=1, model=1, pod=2))
    mesh = make_local_mesh(data=1, model=1, pod=2)
    g = torch.tensor(inp["g"][rank])
    e = torch.tensor(inp["e"][rank])
    mean, err = crosspod_mean_int8({"w": g}, {"w": e}, mesh.get_group("pod"))
    out["exchange/int8"] = mean["w"].numpy()
    out["exchange/err"] = err["w"].numpy()
    out["exchange/f32"] = crosspod_mean({"w": g}, mesh.get_group("pod"))[
        "w"].numpy()
    # the launcher's data-parallel ranks, in this process group
    assert tlaunch.main(DP_ARGS + ["--data", "2", "--metrics",
                                   str(Path(out_dir) / "dp.jsonl")]) == 0
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"r{rank}.npz", **out)


def _tree_of(flat, prefix):
    """The nested tree of ``flat``'s ``prefix/...`` keys."""
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            d = tree
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = v
    return tree


def _crosspod_steps(inp, ref, mesh) -> dict:
    """``STEPS`` cross-pod steps, int8 and f32, from the reference's init
    on ``mesh`` (a rank mesh: this rank's error feedback; a logical one:
    pod 0's): {name: numpy}."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import (OptConfig, init_error_feedback, init_opt,
                                   make_train_step_crosspod)

    cfg = get_smoke_config(ARCH)
    logical = not hasattr(mesh, "get_group")
    batch = {"tokens": torch.tensor(inp["tokens"])}
    out = {}
    for compress in (True, False):
        tag = "int8" if compress else "f32"
        params = params_from_numpy(_tree_of(ref, "init"), cfg, device="cpu")
        opt = init_opt(params)
        err = init_error_feedback(params)
        if logical:
            err = [err, init_error_feedback(params)]
        step = make_train_step_crosspod(
            cfg, OptConfig(lr=1e-3, warmup_steps=5), mesh, compress=compress)
        for i in range(STEPS):
            params, opt, err, m = step(params, opt, err, batch)
            out[f"{tag}/loss{i}"] = np.float32(m["loss"])
            out[f"{tag}/gnorm{i}"] = np.float32(m["grad_norm"])
            if compress:
                out.update(_flat(_np_tree(err[0] if logical else err),
                                 f"{tag}/err{i}"))
                if logical:
                    out.update(_flat(_np_tree(err[1]), f"{tag}/pod1err{i}"))
        out.update(_flat(_np_tree(params), f"{tag}/params"))
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _join(procs, deadline: float, what: str):
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
    """The JAX subprocess, then the two ranks (they start from its init):
    (inputs, JAX outputs, [each rank's outputs], the one-rank metrics)."""
    d = tmp_path_factory.mktemp("train_dist")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=2'\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_train_dist as D\n"
        f"D._jax_main({str(d / 'in.npz')!r}, {str(d / 'jax.npz')!r})\n")
    _join([subprocess.Popen([sys.executable, "-c", code],
                            env=dict(env, JAX_PLATFORMS="cpu"), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)], deadline, "the JAX cross-pod step")
    want = dict(np.load(d / "jax.npz"))
    np.savez(d / "init.npz", **{k: v for k, v in want.items()
                                if k.startswith("init/")})
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_train_dist as D\n"
        "D._rank_main(int(sys.argv[1]), 2, sys.argv[2], sys.argv[3], "
        "sys.argv[4])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(d / "store"),
         str(d / "in.npz"), str(d)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    # meanwhile, the one-rank run on the whole batch and the logical pods
    torch.set_num_threads(1)
    assert tlaunch.main(DP_ARGS + ["--metrics", str(d / "one.jsonl")]) == 0
    logical = _crosspod_steps(inp, dict(np.load(d / "init.npz")),
                              make_local_mesh(data=1, model=1, pod=2))
    _join(procs, deadline, "2 ranks")
    ranks = [dict(np.load(d / f"r{r}.npz")) for r in range(2)]
    metrics = {name: [json.loads(x) for x in
                      (d / f"{name}.jsonl").read_text().splitlines()]
               for name in ("dp", "one")}
    return inp, want, ranks, dict(metrics, logical=logical)


@pytest.mark.parametrize("compress", [True, False], ids=["int8", "f32"])
def test_crosspod_step_matches_jax_mesh(runs, compress):
    """Both ranks report the same loss and grad norm each step, within
    ``CURVE_RTOL`` of the reference's (2, 1, 1) mesh; with ``compress``,
    rank 0's error feedback after step 1 (the reference returns pod 0's)
    is within one scale an element of the reference's, at most
    ``MAX_Q_FLIPS`` elements a full scale apart."""
    _, want, ranks, _ = runs
    tag = "int8" if compress else "f32"
    for i in range(STEPS):
        for key in (f"{tag}/loss{i}", f"{tag}/gnorm{i}"):
            assert ranks[0][key] == ranks[1][key], key
            np.testing.assert_allclose(ranks[0][key], want[key],
                                       rtol=CURVE_RTOL, err_msg=key)
    if not compress:
        return
    flips = 0
    for key in (k for k in want if k.startswith("int8/err0/")):
        scale = want["scale/" + key[len("int8/err0/"):]]
        d = np.abs(ranks[0][key] - want[key])
        assert d.max() <= scale * (1 + 1e-5), (key, d.max(), scale)
        flips += int(np.sum(d > scale / 2))
    assert flips <= MAX_Q_FLIPS, flips


def test_crosspod_exchange_is_bitwise_the_reference(runs):
    """``crosspod_mean_int8`` (mean and each rank's residual) and
    ``crosspod_mean`` on identical per-pod gradients equal the reference's
    over its pod axis, bit for bit, on both ranks."""
    _, want, ranks, _ = runs
    for r, got in enumerate(ranks):
        for key in ("exchange/int8", "exchange/f32"):
            np.testing.assert_array_equal(got[key].view(np.int32),
                                          want[key].view(np.int32))
        np.testing.assert_array_equal(got["exchange/err"].view(np.int32),
                                      want["exchange/err"][r].view(np.int32))


def test_data_parallel_ranks_match_one_rank(runs):
    """``--data 2``: each rank takes half the batch rows, the gradients
    are averaged in rank order, and the loss and grad norm of each step
    are the one-rank run's on the whole batch within ``CURVE_RTOL``."""
    _, _, _, metrics = runs
    dp, one = metrics["dp"], metrics["one"]
    assert [x["step"] for x in dp[:-1]] == [x["step"] for x in one[:-1]] \
        == [1, 2, 3, 4]
    for a, b in zip(dp[:-1], one[:-1]):
        np.testing.assert_allclose([a["loss"], a["grad_norm"]],
                                   [b["loss"], b["grad_norm"]],
                                   rtol=CURVE_RTOL)
    assert dp[-1]["leaves_moved"] == one[-1]["leaves_moved"] == 12


def test_logical_pods_are_bitwise_the_ranks(runs):
    """The cross-pod step on a logical (2, 1, 1) mesh, the pods one after
    another in one process, gives the ranks' bits: loss, grad norm, final
    params, and each pod's error feedback (rank r's is pod r's)."""
    _, _, ranks, metrics = runs
    logical = metrics["logical"]
    for key, want in ranks[0].items():
        if key.startswith("exchange/"):
            continue
        np.testing.assert_array_equal(logical[key], want, err_msg=key)
    for key in (k for k in ranks[1] if k.startswith("int8/err")):
        pod1 = key.replace("int8/err", "int8/pod1err", 1)
        np.testing.assert_array_equal(logical[pod1], ranks[1][key],
                                      err_msg=key)
