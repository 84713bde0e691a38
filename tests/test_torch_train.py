"""Parity: the LM harness's training side (``repro_torch.train``,
``repro_torch.data.lm``, ``models.loss_fn`` and ``param_logical``, the
``repro_torch.launch.train`` launcher) against the JAX package, on the CPU.

Weights are the port's init from a seed as float32 numpy, every constant
leaf moved by seeded noise (``_tree``), carried to both packages (the
reference's init where a test says so: ``params_from_numpy``,
``opt_from_numpy``).  The reference
runs jitted, never through its launcher (which cannot run on this JAX: its
mesh axes are ``Explicit``).  Tolerances, each stated where it is used:

- the loss within ``rtol=1e-6`` and each gradient leaf within
  ``GRAD_TOL`` of its largest element (rwkv6 ``RWKV_GRAD_TOL``): XLA and
  PyTorch sum in different orders, and rwkv6's group norm amplifies;
- the optimizer on identical inputs bitwise, the global norm within
  ``NORM_RTOL`` (XLA's reduction order inside a leaf);
- multi-step runs by their loss and grad-norm curves (``CURVE_RTOL``): at
  step 1 Adam's ``mhat / sqrt(vhat)`` is about ``sign(g)``, so raw params
  are never compared element by element after a step;
- data batches, checkpoints and the launcher's crash and resume bitwise.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models as TM
from repro import configs as jconfigs
from repro.data import lm as jlm
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import (opt_from_numpy, opt_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.data import lm as tlm
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
# each gradient leaf: |got - want| <= GRAD_TOL * max|want| (largest seen
# 4.0e-6, zamba2; 5.8e-6 on the reference's own init); rwkv6's per-head
# group norm amplifies XLA's one-ulp differences (1.1e-5 here, 9.8e-5 on
# the reference's init)
GRAD_TOL = 2e-5
RWKV_GRAD_TOL = 5e-4
LOSS_RTOL = 1e-6
# the global norm: each leaf's sum of squares in another order than XLA's
NORM_RTOL = 4e-7
FAMILIES = ["yi_34b", "granite_moe_3b_a800m", "rwkv6_3b", "zamba2_7b",
            "seamless_m4t_large_v2", "llama_3_2_vision_11b"]


def _grad_tol(arch):
    return RWKV_GRAD_TOL if arch == "rwkv6_3b" else GRAD_TOL


def _leaves(tree):
    return topt.tree_leaves(tree)


def _close_leaves(got, want, tol, what):
    """Every leaf of ``got`` (port tree) within ``tol`` of its largest
    element of ``want`` (reference tree, same order)."""
    got, want = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().double().numpy()
        b = np.asarray(np.asarray(b, np.float32), np.float64)
        assert a.shape == b.shape, (what, i)
        bound = tol * max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, (what, i, np.abs(a - b).max(),
                                              bound)


def _tree(cfg, seed=0):
    """The port's init of ``cfg`` from ``seed`` as float32 numpy, every
    constant leaf moved by seeded noise (sd 0.2), so that no path is
    silenced (the vlm's ``xgate``, the mamba ``A_log``)."""
    g = np.random.default_rng(100 + seed)

    def nudge(a):
        if a.size and np.all(a == a.flat[0]):
            return (a + g.normal(0, 0.2, a.shape)).astype(np.float32)
        return a

    return jax.tree.map(nudge, params_to_numpy(tmodel.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")))


def _tensors(inp, dev="cpu"):
    return {k: torch.tensor(v, device=dev) for k, v in inp.items()}


def _jnp(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


# ------------------------------------------------------------------ loss

def test_cross_entropy_loss_matches_jax():
    g = np.random.default_rng(0)
    logits = g.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = g.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (g.random((3, 7)) < 0.7).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        want = jlayers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = tlayers.cross_entropy_loss(
            torch.tensor(logits), torch.tensor(labels),
            None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def family_grads():
    """Each family's perturbed tree, inputs and the reference's jitted
    ``value_and_grad(loss_fn)``, made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jconfigs.get_smoke_config(arch)
            tree = _tree(tconfigs.get_smoke_config(arch))
            inp = TM._inputs(jcfg)
            inp.pop("steps")
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jmodel.loss_fn(p, jcfg, b)))(
                TM._jax_params(tree, jcfg), _jnp(inp))
            cache[arch] = (tree, inp, float(loss), grads)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, family_grads):
    """``loss_fn`` and its gradient over every leaf, one smoke config per
    family, float32, against ``jax.value_and_grad(loss_fn)``."""
    cfg = tconfigs.get_smoke_config(arch)
    tree, inp, want_loss, want = family_grads(arch)
    params = params_from_numpy(tree, cfg, device="cpu")
    loss, grads = tstep.grads_and_loss(params, cfg, _tensors(inp))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    loss2 = tmodel.loss_fn(params, cfg, _tensors(inp))
    assert float(loss2) == float(loss)
    _close_leaves(grads, want, _grad_tol(arch), arch)
    assert all(float(g.abs().max()) > 0 for g in _leaves(grads)
               if g.numel() > 1) or cfg.family == "hybrid"


def test_remat_gradients_are_bitwise_the_plain_ones():
    """``cfg.remat`` runs each block as a checkpoint; the recomputed
    backward gives the gradients bit for bit (a dense and a hybrid
    config, whose groups are scanned twice)."""
    for arch in ("yi_34b", "zamba2_7b"):
        cfg = tconfigs.get_smoke_config(arch)
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(3),
                                    device="cpu")
        inp = TM._inputs(cfg, seed=3)
        inp.pop("steps")
        plain = tstep.grads_and_loss(
            params, dataclasses.replace(cfg, remat=False), _tensors(inp))
        remat = tstep.grads_and_loss(
            params, dataclasses.replace(cfg, remat=True), _tensors(inp))
        assert torch.equal(plain[0], remat[0])
        for a, b in zip(_leaves(plain[1]), _leaves(remat[1])):
            assert torch.equal(a, b), arch


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_param_logical_matches_reference(arch):
    """``param_logical`` equals the reference's tree, leaf for leaf, at
    full width, and each tuple names every axis of its parameter."""
    cfg = tconfigs.get_config(arch)
    got = tmodel.param_logical(cfg)
    assert got == jmodel.param_logical(jconfigs.get_config(arch))
    spec = tmodel.init_params(cfg, device="meta")

    def walk(lg, sp, path):
        if isinstance(sp, dict):
            assert set(lg) == set(sp), path
            for k in sp:
                walk(lg[k], sp[k], f"{path}/{k}")
        else:
            assert isinstance(lg, tuple) and len(lg) == sp.dim(), path

    walk(got, spec, "")


# ------------------------------------------------------------------ optimizer

def _opt_inputs(seed: int, dtype: str, step: int):
    """Identical params, grads and state as numpy: a stacked 3-D leaf, a
    matrix, a vector; grads over six decades; ``step`` the counter."""
    g = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 8, 12), "ln": (3, 8)}, "embed": (40, 8),
              "ln_f": (8,)}

    def draw(scale, shape, positive=False):
        x = g.normal(0, scale, shape) * g.choice([1, 1e-3, 1e-6], shape)
        return np.abs(x).astype(np.float32) if positive else x.astype(
            np.float32)

    def tree(fn):
        return {"blocks": {k: fn(s) for k, s in shapes["blocks"].items()},
                "embed": fn(shapes["embed"]), "ln_f": fn(shapes["ln_f"])}

    p = tree(lambda s: draw(1.0, s))
    if dtype == "bfloat16":  # values bf16 holds exactly
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                              np.float32), p)
    grads = tree(lambda s: draw(0.1, s))
    if dtype == "bfloat16":
        grads = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16), np.float32), grads)
    m = tree(lambda s: draw(0.01, s))
    v = tree(lambda s: draw(1e-4, s, positive=True))
    return p, grads, {"m": m, "v": v, "step": np.int32(step)}


def _to_torch(tree, dtype):
    return jax.tree.map(lambda a: torch.tensor(a).to(dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 3, 250])
def test_adamw_update_is_bitwise_the_reference(dtype, step, monkeypatch):
    """One AdamW step on identical params, grads and state: params, ``m``,
    ``v`` and the counter bitwise the jitted reference's (f32 and bf16
    params, in warmup and past it).  Slices are forced small, so a 2-D
    leaf is walked in row blocks too."""
    monkeypatch.setattr(topt, "_SLICE_ELEMS", 64)
    cfg = jopt.OptConfig(lr=3e-3, warmup_steps=5)
    p, g, opt = _opt_inputs(7 + step, dtype, step)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, jo = jax.jit(lambda p, g, o: jopt.adamw_update(p, g, o, cfg))(
        jax.tree.map(lambda a: jnp.asarray(a, jdt), p),
        jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
        jax.tree.map(jnp.asarray, opt))
    tdt = getattr(torch, dtype)
    topt_state = {"m": _to_torch(opt["m"], torch.float32),
                  "v": _to_torch(opt["v"], torch.float32),
                  "step": torch.tensor(opt["step"])}
    tp_in = _to_torch(p, tdt)
    tp, to = topt.adamw_update(tp_in, _to_torch(g, tdt), topt_state,
                               topt.OptConfig(lr=3e-3, warmup_steps=5))
    for a, b in zip(_leaves(tp_in), _leaves(_to_torch(p, tdt))):
        assert torch.equal(a, b)  # the functional form left its input
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == getattr(torch, str(b.dtype))
            np.testing.assert_array_equal(
                a.float().numpy().view(np.int32),
                np.asarray(b, np.float32).view(np.int32))
    assert int(to["step"]) == int(jo["step"]) == step + 1


def test_schedule_is_bitwise_the_reference():
    """The warmup's learning rate, as XLA folds it (a multiply by the
    reciprocal of ``warmup_steps``), for every step to 300."""
    steps = np.arange(0, 301, dtype=np.int32)
    for warmup in (1, 3, 5, 7, 100):
        jc = jopt.OptConfig(lr=1e-3, warmup_steps=warmup)
        want = np.asarray(jax.jit(jax.vmap(
            lambda s: jopt._schedule(jc, s)))(jnp.asarray(steps)))
        got = np.array([float(topt._schedule(topt.OptConfig(
            lr=1e-3, warmup_steps=warmup), torch.tensor(s)))
            for s in steps], np.float32)
        np.testing.assert_array_equal(got, want)


def test_global_norm_and_clip_match_jax(monkeypatch):
    """``global_norm`` within ``NORM_RTOL`` (the sum order inside a leaf),
    its leaves added in the reference's order; ``clip_by_global_norm``'s
    f32 tree within the same bound, and no clip below ``max_norm``."""
    monkeypatch.setattr(topt, "_SLICE_ELEMS", 64)
    _, g, _ = _opt_inputs(3, "float32", 0)
    g = jax.tree.map(lambda a: a * 50, g)
    for max_norm in (1.0, 1e6):
        want, want_gn = jax.jit(lambda t: jopt.clip_by_global_norm(
            t, max_norm))(jax.tree.map(jnp.asarray, g))
        got, gn = topt.clip_by_global_norm(_to_torch(g, torch.float32),
                                           max_norm)
        np.testing.assert_allclose(float(gn), float(want_gn),
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(
            float(topt.global_norm(_to_torch(g, torch.float32))),
            float(jopt.global_norm(jax.tree.map(jnp.asarray, g))),
            rtol=NORM_RTOL)
        for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=NORM_RTOL, atol=0)
    assert all(torch.equal(a, torch.tensor(b)) for a, b in zip(
        _leaves(got), jax.tree_util.tree_leaves(g)))


def test_adamw_moves_toward_minimum():
    """The reference's own property (``tests/test_train.py``)."""
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = topt.init_opt(params)
    cfg = topt.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw w^2
        grads, _ = topt.clip_by_global_norm(grads, cfg.clip_norm)
        params, opt = topt.adamw_update(params, grads, opt, cfg)
    assert float(params["w"].abs().max()) < 0.1
    assert int(opt["step"]) == 200 and opt["step"].dtype == torch.int32


def test_clip_by_global_norm():
    """The reference's own property (``tests/test_train.py``)."""
    clipped, gn = topt.clip_by_global_norm({"a": torch.full((10,), 100.0)},
                                           1.0)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)
    assert float(gn) > 100


def test_init_opt_and_state_conversion():
    """``init_opt`` is the reference's state (f32 zeros, int32 counter);
    ``opt_from_numpy`` / ``opt_to_numpy`` carry it across unchanged."""
    cfg = tconfigs.get_smoke_config("zamba2_7b")
    jcfg = jconfigs.get_smoke_config("zamba2_7b")
    jo = jax.eval_shape(lambda: jopt.init_opt(jmodel.init_params(
        jcfg, jax.random.PRNGKey(0))))
    to = topt.init_opt(tmodel.init_params(cfg, device="cpu"))
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 0
    for a, b in zip(_leaves(to["m"]), jax.tree_util.tree_leaves(jo["m"])):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
    g = np.random.default_rng(5)
    state = {"m": jax.tree.map(lambda a: g.normal(0, 1, a.shape).astype(
        np.float32), jo["m"]), "v": jax.tree.map(
        lambda a: g.random(a.shape).astype(np.float32), jo["v"]),
        "step": np.int32(9)}
    back = opt_to_numpy(opt_from_numpy(state, cfg, device="cpu"))
    assert int(back["step"]) == 9 and back["step"].dtype == np.int32
    for part in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(back[part]),
                        jax.tree_util.tree_leaves(state[part])):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="int32 scalar"):
        opt_from_numpy(dict(state, step=np.int64(9)), cfg, device="cpu")
    with pytest.raises(ValueError, match=r"opt\['m'\]"):
        opt_from_numpy(dict(state, m={}), cfg, device="cpu")


# ------------------------------------------------------------------ steps

def test_grads_and_loss_accumulation_matches_jax():
    """``accum=4`` (contiguous microbatches, f32 sums, then 1/4) against
    the reference's ``accum=4`` within the gradient tolerance, and against
    the port's own ``accum=1`` within ``rtol=1e-4`` of each leaf's largest
    element (the batch mean is summed in another order)."""
    cfg = tconfigs.get_smoke_config("yi_34b")
    jcfg = jconfigs.get_smoke_config("yi_34b")
    tree = _tree(cfg, seed=4)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 16)).astype(
        np.int32)
    jl, jg = jax.jit(lambda p, b: jstep.grads_and_loss(p, jcfg, b, 4))(
        TM._jax_params(tree, jcfg), {"tokens": jnp.asarray(toks)})
    params = params_from_numpy(tree, cfg, device="cpu")
    loss4, g4 = tstep.grads_and_loss(params, cfg,
                                     {"tokens": torch.tensor(toks)}, 4)
    assert all(g.dtype == torch.float32 for g in _leaves(g4))
    np.testing.assert_allclose(float(loss4), float(jl), rtol=LOSS_RTOL)
    _close_leaves(g4, jg, GRAD_TOL, "accum 4")
    loss1, g1 = tstep.grads_and_loss(params, cfg,
                                     {"tokens": torch.tensor(toks)}, 1)
    np.testing.assert_allclose(float(loss1), float(loss4), rtol=1e-5)
    _close_leaves(g1, [g.numpy() for g in _leaves(g4)], 1e-4, "accum 1")


def test_train_step_curves_match_jax():
    """Twelve steps of ``make_train_step`` on yi_34b smoke over
    ``SyntheticLMData``, from the reference's init and ``init_opt``: the
    loss and grad-norm curves against the reference's
    ``jax.jit(make_train_step)`` (outside any mesh) within ``CURVE_RTOL``,
    and the loss falls as ``tests/test_models.py`` asks of the reference.
    The step updates its trees in place and returns them."""
    CURVE_RTOL = 2e-5  # largest seen 3.2e-6: the ulps of each step grow
    jcfg = jconfigs.get_smoke_config("yi_34b")
    cfg = tconfigs.get_smoke_config("yi_34b")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    jo = jopt.init_opt(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    opt = opt_from_numpy(jax.tree.map(np.asarray, jo), cfg, device="cpu")
    data = tlm.SyntheticLMData(tlm.LMDataConfig(vocab=cfg.vocab, batch=8,
                                                seq_len=32, seed=3))
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt.OptConfig(
        lr=3e-3, warmup_steps=2)))
    tfn = tstep.make_train_step(cfg, topt.OptConfig(lr=3e-3, warmup_steps=2))
    want, got = [], []
    for i in range(12):
        b = data.batch_for_step(i)
        jparams, jo, jm = jfn(jparams, jo, _jnp(b))
        p2, o2, m = tfn(params, opt, _tensors(b))
        assert p2 is params and o2["m"] is opt["m"]
        params, opt = p2, o2
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want),
                               rtol=CURVE_RTOL)
    assert got[-1][0] < got[0][0] - 0.1, got
    assert int(opt["step"]) == 12


# ------------------------------------------------------------------ data

def test_synthetic_lm_data_is_the_reference():
    """Every batch bitwise the reference's, with and without extras."""
    for seed in (0, 3):
        cfg = dict(vocab=300, batch=4, seq_len=24, seed=seed)
        a = jlm.SyntheticLMData(jlm.LMDataConfig(**cfg))
        b = tlm.SyntheticLMData(tlm.LMDataConfig(**cfg))
        assert a.base_seed == b.base_seed
        np.testing.assert_array_equal(a.probs, b.probs)
        for step in (0, 1, 17):
            for extras in (None, {"frames": (24, 16), "img": (5, 16)}):
                x = a.batch_for_step(step, extras)
                y = b.batch_for_step(step, extras)
                assert sorted(x) == sorted(y)
                for k in x:
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])


# ------------------------------------------------------------------ checkpoints

def _mixed_tree(seed=0):
    g = np.random.default_rng(seed)
    w = g.normal(0, 1, (2, 3)).astype(np.float32)
    b = np.asarray(jnp.asarray(g.normal(0, 1, (4,)), jnp.bfloat16),
                   np.float32)  # values bf16 holds
    m = g.normal(0, 1, (2, 3)).astype(np.float32)
    return {"params": {"w": w, "b": b, "blocks": {"u": m[:1]}},
            "opt": {"m": m, "step": np.int32(7)}}


def _port_tree(tree):
    t = jax.tree.map(torch.tensor, tree)
    t["params"]["b"] = t["params"]["b"].to(torch.bfloat16)
    return t


def _jax_tree(tree):
    t = jax.tree.map(jnp.asarray, tree)
    t["params"]["b"] = t["params"]["b"].astype(jnp.bfloat16)
    return t


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    """As the reference's own test: the newest complete step is found, a
    torn ``.tmp`` directory is not, and the tree comes back bit for bit
    (a bf16 leaf too)."""
    tree = _port_tree(_mixed_tree())
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 5, tree)
    tckpt.save_checkpoint(d, 10, tree, extra={"arch": "x"})
    assert tckpt.latest_step(d) == 10
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    os.makedirs(os.path.join(d, "step_00000098"))  # no manifest
    assert tckpt.latest_step(d) == 10
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    restored, step = tckpt.restore_latest(d, tree)
    assert step == 10
    for a, b in zip(_leaves(restored), _leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored["opt"]["step"]) == 7
    assert tckpt.restore_latest(str(tmp_path / "none"), tree) == (None, None)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A file the reference writes (f32, bf16 as ``V2`` bits, int32)
    restores into the port bit for bit."""
    tree = _mixed_tree(1)
    d = str(tmp_path / "ref")
    jckpt.save_checkpoint(d, 3, _jax_tree(tree))
    with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as f:
        assert f["params||b"].dtype.kind == "V"
        assert sorted(f.files) == sorted(
            k for k, _ in tckpt._items(tree))
    restored, step = tckpt.restore_latest(d, _port_tree(tree))
    assert step == 3
    for a, b in zip(_leaves(restored), _leaves(_port_tree(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port's file restores into the reference bit for bit (f32 and
    int32 leaves), and its bf16 leaf is the reference's own array, the
    same ``V2`` bits (the reference's restore casts ``V2`` to bfloat16,
    which numpy refuses for its own files and the port's alike)."""
    tree = _mixed_tree(2)
    d = str(tmp_path / "port")
    tckpt.save_checkpoint(d, 4, _port_tree(tree))
    plain = {"params": {k: v for k, v in tree["params"].items() if k != "b"},
             "opt": tree["opt"]}
    like = jax.tree.map(jnp.asarray, plain)
    got = jckpt.restore_checkpoint(d, 4, like)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(plain)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 4, _jax_tree(tree))
    with np.load(os.path.join(d, "step_00000004", "arrays.npz")) as p, \
            np.load(str(tmp_path / "ref" / "step_00000004" /
                        "arrays.npz")) as r:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            assert p[k].dtype == r[k].dtype and p[k].tobytes() == \
                r[k].tobytes(), k
    for path in (d, str(tmp_path / "ref")):
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore_checkpoint(path, 4, _jax_tree(tree))


# ------------------------------------------------------------------ launcher

LAUNCH = ["--arch", "yi_34b", "--smoke", "--steps", "10", "--batch", "4",
          "--seq", "16", "--ckpt-every", "5", "--log-every", "100",
          "--device", "cpu"]


def _launch(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *LAUNCH, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_launcher_crash_and_resume_is_bitwise(tmp_path):
    """``--simulate-failure 6`` exits 42 after step 6 with step 5 on disk;
    ``--resume`` replays steps 6 to 10; every array of the final checkpoint
    equals the uninterrupted run's, bit for bit (the reference's own test
    allows ``rtol=1e-5``; the port on the CPU needs none)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    r = _launch(["--ckpt-dir", d1])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[train] done" in r.stdout
    r = _launch(["--ckpt-dir", d2, "--simulate-failure", "6"])
    assert r.returncode == 42, r.stderr[-2000:]
    assert "[train] simulated failure at step 6" in r.stdout
    assert tckpt.latest_step(d2) == 5
    r = _launch(["--ckpt-dir", d2, "--resume", "--log-every", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[train] resumed from step 5" in r.stdout
    assert "[train] step 6 loss=" in r.stdout and "s/step)" in r.stdout
    a = np.load(os.path.join(d1, "step_00000010", "arrays.npz"))
    b = np.load(os.path.join(d2, "step_00000010", "arrays.npz"))
    assert set(a.files) == set(b.files) and len(a.files) == 3 * 12 + 1
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_launcher_metrics_and_refusals(tmp_path, capsys):
    """``--metrics`` writes each step and a summary; ``--model 2`` and
    ``--data 2`` without a process group raise, naming why; without
    ``--device cpu`` the launcher needs a card."""
    path = tmp_path / "m.jsonl"
    argv = [a for a in LAUNCH if a != "--smoke"] + ["--smoke"]
    assert tlaunch.main(argv + ["--steps", "3", "--metrics", str(path)]) == 0
    import json

    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["step"] for x in lines[:3]] == [1, 2, 3]
    summary = lines[3]
    assert summary["summary"] and summary["n_params"] == \
        tconfigs.get_smoke_config("yi_34b").n_params()
    assert summary["leaves_moved"] == summary["leaves"] == 12
    assert summary["random_leaves_moved"] == summary["random_leaves"] == 9
    assert summary["peak_bytes"] is None
    assert "[train] done" in capsys.readouterr().out
    with pytest.raises(ValueError, match="torch.distributed.run"):
        tlaunch.main(argv + ["--model", "2"])
    with pytest.raises(ValueError, match="torch.distributed.run"):
        tlaunch.main(argv + ["--data", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--smoke", "--steps", "1"])


def test_train_lm_example_runs_on_cpu(tmp_path):
    """``examples_torch/train_lm.py --device cpu``: a crash at step 11 and
    the resume from the checkpoint of step 10."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "examples_torch/train_lm.py",
                        "--device", "cpu", "--arch", "yi_34b", "--steps",
                        "20", "--ckpt", str(tmp_path / "c")], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "[train] resumed from step 10" in r.stdout
    assert "training survived a mid-run failure" in r.stdout
    assert tckpt.latest_step(str(tmp_path / "c")) == 20
