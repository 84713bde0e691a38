"""Parity: the LM harness's serving path (``repro_torch.configs``,
``repro_torch.models``, the ``lm`` mode of ``repro_torch.launch.serve``)
against the JAX package, on the CPU.

The weights are the reference's ``init_params(cfg, PRNGKey(0))`` carried
across as float32 numpy (``params_from_numpy``), with every leaf the
reference initialises to a constant perturbed by seeded noise first, so
that no path is silenced (the vlm's ``xgate`` is 0, the mamba ``A_log``,
``dt_bias`` and ``conv_b`` are 0).  Inputs are made with numpy from seeds.
Tolerances, float32: ``rtol=1e-4, atol=1e-5`` on modules, logits and
states (``F32_TOL``), but ``atol=1e-4`` for rwkv6 (``MODEL_TOL``);
bfloat16: ``BF16_TOL``.  The two packages sum in
different orders (XLA contracts some ``a*b + c`` into an fma, GEMMs block
differently), so nothing here is bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# RWKV6's per-head group norm in the time mix divides by the root of a
# small variance: the one-ulp differences of XLA's fused rms_norm in front
# of it come out of the forward's logits at up to 5.9e-5 (at unit scale)
MODEL_TOL = {"rwkv6_3b": dict(rtol=1e-4, atol=1e-4)}
# bf16 keeps 8 significant bits: the forward's logits (up to 3.7) differ
# by up to 3 units in their last place (0.0156 at 2 to 4); four at that
# scale
BF16_TOL = dict(rtol=1e-2, atol=6.25e-2)
B, S = 2, 16
DECODE_STEPS = 4
ARCHS = list(jconfigs.ARCH_IDS)


def _close(got, want, what="", tol=F32_TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.tensor(np.asarray(a))


def _flatten(tree, prefix=""):
    """{path: leaf} of a tree of dicts, tuples and arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ configs

def test_configs_match_reference():
    """Every field of the ten full and ten smoke configs, the registry and
    the parameter counts equal the reference's."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.SHAPES == tuple(
        tconfigs.ShapeCell(**dataclasses.asdict(c)) for c in jconfigs.SHAPES)
    for arch in ARCHS:
        for name in (arch, arch.replace("_", "-")):
            for get in ("get_config", "get_smoke_config"):
                want = getattr(jconfigs, get)(name)
                got = getattr(tconfigs, get)(name)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert (got.n_params(), got.n_active_params()) == (
                    want.n_params(), want.n_active_params())
                assert (got.head_dim, got.d_inner, got.n_ssm_heads) == (
                    want.head_dim, want.d_inner, want.n_ssm_heads)


# ------------------------------------------------------------------ modules

def test_rms_norm_mlp_rope_match_jax():
    g = _rng(1)
    x = g.normal(0, 1, (2, 5, 64)).astype(np.float32)
    scale = g.normal(1, 0.1, (64,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
           "rms_norm")
    for act in ("swiglu", "relu2", "gelu"):
        p = {"w_in": g.normal(0, 0.125, (64, 96)),
             "w_out": g.normal(0, 0.1, (96, 64)),
             "w_gate": g.normal(0, 0.125, (64, 96))}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        _close(tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
               jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), act), f"mlp {act}")
    pos = np.arange(0, 300, 7)
    for theta in (10_000.0, 500_000.0):
        for got, want in zip(tlayers.rope(_t(pos), 32, theta),
                             jlayers.rope(jnp.asarray(pos), 32, theta)):
            _close(got, want, f"rope {theta}")
    cos, sin = jlayers.rope(jnp.arange(5), 16, 10_000.0)
    xh = g.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    _close(tlayers.apply_rope(_t(xh), _t(cos), _t(sin)),
           jlayers.apply_rope(jnp.asarray(xh), cos, sin), "apply_rope")


def _attn_params(g, d=64, hq=4, hkv=2, dh=16):
    shapes = {"wq": (d, hq, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
              "wo": (hq, dh, d)}
    p = {k: g.normal(0, 0.15, s).astype(np.float32)
         for k, s in shapes.items()}
    return p, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


ATTN_KW = dict(n_heads=4, n_kv=2, d_head=16, rope_theta=10_000.0)


@pytest.mark.parametrize("window,memory", [(None, False), (5, False),
                                           (None, True)])
def test_attention_matches_jax(window, memory):
    """Causal GQA attention, with the sliding window, and cross-attention
    over a memory (no mask, no rope), with the k/v it returns."""
    g = _rng(2)
    _, jp, tp = _attn_params(g)
    x = g.normal(0, 1, (2, 12, 64)).astype(np.float32)
    mem = g.normal(0, 1, (2, 9, 64)).astype(np.float32) if memory else None
    want = jattn.attention(jp, jnp.asarray(x), window=window,
                           memory=None if mem is None else jnp.asarray(mem),
                           **ATTN_KW)
    got = tattn.attention(tp, _t(x), window=window,
                          memory=None if mem is None else _t(mem), **ATTN_KW)
    _close(got[0], want[0], "out")
    for a, b in zip(got[1], want[1]):
        _close(a, b, "kv")
    if memory:  # the decode path's projected memory
        for a, b in zip(tattn.project_memory_kv(tp, _t(mem)),
                        jattn.project_memory_kv(jp, jnp.asarray(mem))):
            _close(a, b, "project_memory_kv")
        xq = x[:, :1]
        jk, jv = want[1]
        _close(tattn.attention_with_kv(tp, _t(xq), _t(_np(jk)), _t(_np(jv)),
                                       n_heads=4, n_kv=2, d_head=16),
               jattn.attention_with_kv(jp, jnp.asarray(xq), jk, jv,
                                       n_heads=4, n_kv=2, d_head=16),
               "attention_with_kv")


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode_matches_jax(window):
    """Ten decode steps into a 6-slot cache: with the window the ring
    wraps after step 6 (slot ``pos % 6``, every slot valid); without it
    the slot past the cache clamps to the last row, as
    ``dynamic_update_slice`` does."""
    g = _rng(3)
    _, jp, tp = _attn_params(g)
    jc = jattn.init_cache(2, 2, 6, 16, jnp.float32)
    tc = tattn.init_cache(2, 2, 6, 16, torch.float32)
    for pos in range(10):
        x = g.normal(0, 1, (2, 1, 64)).astype(np.float32)
        jo, jc = jattn.attention_decode(jp, jnp.asarray(x), jc,
                                        jnp.int32(pos), window=window,
                                        **ATTN_KW)
        to, tc = tattn.attention_decode(tp, _t(x), tc, pos, window=window,
                                        **ATTN_KW)
        _close(to, jo, f"out pos {pos}")
        for a, b in zip(tc, jc):
            _close(a, b, f"cache pos {pos}")


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_ffn_matches_jax(capacity_factor):
    """The routed FFN and its router logits: at capacity factor 4 every
    pair has a slot; at 0.5 some experts get more pairs than their ``cap``
    slots and drop the rest."""
    g = _rng(4)
    d, ff, e, k, s = 32, 24, 8, 2, 16
    p = {"router": g.normal(0, d ** -0.5, (d, e)),
         "w_in": g.normal(0, d ** -0.5, (e, d, ff)),
         "w_gate": g.normal(0, d ** -0.5, (e, d, ff)),
         "w_out": g.normal(0, ff ** -0.5, (e, ff, d))}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    x = g.normal(0, 1, (3, s, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=capacity_factor)
    jy, jl = jmoe.moe_ffn({n: jnp.asarray(v) for n, v in p.items()},
                          jnp.asarray(x), **kw)
    ty, tl = tmoe.moe_ffn({n: _t(v) for n, v in p.items()}, _t(x), **kw)
    _close(tl, jl, "router logits")
    _close(ty, jy, "moe out")
    cap = int(max(1, round(s * k / e * capacity_factor)))
    _, top = jax.lax.top_k(jax.nn.softmax(jl.reshape(3, s, e)), k)
    counts = np.stack([np.bincount(np.asarray(r).ravel(), minlength=e)
                       for r in top])
    assert (counts > cap).any() == (capacity_factor == 0.5), (cap, counts)


def test_moe_top_k_takes_ties_to_the_lowest_expert():
    """Equal router probabilities: the lowest expert indices win, as in
    ``lax.top_k``."""
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25],
                           [0.1, 0.3, 0.3, 0.3]]])
    vals, idx = tmoe._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[[0, 1], [1, 2]]]
    _close(vals, jv, "values")


def _mamba_params(g, d=32, expand=2, h=2, state=8, conv=4):
    d_in = expand * d
    conv_dim = d_in + 2 * state
    p = {"in_proj": g.normal(0, d ** -0.5, (d, 2 * d_in + 2 * state + h)),
         "conv_w": g.normal(0, 0.2, (conv, conv_dim)),
         "conv_b": g.normal(0, 0.1, (conv_dim,)),
         "A_log": g.normal(0, 0.5, (h,)),
         "D": g.normal(1, 0.1, (h,)),
         "dt_bias": g.normal(0, 0.5, (h,)),
         "norm": g.normal(1, 0.1, (d_in,)),
         "out_proj": g.normal(0, d_in ** -0.5, (d_in, d))}
    return {n: v.astype(np.float32) for n, v in p.items()}


def test_mamba2_matches_jax():
    """The chunked SSD scan (3 chunks of 8) and five decode steps after
    it, state and outputs."""
    g = _rng(5)
    p = _mamba_params(g)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: _t(v) for n, v in p.items()}
    kw = dict(expand=2, n_heads=2, state=8)
    x = g.normal(0, 1, (2, 24, 32)).astype(np.float32)
    _close(tssm.mamba2(tp, _t(x), chunk=8, **kw),
           jssm.mamba2(jp, jnp.asarray(x), chunk=8, **kw), "mamba2")
    with pytest.raises(ValueError, match="ssm_chunk = 7"):
        tssm.mamba2(tp, _t(x), chunk=7, **kw)
    js = jssm.init_mamba2_state(2, 32, 2, 2, 8, 4, jnp.float32)
    ts = tssm.init_mamba2_state(2, 32, 2, 2, 8, 4, torch.float32)
    for step in range(5):
        xs = g.normal(0, 1, (2, 1, 32)).astype(np.float32)
        jo, js = jssm.mamba2_decode(jp, jnp.asarray(xs), js, **kw)
        to, ts = tssm.mamba2_decode(tp, _t(xs), ts, **kw)
        _close(to, jo, f"decode out {step}")
        for a, b in zip(ts, js):
            _close(a, b, f"decode state {step}")


def test_rwkv6_matches_jax():
    """Time mix chunked (3 chunks of 8), channel mix, and five decode
    steps of both, state and outputs."""
    g = _rng(6)
    jp = jssm.init_rwkv6(jax.random.PRNGKey(6), 64, 96, 4, jnp.float32)
    p = {n: _np(v) for n, v in jp.items()}
    p["ln_x"] = g.normal(1, 0.1, p["ln_x"].shape).astype(np.float32)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: _t(v) for n, v in p.items()}
    x = g.normal(0, 1, (2, 24, 64)).astype(np.float32)
    _close(tssm.rwkv6_timemix(tp, _t(x), n_heads=4, chunk=8),
           jssm.rwkv6_timemix(jp, jnp.asarray(x), n_heads=4, chunk=8),
           "timemix")
    _close(tssm.rwkv6_channelmix(tp, _t(x)),
           jssm.rwkv6_channelmix(jp, jnp.asarray(x)), "channelmix")
    with pytest.raises(ValueError, match="ssm_chunk = 5"):
        tssm.rwkv6_timemix(tp, _t(x), n_heads=4, chunk=5)
    js = jssm.init_rwkv6_state(2, 64, 4, jnp.float32)
    ts = tssm.init_rwkv6_state(2, 64, 4, torch.float32)
    for step in range(5):
        xs = g.normal(0, 1, (2, 1, 64)).astype(np.float32)
        jo, js = jssm.rwkv6_timemix_decode(jp, jnp.asarray(xs), js,
                                           n_heads=4)
        to, ts = tssm.rwkv6_timemix_decode(tp, _t(xs), ts, n_heads=4)
        _close(to, jo, f"timemix decode {step}")
        for a, b in zip(ts, js):
            _close(a, b, f"timemix state {step}")
        jo, jsh = jssm.rwkv6_channelmix_decode(jp, jnp.asarray(xs), js[2])
        to, tsh = tssm.rwkv6_channelmix_decode(tp, _t(xs), ts[2])
        _close(to, jo, f"channelmix decode {step}")
        _close(tsh, jsh, f"channelmix shift {step}")


# ------------------------------------------------------------------ models

def _jax_init(cfg):
    """The reference's ``init_params(cfg, key)``, jitted (one compile, then
    each key in one call)."""
    return jax.jit(lambda key: jmodel.init_params(cfg, key))


def _perturbed_tree(cfg, seed=0):
    """The reference's init as float32 numpy, every constant leaf moved by
    seeded noise (sd 0.2)."""
    tree = jax.tree.map(_np, _jax_init(cfg)(jax.random.PRNGKey(0)))
    g = _rng(100 + seed)

    def nudge(a):
        if a.size and np.all(a == a.flat[0]):
            return (a + g.normal(0, 0.2, a.shape)).astype(np.float32)
        return a

    return jax.tree.map(nudge, tree)


def _inputs(cfg, seed=0):
    g = _rng(200 + seed)
    inp = {"tokens": g.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "steps": g.integers(0, cfg.vocab, (DECODE_STEPS, B, 1)).astype(
               np.int32)}
    if cfg.family == "encdec":
        inp["frames"] = g.normal(0, 0.5, (B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        inp["img"] = g.normal(0, 0.5, (B, cfg.n_img_tokens,
                                       cfg.d_model)).astype(np.float32)
    return inp


def _drive(pkg, cfg, params, inp, to_np):
    """forward (full and last-only), the seeded decode state, and
    ``DECODE_STEPS`` teacher-forced decode steps at ``S + i``, through one
    package: {name: float32 numpy}."""
    if pkg == "jax":
        m, asarr = jmodel, jnp.asarray
        fwd = jax.jit(lambda p, b, last: m.forward(p, cfg, b,
                                                   logits_last_only=last),
                      static_argnums=2)
        step = jax.jit(lambda p, st, t, q: m.decode_step(p, cfg, st, t, q))
        state = m.init_decode_state(cfg, B, S + DECODE_STEPS, mem_len=S)
        pos = jnp.int32
    else:
        m, asarr = tmodel, torch.tensor
        fwd = (lambda p, b, last: m.forward(p, cfg, b,
                                            logits_last_only=last))
        step = (lambda p, st, t, q: m.decode_step(p, cfg, st, t, q))
        state = m.init_decode_state(cfg, B, S + DECODE_STEPS, mem_len=S,
                                    device="cpu")
        pos = int
    batch = {k: asarr(v) for k, v in inp.items() if k != "steps"}
    out = {}
    logits, aux = fwd(params, batch, False)
    out["forward/logits"], out["forward/aux"] = to_np(logits), to_np(aux)
    out["last/logits"] = to_np(fwd(params, batch, True)[0])
    if cfg.family == "encdec":
        mem = m.encode_memory(params, cfg, batch["frames"])
        out["encode_memory"] = to_np(mem)
        state = m.seed_decode_state(params, cfg, state, mem)
    elif cfg.family == "vlm":
        state = m.seed_decode_state(params, cfg, state, batch["img"])
    out.update({f"seeded{k}": to_np(v) for k, v in _flatten(state).items()})
    for i in range(DECODE_STEPS):
        logits, state = step(params, state, asarr(inp["steps"][i]),
                             pos(S + i))
        out[f"step{i}/logits"] = to_np(logits)
        out.update({f"step{i}/state{k}": to_np(v)
                    for k, v in _flatten(state).items()})
    return out


def _tnp(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def jax_runs():
    """Each configuration's JAX outputs, made once: {name: (tree, inputs,
    outputs)}."""
    cache = {}

    def get(name, cfg):
        if name not in cache:
            tree = _perturbed_tree(cfg)
            inp = _inputs(cfg)
            cache[name] = (tree, inp, _drive("jax", cfg,
                                             _jax_params(tree, cfg), inp,
                                             _np))
        return cache[name]

    return get


def _jax_params(tree, cfg):
    """The numpy tree back into the reference's leaf dtypes."""
    ref = jax.eval_shape(lambda: jmodel.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a, r: jnp.asarray(a).astype(r.dtype), tree,
                        ref)


def _check_model(cfg, tree, inp, want, tol):
    params = params_from_numpy(tree, cfg, device="cpu")
    got = _drive("torch", cfg, params, inp, _tnp)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key, tol)
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, jax_runs):
    """Forward (full and last-only) and aux, encdec's memory and both
    seeded cross caches, and four teacher-forced decode steps (logits and
    the whole state tree) of each smoke config, float32."""
    cfg = tconfigs.get_smoke_config(arch)
    tree, inp, want = jax_runs(arch, jconfigs.get_smoke_config(arch))
    got = _check_model(cfg, tree, inp, want, MODEL_TOL.get(arch, F32_TOL))
    assert np.isfinite(got["step3/logits"]).all()
    if cfg.family == "vlm":  # the perturbed gate lets the image through
        assert np.all(tree["groups"]["cross"]["xgate"] != 0)
    if cfg.family == "hybrid":
        assert np.all(tree["groups"]["m"]["A_log"] != 0)
    if cfg.family == "moe":
        assert got["forward/aux"] > 0


def test_model_bf16_matches_jax(jax_runs):
    """A dense smoke config in bfloat16 (params and compute)."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("yi_34b"), **over)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("yi_34b"), **over)
    tree, inp, want = jax_runs("yi_34b bf16", jcfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    assert params["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    _check_model(cfg, tree, inp, want, BF16_TOL)


# ------------------------------------------------------------------ init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """The port's own init: the reference's tree, shapes and dtypes;
    constant leaves equal; each random leaf's mean and std (pooled over 4
    draws) within 10% of the reference's (pooled over 4 keys)."""
    cfg = tconfigs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    jinit = _jax_init(jcfg)
    jdraws = [jax.tree.map(_np, jinit(jax.random.PRNGKey(s)))
              for s in range(4)]
    tdraws = [params_to_numpy(tmodel.init_params(
        cfg, torch.Generator().manual_seed(s), device="cpu"))
        for s in range(4)]
    jspec = _flatten(jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0))))
    tspec = _flatten(tmodel.init_params(cfg, device="meta"))
    assert sorted(jspec) == sorted(tspec)
    for path, r in jspec.items():
        t = tspec[path]
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), path
        jl = np.stack([_flatten(d)[path] for d in jdraws])
        tl = np.stack([_flatten(d)[path] for d in tdraws])
        if np.all(jl == jl.flat[0]):
            assert np.all(tl == jl.flat[0]), path
            continue
        scale = jl.std()
        assert abs(tl.std() - scale) <= 0.1 * scale, (path, tl.std(), scale)
        assert abs(tl.mean() - jl.mean()) <= 0.1 * scale, path


def test_params_from_numpy_checks_the_tree():
    cfg = tconfigs.get_smoke_config("yi_34b")
    tree = params_to_numpy(tmodel.init_params(cfg, device="cpu"))
    bits = dict(tree, ln_f=np.ones(cfg.d_model, np.float32).view(np.uint16)[
        : cfg.d_model])
    with pytest.raises(ValueError, match="bf16 bits"):
        params_from_numpy(bits, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "ln_f"},
                          cfg, device="cpu")
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    ones = torch.ones(cfg.d_model, dtype=torch.bfloat16)
    bits = dict(tree, ln_f=ones.view(torch.int16).numpy().view(np.uint16))
    got = params_from_numpy(bits, bf, device="cpu")
    assert torch.equal(got["ln_f"], ones)


# ------------------------------------------------------------------ entry

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_smoke_runs_on_cpu(arch, capsys):
    """``serve lm --smoke --device cpu``: a prefill and four decode steps."""
    assert serve_main(["lm", "--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--tokens",
                       "4"]) == 0
    out = capsys.readouterr().out
    assert "[lm] prefill 2x16" in out and "ms/token" in out
    assert "[lm] sample:" in out


def test_serve_lm_refuses_a_mesh():
    """``--data 2`` or ``--model 2`` without a process group of 2 ranks
    raises, naming the launcher that makes one."""
    for flag in ("--data", "--model"):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            serve_main(["lm", "--smoke", "--device", "cpu", flag, "2"])


def test_serve_lm_example_runs_on_cpu(capsys):
    """``examples_torch/serve_lm.py --device cpu``: its default smoke
    architecture (zamba2_7b) through the ``lm`` mode."""
    path = ROOT / "examples_torch" / "serve_lm.py"
    spec = importlib.util.spec_from_file_location("example_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--tokens", "2"]) == 0
    assert "decoded 2 tokens x batch 4" in capsys.readouterr().out
