"""Model assembly: init / forward / decode for every assigned architecture
family, in PyTorch.

Counterpart of ``repro/models/model.py``.  Families: dense
(deepseek/yi/nemotron/h2o-danube), moe (granite/qwen3), ssm (rwkv6),
hybrid (zamba2: mamba2 blocks and one shared attention block), encdec
(seamless-m4t: stub frame embeddings -> encoder, token decoder), vlm
(llama-3.2-vision: stub patch embeddings, a cross-attention block closing
every group of ``cross_attn_every`` layers).

Params are the reference's tree: nested dicts, homogeneous blocks stacked
along a leading layer axis (the hybrid's ``groups`` along two), which the
forward and decode loops walk in Python.  ``param_logical(cfg)`` mirrors the
tree with logical-axes tuples at the leaves.  Where the reference wraps a
scanned block in ``jax.checkpoint`` (``cfg.remat``), the forward runs it
through ``torch.utils.checkpoint`` while grad is enabled: its activations
are recomputed in the backward instead of kept.  Neither that nor
``cfg.scan_unroll`` changes an output.  ``loss_fn`` is the train step's
objective.

``constrain`` (``repro_torch.dist``) sits at the reference's sites.  On one
device, a logical mesh or plain tensors it is the identity and every
branch below is the one-device program.  Given DTensor parameters laid on
a rank mesh (``init_params(..., mesh=)``) it redistributes the
activations, and the products (``dist.einsum``), the attention, the SSM
scans and the MoE's routing run on each rank's shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist import (constrain, distribute_leaf, einsum, is_rank_mesh,
                    reshape)
from ..runtime import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (DTYPES, Init, cross_entropy_loss, embed_sharded,
                     init_linear, init_mlp, mlp, mlp_logical, rms_norm)

__all__ = [
    "seed_decode_state",
    "encode_memory",
    "init_params",
    "param_logical",
    "forward",
    "init_decode_state",
    "decode_step",
    "loss_fn",
]


def _dt(name: str) -> torch.dtype:
    return DTYPES[name]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (every leaf indexed on its leading
    axis)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _depth(tree) -> int:
    """The leading (layer) axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _unstack(tree) -> list:
    """The layers of a stacked tree, each leaf unbound once along its
    leading axis (one backward node a leaf, where indexing would add one a
    layer, each writing a whole leaf of zeros)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return torch.unbind(tree)


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ===================================================================== blocks
def _attn_kw(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def _init_dense_block(init: Init, cfg: ModelConfig, lead: tuple = ()):
    dt = _dt(cfg.param_dtype)
    d = cfg.d_model
    p = {
        "ln1": init.full((*lead, d), 1.0, dt),
        "attn": attn.init_attn(init, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dt, lead=lead),
        "ln2": init.full((*lead, d), 1.0, dt),
    }
    if cfg.family == "moe":
        p["mlp"] = moe_mod.init_moe(init, d, cfg.d_ff, cfg.n_experts, dt,
                                    lead=lead)
    else:
        p["mlp"] = init_mlp(init, d, cfg.d_ff, cfg.activation, dt, lead=lead)
    return p


def _init_cross_block(init: Init, cfg: ModelConfig, lead: tuple):
    """A dense block with a cross-attention beside it (encdec's decoder
    blocks, the vlm's cross blocks)."""
    dt = _dt(cfg.param_dtype)
    return {
        **_init_dense_block(init, cfg, lead),
        "lnx": init.full((*lead, cfg.d_model), 1.0, dt),
        "xattn": attn.init_attn(init, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, dt, lead=lead),
    }


def _ffn(p, hin, cfg: ModelConfig):
    """The block's MLP or MoE: (out, router logits or None)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(p["mlp"], hin, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
    return mlp(p["mlp"], hin, cfg.activation), None


def dense_block_logical(cfg: ModelConfig):
    return {
        "ln1": (None,),
        "attn": attn.attn_logical(),
        "ln2": (None,),
        "mlp": moe_mod.moe_logical() if cfg.family == "moe"
        else mlp_logical(cfg.activation),
    }


def dense_block(p, x, cfg: ModelConfig):
    """Returns (x, aux): aux is the MoE load-balance loss (or 0)."""
    h, _ = attn.attention(
        p["attn"], constrain(rms_norm(x, p["ln1"], cfg.norm_eps),
                             ("batch", "act_seq", None)),
        causal=True, window=cfg.sliding_window, **_attn_kw(cfg))
    x = constrain(x + h, ("batch", "seq", None))
    hin = constrain(rms_norm(x, p["ln2"], cfg.norm_eps),
                    ("batch", "act_seq", None))
    h, router_logits = _ffn(p, hin, cfg)
    aux = (_zero(x) if router_logits is None
           else _load_balance_loss(router_logits, cfg))
    return constrain(x + h, ("batch", "seq", None)), aux


def _load_balance_loss(router_logits, cfg: ModelConfig):
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    if isinstance(router_logits, DTensor):
        return _load_balance_loss_laid(router_logits, cfg)
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    top = torch.argmax(probs, dim=-1)
    f = F.one_hot(top, cfg.n_experts).float().mean(0)
    pbar = probs.mean(0)
    return cfg.n_experts * torch.sum(f * pbar)


def _load_balance_loss_laid(router_logits, cfg: ModelConfig):
    """:func:`_load_balance_loss` of (B, S, E) DTensor logits: each rank
    counts its tokens' top choices and sums their probabilities (partial
    sums over the mesh dimensions that shard the tokens), then the means
    are taken whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = router_logits.device_mesh
    rows = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                 for p in router_logits.placements)
    router_logits = router_logits.redistribute(mesh, rows)
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in rows)

    def counts(lg):
        probs = torch.softmax(lg, dim=-1).reshape(-1, cfg.n_experts)
        top = torch.argmax(probs, dim=-1)
        return (F.one_hot(top, cfg.n_experts).float().sum(0),
                probs.sum(0))

    f, p = local_map(counts, out_placements=(sums, sums), in_placements=None,
                     in_grad_placements=(rows,))(router_logits)
    n = router_logits.shape[0] * router_logits.shape[1]
    whole = [Replicate()] * mesh.ndim
    f = f.redistribute(mesh, whole) / n
    pbar = p.redistribute(mesh, whole) / n
    return cfg.n_experts * torch.sum(f * pbar)


def _scan_blocks(block_fn, stacked, x, remat: bool = False):
    """Run ``block_fn`` over the stacked layers in order; (x, sum of aux).
    With ``remat`` and grad enabled each block is a checkpoint: only its
    input is kept, and its activations are recomputed in the backward."""
    fn = block_fn
    if remat and torch.is_grad_enabled():
        def fn(p, h):
            return checkpoint(block_fn, p, h, use_reentrant=False)
    auxs = []
    for p in _unstack(stacked):
        x, aux = fn(p, x)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


# ===================================================================== top level
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, mesh=None):
    """The reference's parameter tree for ``cfg``, drawn from ``generator``
    (default: a generator on ``device`` seeded with 0).

    Each leaf has the reference's shape, dtype, distribution and scale;
    random leaves are drawn in f32 and cast.  Their bits are not
    ``jax.random``'s.  On ``device="meta"`` the leaves carry shapes and
    dtypes only.  Given a ``DeviceMesh``, every rank draws the same leaves
    (the one-device bits) one at a time and keeps its shard, laid by
    :func:`param_logical` (``dist.distribute_leaf``): a tree of DTensors.
    """
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if is_rank_mesh(mesh):
        # the leaves' draw order, from a pass on meta, names each leaf's
        # logical axes before it is drawn
        order = []
        meta = _init_tree(cfg, Init(None, "meta", place=lambda t: (
            order.append(t), t)[1]))
        axes = {id(t): ax for t, ax in zip(_leaves(meta),
                                           _leaves(param_logical(cfg)))}
        todo = iter([axes[id(t)] for t in order])
        return _init_tree(cfg, Init(generator, dev, place=lambda t: (
            distribute_leaf(t, next(todo), mesh))))
    return _init_tree(cfg, Init(generator, dev))


def _leaves(tree) -> list:
    """The leaves of a dict tree, keys sorted (a logical-axes tuple is a
    leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _init_tree(cfg: ModelConfig, init: Init):
    dt = _dt(cfg.param_dtype)
    d = cfg.d_model
    p = {
        "embed": init.normal((cfg.vocab, d), 0.02, dt),
        "ln_f": init.full((d,), 1.0, dt),
        "unembed": init_linear(init, d, cfg.vocab, dt),
    }
    fam = cfg.family
    if fam in ("dense", "moe"):
        p["blocks"] = _init_dense_block(init, cfg, (cfg.n_layers,))
    elif fam == "ssm":
        lead = (cfg.n_layers,)
        p["blocks"] = {
            "ln1": init.full((*lead, d), 1.0, dt),
            "tm": ssm_mod.init_rwkv6(init, d, cfg.d_ff, cfg.n_heads, dt,
                                     lead=lead),
            "ln2": init.full((*lead, d), 1.0, dt),
        }
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        groups = cfg.n_layers // (every + 1)
        trailing = cfg.n_layers - groups * (every + 1)

        def mamba_init(lead):
            return {
                "ln": init.full((*lead, d), 1.0, dt),
                "m": ssm_mod.init_mamba2(init, d, cfg.ssm_expand,
                                         cfg.n_ssm_heads, cfg.ssm_state,
                                         cfg.ssm_conv, dt, lead=lead),
            }

        p["groups"] = mamba_init((groups, every))
        # one block even when none trail, as the reference
        p["trailing"] = mamba_init((max(trailing, 1),))
        p["shared_attn"] = _init_dense_block(init, cfg)  # ONE shared block
    elif fam == "encdec":
        p["enc_blocks"] = _init_dense_block(init, cfg, (cfg.n_enc_layers,))
        p["dec_blocks"] = _init_cross_block(init, cfg, (cfg.n_dec_layers,))
        p["ln_enc"] = init.full((d,), 1.0, dt)
    elif fam == "vlm":
        every = cfg.cross_attn_every
        groups = cfg.n_layers // every
        p["groups"] = {
            "selfs": _init_dense_block(init, cfg, (groups, every - 1)),
            "cross": {**_init_cross_block(init, cfg, (groups,)),
                      "xgate": init.full((groups,), 0.0, torch.float32)},
        }
    else:
        raise ValueError(fam)
    return p


def param_logical(cfg: ModelConfig):
    """Same tree as init_params but with logical-axes tuples at the
    leaves."""
    fam = cfg.family
    blk = dense_block_logical(cfg)
    p = {"embed": ("vocab", "embed"), "ln_f": (None,),
         "unembed": ("embed", "vocab")}
    if fam in ("dense", "moe"):
        p["blocks"] = _prefix_layers(blk)
    elif fam == "ssm":
        p["blocks"] = _prefix_layers(
            {"ln1": (None,), "tm": ssm_mod.rwkv6_logical(), "ln2": (None,)})
    elif fam == "hybrid":
        mamba = {"ln": (None,), "m": ssm_mod.mamba2_logical()}
        p["groups"] = _prefix_layers(_prefix_layers(mamba))
        p["trailing"] = _prefix_layers(mamba)
        p["shared_attn"] = blk
    elif fam == "encdec":
        p["enc_blocks"] = _prefix_layers(blk)
        p["dec_blocks"] = _prefix_layers(
            {**blk, "lnx": (None,), "xattn": attn.attn_logical()})
        p["ln_enc"] = (None,)
    elif fam == "vlm":
        p["groups"] = _prefix_layers({
            "selfs": _prefix_layers(blk),
            "cross": {**blk, "lnx": (None,), "xattn": attn.attn_logical(),
                      "xgate": ()},
        })
    return p


def _prefix_layers(tree):
    """Prepend the stacked-layers axis (None) to every logical tuple."""
    if isinstance(tree, dict):
        return {k: _prefix_layers(v) for k, v in tree.items()}
    return (None, *tree)


# ===================================================================== forward
def forward(params, cfg: ModelConfig, batch, *,
            logits_last_only: bool = False):
    """Full-sequence forward.

    batch: {'tokens': (B,S) int} plus per-family extras:
      encdec: {'frames': (B,S_enc,d)} (stub frontend: precomputed embeddings)
      vlm:    {'img': (B,n_img,d)}
    ``logits_last_only``: the serving prefill, unembedding only the final
    position.  Returns (logits (B,S,V) or (B,1,V), aux_loss).
    """
    fam = cfg.family
    x = _embed(params, cfg, batch["tokens"])
    x = constrain(x, ("batch", "seq", None))

    if fam in ("dense", "moe"):
        x, aux = _scan_blocks(lambda p, h: dense_block(p, h, cfg),
                              params["blocks"], x, cfg.remat)
    elif fam == "ssm":
        x, aux = _scan_blocks(lambda p, h: _rwkv_block(p, h, cfg),
                              params["blocks"], x, cfg.remat)
    elif fam == "hybrid":
        x, aux = _hybrid_forward(params, x, cfg)
    elif fam == "encdec":
        mem = encode_memory(params, cfg, batch["frames"].to(x.dtype))
        x, aux = _scan_blocks(lambda p, h: _dec_block(p, h, mem, cfg),
                              params["dec_blocks"], x, cfg.remat)
    elif fam == "vlm":
        img = constrain(batch["img"].to(x.dtype), ("batch", "img", None))
        x, aux = _vlm_forward(params, x, img, cfg)
    else:
        raise ValueError(fam)

    if logits_last_only:
        x = x[:, -1:, :]
    return _unembed(params, x, cfg), aux


def _embed(params, cfg: ModelConfig, tokens):
    """The token rows of the embedding, in the compute dtype."""
    w = params["embed"].to(_dt(cfg.compute_dtype))
    if isinstance(w, DTensor):
        return embed_sharded(w, tokens)
    return w[tokens]


def _unembed(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = einsum("bsd,dv->bsv", x, params["unembed"].to(x.dtype))
    return constrain(logits, ("batch", "seq", "vocab"))


def _rwkv_block(p, x, cfg: ModelConfig):
    x = x + ssm_mod.rwkv6_timemix(p["tm"], rms_norm(x, p["ln1"],
                                                    cfg.norm_eps),
                                  n_heads=cfg.n_heads, chunk=cfg.ssm_chunk)
    x = x + ssm_mod.rwkv6_channelmix(p["tm"],
                                     rms_norm(x, p["ln2"], cfg.norm_eps))
    return constrain(x, ("batch", "seq", None)), _zero(x)


def _mamba_block(p, x, cfg: ModelConfig):
    h = ssm_mod.mamba2(p["m"], rms_norm(x, p["ln"], cfg.norm_eps),
                       expand=cfg.ssm_expand, n_heads=cfg.n_ssm_heads,
                       state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    return constrain(x + h, ("batch", "seq", None)), _zero(x)


def _trailing(cfg: ModelConfig) -> int:
    every = cfg.shared_attn_every + 1
    return cfg.n_layers - (cfg.n_layers // every) * every


def _hybrid_forward(params, x, cfg: ModelConfig):
    shared = params["shared_attn"]
    for gp in _unstack(params["groups"]):
        x, _ = _scan_blocks(lambda p, h: _mamba_block(p, h, cfg), gp, x,
                            cfg.remat)
        x, _ = dense_block(shared, x, cfg)  # the ONE shared attention block
    if _trailing(cfg) > 0:
        x, _ = _scan_blocks(lambda p, h: _mamba_block(p, h, cfg),
                            params["trailing"], x, cfg.remat)
    return x, _zero(x)


def _enc_block(p, x, cfg: ModelConfig):
    h, _ = attn.attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                          causal=False, **_attn_kw(cfg))
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
    return constrain(x, ("batch", "kv_seq", None)), _zero(x)


def _dec_block(p, x, mem, cfg: ModelConfig):
    h, _ = attn.attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                          causal=True, **_attn_kw(cfg))
    x = x + h
    hx, _ = attn.attention(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps),
                           memory=mem, **_attn_kw(cfg))
    x = x + hx
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
    return constrain(x, ("batch", "seq", None)), _zero(x)


def _vlm_forward(params, x, img, cfg: ModelConfig):
    for gp in _unstack(params["groups"]):
        x, _ = _scan_blocks(lambda p, h: dense_block(p, h, cfg), gp["selfs"],
                            x, cfg.remat)
        cp = gp["cross"]
        x, _ = dense_block(cp, x, cfg)
        hx, _ = attn.attention(cp["xattn"], rms_norm(x, cp["lnx"],
                                                     cfg.norm_eps),
                               memory=img, **_attn_kw(cfg))
        x = constrain(x + torch.tanh(cp["xgate"]).to(x.dtype) * hx,
                      ("batch", "seq", None))
    return x, _zero(x)


# ===================================================================== decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      mem_len: int = 0, device=None):
    """Per-layer stacked decode state (KV caches / SSM states), zeros.

    ``mem_len``: the encoder-memory length for encdec (set at prefill).
    """
    dev = resolve_device(device)
    dt = _dt(cfg.compute_dtype)
    fam = cfg.family
    kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n, length=kv_len):
        return (zeros(n, batch, length, cfg.n_kv_heads, cfg.head_dim),
                zeros(n, batch, length, cfg.n_kv_heads, cfg.head_dim))

    if fam in ("dense", "moe"):
        return {"kv": kv(cfg.n_layers)}
    if fam == "ssm":
        hp = cfg.d_model // cfg.n_heads
        return {
            "shift": zeros(cfg.n_layers, batch, cfg.d_model),
            "S": zeros(cfg.n_layers, batch, cfg.n_heads, hp, hp,
                       dtype=torch.float32),
            "cshift": zeros(cfg.n_layers, batch, cfg.d_model),
        }
    if fam == "hybrid":
        every = cfg.shared_attn_every
        groups = cfg.n_layers // (every + 1)
        h, pdim = cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state

        def mamba_state(*lead):
            return (zeros(*lead, batch, h, cfg.ssm_state, pdim,
                          dtype=torch.float32),
                    zeros(*lead, batch, cfg.ssm_conv - 1, conv_dim))

        return {
            "groups": mamba_state(groups, every),
            "trailing": mamba_state(max(_trailing(cfg), 1)),
            "shared_kv": kv(groups),
        }
    if fam == "encdec":
        # the cross-attention k/v over the encoder memory, seeded at
        # prefill (seed_decode_state)
        return {"kv": kv(cfg.n_dec_layers),
                "cross_kv": kv(cfg.n_dec_layers, max(mem_len, 1))}
    if fam == "vlm":
        every = cfg.cross_attn_every
        groups = cfg.n_layers // every
        return {
            "self_kv": kv(groups * (every - 1)),
            "cross_self_kv": kv(groups),
            # the patch-embedding cross k/v (seed_decode_state)
            "cross_kv": kv(groups, cfg.n_img_tokens),
        }
    raise ValueError(fam)


def _stack(pairs):
    """[(a_i, b_i, ...)] -> (stack(a), stack(b), ...)."""
    return tuple(torch.stack(t) for t in zip(*pairs))


def decode_step(params, cfg: ModelConfig, state, token, pos):
    """One-token decode: token (B, 1) int, pos an int -> (logits (B,1,V),
    the new state).  The state passed in is not written."""
    fam = cfg.family
    pos = int(pos)
    x = constrain(_embed(params, cfg, token), ("batch", None, None))
    akw = _attn_kw(cfg)

    def attn_block_decode(p, x, cache):
        h, c2 = attn.attention_decode(
            p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cache, pos,
            window=cfg.sliding_window, **akw)
        x = x + h
        h, _ = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
        return x + h, c2

    def attn_blocks(stacked, x, ck, cv):
        caches = []
        for i in range(_depth(stacked)):
            x, c2 = attn_block_decode(_layer(stacked, i), x, (ck[i], cv[i]))
            caches.append(c2)
        return x, _stack(caches)

    def mamba_blocks(stacked, x, hS, hconv):
        states = []
        for i in range(_depth(stacked)):
            p = _layer(stacked, i)
            h, st = ssm_mod.mamba2_decode(
                p["m"], rms_norm(x, p["ln"], cfg.norm_eps), (hS[i], hconv[i]),
                expand=cfg.ssm_expand, n_heads=cfg.n_ssm_heads,
                state=cfg.ssm_state)
            x = x + h
            states.append(st)
        return x, _stack(states)

    if fam in ("dense", "moe"):
        x, kv = attn_blocks(params["blocks"], x, *state["kv"])
        state = {"kv": kv}
    elif fam == "ssm":
        out = []
        for i in range(_depth(params["blocks"])):
            p = _layer(params["blocks"], i)
            st = (state["shift"][i], state["S"][i], state["cshift"][i])
            h, (shift2, S2, _) = ssm_mod.rwkv6_timemix_decode(
                p["tm"], rms_norm(x, p["ln1"], cfg.norm_eps), st,
                n_heads=cfg.n_heads)
            x = x + h
            h, cshift2 = ssm_mod.rwkv6_channelmix_decode(
                p["tm"], rms_norm(x, p["ln2"], cfg.norm_eps), st[2])
            x = x + h
            out.append((shift2, S2, cshift2))
        sh, S, csh = _stack(out)
        state = {"shift": sh, "S": S, "cshift": csh}
    elif fam == "hybrid":
        hS, hconv = state["groups"]
        ck, cv = state["shared_kv"]
        mamba, kv = [], []
        for g in range(_depth(params["groups"])):
            x, st = mamba_blocks(_layer(params["groups"], g), x, hS[g],
                                 hconv[g])
            x, c2 = attn_block_decode(params["shared_attn"], x,
                                      (ck[g], cv[g]))
            mamba.append(st)
            kv.append(c2)
        trailing = state["trailing"]
        if _trailing(cfg) > 0:
            x, trailing = mamba_blocks(params["trailing"], x, *trailing)
        state = {"groups": _stack(mamba), "trailing": trailing,
                 "shared_kv": _stack(kv)}
    elif fam == "encdec":
        ck, cv = state["kv"]
        xk, xv = state["cross_kv"]
        kv = []
        for i in range(_depth(params["dec_blocks"])):
            p = _layer(params["dec_blocks"], i)
            h, c2 = attn.attention_decode(
                p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                (ck[i], cv[i]), pos, **akw)
            x = x + h
            x = x + attn.attention_with_kv(
                p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps), xk[i], xv[i],
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim)
            x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                        cfg.activation)
            kv.append(c2)
        state = {"kv": _stack(kv), "cross_kv": (xk, xv)}
    elif fam == "vlm":
        every = cfg.cross_attn_every
        groups = cfg.n_layers // every
        sck, scv = (reshape(t, groups, every - 1, *t.shape[1:])
                    for t in state["self_kv"])
        cck, ccv = state["cross_self_kv"]
        xk, xv = state["cross_kv"]
        selfs, cross = [], []
        for g in range(groups):
            gp = _layer(params["groups"], g)
            x, s2 = attn_blocks(gp["selfs"], x, sck[g], scv[g])
            cp = gp["cross"]
            x, c2 = attn_block_decode(cp, x, (cck[g], ccv[g]))
            hx = attn.attention_with_kv(
                cp["xattn"], rms_norm(x, cp["lnx"], cfg.norm_eps), xk[g],
                xv[g], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                d_head=cfg.head_dim)
            x = x + torch.tanh(cp["xgate"]).to(x.dtype) * hx
            selfs.append(s2)
            cross.append(c2)
        sck, scv = _stack(selfs)
        state = {
            "self_kv": (reshape(sck, -1, *sck.shape[2:]),
                        reshape(scv, -1, *scv.shape[2:])),
            "cross_self_kv": _stack(cross),
            "cross_kv": (xk, xv),
        }
    else:
        raise ValueError(fam)
    return _unembed(params, x, cfg), state


def seed_decode_state(params, cfg: ModelConfig, state, memory):
    """Fill the precomputed cross-attention k/v from encoder/image memory.

    encdec: ``memory`` is the encoded frames (:func:`encode_memory`); vlm:
    ``memory`` is the patch-embedding stub input.  Other families: the
    state as given.
    """
    if cfg.family == "encdec":
        xattn = params["dec_blocks"]["xattn"]
    elif cfg.family == "vlm":
        xattn = params["groups"]["cross"]["xattn"]
    else:
        return state
    state = dict(state)
    state["cross_kv"] = _stack(
        attn.project_memory_kv(_layer(xattn, i), memory)
        for i in range(_depth(xattn)))
    return state


def encode_memory(params, cfg: ModelConfig, frames):
    """Run the encoder stack (encdec prefill side): frames -> memory."""
    frames = constrain(frames, ("batch", "kv_seq", None))
    mem, _ = _scan_blocks(lambda p, h: _enc_block(p, h, cfg),
                          params["enc_blocks"], frames, cfg.remat)
    return rms_norm(mem, params["ln_enc"], cfg.norm_eps)


# ===================================================================== training
def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Next-token LM loss (+ MoE aux): the train step's objective."""
    logits, aux = forward(params, cfg, batch)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    mask[:, -1] = 0.0
    ce = cross_entropy_loss(logits, labels, mask)
    if isinstance(ce, DTensor):
        # both terms whole on every rank before the sum (a partial
        # scalar's backward does not take the broadcast from a sum)
        ce, aux = (_replicated(t, ce.device_mesh) for t in (ce, aux))
    return ce + aux_weight * aux


def _replicated(t, mesh):
    from torch.distributed.tensor import Replicate

    if not isinstance(t, DTensor):
        return t
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)
