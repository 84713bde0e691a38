"""State-space sequence mixers: Mamba2 (SSD, zamba2-7b) and RWKV6 (rwkv6-3b),
in PyTorch.

Counterpart of ``repro/models/ssm.py``, in its order of operations and with
its clips.  Both run in the chunked form: attention-like einsums within a
chunk, vectorised over the chunks, then a short loop over the chunk states.
A sequence must be a whole number of chunks (``ValueError`` otherwise).

Decode paths carry recurrent state explicitly:
  mamba2: (h (B,H,N,P), conv window (B,K-1,Cdim))
  rwkv6:  (token shift (B,d), S (B,H,P,P), channel-mix shift (B,d))

As in the reference: RWKV6 keeps the data-dependent decay (its LoRA) with
static token-shift mix coefficients for r/k/v/g, and Mamba2 uses one B/C
group.  The depthwise causal conv is spelled as shifts and multiplies, as
the reference spells it, not as a library convolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..dist import constrain, reshape
from .layers import Init, dense, init_linear, rms_norm

__all__ = [
    "init_mamba2",
    "mamba2_logical",
    "mamba2",
    "mamba2_decode",
    "init_mamba2_state",
    "init_rwkv6",
    "rwkv6_logical",
    "rwkv6_timemix",
    "rwkv6_channelmix",
    "rwkv6_timemix_decode",
    "rwkv6_channelmix_decode",
    "init_rwkv6_state",
]

f32 = torch.float32


def _chunks(L: int, chunk: int, what: str) -> int:
    """The number of chunks of a length-``L`` sequence."""
    if chunk < 1 or L % chunk:
        raise ValueError(f"{what}: the sequence length {L} is not a multiple "
                         f"of the chunk (ssm_chunk = {chunk})")
    return L // chunk


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===================================================================== Mamba2
def _mamba_dims(d_model: int, expand: int, n_heads: int, state: int):
    d_in = expand * d_model
    h = n_heads
    p = d_in // h
    conv_dim = d_in + 2 * state  # x, B, C share the causal conv
    return d_in, h, p, conv_dim


def init_mamba2(init: Init, d_model: int, expand: int, n_heads: int,
                state: int, conv: int, dtype, lead: tuple = ()):
    d_in, h, p, conv_dim = _mamba_dims(d_model, expand, n_heads, state)
    return {
        "in_proj": init_linear(init, d_model, 2 * d_in + 2 * state + h,
                               dtype, lead=lead),
        "conv_w": init.normal((*lead, conv, conv_dim), 0.2, dtype),
        "conv_b": init.full((*lead, conv_dim), 0.0, dtype),
        "A_log": init.full((*lead, h), 0.0, f32),
        "D": init.full((*lead, h), 1.0, f32),
        "dt_bias": init.full((*lead, h), 0.0, f32),
        "norm": init.full((*lead, d_in), 1.0, dtype),
        "out_proj": init_linear(init, d_in, d_model, dtype, lead=lead),
    }


def mamba2_logical():
    return {
        "in_proj": ("embed", "ff"),
        "conv_w": ("conv", None),
        "conv_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": (None,),
        "out_proj": ("ff", "embed"),
    }


def _mamba_split(params, x, d_in: int, state: int, h: int):
    zxbcdt = dense(x, params["in_proj"])
    return torch.split(zxbcdt, [d_in, d_in, state, state, h], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over (B, L, Cdim); kernel (K, Cdim)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    L = xbc.shape[1]
    out = 0
    for i in range(k):  # the reference's Python sum, from 0
        out = out + pad[:, i:i + L, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def mamba2(params, x, *, expand: int, n_heads: int, state: int, chunk: int):
    """x (B, L, d) -> (B, L, d); L must be a multiple of ``chunk``."""
    bsz, L, d_model = x.shape
    _chunks(L, chunk, "mamba2")
    d_in, h, p, conv_dim = _mamba_dims(d_model, expand, n_heads, state)
    z, xc, B, C, dt = _mamba_split(params, x, d_in, state, h)
    xbc = _causal_conv(torch.cat([xc, B, C], -1), params["conv_w"],
                       params["conv_b"])
    xc, B, C = torch.split(xbc, [d_in, state, state], dim=-1)
    xh = reshape(xc, bsz, L, h, p).float()
    Bh = B.float()  # (B, L, N): one group, shared across heads
    Ch = C.float()
    dt = _softplus(dt.float() + params["dt_bias"][None, None, :])  # (B,L,H)
    a = -torch.exp(params["A_log"])  # (H,)

    if isinstance(xh, DTensor):
        y = _mamba_core_laid(xh, Bh, Ch, dt, a, params["D"], chunk)
    else:
        y = _mamba_core(xh, Bh, Ch, dt, a, params["D"], chunk)
    y = reshape(y, bsz, L, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm"])
    y = constrain(y, ("batch", "act_seq", "ff"))
    return dense(y, params["out_proj"])


def _mamba_core(xh, Bh, Ch, dt, a, D, chunk: int):
    """The chunked SSD scan: xh (B,L,H,P), Bh/Ch (B,L,N), dt (B,L,H), a
    and D (H,) -> y (B,L,H,P), all f32."""
    bsz, L, h, p = xh.shape
    state = Bh.shape[-1]
    nc = L // chunk
    c = chunk
    xh = xh.reshape(bsz, nc, c, h, p)
    Bh = Bh.reshape(bsz, nc, c, state)
    Ch = Ch.reshape(bsz, nc, c, state)
    dt = dt.reshape(bsz, nc, c, h)
    lam = dt * a[None, None, None, :]  # per-step log decay (B,nc,c,H)
    ell = torch.cumsum(lam, dim=2)  # inclusive (B,nc,c,H)

    # intra-chunk: M[t,s] = C_t.B_s * exp(ell_t - ell_s) * [s<=t]
    cb = torch.einsum("bnts,bnus->bntu", Ch, Bh)  # (B,nc,c,c)
    dec = torch.exp(torch.clamp(
        ell[:, :, :, None, :] - ell[:, :, None, :, :], -60.0, 0.0))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    m = cb[..., None] * dec * tri[None, None, :, :, None]  # (B,nc,t,s,H)
    xdt = xh * dt[..., None]  # (B,nc,c,H,P)
    y_intra = torch.einsum("bntsh,bnshp->bnthp", m, xdt)

    # chunk summary states: S_n = sum_s exp(ell_c - ell_s) dt_s B_s (x) x_s
    dec_end = torch.exp(torch.clamp(ell[:, :, -1:, :] - ell, -60.0, 0.0))
    s_chunk = torch.einsum("bnsh,bnsv,bnshp->bnhvp", dec_end, Bh, xdt)
    lam_chunk = torch.exp(torch.clamp(ell[:, :, -1, :], -60.0, 0.0))

    hprev = torch.zeros((bsz, h, state, p), dtype=f32, device=xh.device)
    starts = []
    for n in range(nc):  # the state at each chunk's start
        starts.append(hprev)
        hprev = hprev * lam_chunk[:, n, :, None, None] + s_chunk[:, n]
    h_starts = torch.stack(starts, 1)  # (B,nc,H,N,P)

    # inter-chunk: y_t += C_t . (exp(ell_t) * H_start), the decay inclusive
    # (y_t reads h_t after this step's decay and update)
    dec_in = torch.exp(torch.clamp(ell, -60.0, 0.0))  # (B,nc,c,H)
    y_inter = torch.einsum("bntv,bnhvp,bnth->bnthp", Ch, h_starts, dec_in)

    y = y_intra + y_inter + xh * D[None, None, None, :, None]
    return y


def _heads_layout(t, hdim: int, n_heads: int):
    """Placements of ``t`` that keep each rank on whole heads: its batch
    shard (dimension 0) and a heads shard at ``hdim`` where the heads
    divide evenly; the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, n, out = t.device_mesh, 1, []
    for i, q in enumerate(t.placements):
        if q.is_shard(0):
            out.append(Shard(0))
        elif q.is_shard(hdim) and n_heads % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            out.append(Shard(hdim))
        else:
            out.append(Replicate())
    return tuple(out)


def _per(pl, hdim: int, batch, heads, other):
    """Placements for an input of a heads-laid region: ``batch`` where
    ``pl`` shards the batch, ``heads`` where it shards the heads (at
    ``hdim``), ``other`` elsewhere."""
    return tuple(batch if q.is_shard(0) else heads if q.is_shard(hdim)
                 else other for q in pl)


def _mamba_core_laid(xh, Bh, Ch, dt, a, D, chunk: int):
    """:func:`_mamba_core` on DTensors, each rank on its own batch rows and
    whole heads (the reference leaves the scan's einsums to GSPMD)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    pl = _heads_layout(xh, 2, xh.shape[2])
    shared = _per(pl, 2, Shard(0), Replicate(), Replicate())
    vec = _per(pl, 2, Replicate(), Shard(0), Replicate())
    xh, dt = (t.redistribute(mesh, pl) for t in (xh, dt))
    Bh, Ch = (t.redistribute(mesh, shared) for t in (Bh, Ch))
    a, D = (t.redistribute(mesh, vec) for t in (a, D))
    g_shared = _per(pl, 2, Shard(0), Partial(), Replicate())
    g_vec = _per(pl, 2, Partial(), Shard(0), Replicate())
    return local_map(
        lambda *t: _mamba_core(*t, chunk), out_placements=(pl,),
        in_placements=None,
        in_grad_placements=(pl, g_shared, g_shared, pl, g_vec, g_vec))(
            xh, Bh, Ch, dt, a, D)


def init_mamba2_state(batch: int, d_model: int, expand: int, n_heads: int,
                      state: int, conv: int, dtype, device=None):
    d_in, h, p, conv_dim = _mamba_dims(d_model, expand, n_heads, state)
    return (
        torch.zeros((batch, h, state, p), dtype=f32, device=device),
        torch.zeros((batch, conv - 1, conv_dim), dtype=dtype, device=device),
    )


def mamba2_decode(params, x, st, *, expand: int, n_heads: int, state: int):
    """One-token step: x (B, 1, d), st = (h, conv_window)."""
    bsz, _, d_model = x.shape
    d_in, h, p, conv_dim = _mamba_dims(d_model, expand, n_heads, state)
    hstate, convw = st
    z, xc, B, C, dt = _mamba_split(params, x, d_in, state, h)
    xbc_new = torch.cat([xc, B, C], -1)  # (B,1,Cdim)
    win = torch.cat([convw, xbc_new], dim=1)  # (B,K,Cdim)
    w = params["conv_w"].to(x.dtype)
    conv_out = F.silu((win * w[None, :, :]).sum(dim=1)
                      + params["conv_b"][None, :].to(x.dtype))  # (B,Cdim)
    xc1, B1, C1 = torch.split(conv_out, [d_in, state, state], dim=-1)
    xh = reshape(xc1, bsz, h, p).float()
    dt1 = _softplus(dt[:, 0].float() + params["dt_bias"][None, :])  # (B,H)
    a = -torch.exp(params["A_log"])
    lam = torch.exp(dt1 * a[None, :])  # (B,H)
    outer = torch.einsum("bv,bhp->bhvp", B1.float(), xh * dt1[..., None])
    hnew = hstate * lam[:, :, None, None] + outer
    y = torch.einsum("bv,bhvp->bhp", C1.float(), hnew) + (
        xh * params["D"][None, :, None])
    y = reshape(y, bsz, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm"])
    out = dense(y, params["out_proj"])
    return out, (hnew, win[:, 1:])


# ===================================================================== RWKV6
def init_rwkv6(init: Init, d: int, ff: int, n_heads: int, dtype,
               lora_rank: int = 64, lead: tuple = ()):
    p = d // n_heads
    return {
        "mix": init.uniform((*lead, 5, d), 0.5, 0.25, f32),
        "wr": init_linear(init, d, d, dtype, lead=lead),
        "wk": init_linear(init, d, d, dtype, lead=lead),
        "wv": init_linear(init, d, d, dtype, lead=lead),
        "wg": init_linear(init, d, d, dtype, lead=lead),
        "wo": init_linear(init, d, d, dtype, lead=lead),
        "w0": init.normal((*lead, d), 0.1, f32, shift=-6.0),
        "w_lora_a": init_linear(init, d, lora_rank, f32, lead=lead),
        "w_lora_b": init_linear(init, lora_rank, d, f32, scale=0.01,
                                lead=lead),
        "u": init.normal((*lead, n_heads, p), 0.1, f32),
        "ln_x": init.full((*lead, d), 1.0, f32),
        # channel mix
        "mix_c": init.uniform((*lead, 2, d), 0.5, 0.25, f32),
        "ck": init_linear(init, d, ff, dtype, lead=lead),
        "cv": init_linear(init, ff, d, dtype, lead=lead),
        "cr": init_linear(init, d, d, dtype, lead=lead),
    }


def rwkv6_logical():
    return {
        "mix": (None, "embed"),
        "wr": ("embed", "heads"),
        "wk": ("embed", "heads"),
        "wv": ("embed", "heads"),
        "wg": ("embed", "heads"),
        "wo": ("heads", "embed"),
        "w0": ("embed",),
        "w_lora_a": ("embed", None),
        "w_lora_b": (None, "embed"),
        "u": ("heads", None),
        "ln_x": ("embed",),
        "mix_c": (None, "embed"),
        "ck": ("embed", "ff"),
        "cv": ("ff", "embed"),
        "cr": ("embed", None),
    }


def _shift(x):
    """Token shift: x_{t-1} (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _rwkv_proj(params, x, xx):
    mix = params["mix"]  # (5, d): r, k, v, g, w

    def mixed(i):
        m = mix[i][None, None, :].to(x.dtype)
        return x + (xx - x) * m

    r = dense(mixed(0), params["wr"])
    k = dense(mixed(1), params["wk"])
    v = dense(mixed(2), params["wv"])
    g = F.silu(dense(mixed(3), params["wg"]))
    # the data-dependent decay (the Finch contribution): exp(-exp(w0 + lora))
    xw = mixed(4).float()
    lora = dense(torch.tanh(dense(xw, params["w_lora_a"])),
                 params["w_lora_b"])
    logw = -torch.exp(torch.clamp(params["w0"][None, None, :] + lora,
                                  -20.0, 8.0))
    return r, k, v, g, logw  # logw = log(decay) in (-inf, 0)


def _group_norm(y, eps: float):
    """Per-head normalisation over the last axis (population variance)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps)


def _rwkv_core(r, k, v, logw, u, hp: int, chunk: int, norm_eps: float):
    """The chunked RWKV6 time mix of r, k, v (B,L,d) and the log decay
    (B,L,d, f32) with the bonus u (H,P) -> the per-head group-normed
    output (B,L,d) in f32, before ``ln_x``."""
    bsz, L, d = r.shape
    n_heads = d // hp
    nc = L // chunk
    c = chunk

    def heads(t):
        return t.reshape(bsz, nc, c, n_heads, hp).float()

    r, k, v = heads(r), heads(k), heads(v)
    logw = logw.reshape(bsz, nc, c, n_heads, hp)
    ell = torch.cumsum(logw, dim=2)  # inclusive (B,nc,c,H,P)

    # intra-chunk: y_t = sum_{s<t} [r_t exp(ell_{t-1} - ell_s)] . k_s v_s
    # plus the bonus; the decay factorised, each factor's log clipped to
    # [-60, 0] so that both stay finite in f32
    ell_prev = ell - logw  # ell_{t-1}
    r_dec = r * torch.exp(torch.clamp(ell_prev, -60.0, 0.0))
    att = torch.einsum("bnthp,bnshp->bnhts", r_dec,
                       k * torch.exp(torch.clamp(-ell, 0.0, 60.0)))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    att = att * tri[None, None, None, :, :]
    y = torch.einsum("bnhts,bnshp->bnthp", att, v)
    bonus = torch.einsum("bnthp,bnthp->bnth", r,
                         k * u[None, None, None, :, :])
    y = y + bonus[..., None] * v

    # inter-chunk state: S (B,H,P,P) [key dim, value dim]
    dec_end = torch.exp(torch.clamp(ell[:, :, -1:, :, :] - ell, -60.0, 0.0))
    s_chunk = torch.einsum("bnshp,bnshv->bnhpv", k * dec_end, v)
    lam_chunk = torch.exp(torch.clamp(ell[:, :, -1, :, :], -60.0, 0.0))

    sprev = torch.zeros((bsz, n_heads, hp, hp), dtype=f32, device=r.device)
    starts = []
    for n in range(nc):
        starts.append(sprev)
        sprev = sprev * lam_chunk[:, n, ..., None] + s_chunk[:, n]
    s_starts = torch.stack(starts, 1)  # (B,nc,H,P,P)
    y_inter = torch.einsum("bnthp,bnhpv->bnthv", r_dec, s_starts)
    y = (y + y_inter).reshape(bsz, L, n_heads, hp)
    # group norm per head (ln_x), gate, output projection
    return _group_norm(y, norm_eps).reshape(bsz, L, d)


def _rwkv_core_laid(r, k, v, logw, u, hp: int, chunk: int, norm_eps: float):
    """:func:`_rwkv_core` on DTensors, each rank on its own batch rows and
    whole heads (the reference leaves the scan's einsums to GSPMD)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = r.device_mesh
    pl = _heads_layout(r, 2, r.shape[2] // hp)
    vec = _per(pl, 2, Replicate(), Shard(0), Replicate())
    r, k, v, logw = (t.redistribute(mesh, pl) for t in (r, k, v, logw))
    u = u.redistribute(mesh, vec)
    g_vec = _per(pl, 2, Partial(), Shard(0), Replicate())
    return local_map(
        lambda *t: _rwkv_core(*t, hp, chunk, norm_eps), out_placements=(pl,),
        in_placements=None, in_grad_placements=(pl, pl, pl, pl, g_vec))(
            r, k, v, logw, u)


def rwkv6_timemix(params, x, *, n_heads: int, chunk: int,
                  norm_eps: float = 1e-5):
    """RWKV6 time mixing, chunked: x (B, L, d) -> (B, L, d)."""
    bsz, L, d = x.shape
    _chunks(L, chunk, "rwkv6_timemix")
    hp = d // n_heads
    r, k, v, g, logw = _rwkv_proj(params, x, _shift(x))
    if isinstance(r, DTensor):
        y = _rwkv_core_laid(r, k, v, logw, params["u"], hp, chunk, norm_eps)
    else:
        y = _rwkv_core(r, k, v, logw, params["u"], hp, chunk, norm_eps)
    y = y * params["ln_x"][None, None, :]
    y = y.to(x.dtype) * g
    return dense(y, params["wo"])


def rwkv6_channelmix(params, x):
    xx = _shift(x)
    mix = params["mix_c"]
    xk = x + (xx - x) * mix[0][None, None, :].to(x.dtype)
    xr = x + (xx - x) * mix[1][None, None, :].to(x.dtype)
    kk = torch.square(torch.relu(dense(xk, params["ck"])))
    kk = constrain(kk, ("batch", "act_seq", "ff"))
    return torch.sigmoid(dense(xr, params["cr"])) * dense(kk, params["cv"])


def init_rwkv6_state(batch: int, d: int, n_heads: int, dtype, device=None):
    hp = d // n_heads
    return (
        torch.zeros((batch, d), dtype=dtype, device=device),  # token shift
        torch.zeros((batch, n_heads, hp, hp), dtype=f32, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),  # channel shift
    )


def _rwkv_step(r, k, v, logw, S, u, hp: int, norm_eps: float):
    """One RWKV6 step of r, k, v and the log decay (B,1,d) on the state S
    (B,H,P,P): (the group-normed output (B,1,d) in f32, the new S)."""
    bsz, _, d = r.shape
    n_heads = d // hp
    r1 = r[:, 0].reshape(bsz, n_heads, hp).float()
    k1 = k[:, 0].reshape(bsz, n_heads, hp).float()
    v1 = v[:, 0].reshape(bsz, n_heads, hp).float()
    w1 = torch.exp(logw[:, 0].reshape(bsz, n_heads, hp))  # decay in (0,1)
    kv = torch.einsum("bhp,bhv->bhpv", k1, v1)
    y = torch.einsum("bhp,bhpv->bhv", r1, S + u[None, :, :, None] * kv)
    S_new = S * w1[..., None] + kv
    return _group_norm(y, norm_eps).reshape(bsz, 1, d), S_new


def _rwkv_step_laid(r, k, v, logw, S, u, hp: int, norm_eps: float):
    """:func:`_rwkv_step` on DTensors, each rank on its own batch rows and
    whole heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = r.device_mesh
    pl = _heads_layout(r, 2, r.shape[2] // hp)
    state = tuple(Shard(0) if q.is_shard(0) else Shard(1) if q.is_shard(2)
                  else Replicate() for q in pl)
    vec = _per(pl, 2, Replicate(), Shard(0), Replicate())
    r, k, v, logw = (t.redistribute(mesh, pl) for t in (r, k, v, logw))
    return local_map(
        lambda *t: _rwkv_step(*t, hp, norm_eps), out_placements=(pl, state),
        in_placements=None)(r, k, v, logw, S.redistribute(mesh, state),
                            u.redistribute(mesh, vec))


def rwkv6_timemix_decode(params, x, st, *, n_heads: int,
                         norm_eps: float = 1e-5):
    """One-token step: x (B, 1, d); st = (shift, S, cshift) -> (y, new_st)."""
    bsz, _, d = x.shape
    hp = d // n_heads
    shift, S, cshift = st
    r, k, v, g, logw = _rwkv_proj(params, x, shift[:, None, :])
    if isinstance(r, DTensor):
        y, S_new = _rwkv_step_laid(r, k, v, logw, S, params["u"], hp,
                                   norm_eps)
    else:
        y, S_new = _rwkv_step(r, k, v, logw, S, params["u"], hp, norm_eps)
    y = y * params["ln_x"][None, None, :]
    y = y.to(x.dtype) * g
    out = dense(y, params["wo"])
    return out, (x[:, 0, :], S_new, cshift)


def rwkv6_channelmix_decode(params, x, cshift):
    xx = cshift[:, None, :]
    mix = params["mix_c"]
    xk = x + (xx - x) * mix[0][None, None, :].to(x.dtype)
    xr = x + (xx - x) * mix[1][None, None, :].to(x.dtype)
    kk = torch.square(torch.relu(dense(xk, params["ck"])))
    out = torch.sigmoid(dense(xr, params["cr"])) * dense(kk, params["cv"])
    return out, x[:, 0, :]
