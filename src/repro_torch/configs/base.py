"""Model + workload configuration schema.

One :class:`ModelConfig` per assigned architecture lives in
``repro_torch/configs/<arch_id>.py`` with the exact public-literature dimensions; each
also exposes a ``smoke()`` reduction (same family, tiny dims) for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "Family"]

Family = str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # activations / norms
    activation: str = "swiglu"  # swiglu | relu2 | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    # attention variants
    sliding_window: Optional[int] = None  # SWA (h2o-danube)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0  # 0 -> d_inner // 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one shared attention block applied every N ssm blocks
    shared_attn_every: int = 0
    # encoder-decoder (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # vlm (llama-3.2-vision): one cross-attn block every N layers
    cross_attn_every: int = 0
    n_img_tokens: int = 1601
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training-side knobs
    remat: bool = True
    # Megatron-style residual sequence parallelism (seq -> 'model'): the
    # memory-bound win for very wide dense stacks
    sp_residual: bool = False
    # dry-run cost probes: unroll layer scans so XLA cost analysis counts every
    # layer (while-loop bodies are otherwise counted once)
    scan_unroll: bool = False
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // 64

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        dh = self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
        if self.family == "moe":
            mlp = d * self.n_experts + self.n_experts * (3 * d * ff)
        elif self.activation == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.family == "ssm":  # rwkv6
            blk = 6 * d * d + 2 * d * ff + d * ff  # time-mix + channel-mix approx
            n = self.n_layers * blk
        elif self.family == "hybrid":
            h = self.n_ssm_heads
            din = self.d_inner
            mamba = d * (2 * din + 2 * self.ssm_state + h) + din * d
            n_attn = max(1, self.n_layers // (self.shared_attn_every + 1))
            n = self.n_layers * mamba + n_attn * 0 + (attn + mlp)  # shared block once
        elif self.family == "encdec":
            n = self.n_enc_layers * (attn + mlp) + self.n_dec_layers * (2 * attn + mlp)
        else:
            n = self.n_layers * (attn + mlp)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return int(n + emb)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count), for 6·N_active·D."""
        if self.family != "moe":
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dh = self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
        mlp = d * self.n_experts + self.top_k * (3 * d * ff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(self.n_layers * (attn + mlp) + emb)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell for the dry-run grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
