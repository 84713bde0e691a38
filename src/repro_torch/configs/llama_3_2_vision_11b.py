"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]
Vision frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed patch embeddings (B, 1601, d).  Full attention -> long_500k SKIPPED.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama_3_2_vision_11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    n_img_tokens=1601,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, cross_attn_every=2, n_img_tokens=16, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
