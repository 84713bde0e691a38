"""qwen3-moe-235b-a22b [moe] — 94L d=4096 64H (GQA kv=4) d_ff=1536/expert,
vocab 151936, 128 experts top-8.  [hf:Qwen/Qwen3-235B-A22B; hf]
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    d_head=128,
    n_experts=128,
    top_k=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=48,
        d_head=16, vocab=128, n_experts=8, top_k=2, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
