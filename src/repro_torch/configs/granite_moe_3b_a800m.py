"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, 40 experts top-8.  [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
(The assignment sheet lists "MoE 40e top-8" — we use 40 experts; see DESIGN.md.)
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=128, n_experts=8, top_k=2, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
