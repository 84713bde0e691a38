"""zamba2-7b [hybrid] — 81 blocks: Mamba2 backbone + ONE shared attention
block applied every 6 mamba blocks (Zamba design), d=3584 32H (kv=32=MHA)
d_ff=14336 vocab=32000 ssm_state=64.  [arXiv:2411.15242]
SSM state decode -> long_500k cell RUNS.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    shared_attn_every=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, ssm_state=16, ssm_chunk=8, shared_attn_every=2,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )
