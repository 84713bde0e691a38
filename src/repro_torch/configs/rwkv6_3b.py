"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay, 32L d=2560
(40 heads x 64) d_ff=8960 vocab=65536.  [arXiv:2404.05892; hf]
Linear recurrence -> long_500k cell RUNS (O(1) state decode).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6_3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # head size 64
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    ssm_chunk=128,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, ssm_chunk=8, param_dtype="float32", compute_dtype="float32",
        remat=False,
    )
