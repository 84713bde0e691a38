"""yi-34b [dense] — llama-arch GQA, 60L d=7168 56H (kv=8) d_ff=20480
vocab=64000.  [arXiv:2403.04652; hf]
Pure full attention -> long_500k cell is SKIPPED (DESIGN.md §5).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi_34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, param_dtype="float32", compute_dtype="float32", remat=False,
    )
