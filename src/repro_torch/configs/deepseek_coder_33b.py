"""deepseek-coder-33b [dense] — llama-arch, 62L d=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256.  [arXiv:2401.14196; hf]
Pure full attention -> long_500k cell is SKIPPED (DESIGN.md §5).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek_coder_33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, param_dtype="float32", compute_dtype="float32", remat=False,
    )
