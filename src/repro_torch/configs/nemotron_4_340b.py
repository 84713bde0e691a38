"""nemotron-4-340b [dense] — 96L d=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819]
Pure full attention -> long_500k cell is SKIPPED (DESIGN.md §5).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron_4_340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    activation="relu2",
    rope_theta=10_000.0,
    sp_residual=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=128, param_dtype="float32", compute_dtype="float32", remat=False,
    )
