"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention,
24L d=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.  [arXiv:2401.16818]
SWA (window 4096) makes decode O(W): long_500k cell RUNS (ring-buffer cache).
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o_danube_3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    sliding_window=4096,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, sliding_window=32, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
