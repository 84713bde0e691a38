"""seamless-m4t-large-v2 [audio] — enc-dec, 24L+24L d=1024 16H d_ff=8192,
vocab 256206.  [arXiv:2308.11596; hf]
Modality frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed speech-frame embeddings (B, S_enc, d) to the encoder.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless_m4t_large_v2",
    family="encdec",
    n_layers=48,          # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    activation="gelu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )
