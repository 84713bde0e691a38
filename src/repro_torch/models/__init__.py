"""The LM harness's models, in PyTorch: ``repro.models`` (init, forward,
decode and the training loss for the ten architectures of
``repro_torch.configs``, and the logical-axes tree of the parameters)."""
from .model import (
    decode_step,
    encode_memory,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_logical,
    seed_decode_state,
)

__all__ = [
    "decode_step",
    "encode_memory",
    "seed_decode_state",
    "forward",
    "init_decode_state",
    "init_params",
    "loss_fn",
    "param_logical",
]
