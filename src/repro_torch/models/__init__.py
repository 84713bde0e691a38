"""The LM harness's models, in PyTorch: the serving side of
``repro.models`` (init, forward, decode for the ten architectures of
``repro_torch.configs``).  ``loss_fn`` and ``param_logical`` belong to the
training side and are not ported yet."""
from .model import (
    decode_step,
    encode_memory,
    forward,
    init_decode_state,
    init_params,
    seed_decode_state,
)

__all__ = [
    "decode_step",
    "encode_memory",
    "seed_decode_state",
    "forward",
    "init_decode_state",
    "init_params",
]
