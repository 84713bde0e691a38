"""Device resolution for the PyTorch port.

Entry points run on the card unless the caller asks for the CPU.  There is no
environment override and no silent fallback: asking for the card on a machine
without one raises, and on the CPU every kernel wrapper runs its plain PyTorch
version (the CPU parity tests pass ``device="cpu"`` explicitly).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "fma", "sqrt"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path explicitly"
        )
    return dev


def fma(a, b, c):
    """``a * b + c`` with one rounding, the form XLA contracts on the CPU.

    The JAX reference's compiled CPU programs evaluate several ``x * y + z``
    sites as a fused multiply-add; the port spells exactly those sites with
    this helper so its bits follow the reference.  ``torch.addcmul`` with the
    default ``value=1`` is a fused multiply-add on both devices (probed
    against an exact round-to-odd emulation by ``chip_smoke.py``).
    """
    return torch.addcmul(c, a, b)


def sqrt(x):
    """Correctly rounded f32 square root.

    PyTorch's CPU ``sqrt`` for float32 is not correctly rounded (it differs
    from IEEE ``sqrt`` in about 0.7% of random inputs); the reference's is.
    The f64 square root rounded to f32 is the correctly rounded f32 result
    (53 >= 2 * 24 + 2 bits), on either device.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
