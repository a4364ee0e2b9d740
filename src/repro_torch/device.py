"""Where the port runs: the CUDA card unless the caller names a device."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device`, or the current CUDA card when it is None.  Without a card
    a None device raises: the port never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
