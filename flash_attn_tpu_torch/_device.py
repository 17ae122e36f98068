"""Device resolution for the port's entry points: the card by default."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for
    (explicitly or by default) and none is present; pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev
