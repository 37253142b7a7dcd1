"""The device rule of the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device of the port's entry points: ``None`` means the CUDA card.
    Never falls back to the CPU quietly — with no card visible, only
    ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA card by default and none is "
            "visible; pass device='cpu' to run on the CPU"
        )
    return dev
