"""The device rule of the port's entry points."""

from __future__ import annotations

import threading

import torch

__all__ = ["CAPTURE_LOCK", "resolve_device"]

#: one CUDA graph capture at a time in the process: ``torch.cuda.graph``
#: captures on a stream shared by its instances, and synchronizes the device
#: and frees the allocator's cache first (the train step and the
#: acquisition refinement both capture under it)
CAPTURE_LOCK = threading.Lock()


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
