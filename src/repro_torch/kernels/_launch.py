"""Checks shared by the kernel wrappers before they launch or run plain."""

from __future__ import annotations

from typing import Sequence

import torch

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# what the GP kernels take; the LM kernels name their own
GP_DTYPES = (torch.float32, torch.float64)


def check_inputs(
    name: str,
    tensors: Sequence[torch.Tensor],
    shapes: Sequence[tuple],
    dtypes: Sequence[torch.dtype] = GP_DTYPES,
) -> str:
    """Validate device, dtype (one of ``dtypes``, the same for every input),
    shape and contiguity; return "cpu" or "cuda".

    A kernel output carries no gradient, so asking for one raises here
    instead of silently detaching."""
    first = tensors[0]
    dev = first.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if first.dtype not in dtypes:
        allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: dtype must be {allowed}, got {first.dtype}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.device != dev:
            raise ValueError(f"{name}: input {i} on {t.device}, expected {dev}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: input {i} is {t.dtype}, expected {first.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: input {i} has shape {tuple(t.shape)}, expected {tuple(shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} is not contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward pass; score through the torch "
            "composition where a gradient is needed"
        )
    return dev.type


def suffix(dtype: torch.dtype) -> str:
    return _SUFFIX[dtype]


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
