"""Wrapper of the flash-attention CUDA kernel.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/flash_attention.cu`` on the current stream, or
raises. The output is allocated here with ``torch.empty``. bf16 runs the
tensor-core body and f32 the SIMT body; neither falls back to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.flash_attention.plain import flash_attention_plain

__all__ = ["flash_attention_kernel", "DTYPES", "MAX_HEAD_DIM"]

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 256  # both bodies' register tiles


def flash_attention_kernel(q, k, v, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal attention: q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh), bf16 or f32 →
    (B, S, Hq, Dh) in the same dtype; f32 softmax and accumulation."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV heads")
    shapes = ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    if check_inputs("flash_attention", (q, k, v), shapes, DTYPES) == "cpu":
        return flash_attention_plain(q, k, v, window, softcap)
    mult = 16 // q.element_size()  # rows of whole 16-byte chunks
    if dh % mult or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {dh} must be a multiple of {mult} and at "
            f"most {MAX_HEAD_DIM} in {q.dtype}"
        )
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("flash_attention"), f"flash_attention_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, hq, hkv, dh, int(window), float(softcap), float(dh**-0.5),
                 stream)
    raise_on_error("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out
