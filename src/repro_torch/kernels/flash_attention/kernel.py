"""Wrappers of the flash-attention CUDA kernels.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/flash_attention.cu`` (the forward) or
``csrc/flash_attention_bwd.cu`` (training's backward) on the current
stream, or raises. Outputs and scratch are allocated here with
``torch.empty``. The forward in bf16 runs the tensor-core body and in f32
the SIMT body; neither falls back to the other. Training's pair (the
forward with the row log-sum-exp, and the backward) is bf16 only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.flash_attention.plain import (
    flash_attention_bwd_plain, flash_attention_plain,
)

__all__ = ["flash_attention_kernel", "flash_attention_fwd_lse", "flash_attention_bwd",
           "DTYPES", "MAX_HEAD_DIM"]

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 256  # the forward's register tiles; the backward takes as much


def _shapes(name, q, k):
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} KV heads")
    return b, s, hq, hkv, dh


def _check_launch(name, tensors, dh, max_dh):
    mult = 16 // tensors[0].element_size()  # rows of whole 16-byte chunks
    if dh % mult or dh > max_dh:
        raise ValueError(
            f"{name}: head dim {dh} must be a multiple of {mult} and at "
            f"most {max_dh} in {tensors[0].dtype}"
        )
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _forward(q, k, v, window, softcap, scale, lse):
    b, s, hq, hkv, dh = _shapes("flash_attention", q, k)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("flash_attention"), f"flash_attention_{suffix(q.dtype)}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, s, hq, hkv, dh, int(window), float(softcap), float(scale), stream)
    raise_on_error("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_kernel(q, k, v, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal attention: q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh), bf16 or f32 →
    (B, S, Hq, Dh) in the same dtype; f32 softmax and accumulation."""
    b, s, hq, hkv, dh = _shapes("flash_attention", q, k)
    shapes = ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    if check_inputs("flash_attention", (q, k, v), shapes, DTYPES) == "cpu":
        return flash_attention_plain(q, k, v, window, softcap)
    _check_launch("flash_attention", (q, k, v), dh, MAX_HEAD_DIM)
    return _forward(q, k, v, window, softcap, dh**-0.5, None)


def flash_attention_fwd_lse(q, k, v, window: int, softcap: float, scale: float):
    """Training's forward: the attention of ``flash_attention_kernel`` with
    scores scaled by ``scale``, and the row log-sum-exp of the (soft-capped,
    masked) scores, f32 (B, Hq, S). bf16 on the card."""
    b, s, hq, hkv, dh = _shapes("flash_attention", q, k)
    shapes = ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    dtypes = DTYPES if q.device.type == "cpu" else (torch.bfloat16,)
    if check_inputs("flash_attention", (q, k, v), shapes, dtypes) == "cpu":
        return flash_attention_plain(q, k, v, window, softcap, scale, lse=True)
    _check_launch("flash_attention", (q, k, v), dh, MAX_HEAD_DIM)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, window, softcap, scale, lse), lse


def flash_attention_bwd(q, k, v, o, lse, do, window: int, softcap: float, scale: float):
    """(dq, dk, dv) of ``flash_attention_fwd_lse`` at upstream gradient
    ``do`` (B, S, Hq, Dh), from its inputs, its output ``o`` and its LSE.
    On the card three launches: D = rowsum(do ∘ o), then dK/dV, then dQ."""
    b, s, hq, hkv, dh = _shapes("flash_attention_bwd", q, k)
    shapes = ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh), (b, s, hq, dh), (b, s, hq, dh))
    dtypes = DTYPES if q.device.type == "cpu" else (torch.bfloat16,)
    if check_inputs("flash_attention_bwd", (q, k, v, o, do), shapes, dtypes) == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, window, softcap, scale)
    check_inputs("flash_attention_bwd", (lse,), ((b, hq, s),), (torch.float32,))
    if lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse on {lse.device}, expected {q.device}")
    _check_launch("flash_attention_bwd", (q, k, v, o, do), dh, MAX_HEAD_DIM)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd")
    sizes = (b, s, hq, hkv, dh, int(window), float(softcap), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        launches = (
            ("flash_attention_bwd_dot", (o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                                         b, s, hq, dh, stream)),
            ("flash_attention_bwd_dkdv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                          dk.data_ptr(), dv.data_ptr(), *sizes, stream)),
            ("flash_attention_bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        dq.data_ptr(), *sizes, stream)),
        )
        for name, args in launches:
            raise_on_error(name, getattr(lib, f"{name}_bf16")(*args))
            LAUNCHES[name] += 1
    return dq, dk, dv
