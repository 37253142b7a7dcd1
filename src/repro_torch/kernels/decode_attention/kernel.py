"""Wrapper of the flash-decode CUDA kernel.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/decode_attention.cu`` on the current stream, or
raises. The output and the kernel's scratch (each cache split's running
max, sum and accumulator, f32) are allocated here with ``torch.empty``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.decode_attention.plain import decode_attention_plain

__all__ = ["decode_attention_kernel", "DTYPES", "MAX_HEAD_DIM", "split_plan"]

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 256  # both bodies' register tiles
HEADS_PER_BLOCK = 16  # query heads a block owns (both bodies)
# Per body (csrc/decode_attention.cu): keys per tile, tiles per cache split
# at least, and the blocks per SM the split count aims at. The tensor-core
# body takes 64-key tiles and aims at eight blocks an SM, so that the
# blocks of a long cache spread evenly over the SMs, and allows one tile a
# split, so that a short cache still gives every SM a block; the SIMT body
# keeps its 32-key tiles, four a split, two blocks an SM.
PLAN = {torch.bfloat16: (64, 1, 8), torch.float32: (32, 4, 2)}


def split_plan(b: int, hkv: int, g: int, c: int, sm_count: int,
               dtype: torch.dtype = torch.float32) -> tuple:
    """(splits, tiles per split) of the cache for the body that ``dtype``
    runs, by its ``PLAN``: about its blocks per SM, at least its fewest
    tiles a split, no split empty."""
    tile, min_tiles, waves = PLAN[dtype]
    tiles = -(-c // tile)
    blocks = b * hkv * -(-g // HEADS_PER_BLOCK)
    nsplit = max(1, min(-(-tiles // min_tiles), -(-waves * sm_count // blocks)))
    per = -(-tiles // nsplit)
    return -(-tiles // per), per


def decode_attention_kernel(q, k_cache, v_cache, valid, *, softcap: float = 0.0) -> torch.Tensor:
    """One query token per sequence: q (B, Hq, Dh), k/v caches (B, C, Hkv,
    Dh), bf16 or f32, valid (B, C) bool → (B, Hq, Dh) in q's dtype; f32
    softmax and accumulation. A row with no valid slot gives 0."""
    b, hq, dh = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"decode_attention: {hq} query heads over {hkv} KV heads")
    shapes = ((b, hq, dh), (b, c, hkv, dh), (b, c, hkv, dh))
    dev = check_inputs("decode_attention", (q, k_cache, v_cache), shapes, DTYPES)
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, c):
        raise ValueError(
            f"decode_attention: valid must be bool of shape {(b, c)}, got "
            f"{valid.dtype} {tuple(valid.shape)}"
        )
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("decode_attention: valid must be contiguous on q's device")
    if c < 1:
        raise ValueError("decode_attention: the cache has no slot")
    if dev == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid, softcap)
    if (dh * q.element_size()) % 16 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attention: a head of {dh} {q.dtype} must fill whole "
            f"16-byte chunks and be at most {MAX_HEAD_DIM} wide"
        )
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and the k and v caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("decode_attention"), f"decode_attention_{suffix(q.dtype)}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, per = split_plan(b, hkv, hq // hkv, c, sms, q.dtype)
    part_m = torch.empty((nsplit, b * hq), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((nsplit, b * hq, dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                 b, c, hq, hkv, dh, nsplit, per, float(softcap), float(dh**-0.5), stream)
    raise_on_error("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out
