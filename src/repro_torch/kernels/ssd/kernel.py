"""Wrappers of the SSD scan's CUDA kernels (``csrc/ssd.cu``).

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernels on the current stream, or raises. Outputs and scratch are
allocated here with ``torch.empty``. x, B and C are read in rows (the last
dims contiguous, any stride between tokens; ``ssd_pack`` copies the mixer's
views of its conv output into rows); Δ, A and the upstream gradient as they
are, contiguous. bf16 on the card.
``LAUNCHES["ssd_fwd"]`` counts a forward (four kernels),
``LAUNCHES["ssd_bwd"]`` a backward (six), ``LAUNCHES["ssd_pack"]`` a copy of
a view into rows (``ssd_pack``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import raise_on_error
from repro_torch.kernels.ssd.plain import cb_width, chunks, ssd_bwd_plain, ssd_fwd_plain

__all__ = ["ssd_pack", "ssd_fwd", "ssd_bwd", "heads_a_block"]

MAX_HEAD_DIM = 64   # P: the kernels' register tiles hold 16 or 64 columns
MAX_STATE = 128     # N: 16, 64 or 128
MAX_CHUNK = 256     # L: a chunk's running sums and rows in shared memory
MAX_HEADS_A_BLOCK = 8
CARRY_SLICE = 1024  # state elements a block of the carry walks (csrc: kCarrySlice)


def heads_a_block(heads_per_group: int) -> int:
    """Heads whose dB and dC one backward block sums in registers: the
    largest divisor of H/G up to 8."""
    return max(e for e in range(1, MAX_HEADS_A_BLOCK + 1) if heads_per_group % e == 0)


def _token_stride(name: str, t: torch.Tensor, width: int) -> int:
    """The stride between tokens of (Bt, S, X, width) ``t``, whose last two
    dims are contiguous and whose batches follow one another."""
    bsz, s = t.shape[:2]
    ts = t.stride(1)
    if t.stride(3) != 1 or t.stride(2) != width or (bsz > 1 and t.stride(0) != s * ts):
        raise ValueError(f"ssd: {name} must be (Bt, S, ·, {width}) with contiguous rows, "
                         f"got strides {t.stride()}")
    if ts % 8 or t.data_ptr() % 16:
        raise ValueError(f"ssd: {name} must be 16-byte aligned, token stride a multiple of 8")
    return ts


def _check(x, dt, a, b, c, chunk):
    """Sizes (Bt, S, H, P, G, N) and token strides on the card; raises on
    what the kernels do not take."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(b.shape) != (bsz, s, g, n) or tuple(c.shape) != (bsz, s, g, n):
        raise ValueError(f"ssd: B {tuple(b.shape)} and C {tuple(c.shape)} must be (Bt, S, G, N)")
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or h % g:
        raise ValueError(f"ssd: Δ {tuple(dt.shape)}, A {tuple(a.shape)}, "
                         f"{h} heads over {g} groups")
    for name, t, want in (("x", x, torch.bfloat16), ("B", b, torch.bfloat16),
                          ("C", c, torch.bfloat16), ("Δ", dt, torch.float32),
                          ("A", a, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"ssd: {name} on {t.device}, expected {x.device}")
        if t.dtype != want:
            raise TypeError(f"ssd: {name} must be {want} on the card, got {t.dtype}")
    if p % 8 or p > MAX_HEAD_DIM or n % 8 or n > MAX_STATE:
        raise ValueError(f"ssd: head dim {p} and state {n} must be multiples of 8, at most "
                         f"{MAX_HEAD_DIM} and {MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk {chunk} must be 1 to {MAX_CHUNK}")
    if not (dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd: Δ and A must be contiguous")
    strides = (_token_stride("x", x, p), _token_stride("B", b, n), _token_stride("C", c, n))
    return (bsz, s, h, p, g, n), strides


def ssd_pack(t: torch.Tensor) -> torch.Tensor:
    """(Bt, S, X, Y) bf16 with rows of X·Y contiguous channels: ``t`` as it
    is when its rows are so, else a copy by ``csrc/ssd.cu``'s ``ssd_pack``
    (the mixer's views of the conv output lie a token apart along S). A CPU
    tensor is copied by ``contiguous``."""
    bsz, s, xx, yy = t.shape
    if t.stride(3) == 1 and t.stride(2) == yy:
        return t
    if t.device.type == "cpu":
        return t.contiguous()
    if t.dtype != torch.bfloat16 or t.stride(2) != yy * t.stride(3):
        raise ValueError(f"ssd_pack: bf16 with evenly strided channels, got {t.dtype}, "
                         f"strides {t.stride()}")
    out = torch.empty((bsz, s, xx, yy), dtype=t.dtype, device=t.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library("ssd").ssd_pack_bf16(t.data_ptr(), t.stride(0), t.stride(1),
                                                   t.stride(3), bsz, s, xx * yy, out.data_ptr(),
                                                   stream)
    raise_on_error("ssd_pack", err)
    LAUNCHES["ssd_pack"] += 1
    return out


def ssd_fwd(x, dt, a, b, c, chunk: int):
    """y (Bt, S, H, P) float32 of the scan, and what the backward reads:
    (y, cs, cb, states, states16) as ``plain.ssd_fwd_plain`` documents
    them."""
    if x.device.type == "cpu":
        return ssd_fwd_plain(x, dt, a, b, c, chunk)
    sizes, strides = _check(x, dt, a, b, c, chunk)
    bsz, s, h, p, g, n = sizes
    k, lp = chunks(s, chunk), cb_width(chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, s, h, p), **f32)
    cs = torch.empty((bsz, h, k, chunk), **f32)
    cb = torch.empty((bsz, g, k, lp, lp), **f32)
    states = torch.empty((bsz, h, k, p, n), **f32)
    states16 = torch.empty(states.shape, dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y, cs, cb, states, states16
    own = torch.empty_like(states)  # each chunk's own state, before the carry
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library("ssd").ssd_fwd_bf16(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), cs.data_ptr(), cb.data_ptr(), states.data_ptr(), states16.data_ptr(),
            own.data_ptr(), *sizes[:4], g, n, chunk, *strides, stream)
    raise_on_error("ssd_fwd", err)
    LAUNCHES["ssd_fwd"] += 1
    return y, cs, cb, states, states16


def ssd_bwd(x, dt, a, b, c, cs, cb, states, states16, dy, chunk: int):
    """(dx, dΔ, dA, dB, dC) of the scan at upstream gradient ``dy`` (Bt, S,
    H, P) float32, from its inputs and the running sums, C·Bᵀ and entering
    states ``ssd_fwd`` returned; dx, dB and dC bf16, dΔ and dA float32 on
    the card. Deterministic: no atomics."""
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, dt, a, b, c, cs, cb, states, states16, dy, chunk)
    sizes, strides = _check(x, dt, a, b, c, chunk)
    bsz, s, h, p, g, n = sizes
    k = chunks(s, chunk)
    for name, t, shape in (("dy", dy, (bsz, s, h, p)),
                           ("cs", cs, (bsz, h, k, chunk)),
                           ("cb", cb, (bsz, g, k, cb_width(chunk), cb_width(chunk))),
                           ("states", states, (bsz, h, k, p, n)),
                           ("states16", states16, (bsz, h, k, p, n))):
        want = torch.bfloat16 if name == "states16" else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"ssd_bwd: {name} must be contiguous {want} {shape} on {x.device}")
    hpb = heads_a_block(h // g)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((bsz, s, h), **f32)
    da = torch.empty((h,), **f32)
    db = torch.empty((bsz, s, g, n), dtype=b.dtype, device=x.device)
    dc = torch.empty((bsz, s, g, n), dtype=c.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, ddt, da.zero_(), db, dc
    scratch = (torch.empty((bsz, h, k, p, n), dtype=torch.bfloat16, device=x.device),  # Ĝ
               torch.empty((bsz, h, k, p, n), **f32),  # each chunk's own part of Ĝ
               torch.empty((bsz, s, h, p), dtype=torch.bfloat16, device=x.device),  # dy, bf16
               # ⟨Ĝ_k, E_{k+1}⟩ in parts, one a carry block
               torch.empty((bsz, h, k, -(-p * n // CARRY_SLICE)), **f32),
               torch.empty((bsz, h, k, chunk), **f32),  # r = x·dxd
               torch.empty((bsz, h, k, chunk), **f32),  # what dcs gains by rows i
               torch.empty((bsz, h, k, chunk), **f32),  # what dcs loses by rows j
               torch.empty((h // g // hpb, bsz, s, g, n), **f32),  # dB by head group
               torch.empty((h // g // hpb, bsz, s, g, n), **f32))  # dC by head group
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library("ssd").ssd_bwd_bf16(
            *(t.data_ptr() for t in (x, dt, a, b, c, cs, cb, states, states16, dy, dx, ddt, da,
                                     db, dc, *scratch)),
            *sizes[:4], g, n, chunk, *strides, hpb, stream)
    raise_on_error("ssd_bwd", err)
    LAUNCHES["ssd_bwd"] += 1
    return dx, ddt, da, db, dc
