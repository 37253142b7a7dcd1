"""The SSD scan with a gradient: the kernel pair behind autograd.

``SSDTrain`` runs ``ssd_fwd`` forward (on x, B and C in rows: the mixer
hands over views of the conv's output, whose channels lie a token length
apart, and ``ssd_pack`` copies those) — y, and of what the backward reads
only the running sums (Bt, H, K, L), C·Bᵀ once a group and the chunks'
entering states (float32, and bf16 for the products), nothing of size L²
a head — and ``ssd_bwd`` backward. On
the card both are hand-written kernels (bf16), launched on the current
stream with outputs from ``torch.empty``, so a CUDA graph captures them; on
CPU tensors both run their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_bwd, ssd_fwd, ssd_pack

__all__ = ["SSDTrain"]


class SSDTrain(torch.autograd.Function):
    """The Mamba-2 recurrence without its D skip (``models/mamba2.py::ssd``):
    ``apply(x, dt, a, b, c, chunk)``, x (Bt, S, H, P), Δ (Bt, S, H), A
    (H,), B and C (Bt, S, G, N) → y (Bt, S, H, P) float32."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int):
        x, b, c = (ssd_pack(t) for t in (x, b, c))
        y, *saved = ssd_fwd(x, dt, a, b, c, chunk)
        ctx.save_for_backward(x, dt, a, b, c, *saved)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_bwd(*ctx.saved_tensors, dy.contiguous(), ctx.chunk)
        return (*grads, None)
