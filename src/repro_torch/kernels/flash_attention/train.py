"""Training's attention: the flash-attention pair behind autograd.

``FlashAttentionTrain`` runs ``flash_attention_fwd_lse`` forward — the
output and the row log-sum-exp, nothing of size S² kept — and
``flash_attention_bwd`` backward, which rebuilds the probabilities from q,
k and the LSE. On the card both are hand-written kernels (bf16), launched
on the current stream with outputs from ``torch.empty``, so a CUDA graph
captures them; on CPU tensors both run their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd_lse

__all__ = ["FlashAttentionTrain"]


class FlashAttentionTrain(torch.autograd.Function):
    """Causal (windowed, soft-capped) GQA attention with a gradient for q,
    k and v: ``apply(q, k, v, window, softcap, scale)``, q (B, S, Hq, Dh)
    and k/v (B, S, Hkv, Dh) contiguous → (B, S, Hq, Dh); positions are
    0…S−1."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float, scale: float):
        out, lse = flash_attention_fwd_lse(q, k, v, window, softcap, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None
