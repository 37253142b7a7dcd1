"""Serving entry points of the port: prefill and single-token decode steps.

The JAX package jit-compiles these; PyTorch runs them eagerly. The model
holds its parameters, so the functions take none.
"""

from __future__ import annotations

import torch

__all__ = ["make_prefill", "make_decode_step", "greedy_generate"]


def make_prefill(model, cache_len: int):
    def prefill(inputs):
        return model.prefill(inputs, cache_len)

    return prefill


def make_decode_step(model):
    def decode_step(cache, inputs, t):
        return model.decode_step(cache, inputs, t)

    return decode_step


def greedy_generate(model, prompt, num_tokens: int, cache_len: int) -> torch.Tensor:
    """Greedy generation: prefill the prompt ((B, S) tokens or (B, S, D)
    embeddings), then ``num_tokens`` decode steps each fed the previous
    argmax. Returns the (B, num_tokens) generated tokens."""
    logits, cache = make_prefill(model, cache_len)(prompt)
    step = make_decode_step(model)
    seq_len = prompt.shape[1]
    out = []
    tok = torch.argmax(logits, dim=-1)  # (B,)
    for i in range(num_tokens):
        out.append(tok)
        if model.cfg.embed_inputs:
            # stub frontend: feed the token back through the output embedding
            with torch.inference_mode():
                emb = model.embed[tok][:, None, :]
            logits, cache = step(cache, emb, seq_len + i)
        else:
            logits, cache = step(cache, tok, seq_len + i)
        tok = torch.argmax(logits, dim=-1)
    tokens = torch.stack(out, dim=1)
    # a model on a mesh returns the tokens whole, as a plain tensor
    return tokens.full_tensor() if hasattr(tokens, "full_tensor") else tokens
