"""Flash-decode's public entry point, with the JAX package's signature
(``src/repro/kernels/decode_attention/ops.py::decode_attention``):
``decode_attention(q, k_cache, v_cache, valid, *, softcap=0.0)`` on the
model's layout — q (B, Hq, Dh), caches (B, C, Hkv, Dh), valid (B, C) bool.

The JAX wrapper transposes the caches to (B·Hkv, C, Dh), packs the G query
heads of each KV head into a (B·Hkv, G, Dh) tile padded to 8 × 128, pads C
to a multiple of 512 and the mask to int32, and trims after. The CUDA
kernel reads the model's layouts and the bool mask directly and masks its
ragged tail, so none of that work has a counterpart here. As in the JAX
package, no model calls it: ``attention_decode`` keeps its own masked
softmax (ROADMAP B8).
"""

from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel as decode_attention

__all__ = ["decode_attention"]
