"""Flash-decode: one query token against a KV cache (see ``csrc/decode_attention.cu``)."""
