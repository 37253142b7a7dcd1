"""Causal / sliding-window GQA flash attention (see ``csrc/flash_attention.cu``)."""
