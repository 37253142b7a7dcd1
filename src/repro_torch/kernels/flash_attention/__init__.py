"""Causal / sliding-window GQA flash attention (see ``csrc/flash_attention.cu``).

Prefill and serving (``impl="kernel"``) call the forward,
``kernel.flash_attention_kernel``. Training calls the pair in ``train.py``:
the forward with the row log-sum-exp and the backward of
``csrc/flash_attention_bwd.cu``, behind a ``torch.autograd.Function``.
"""
