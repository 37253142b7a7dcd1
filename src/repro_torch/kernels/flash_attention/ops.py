"""No dispatcher: the model calls ``kernel.flash_attention_kernel`` directly.

The JAX wrapper this stands beside (``src/repro/kernels/flash_attention/ops.py``)
transposes to (B·H, S, Dh), pads S to 128 and Dh to 128 lanes and trims
after. The CUDA kernel reads the model's (B, S, H, Dh) layout directly and
masks its ragged tail, so none of that work has a counterpart here. Inputs
keep their dtype (bf16 on the serving path): nothing is cast to f32.

Attention is always causal. The JAX wrapper's ``causal=False`` is not
ported: it pads S with zero keys that only the causal mask hides, so for a
ragged S its non-causal output attends to padding (ROADMAP C7), and no model
calls it.
"""
