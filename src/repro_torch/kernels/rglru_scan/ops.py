"""No dispatcher: the model calls ``kernel.rglru_scan_kernel`` directly.

The JAX wrapper this stands beside (``src/repro/kernels/rglru_scan/ops.py``)
casts to float32, transposes to (B, di, S) and pads to 256-channel ×
128-step blocks. The CUDA kernel runs one thread per (batch, channel) on the
model's (B, S, di) layout, and the gates reach it in float32 already, so none
of that work has a counterpart here. Besides h, the kernel returns the state
at the last step, which a prefill hands to decoding.
"""
