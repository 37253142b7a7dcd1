"""No dispatcher: the model calls ``kernel.mamba_scan_kernel`` directly.

The JAX wrapper this stands beside (``src/repro/kernels/mamba_scan/ops.py``)
casts to float32, transposes u and dt to (B, di, S) and b, c to (B, ds, S),
pads the channels to a multiple of 256 (with a = 0, so the padded channels
stay 0) and the steps to a multiple of 128, and trims and transposes y
back: the TPU kernel's blocks are 256 channels × 128 steps with the time
axis on the lanes. The CUDA kernel runs one thread per (batch, channel) on
the model's (B, S, ·) layouts, checks the ragged channel and step ranges
itself, and its inputs reach it in float32 already, so none of that work
has a counterpart here. Besides y, the kernel returns the state after the
last step, which the JAX package recomputes for a prefill with a second
scan (``models/model.py::_mamba_prefill``).
"""
