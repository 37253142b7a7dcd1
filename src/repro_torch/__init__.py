"""PyTorch/CUDA port of the AMT reproduction (``repro``, the JAX reference).

Same module layout as the reference (``repro_torch.core``,
``repro_torch.core.gp``, ``repro_torch.kernels``). Importing the package
changes no global state: every tensor it makes names its dtype (float64 for
the GP and BO numerics) and its device. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
