"""The Mamba-2 (SSD) scan of ``models/mamba2.py`` as hand-written kernels
(see ``csrc/ssd.cu``): ``kernel.ssd_fwd`` (y and what the backward reads),
``kernel.ssd_bwd`` (dx, dΔ, dA, dB, dC) and, in ``train.py``, the pair
behind a ``torch.autograd.Function``. The plain composition the model runs
off the card stays in ``models/mamba2.py`` (``ssd``); ``plain.py`` holds
the kernels' own plan written in PyTorch. There is no ``ops.py``: the JAX
package has no such mixer, so nothing of a JAX wrapper is left to note.
"""
