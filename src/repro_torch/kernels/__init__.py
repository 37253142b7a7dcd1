"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each kernel lives in a package of its own (``acq_score``, ``matern52``):

* ``kernel.py`` — the wrapper. On a CPU tensor it runs the plain version; on
  a CUDA tensor it launches the kernel (built from ``csrc/`` at first use,
  see ``_build.py``) or raises. There is no fallback from the card.
* ``plain.py`` — the same function written directly in PyTorch. The CPU
  tests and the on-card comparison use it; the main path on a card does not.
* ``ops.py`` — the dispatcher the engine calls: padding and parameter
  packing in the reference's layout.

``LAUNCHES`` counts kernel launches per kernel name; a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "KERNEL_NAMES", "reset_launch_counts"]

KERNEL_NAMES = ("acq_score", "acq_score_multi", "matern52_gram", "matern52_cross")

LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
