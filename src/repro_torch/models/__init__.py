"""The LM workload's models in PyTorch: the port of ``repro.models``
(dense and sliding-window attention, RG-LRU blocks, dense MLPs)."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
