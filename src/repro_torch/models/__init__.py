"""The LM workload's models in PyTorch: the port of ``repro.models``
(dense and sliding-window attention, Mamba and RG-LRU blocks, dense and MoE
MLPs), served and trained."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
