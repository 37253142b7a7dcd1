from repro_torch.configs.base import (
    Mamba2Settings,
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
    ShapeConfig,
    SHAPES,
)
from repro_torch.configs.registry import (
    ARCHITECTURES,
    get_config,
    list_archs,
    tiny,
)

__all__ = [
    "Mamba2Settings",
    "MambaSettings",
    "ModelConfig",
    "MoESettings",
    "RGLRUSettings",
    "ShapeConfig",
    "SHAPES",
    "ARCHITECTURES",
    "get_config",
    "list_archs",
    "tiny",
]
