from .base import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    supports_shape,
)
from .registry import ARCHS, ASSIGNED, get

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
    "SHAPES", "ShapeConfig", "supports_shape",
    "ARCHS", "ASSIGNED", "get",
]
