from repro_torch.configs.base import (
    ARCH_IDS,
    ARCH_REGISTRY,
    PORTED_ARCH_IDS,
    SHAPES,
    RunConfig,
    ModelConfig,
    ShapeSpec,
    get_config,
    register,
    shape_applicable,
    smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "ARCH_REGISTRY",
    "PORTED_ARCH_IDS",
    "SHAPES",
    "RunConfig",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "register",
    "shape_applicable",
    "smoke_config",
]
