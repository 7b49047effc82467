from .base import (ModelConfig, MoEConfig, ParallelConfig, RGLRUConfig,
                   SHAPES, SSMConfig, ShapeSpec)
from .registry import all_cells, get, names, reduced, shapes_for

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "ParallelConfig",
    "ShapeSpec", "SHAPES", "get", "reduced", "names", "shapes_for",
    "all_cells",
]
