"""Architecture configs — one module per ported architecture."""
from .base import (ArchConfig, ShapeConfig, STANDARD_SHAPES, all_archs,
                   get_arch, register)

__all__ = ["ArchConfig", "ShapeConfig", "STANDARD_SHAPES", "all_archs",
           "get_arch", "register"]
