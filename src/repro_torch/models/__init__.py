"""Model configurations and the torch reference of the traced decoder block.

The model zoo itself (the families behind ``configs/``) is not ported yet;
``config`` holds the configurations the graph tier traces, and
``traceable`` the float64 reference its compiled graphs are held to.
"""
from .config import (FULL_ATTENTION_ARCHS, SHAPES, ModelConfig, ShapeConfig,
                     shape_applicable)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "FULL_ATTENTION_ARCHS",
           "shape_applicable"]
