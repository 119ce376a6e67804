"""The model zoo's attention families, their configurations, and the torch
reference of the traced decoder block.

``build_model`` gives the dense, MoE and VLM decoder LMs
(``transformer.DecoderLM``) and whisper (``whisper.WhisperModel``);
``convert.from_jax_params`` carries the JAX package's parameters across.
The recurrent families (xlstm, jamba) are not ported yet.  ``traceable``
holds the float64 reference the graph tier's compiled blocks are held to.
"""
from .api import build_model
from .config import (FULL_ATTENTION_ARCHS, SHAPES, ModelConfig, ShapeConfig,
                     shape_applicable)

__all__ = ["build_model", "ModelConfig", "ShapeConfig", "SHAPES",
           "FULL_ATTENTION_ARCHS", "shape_applicable"]
