"""The model zoo's families, their configurations, and the torch reference
of the traced decoder block.

``build_model`` gives the dense, MoE and VLM decoder LMs
(``transformer.DecoderLM``), whisper (``whisper.WhisperModel``), xLSTM
(``xlstm_lm.XLSTMLM``) and the Jamba hybrid (``hybrid.HybridLM``);
``convert.from_jax_params`` carries the JAX package's parameters across.
``traceable`` holds the float64 reference the graph tier's compiled blocks
are held to.
"""
from .api import build_model
from .config import (FULL_ATTENTION_ARCHS, SHAPES, ModelConfig, ShapeConfig,
                     shape_applicable)
from .hybrid import HybridLM
from .xlstm_lm import XLSTMLM

__all__ = ["build_model", "ModelConfig", "ShapeConfig", "SHAPES",
           "FULL_ATTENTION_ARCHS", "shape_applicable", "XLSTMLM",
           "HybridLM"]
