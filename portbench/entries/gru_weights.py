"""A GRU's ten weights and its inputs, made on the device from the seed:
the weights uniform in +-1/sqrt(H) (PyTorch's ``nn.GRU`` initialisation),
inputs uniform in +-1, one draw a tensor, in the dtype they are served in."""
from __future__ import annotations

import math

import torch

from portbench.reference import GRU_NAMES


def make_weights(inp: int, hidden: int, dtype: torch.dtype,
                 gen: torch.Generator, device: torch.device) -> dict:
    bound = 1.0 / math.sqrt(hidden)
    shapes = {"W": (inp, hidden), "U": (hidden, hidden), "b": (hidden,)}
    return {name: torch.empty(shapes[name[0]], dtype=dtype, device=device)
            .uniform_(-bound, bound, generator=gen) for name in GRU_NAMES}


def uniform(shape, dtype: torch.dtype, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -1.0, 1.0, generator=gen)
