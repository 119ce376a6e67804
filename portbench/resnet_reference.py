"""The plain reference of the ``resnet50-1x1-gemm`` configuration, and its
control: ResNet-50's stride-1 pointwise convolutions in plain PyTorch.

A copy of the program's ``models/resnet50_1x1_reference.py`` kept with the
benchmark, so that a change to the program cannot move what ``correct`` is
decided against.  It imports nothing of the program.  The network is
ResNet-50 v1.5, torchvision's ``resnet50`` (arXiv:1512.03385 Table 1):
bottleneck blocks [3, 4, 6, 3] of widths 64, 128, 256, 512, each a 1x1
reduce, a 3x3 and a 1x1 expand to four times the width, the first block of
a stage with a 1x1 projection; a stage's stride is on its first 3x3, so
that block's reduce runs at the resolution before it.  Activations are
NHWC ``[B, H, W, C]``, a filter ``[kh, kw, Cin, Cout]``.

Departures from the model, each by choice of what is measured: the
convolutions alone, with no BatchNorm, ReLU or residual add, each conv on
an input of its own; the stride-2 projections, the 3x3 convs, the stem,
the pooling and the fully connected layer are left out.

``conv1x1`` computes with ``torch.nn.functional.conv2d`` on the NCHW
permutation, not as a matrix product.  Float64 throughout, TF32 off.
``precision`` rounds both operands as ``reference.lower`` does:
``"fp8"`` is the control of this bf16 configuration.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import lower, strict

#: (blocks, width, input channels, output resolution) of each stage
STAGES = ((3, 64, 64, 56), (4, 128, 256, 28), (6, 256, 512, 14),
          (3, 512, 1024, 7))
#: a bottleneck's expand: output channels = EXPANSION x width
EXPANSION = 4


def pointwise_convs() -> list[dict]:
    """The 33 stride-1 1x1 convolutions of one forward, in network order:
    each with ``stage`` (2-5, as ``conv2``-``conv5``), ``block``, ``role``
    (``reduce``, ``expand`` or ``projection``), ``h``, ``w``, ``cin`` and
    ``cout``."""
    out = []
    for s, (blocks, width, cin, res) in enumerate(STAGES):
        wide = EXPANSION * width
        for b in range(blocks):
            into = cin if b == 0 else wide
            at = res * 2 if b == 0 and s > 0 else res
            out.append(dict(stage=s + 2, block=b, role="reduce", h=at, w=at,
                            cin=into, cout=width))
            out.append(dict(stage=s + 2, block=b, role="expand", h=res,
                            w=res, cin=width, cout=wide))
            if b == 0 and s == 0:         # the one projection of stride 1
                out.append(dict(stage=s + 2, block=b, role="projection",
                                h=res, w=res, cin=cin, cout=wide))
    return out


def init_weight(cin: int, cout: int, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """A ``[1, 1, cin, cout]`` filter from ``generator``, uniform in
    +-1/sqrt(cin)."""
    u = torch.rand((1, 1, cin, cout), generator=generator, device=device,
                   dtype=dtype)
    return (2 * u - 1) / math.sqrt(cin)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            precision: str = "config") -> torch.Tensor:
    """The stride-1 1x1 convolution of the NHWC activation ``x``
    ``[B, H, W, Cin]`` by the filter ``w`` ``[1, 1, Cin, Cout]``, both
    operands in ``precision``: NHWC ``[B, H, W, Cout]`` in float64, on
    ``x``'s device."""
    strict()
    y = torch.nn.functional.conv2d(
        lower(x, precision).permute(0, 3, 1, 2),
        lower(w.to(x.device), precision).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)
